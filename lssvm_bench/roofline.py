"""The yardstick of the kernels' roofline shares: which kernel a trace
event belongs to, at which precision tier, and the least time a call could
take on the chip.

The work is counted from the call's own operands at the data's width: no
padded rows or features, whatever a kernel computes on top.  A Gram
product over ``a`` x ``b`` entries of ``f`` features takes ``2 f`` flops an
entry, three times that at ``bf16x3`` (three bf16 products), against the
tier's peak; its bytes read each operand once at its stored width and the
vector, the row norms and the output once.  The least time is the larger of
flops over peak and bytes over bandwidth, so a share cannot pass 100 %
for any implementation of the same product."""

from __future__ import annotations

import re

#: NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
PEAK_FLOPS = {"exact": 67e12, "bf16x3": 989e12, "bf16cast": 989e12}
PEAK_BYTES_PER_S = 3.35e12
#: bytes per stored feature value of an operand at each tier (bf16x3 keeps
#: a hi and a lo bf16 part)
OPERAND_BYTES = {"exact": 4, "bf16x3": 4, "bf16cast": 2}
PRODUCTS = {"exact": 1, "bf16x3": 3, "bf16cast": 1}

# (pattern, kernel, tier or None where the tier comes from a template
# argument); demangled names first, then the mangled forms
_MAIN = [
    (re.compile(r"gram_matvec_sym_kernel"), "K1", "exact"),
    (re.compile(r"gram_matvec_rect_kernel"), "K2", "exact"),
    (re.compile(r"gram_pair_contrib_kernel"), "K3", "exact"),
    (re.compile(r"gram_wgmma_rows_kernel\s*<\s*(\d)|gram_wgmma_rows_kernelILi(\d)E"), "K2", None),
]
_WGMMA = re.compile(r"gram_wgmma_kernel\s*<\s*(\d)\s*,\s*(\d)|gram_wgmma_kernelILi(\d)ELi(\d)E")
_MODE = {0: "K1", 1: "K3", 2: "K2"}
_NPROD = {3: "bf16x3", 1: "bf16cast"}
#: the reductions that finish a call: K1's strip sum, and the slab sum of
#: whichever of K2 or K3 launched just before it
_REDUCE = {"reduce_sym_strip_kernel": "K1", "reduce_slab_kernel": None}


def classify(name: str):
    """``(kernel, tier)`` of a main Gram kernel's trace name, ``(kernel,
    "reduce")`` of a reduction (kernel None: the preceding call's), or None
    for any other event."""
    m = _WGMMA.search(name)
    if m:
        nprod, mode = (int(v) for v in (m.group(1, 2) if m.group(1) else m.group(3, 4)))
        return _MODE[mode], _NPROD[nprod]
    for pattern, kernel, tier in _MAIN:
        m = pattern.search(name)
        if m:
            if tier is None:
                tier = _NPROD[int(next(g for g in m.groups() if g))]
            return kernel, tier
    for red, kernel in _REDUCE.items():
        if red in name:
            return kernel, "reduce"
    return None


def least_seconds(flops: float, nbytes: float, tier: str) -> float:
    return max(flops / PEAK_FLOPS[tier], nbytes / PEAK_BYTES_PER_S)


def k1_call(n: int, f: int, tier: str) -> tuple[float, float]:
    """(flops, bytes) of K1 = K(X, X) v over ``n`` rows of ``f`` features:
    the symmetric product counts its n (n + 1) / 2 distinct entries."""
    entries = n * (n + 1) / 2
    flops = entries * 2 * f * PRODUCTS[tier]
    nbytes = n * f * OPERAND_BYTES[tier] + 3 * n * 4  # X; v, norms, out
    return flops, nbytes


def k2_call(rows: int, cols: int, f: int, tier: str) -> tuple[float, float]:
    """(flops, bytes) of K2 = K(X, Y) v, X ``rows`` x f, Y ``cols`` x f."""
    flops = rows * cols * 2 * f * PRODUCTS[tier]
    nbytes = (rows + cols) * f * OPERAND_BYTES[tier] + (rows + 2 * cols) * 4 + rows * 4
    return flops, nbytes


def calls(kernels, kernel: str):
    """The calls of ``kernel`` in a device's time-ordered events: each a
    maximal run of that kernel's launches (its strips and their reductions)
    with no other device activity between them.  ``kernels`` holds
    ``(name, start_s, end_s)``; yields ``(tier, busy_seconds)`` per call."""
    call_tier, busy, owner = None, 0.0, None
    for name, start, end in kernels:
        c = classify(name)
        if c is not None and c[1] == "reduce" and c[0] is None:
            c = (owner, "reduce")
        if c is not None and c[0] == kernel:
            if c[1] != "reduce":
                if call_tier is not None and call_tier != c[1]:
                    yield call_tier, busy
                    busy = 0.0
                call_tier = c[1]
            busy += end - start
            owner = c[0]
            continue
        if call_tier is not None:
            yield call_tier, busy
        call_tier, busy = None, 0.0
        owner = c[0] if c is not None else None
    if call_tier is not None:
        yield call_tier, busy


def share(kernels_by_device, kernel: str, work) -> float | None:
    """Σ least time / Σ device time over every call of ``kernel``, in %;
    ``work(tier) -> (flops, bytes)`` gives one call's count.  None where
    the trace holds no call."""
    least = busy = 0.0
    for events in kernels_by_device.values():
        for tier, seconds in calls(events, kernel):
            least += least_seconds(*work(tier), tier)
            busy += seconds
    return 100.0 * least / busy if busy > 0 else None
