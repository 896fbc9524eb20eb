#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on an NVIDIA GPU.

    python3 chip_smoke.py [--profile | --probe | --sharded | --distributed | --strips | --tools
                           | --float64 | --cg | --gram | --cli]

Needs one CUDA device, ``nvcc`` (``$CUDA_HOME`` or ``/usr/local/cuda``) and
the repository around this script; it imports nothing of JAX.  Phases 3-10
check the exact tier and pin ``PLSSVM_MATMUL_PRECISION=highest``; phases
11-14 run the bf16x3 / bf16cast tiers and the default adaptive plan.
Phases, one line or more each, any failure exits non-zero:

1. device: ``nvidia-smi`` name and power limit, CUDA version;
2. build: every ``csrc/*.cu`` through ``ops/_build.py``;
3. K1 (symmetric Gram matvec) against its plain PyTorch version, three
   kernels x four shapes, with ms per A·v for both;
4. K2 (rectangular Gram matvec) against its plain version at predict
   shapes;
5. K3 (panel-pair Gram matvec) against its plain version at the sparse
   main path's panel pairs, three kernels: cross panels 4096 x 4096 at
   f = 4096, a ragged 3000 x 1700 pair at f = 1001, and the diagonal
   panel (``same=True``, K1 on the panel);
6. the dense main path through the CLIs: ``plssvm-train-torch`` on a
   seeded 32768 x 256 two-blob LIBSVM file (rbf, float32, ``-b cuda``),
   then ``plssvm-predict-torch`` on a 4096-point test file; the launch
   counters must show K1 in training and K2 in prediction, accuracy
   >= 95 %, the learn's steps replayed as CUDA graphs, its wall split into
   set-up and CG ms (``Timings`` sink) with their parts (set-up: ``load``,
   ``pad``, ``h2d``, ``system``, ``operands``; CG: ``capture``) beside its
   steps issued, host reads and chunk size, each CLI's wall split into its
   parts (train: ``parse``, ``learn``, ``write``; predict:
   ``parse_model``, ``parse_data``, ``predict``, ``write``), the model
   file's and the predictions' SHA-256; and a small learn checked against a
   direct solve of the LS-SVM system;
7. timing at rbf 4096 x 256 float32: CG iterations/s at a pinned count
   (eps = 0, slope between two caps) with K1 and with the plain version,
   and learn() time to eps = 1e-6;
8. the sparse main path through the CLIs, at the JAX bench's sparse size
   (16384 x 4096 at 1 % density, rbf, float32, default
   ``--sparse_threshold``): the auto tier (``gram``), the ``dense`` tier
   (K1 must launch) and the ``implicit`` panel tier over four 4096-row
   panels (K3 must launch), each predicted by ``plssvm-predict-torch``;
   the tiers' decision values must agree and the accuracy reach its bar;
   the densify of one panel timed against the broadcast-compare form;
9. the sparse-linear CLI at the same size, CG it/s of every sparse tier
   at a pinned count, bitwise repeatability of two sparse learns, and one
   ``gather``-arm learn at 8192 x 262144 and 0.01 % density;
10. only with ``--profile``, run last: ``torch.profiler`` over 12 CG
    iterations of each sparse tier (4 of the gather arm), printing the
    device's idle share of the CG wall time and the six costliest kernels;
11. K4: the one-pass split kernel (``csrc/split_bf16.cu``) bit for bit
    against its plain version on seeded data with subnormals, zeros of
    both signs, infinities, NaNs, remainders that flush and a ragged
    f = 1001 (pad columns zero), with its ms per 4096 x 4096 panel and per
    32768 x 256; then K1, K2 and K3 at the bf16x3 and bf16cast tiers,
    three kernels, at the main path's shapes, each against its plain
    version at the same tier and against the exact kernel, all on the
    TMA-fed wgmma tile (``csrc/gram_tile_wgmma.cuh``; K2 in its row-only
    mode): K1 at 32768 x 256 and on a 4096-row diagonal panel at f = 4096;
    K2 at 4096 points and at one point against 32768 support vectors,
    f = 256, and on a ragged 3000 x 1700 at f = 1001, with prepared
    operands and, at the predict's shape, with the split or cast inside;
    K3 at 4096 x 4096, f = 4096, on a ragged 3000 x 1700 pair at f = 1001
    and on one pair of 512-row panels, with each panel's operands prepared
    by the caller as the panel schedules do (the preparation is timed per
    panel); two runs of each are compared bitwise;
12. the adaptive dense main path: ``plssvm-train-torch`` on phase 6's
    32768 x 256 file with the default plan (bf16cast CG, verified and, if
    need be, continued on bf16x3), with phase 6's splits, loop line and
    digests, then ``plssvm-predict-torch`` with each bf16 tier pinned (K2
    at that tier);
13. the adaptive sparse ``dense`` and ``implicit`` tiers through the CLIs
    on phase 8's 16384 x 4096, 1 % files;
14. a forced escalation (``PLSSVM_CG_STAG_PATIENCE=2``, eps 1e-9) at rbf
    4096 x 256, and CG it/s at a pinned count per tier (``highest``,
    ``high``, ``default``) at rbf 32768 x 256 and at the sparse
    ``implicit`` tier;
15. the checkpointed dense learn through ``plssvm-train-torch`` on phase
    6's file (exact tier): a run stopped by ``--max_iter 5`` and resumed
    from its checkpoint, an uninterrupted ``--checkpoint --verbose_cg`` run
    (one ``Start Iteration`` line per iteration) and a one-shot learn end on
    the same iteration count, the first two on byte-equal model files, the
    third within 1e-6; K1 launches once per A·v; the learn's wall split
    into set-up and CG milliseconds from a ``Timings`` sink;
16. the small CLIs: ``plssvm-generate-data-torch`` writes a train and a
    test file, the train and predict CLIs run on them on the card,
    ``plssvm-detect-torch --json`` names the card, ``cuda`` and ``nvcc``;
17. the row-sharded dense learn (``parallel/sharded.py``) over 2 and 4
    logical shards of the card (and over every card where there are more):
    the ``implicit`` ring at rbf 32768 x 256 on each pinned tier and on the
    adaptive plan, every hop one launch of K2 (p squared per A·v), against
    the single-device learn of the same tier; the ``linear`` and ``cached``
    modes at 4096 x 256; sharded predict and ``w`` against the
    single-device ones; a chunked sharded learn interrupted and resumed
    from its checkpoint; two runs bitwise equal; ms per A·v for p = 1, 2, 4
    beside K1's;
18. the rest of ``parallel/sharded.py`` on 2 and 4 logical shards of the
    card (and over every card where there are more), float32, each against
    its one-device counterpart: (a) the feature-sharded learn at 4096 x
    65536 (f / p > D), linear, polynomial and rbf, and a chunked rbf learn
    interrupted and resumed; (b) the sparse linear ring on phase 8's set;
    (c) the panel ring, rbf, over 2 shards at the largest K-cache budget
    that routes a learn there, every panel pair one launch of K2 (p² nP²
    per A·v) on ``highest`` and on ``default``, and a learn; (d) the gather
    ring on phase 9's 8192 x 262144 set.  One A·v of each within
    ``RING_TOL`` of the one-device operator, each learn's iterations within
    one of the one-device learn's, its residual at the target and by the
    one-device operator under ``TRUE_RESIDUAL`` times it; ms per A·v;
19. the sharded learns and predict across two processes
    (``parallel/distributed.py``), each a worker of this script with two
    logical shards, a global mesh of four: both ranks on the card over gloo
    (blocks staged through host memory), and, where there are two cards or
    more, one rank per card over NCCL.  At phase 17's rbf 32768 x 256: one
    A·v of the ring on ``highest`` and on ``default``, the ring learn on
    ``highest`` and on the adaptive plan (K2 counted in each worker, half
    the one-process launches each), the chunked learn stopped at 5 by one
    pair (rank 0 writes the checkpoint) and resumed by a fresh pair, the
    sharded predict of 4096 points; the gather ring on phase 9's set; the
    feature-sharded rbf learn on phase 18's 4096 x 65536 (one A·v, a learn
    capped at 20 iterations); the sparse linear ring and the panel ring
    (rbf, 768-row panels) on phase 8's set: one A·v each, the panel ring's
    on ``highest`` and on ``default`` with K2 on every panel pair (each
    rank half the one-process launches), and their learns.  Every result
    is bitwise the one-process run's over the same four shards, on both
    ranks; a worker that fails, hangs (``DIST_TIMEOUT``) or exits non-zero
    fails the phase.  Prints the transport, ms per A·v beside the
    one-process run's, the learns' seconds and the phase's;
20. the kernels' scratch in strips (``ops/gram_matvec.SCRATCH_BYTES``): K1
    rbf at 131072 x 256 on each tier, one strip against the default budget's
    four (the two within 1e-6, said whether bitwise; the strips against the
    plain version), with ms; K1 bf16cast at 524288 x 256, where one slab
    would take 8 GiB, its peak memory beyond its inputs within
    ``SCRATCH_BYTES`` plus the output, held to K2 on the same operands; K2
    and K3 in four strips against one, on each tier;
21. the on-chip tools of ``plssvm_sparse_fp22_tpu_torch/scripts`` at small
    sizes on the card (``gpu_validate`` with every check passing,
    ``profile_cg``, ``precision_study``, ``comms_check`` over two ranks,
    ``scaling_bench`` on logical shards), one line each;
22. float64 on the card, where the kernels (float32 only) launch nowhere,
    as the JAX package keeps float64 off Pallas: (a) the train CLI without
    ``--use_float`` on two blobs of 40960 x 256, rbf (float64 K 12.5 GiB,
    beyond the 8 GiB budget: ``implicit`` as the blocked float64 product),
    converged to eps 1e-6, then the predict CLI without ``--use_float`` on
    4096 points at >= 95 %, each with phase 6's splits and digests; (b)
    that system's float64 A·v against the float64 cached K under a 16 GiB budget (``F64_AV_TOL``), with ms of
    both; (c) the sparse panel tier at float64 on phase 8's set (512 MiB
    budget: plain pairs), converged, its A·v against the gram tier's
    (``F64_AV_TOL``), accuracy on the test rows; (d) phase 6's reference
    check at float64, forced to ``implicit``, eps 1e-10
    (``F64_REFERENCE_TOL``); (e) the default float32 ``linear`` learn
    through the CLIs on the exact tier (no bf16 operand prepared), at the
    direct float64 solve's training accuracy less one point;
23. the CG loop on the device (``solver/cg.py``: chunk graphs, a WHILE
    node over IF-node slots, the host's read one chunk behind) at rbf 4096 x 256 and 32768 x
    256, each tier, after the torch, CUDA and driver versions: CG it/s by
    the two-cap slope on the chunk graphs and in the eager masked loop, the
    idle share of a pinned solve under ``torch.profiler``, the device µs of
    a chunk launched after the stop (one skipped slot), and per solve the
    host reads, slots issued and steps
    executed; the chunk-graph solve bit for bit the eager loop's (``x``,
    ``delta``, ``k``) pinned across the refresh at 49, to eps 1e-6 and
    resumed from ``k0`` = 37, with K1 counted once per step executed, once
    for the initial residual and once per refresh, at most ``ceil(n / c) +
    2`` host reads for ``n`` iterations, and one capture for the loop; (b)
    ``learn()`` on fresh ``CSVM``s of one layout (rbf 4096 x 256, the
    default plan and ``highest``): after ``solver.cg.clear_graphs()`` the
    first learn captures, a second of the same data nothing, bit for bit
    the first, one at another ``cost`` or ``eps`` only loops not run before
    (on ``highest`` none; a repeat nothing), one graph per loop, one at
    another ``gamma`` its own; each learn's wall ms;
24. the sparse gram tier's Gram from the CSR rows (``ops/sparse_gram.py``,
    the pair kernel ``csrc/sparse_gram.cu``) at rcv1's shape (the
    benchmark's generator, ``lssvm_bench/data/sparse_docs.py``, 20241 x
    47236): the split at ``split_threshold`` (T, heavy columns, light
    pairs), the kernel path twice bit for bit, bitwise its plain version on
    the same slab product, 512 sampled rows within 1e-5 of the float64 Gram
    beside ``Xd @ Xd.T``'s error, ``sq`` G's diagonal, the padding zero; ms
    of the split, the slab's product, the pair kernel and the whole Gram
    beside its bound (the larger of the Gram's write and sum of count²
    multiply-adds at the float32 peak), the plain version and ``Xd @ Xd.T``
    (``library_ms``); the split's two rates measured as slopes
    (``constants.SPARSE_GRAM_*``) and the modelled ms beside the measured
    ones at several thresholds; two learns of the gram tier, each one pair
    kernel, counted from zero before it.

``--sharded`` runs phases 1, 2, 17, 18 and 19 only (the phases that differ
on a machine with several cards); ``--distributed`` phases 1, 2 and 19;
``--strips`` phases 1, 2 and 20; ``--tools`` phases 1, 2 and 21;
``--float64`` phases 1, 2 and 22; ``--cg`` phases 1, 2 and 23; ``--gram``
phases 1, 2 and 24; ``--cli``
phases 1, 2, 6 (its reference check first, on its own data, so that the
CLIs' splits are those of a process that has used the card, as in the
full run), 12, 22 (a) and 23 (b): the CLIs and learns with their splits.
``--probe`` is the short first run after a change to a kernel source:
phases 1 and 2, the compiler's resource lines of every kernel (the whole
log goes to ``build.log`` beside the built library), and phase 11's checks
with one launch each instead of a timing loop; it prints no result line.

The line before the last is the kernels' JSON record: per kernel x tier
its launches on a main path, its error against and time beside its plain
version, and ``bound_ms``, the least time the card could take
(:func:`bound_ms`).  ``library_ms`` is null for the ten Gram-matvec and
split records: no single PyTorch call computes a Gram product, a kernel
transform and the GEMVs in one, nor both parts of the split.  The eleventh,
``sparse_gram_pairs`` (phase 24), is the whole Gram from the rows, its
``library_ms`` the dense float32 ``Xd @ Xd.T``.  K2's bf16 records carry the kernel's time on
prepared operands as ``ms`` and the predict's, split or cast inside, as
``ms_with_preparation``; K1's exact record also carries its launches under
the chunked CG loop (phase 15, ``launches_chunked_learn``) and K2's records
and the split's theirs on the ring of 4 shards (phase 17,
``launches_ring``), K2's exact record its launches in the panel ring's learn
(phase 18, ``launches_sparse_ring``), K2's records and the split's theirs in
the ring learns across two processes, summed over the ranks (phase 19,
``launches_distributed``), and K2's exact record its launches in the panel
ring's learn across two processes, summed over the ranks (phase 19,
``launches_distributed_sparse_ring``); K1's, K2's and K3's records carry
their one-strip and stripped ms of phase 20 (``strips``; K1 bf16cast also
its D = 524288 call under ``big``).  The last line is ``{"ok": true, "device": {...}}``.  Scratch files go to
``.smoke_work/`` beside this script and are removed at the end.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke_work")
SEED = 20261016
#: kernel vs plain version: the two differ only in summation order, over up
#: to 32768 terms per entry; at a bf16 tier both multiply the same bf16
#: operands exactly, and the tensor core's f32 accumulation (not rounded to
#: nearest at every add) is one more difference in the order of the sums
TOL = 1e-4
#: a bf16 tier against the exact kernel, relative to max|exact|: the budgets
#: of tests/test_solver.py:133-137
TIER_BUDGET = {"bf16x3": 1e-3, "bf16cast": 3e-2}
TIERS_ALL = ("exact", *TIER_BUDGET)
SOURCES = {
    "gram_matvec_sym": "plssvm_sparse_fp22_tpu_torch/csrc/gram_matvec.cu",
    "gram_matvec_rect": "plssvm_sparse_fp22_tpu_torch/csrc/gram_matvec.cu",
    "gram_pair_contrib": "plssvm_sparse_fp22_tpu_torch/csrc/pair_contrib.cu",
    "split_bf16": "plssvm_sparse_fp22_tpu_torch/csrc/split_bf16.cu",
}


def source_of(name: str) -> str:
    """The file that holds kernel x tier ``name``: its entry point's source,
    or the header of the wgmma tile for a bf16 tier."""
    kernel, _, tier = name.partition("/")
    if tier in TIER_BUDGET:
        return "plssvm_sparse_fp22_tpu_torch/csrc/gram_tile_wgmma.cuh"
    return SOURCES[kernel]


#: published peaks of one H100 SXM (NVIDIA's data sheet, dense rates): bf16
#: tensor cores, float32 outside the tensor cores, device memory
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12
#: the shapes the kernels' records are taken at (rbf, float32 inputs): K1's
#: rows and features, K2's and K3's rows of each side and features
RECORD_SHAPES = {"gram_matvec_sym": (32768, 32768, 256),
                 "gram_matvec_rect": (4096, 32768, 256),
                 "gram_pair_contrib": (4096, 4096, 4096),
                 "split_bf16": (4096, 0, 4096)}
_PALLAS = "plssvm_sparse_fp22_tpu/ops/pallas_matvec.py"
#: the TPU kernel (body, or its tier arm) each kernel x tier replaces; K3
#: (pair_gram_contrib) runs the body of K1 over two panels, so its bf16 tiers
#: replace the same arms as K1's
REPLACES = {
    "gram_matvec_sym/exact": f"{_PALLAS}:388",
    "gram_matvec_sym/bf16x3": f"{_PALLAS}:441",
    "gram_matvec_sym/bf16cast": f"{_PALLAS}:453",
    "gram_matvec_rect/exact": f"{_PALLAS}:117",
    "gram_matvec_rect/bf16x3": f"{_PALLAS}:157",
    "gram_matvec_rect/bf16cast": f"{_PALLAS}:165",
    "gram_pair_contrib/exact": f"{_PALLAS}:716",
    "gram_pair_contrib/bf16x3": f"{_PALLAS}:441",
    "gram_pair_contrib/bf16cast": f"{_PALLAS}:453",
    "split_bf16": f"{_PALLAS}:282",
}
#: the sparse main path: the JAX bench's sparse size (bench.py:640-643) and
#: its gamma = 256 / f (bench.py:191-199: at 1 / f the rbf matrix is nearly
#: rank one)
SPARSE_N, SPARSE_TEST, SPARSE_F, SPARSE_DENSITY = 16384, 4096, 4096, 0.01
SPARSE_GAMMA = 256.0 / SPARSE_F
#: the panel tier's K-cache budget: 4 panels of 4096 rows (bench.py:150-154
#: keeps the decomposition honest the same way)
PANEL_BUDGET = 512 * 1024**2
PANEL_ROWS = 4096
#: the three sparse tiers solve one system to eps 1e-6 in float32, each
#: stopping with its own residual after 7 iterations: on an H100 the dense
#: and implicit tiers' decision values sat 4.0e-3 and 4.2e-3 of the largest
#: one from the gram tier's, so the bound is 2e-2 and 99 % equal labels
TIER_TOL = 2e-2
TIER_LABELS = 0.99
#: accuracy on the planted linear rule; a CPU rehearsal reached 72 % at 4096
#: and 79 % at 8192 training rows (rbf and linear alike)
SPARSE_ACCURACY = 75.0


class SmokeError(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def two_blobs(n: int, f: int, rng: np.random.Generator):
    """Two gaussian blobs at +-0.5 per feature, labels +-1, shuffled."""
    half = n // 2
    X = np.concatenate([rng.normal(0.5, 1.0, (half, f)), rng.normal(-0.5, 1.0, (n - half, f))])
    y = np.concatenate([np.ones(half), -np.ones(n - half)])
    perm = rng.permutation(n)
    return X[perm], y[perm]


def write_libsvm(path: str, X: np.ndarray, y: np.ndarray) -> None:
    """Dense LIBSVM file, 0-based indices like the reference's fixtures;
    9 significant digits round-trip float32."""
    fmt = "%d " + " ".join(f"{j}:%.9g" for j in range(X.shape[1]))
    with open(path, "w") as fh:
        np.savetxt(fh, np.column_stack([y, X]), fmt=fmt)


def write_libsvm_sparse(path: str, csr, y: np.ndarray) -> None:
    """Sparse LIBSVM file (0-based indices, 9 significant digits)."""
    with open(path, "w") as fh:
        for i in range(csr.shape[0]):
            lo, hi = csr.indptr[i], csr.indptr[i + 1]
            pairs = " ".join(f"{j}:{v:.9g}" for j, v in zip(csr.indices[lo:hi], csr.data[lo:hi]))
            fh.write(f"{int(y[i])} {pairs}\n")


def planted_sparse(n: int, f: int, density: float, rng: np.random.Generator):
    """Uniform [0, 1) values at the given density (``bench.py:182-211``)
    with labels from a planted linear rule: the sign of ``x . w - median``
    for a random dense ``w``."""
    import scipy.sparse as sp

    csr = sp.random(n, f, density=density, format="csr", dtype=np.float32, random_state=rng)
    score = csr @ rng.normal(size=f)
    return csr, np.where(score > np.median(score), 1.0, -1.0)


@contextlib.contextmanager
def environ(**env):
    """Set environment variables for the block (the tier knobs)."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def recording_csvms(cli_module, timings: bool = False):
    """Keep the CSVMs a CLI module builds, to read their ``last_cg_info``;
    with ``timings`` each gets a ``Timings`` sink for its learn's spans."""
    made, build = [], cli_module.make_csvm

    def make(params):
        made.append(build(params))
        if timings:
            from plssvm_sparse_fp22_tpu_torch.utils.timing import Timings

            made[-1].timings = Timings()
        return made[-1]

    cli_module.make_csvm = make
    try:
        yield made
    finally:
        cli_module.make_csvm = build


def nonzero(counts: dict) -> dict:
    """The launch counters that are not 0."""
    return {k: v for k, v in counts.items() if v}


def timed_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, kernel_name: str) -> float | None:
    """Mean device time of the kernel whose name contains ``kernel_name``
    over ``reps`` calls of ``fn``, from ``torch.profiler``: for a kernel of
    a few tens of microseconds, CUDA events around the calls would time the
    host's launch path instead.  ``None`` where the profiler cannot trace
    the device (it saw none of the launches), or where it saw another count
    of launches than ``fn`` made twice in a row (on an H100 it once reported
    10 of 20), so that no time is given for a wrong count."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us, count = 0.0, 0
        for ev in prof.key_averages():
            if kernel_name in ev.key:
                us = getattr(ev, "self_device_time_total", None)
                total_us += getattr(ev, "self_cuda_time_total", 0) if us is None else us
                count += ev.count
        if count == 0 or total_us <= 0:
            return None
        if count == reps:
            return total_us / count / 1e3
    print(f"    the profiler saw {count} launches of {kernel_name} in {reps} calls, twice: its "
          "time is not taken", flush=True)
    return None


def bound_ms(name: str, Di: int, Dj: int, f: int) -> dict:
    """The least time the card could take for kernel x tier ``name`` on
    (Di, f) x (Dj, f) inputs: the larger of the Gram product's operations
    over the peak of their type (2 f per Gram entry, three products at
    bf16x3; K1 counts its lower-triangular 128 x 128 tiles only; float32
    FFMA at the exact tier, the bf16 tensor cores else) and the bytes it
    must move (each operand matrix, the row norms and v read once, the
    output written once) over the memory rate.  The transform's and the
    GEMVs' operations, a few per Gram entry against 2 f, are left out.  The
    split of a (Di, f) matrix moves 4 bytes in and 2 + 2 out per value (f a
    multiple of 64 here, so no pad) and does some ten operations on each."""
    if name == "split_bf16":
        return {"bound_ms": max(Di * f * 8 / PEAK_BYTES, Di * f * 10 / PEAK_F32) * 1e3,
                "bound_by": "bytes"}
    kernel, tier = name.split("/")
    nbi, nbj = -(-Di // 128), -(-Dj // 128)
    entries = (nbi * (nbi + 1) // 2 * 128 * 128 if kernel == "gram_matvec_sym" else Di * Dj)
    flops = 2.0 * f * entries * (3 if tier == "bf16x3" else 1)
    ops_s = flops / (PEAK_F32 if tier == "exact" else PEAK_BF16)
    rows = Di if kernel == "gram_matvec_sym" else Di + Dj
    per_value = {"exact": 4, "bf16x3": 4, "bf16cast": 2}[tier]  # hi + lo are 2 x 2 bytes
    outs = Di + Dj if kernel == "gram_pair_contrib" else Di
    bytes_s = (rows * f * per_value + (2 * rows + outs) * 4) / PEAK_BYTES
    return {"bound_ms": max(ops_s, bytes_s) * 1e3,
            "bound_by": "operations" if ops_s >= bytes_s else "bytes"}


def run_cli(main, argv, **kw) -> tuple[int, str]:
    """Run a CLI ``main`` in-process (``kw``: its ``timings`` sink), echo
    and return its stdout."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv, **kw)
    out = buf.getvalue()
    sys.stdout.write(out)
    return rc, out


def phase_device():
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0])
    print(f"[1 device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s), using {torch.cuda.get_device_name(0)}",
          flush=True)


def phase_build():
    from plssvm_sparse_fp22_tpu_torch.ops import _build

    info = _build.build()
    lib = _build.load()
    check(lib.gram_matvec_tile() > 0, "kernel library did not load")
    usage = [line.strip() for line in info["log"].splitlines()
             if "registers" in line or "spill" in line]
    print(f"[2 build] nvcc {info['seconds']:.1f} s (cached: {info['cached']}) -> "
          f"{os.path.relpath(info['path'], ROOT)}; " + " | ".join(usage), flush=True)
    if "C7510" in info["log"] or "C7520" in info["log"]:  # slower, not wrong: said, not failed on
        print("[2 build] note: ptxas serialised the wgmma instructions of a kernel (C7510: a "
              "function call between a tile's products; C7520: a wgmma under a branch); see "
              "--probe", flush=True)
    return info


def show_build_log(info: dict) -> None:
    """``--probe``: the compiler's lines per kernel (entry function, registers,
    spills, shared memory, any warning: a ``setmaxnreg ignored`` would show
    here, and so would ptxas's note C7510, "Potential Performance Loss: wgmma
    .mma_async instructions are serialized"), and the whole log into
    ``build.log`` beside the library."""
    with open(os.path.join(os.path.dirname(info["path"]), "build.log"), "w") as fh:
        fh.write(info["log"])
    for line in info["log"].splitlines():
        if any(word in line for word in ("entry function", "registers", "spill", "arning",
                                         "setmaxnreg", "Performance")):
            print("  " + line.strip()[:200], flush=True)


def compare(name, got, want, ms, plain_ms, label):
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    ok = err <= TOL * scale
    print(f"  {name} {label}: max|d|={err:.3e} (rel {err / scale:.2e}, tol {TOL:g}) "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms per call", flush=True)
    check(ok, f"{name} {label} disagrees with its plain version: {err} > {TOL} * {scale}")
    return err


def phase_k1(dev, rng):
    import torch

    from plssvm_sparse_fp22_tpu_torch.ops import gram_matvec as gm
    from plssvm_sparse_fp22_tpu_torch.types import KernelType

    print("[3 K1] gram_matvec_sym vs gram_matvec_sym_plain, float32", flush=True)
    record = {}
    for D, f in [(40, 5), (96, 33), (4096, 256), (32768, 256)]:
        X = torch.tensor(rng.normal(size=(D, f)), dtype=torch.float32, device=dev)
        v = torch.tensor(rng.normal(size=D), dtype=torch.float32, device=dev)
        for kernel in KernelType:
            kw = {"degree": 3, "gamma": 1.0 / f, "coef0": 1.0}
            mv = gm.make_sym_matvec(kernel, X, **kw)
            sq = gm.row_sqnorms(X)

            def plain():
                return gm.gram_matvec_sym_plain(kernel, X, v, sq=sq, **kw)

            got, want = mv(v), plain()
            torch.cuda.synchronize()
            big = D >= 4096
            ms = timed_ms(lambda: mv(v), 20 if big else 50)
            plain_ms = timed_ms(plain, 5 if big else 50)
            err = compare("K1", got, want, ms, plain_ms, f"{kernel.name} ({D}, {f})")
            if (D, f, kernel) == (32768, 256, KernelType.rbf):
                record = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return record


def phase_k2(dev, rng):
    import torch

    from plssvm_sparse_fp22_tpu_torch.ops import gram_matvec as gm
    from plssvm_sparse_fp22_tpu_torch.types import KernelType

    print("[4 K2] gram_matvec vs gram_matvec_plain, float32, X_sv (32768, 256)", flush=True)
    f = 256
    Y = torch.tensor(rng.normal(size=(32768, f)), dtype=torch.float32, device=dev)
    a = torch.tensor(rng.normal(size=32768), dtype=torch.float32, device=dev)
    sqy = gm.row_sqnorms(Y)
    record = {}
    for D in (1, 4096):
        P = torch.tensor(rng.normal(size=(D, f)), dtype=torch.float32, device=dev)
        for kernel in KernelType:
            kw = {"Y": Y, "degree": 3, "gamma": 1.0 / f, "coef0": 1.0, "sqy": sqy}

            def kern():
                return gm.gram_matvec(kernel, P, a, **kw)

            def plain():
                return gm.gram_matvec_plain(kernel, P, a, **kw)

            got, want = kern(), plain()
            torch.cuda.synchronize()
            ms = timed_ms(kern, 20)
            plain_ms = timed_ms(plain, 5)
            err = compare("K2", got, want, ms, plain_ms, f"{kernel.name} P ({D}, {f})")
            if (D, kernel) == (4096, KernelType.rbf):
                record = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return record


def phase_k3(dev, rng):
    import torch

    from plssvm_sparse_fp22_tpu_torch.ops import gram_matvec as gm
    from plssvm_sparse_fp22_tpu_torch.types import KernelType

    print("[5 K3] pair_gram_contrib vs pair_gram_contrib_plain, float32", flush=True)
    record = {}
    for Di, Dj, f, same in [(4096, 4096, 4096, False), (3000, 1700, 1001, False),
                            (4096, 4096, 4096, True)]:
        Xi = torch.tensor(rng.normal(size=(Di, f)), dtype=torch.float32, device=dev)
        Xj = Xi if same else torch.tensor(rng.normal(size=(Dj, f)), dtype=torch.float32,
                                          device=dev)
        vi = torch.tensor(rng.normal(size=Di), dtype=torch.float32, device=dev)
        vj = vi if same else torch.tensor(rng.normal(size=Dj), dtype=torch.float32, device=dev)
        sqi, sqj = gm.row_sqnorms(Xi), gm.row_sqnorms(Xj)
        for kernel in KernelType:
            kw = {"same": same, "sq_i": sqi, "sq_j": sqj, "degree": 3, "gamma": 1.0 / f,
                  "coef0": 1.0}

            def kern():
                return gm.pair_gram_contrib(kernel, Xi, Xj, vi, vj, **kw)

            def plain():
                return gm.pair_gram_contrib_plain(kernel, Xi, Xj, vi, vj, **kw)

            (oi, oj), (wi, wj) = kern(), plain()
            torch.cuda.synchronize()
            # both sides of a cross pair; with same=True their sum is the contract
            got = oi + oj if same else torch.cat([oi, oj])
            want = wi + wj if same else torch.cat([wi, wj])
            ms, plain_ms = timed_ms(kern, 10), timed_ms(plain, 10)
            label = f"{kernel.name} ({Di}, {Dj}, f {f}){' same' if same else ''}"
            err = compare("K3", got, want, ms, plain_ms, label)
            if (Di, same, kernel) == (4096, False, KernelType.rbf):
                record = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return record


def parts_text(timings, name: str) -> str:
    """``a 1.0, b 2.0`` ms of span ``name``'s parts in a ``Timings`` sink."""
    return ", ".join(f"{k} {v:.1f}" for k, v in timings.part_summary(name).items())


def learn_split(svm, log: str) -> str:
    """A CLI learn's wall split from its ``Timings`` sink (set-up and CG
    ms, each with its parts, the rest of the CLI's own learn time) and its
    device loop: steps issued and executed beside the iterations, host
    reads, chunk size, CUDA graphs."""
    spans, loop = svm.timings.summary(), svm.last_cg_loop
    rest = cg_ms(log) - spans["setup"] - spans["cg"]
    return (f"learn split: set-up {spans['setup']:.1f} ms ({parts_text(svm.timings, 'setup')}), "
            f"CG {spans['cg']:.1f} ms ({parts_text(svm.timings, 'cg')}), rest "
            f"{rest:.1f} ms of {cg_ms(log)} ms; {loop['steps']} steps issued, "
            f"{loop['executed']} executed for {svm.last_cg_info['iterations']} iterations, "
            f"{loop['host_reads']} host reads, "
            f"chunk {loop['chunk']}, CUDA graphs {loop['graph']}")


def cli_split(timings) -> str:
    """A CLI run's wall split from the ``Timings`` sink its ``main`` took:
    the ``cli`` span's parts in ms, and the span."""
    return f"CLI split: {parts_text(timings, 'cli')} of {timings.summary()['cli']:.1f} ms"


def file_digest(path: str) -> str:
    """The first 16 hex digits of a file's SHA-256: the model and prediction
    files of two runs compare by it."""
    import hashlib

    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()[:16]


def phase_main_path(rng):
    from plssvm_sparse_fp22_tpu_torch.cli import train as train_cli
    from plssvm_sparse_fp22_tpu_torch.cli.predict import main as predict_main
    from plssvm_sparse_fp22_tpu_torch.ops import gram_matvec as gm
    from plssvm_sparse_fp22_tpu_torch.utils.timing import Timings

    n_train, n_test, f = 32768, 4096, 256
    X, y = two_blobs(n_train + n_test, f, rng)
    train, test = os.path.join(WORK, "train.libsvm"), os.path.join(WORK, "test.libsvm")
    model, out = os.path.join(WORK, "train.model"), os.path.join(WORK, "test.predict")
    t0 = time.perf_counter()
    write_libsvm(train, X[:n_train], y[:n_train])
    write_libsvm(test, X[n_train:], y[n_train:])
    print(f"[6 main path] wrote {n_train} x {f} train and {n_test} x {f} test files in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    gm.reset_launches()
    t0 = time.perf_counter()
    with recording_csvms(train_cli) as made:
        rc, log = run_cli(train_cli.main, ["-t", "2", "-e", "1e-6", "--use_float", "-b", "cuda",
                                           "-p", "gpu_nvidia", train, model], timings=Timings())
    train_s = time.perf_counter() - t0
    after_train = dict(gm.launches)
    check(rc == 0, f"train CLI returned {rc}")
    check(made[-1].last_cg_loop["graph"], "the one-device learn replayed no CUDA graph")
    m = re.search(r"Finished after (\d+) iterations", log)
    check(m is not None, "train CLI printed no iteration count")
    iters = int(m.group(1))
    # only the implicit mode on the cuda backend launches K1
    k1 = after_train["gram_matvec_sym/exact"]
    check(k1 > 0, "training did not launch K1 (implicit mode)")
    check(k1 == iters + 1 + iters // 50,
          f"K1 launches {k1} != one per CG iteration plus the initial residual and the "
          f"refreshes ({iters} iterations)")
    info = made[-1].last_cg_info
    print(f"[6 main path] train CLI: rc 0, {iters} CG iterations in implicit mode, residual "
          f"{info['delta']!r} of delta0 {info['delta0']!r}, {train_s:.1f} s end to end, "
          f"launches {nonzero(after_train)}; {learn_split(made[-1], log)}; "
          f"{cli_split(made[-1].timings)}; model sha256 {file_digest(model)}", flush=True)

    t0 = time.perf_counter()
    timings = Timings()
    rc, log = run_cli(predict_main, ["--use_float", "-b", "cuda", "-p", "gpu_nvidia",
                                     test, model, out], timings=timings)
    predict_s = time.perf_counter() - t0
    launches = dict(gm.launches)
    check(rc == 0, f"predict CLI returned {rc}")
    check(launches["gram_matvec_rect/exact"] > after_train["gram_matvec_rect/exact"],
          "prediction did not launch K2")
    labels = np.loadtxt(out)
    check(labels.shape == (n_test,) and set(np.unique(labels)) <= {-1.0, 1.0},
          f"prediction file holds {labels.shape} values, not {n_test} labels of +-1")
    m = re.search(r"Accuracy = ([0-9.]+)%", log)
    check(m is not None, "predict CLI printed no accuracy")
    acc = float(m.group(1))
    check(acc >= 95.0, f"accuracy {acc}% < 95%")
    check(abs(np.mean(labels == y[n_train:]) * 100 - acc) < 1e-9,
          "accuracy line disagrees with the labels")
    print(f"[6 main path] predict CLI: rc 0, accuracy {acc}%, {predict_s:.1f} s end to end, "
          f"launches {nonzero(launches)}; {cli_split(timings)}; predictions sha256 "
          f"{file_digest(out)}", flush=True)
    return {"launches": launches, "train": train, "test": test}


def phase_reference(rng):
    """A small rbf learn on the cuda backend against a direct solve of the
    full LS-SVM system [[K + I/C, 1], [1^T, 0]] [alpha; b] = [y; 0]."""
    import scipy.sparse as sp

    from plssvm_sparse_fp22_tpu_torch import make_csvm
    from plssvm_sparse_fp22_tpu_torch.io.libsvm import ParsedData
    from plssvm_sparse_fp22_tpu_torch.params import Parameter
    from plssvm_sparse_fp22_tpu_torch.types import BackendType, KernelType

    n, f, gamma = 300, 16, 1.0 / 16
    X, y = two_blobs(n + 100, f, rng)
    P, X, y = X[n:], X[:n], y[:n]
    p = Parameter(kernel=KernelType.rbf, gamma=gamma, epsilon=1e-6, max_iter=500,
                  dtype=np.float32, backend=BackendType.cuda, print_info=False)
    p.data = ParsedData(csr=sp.csr_matrix(X), values=y, _dense=X)
    p.values = y
    svm = make_csvm(p)
    svm.learn()
    check(svm.last_cg_info["mode"] == "implicit", "small learn did not run implicit mode")
    got = svm.predict(P)

    def rbf(A, B):
        d = (A * A).sum(1)[:, None] + (B * B).sum(1)[None, :] - 2.0 * A @ B.T
        return np.exp(-gamma * np.maximum(d, 0.0))

    M = np.zeros((n + 1, n + 1))
    M[:n, :n] = rbf(X, X) + np.eye(n)
    M[:n, n] = M[n, :n] = 1.0
    sol = np.linalg.solve(M, np.concatenate([y, [0.0]]))
    want = rbf(P, X) @ sol[:n] + sol[n]
    err = float(np.abs(got - want).max() / np.abs(want).max())
    check(np.all(np.isfinite(got)) and got.shape == (100,), "small predict not finite")
    # float32 CG to eps 1e-6 against an exact float64 solve: 2e-4 to 5e-4 of
    # the scale in a CPU rehearsal of this phase (torch backend, 5 seeds)
    check(err <= 5e-3, f"small learn off the direct solve by {err:.2e} of scale")
    print(f"[6 reference] rbf 300 x 16 float32 cuda learn ({svm.last_cg_info['iterations']} "
          f"CG iterations): decision values within {err:.2e} of a direct float64 solve",
          flush=True)


def dense_system(dev, X, y, gamma, kernel=None, dtype=np.float32):
    """The reduced CG system (rbf unless ``kernel`` says otherwise) of a dense
    data set on the card, as ``CSVM._learn_dense`` builds it (C = 1):
    ``(X_pad, q, mask, QA_cost, cost_inv, b)``, padded to a multiple of 256
    rows, in ``dtype`` (float32 unless said)."""
    import torch

    from plssvm_sparse_fp22_tpu_torch.ops.kernel_functions import gram_block, kernel_scalar
    from plssvm_sparse_fp22_tpu_torch.types import KernelType

    kernel = KernelType.rbf if kernel is None else kernel
    tdt = torch.float64 if dtype == np.float64 else torch.float32

    n, f = X.shape
    dept = n - 1
    D = -(-dept // 256) * 256
    Xp = np.zeros((D, f), dtype)
    Xp[:dept] = X[:dept]
    Xd = torch.tensor(Xp, device=dev)
    xl = torch.tensor(X[-1], dtype=tdt, device=dev)
    mask = torch.zeros(D, dtype=tdt, device=dev)
    mask[:dept] = 1.0
    b = torch.zeros(D, dtype=tdt, device=dev)
    b[:dept] = torch.tensor(y[:dept] - y[-1], dtype=tdt, device=dev)
    cost_inv = torch.tensor(1.0, dtype=tdt, device=dev)
    q = gram_block(kernel, Xd, xl[None, :], gamma=gamma)[:, 0] * mask
    QA = kernel_scalar(kernel, xl, xl, gamma=gamma) + cost_inv
    return Xd, q, mask, QA, cost_inv, b


def pinned_cg_rate(op, b, mask, caps) -> float:
    """CG iterations per second of an operator at a pinned count: eps = 0,
    the slope of the synchronised solve time between two caps."""
    import torch

    from plssvm_sparse_fp22_tpu_torch.solver.cg import cg_solve

    secs = {}
    for imax in caps:
        cg_solve(op.matvec, b, mask, 0.0, 5)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cg_solve(op.matvec, b, mask, 0.0, imax)
        torch.cuda.synchronize()
        secs[imax] = time.perf_counter() - t0
        check(res.iterations == imax, f"pinned CG ran {res.iterations} != {imax}")
    return (caps[1] - caps[0]) / (secs[caps[1]] - secs[caps[0]])


def phase_timing(dev, rng):
    import torch

    from plssvm_sparse_fp22_tpu_torch import make_csvm
    from plssvm_sparse_fp22_tpu_torch.io.libsvm import ParsedData
    from plssvm_sparse_fp22_tpu_torch.ops.matvec import build_operator
    from plssvm_sparse_fp22_tpu_torch.params import Parameter
    from plssvm_sparse_fp22_tpu_torch.types import BackendType, KernelType

    import scipy.sparse as sp

    n, f = 4096, 256
    gamma = 1.0 / f
    X, y = two_blobs(n, f, rng)
    Xd, q, mask, QA, cost_inv, b = dense_system(dev, X, y, gamma)

    print(f"[7 timing] rbf {n} x {f} float32, implicit mode, CG at eps = 0", flush=True)
    rates = {}
    for backend in (BackendType.cuda, BackendType.torch, BackendType.torch, BackendType.cuda):
        op = build_operator(KernelType.rbf, Xd, q, mask, QA, cost_inv, gamma=gamma,
                            mode="implicit", backend=backend)
        rate = pinned_cg_rate(op, b, mask, (20, 120))
        rates.setdefault(backend.value, []).append(rate)
        print(f"  {backend.value:5s} ({'K1' if backend == BackendType.cuda else 'plain'}): "
              f"{rate:.1f} CG it/s (slope 20 -> 120 iterations)", flush=True)

    p = Parameter(kernel=KernelType.rbf, gamma=gamma, epsilon=1e-6, max_iter=1000,
                  dtype=np.float32, backend=BackendType.cuda, print_info=False)
    p.data = ParsedData(csr=sp.csr_matrix(X), values=y, _dense=X)
    p.values = y
    svm = make_csvm(p)
    svm.learn()  # warm-up (library load, allocator)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    svm.learn()
    torch.cuda.synchronize()
    learn_s = time.perf_counter() - t0
    info = svm.last_cg_info
    print(f"  learn() to eps 1e-6: {learn_s:.4f} s, {info['iterations']} CG iterations, "
          f"mode {info['mode']}, converged: {info['delta'] <= 1e-12 * info['delta0']}",
          flush=True)
    return rates


def densify_compare(vals, lcols, ntiles: int, Lt: int):
    """The JAX package's broadcast-compare densify (``sparse.py:324-337``),
    in torch, timed against the port's index-put form."""
    import torch

    m = vals.shape[0]
    V, C = vals.reshape(m, ntiles, Lt), lcols.reshape(m, ntiles, Lt)
    lane = torch.arange(128, dtype=C.dtype, device=C.device).reshape(1, 1, 128)
    out = torch.zeros((m, ntiles, 128), dtype=vals.dtype, device=vals.device)
    for slot in range(Lt):
        out = out + V[:, :, slot:slot + 1] * (C[:, :, slot:slot + 1] == lane)
    return out.reshape(m, ntiles * 128)


def sparse_learn(csr, y, kernel, *, eps, max_iter, gamma=SPARSE_GAMMA, dtype=np.float32):
    """A learn (float32 unless ``dtype`` says otherwise) on the cuda backend
    through the library API; returns the CSVM and its seconds
    (synchronised)."""
    import torch

    from plssvm_sparse_fp22_tpu_torch import make_csvm
    from plssvm_sparse_fp22_tpu_torch.io.libsvm import ParsedData
    from plssvm_sparse_fp22_tpu_torch.params import Parameter
    from plssvm_sparse_fp22_tpu_torch.types import BackendType

    p = Parameter(kernel=kernel, gamma=gamma, epsilon=eps, max_iter=max_iter,
                  dtype=dtype, backend=BackendType.cuda, print_info=False)
    p.data = ParsedData(csr=csr, values=y)
    p.values = y
    svm = make_csvm(p)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    svm.learn()
    torch.cuda.synchronize()
    return svm, time.perf_counter() - t0


@contextlib.contextmanager
def cg_spans():
    """Seconds of every CG solve the learns run (synchronised before and
    after), so a rate leaves out packing and Gram assembly."""
    import torch

    from plssvm_sparse_fp22_tpu_torch.models import base, sparse_learn as learns

    spans, solve = [], learns.cg_solve

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve(*args, **kw)
        torch.cuda.synchronize()
        spans.append(time.perf_counter() - t0)
        return res

    base.cg_solve = learns.cg_solve = timed
    try:
        yield spans
    finally:
        base.cg_solve = learns.cg_solve = solve


def pinned_rate(csr, y, kernel, caps, **kw) -> float:
    """CG iterations per second at a pinned count: eps = 0, the slope of the
    CG solve's seconds between two iteration caps, the faster of two learns
    at each cap."""
    secs = {}
    with cg_spans() as spans:
        for imax in caps:
            for _ in range(2):
                svm, _ = sparse_learn(csr, y, kernel, eps=0.0, max_iter=imax, **kw)
                check(svm.last_cg_info["iterations"] == imax,
                      f"pinned CG ran {svm.last_cg_info['iterations']} != {imax}")
                secs[imax] = min(spans[-1], secs.get(imax, spans[-1]))
    return (caps[1] - caps[0]) / (secs[caps[1]] - secs[caps[0]])


def phase_sparse_main(dev):
    """The sparse main path through the CLIs, one run per tier, each with
    the launch counters set to 0 just before and read just after."""
    import torch

    from plssvm_sparse_fp22_tpu_torch.cli import train as train_cli
    from plssvm_sparse_fp22_tpu_torch.cli.predict import main as predict_main
    from plssvm_sparse_fp22_tpu_torch.io.libsvm import parse_libsvm_file
    from plssvm_sparse_fp22_tpu_torch.ops import gram_matvec as gm
    from plssvm_sparse_fp22_tpu_torch.ops import sparse as ops_sparse

    n, f = SPARSE_N, SPARSE_F
    csr, y = main_sparse_set()
    train, test = os.path.join(WORK, "sparse.libsvm"), os.path.join(WORK, "sparse.test.libsvm")
    t0 = time.perf_counter()
    write_libsvm_sparse(train, csr[:n], y[:n])
    write_libsvm_sparse(test, csr[n:], y[n:])
    test_data = parse_libsvm_file(test)
    print(f"[8 sparse] wrote {n} x {f} train and {SPARSE_TEST} x {f} test files at "
          f"{SPARSE_DENSITY:.0%} density ({csr.nnz} nonzeros) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    tiers = [("auto", {}, "sparse_gram"),
             ("dense", {"PLSSVM_SPARSE_MODE": "dense"}, "sparse_dense_implicit"),
             ("implicit", {"PLSSVM_SPARSE_MODE": "implicit",
                           "PLSSVM_K_CACHE_BYTES": str(PANEL_BUDGET)}, "sparse_implicit")]
    decisions, launches = {}, {}
    for name, env, mode in tiers:
        model, out = os.path.join(WORK, f"sparse.{name}.model"), os.path.join(WORK, "s.predict")
        with environ(**env), recording_csvms(train_cli) as made:
            gm.reset_launches()
            t0 = time.perf_counter()
            rc, _ = run_cli(train_cli.main, ["-t", "2", "-g", repr(SPARSE_GAMMA), "-e", "1e-6",
                                             "--use_float", "-b", "cuda", "-p", "gpu_nvidia",
                                             train, model])
            train_s = time.perf_counter() - t0
            counts = dict(gm.launches)
        check(rc == 0, f"sparse train CLI ({name} tier) returned {rc}")
        svm = made[-1]
        info = svm.last_cg_info
        iters = info["iterations"]
        check(info["mode"] == mode, f"{name} tier ran mode {info['mode']}, not {mode}")
        # A·v products: the initial residual, one per iteration, the refreshes
        mvs = iters + 1 + iters // 50
        want = {"auto": {"gram_matvec_sym/exact": 0, "gram_pair_contrib/exact": 0},
                "dense": {"gram_matvec_sym/exact": mvs, "gram_pair_contrib/exact": 0},
                # 4 panels: 4 diagonal pairs on K1, 6 cross pairs on K3
                "implicit": {"gram_matvec_sym/exact": 4 * mvs,
                             "gram_pair_contrib/exact": 6 * mvs}}[name]
        check(all(counts[k] == v for k, v in want.items()),
              f"{name} tier launches {counts}, expected {want}")
        decisions[name] = svm.predict_parsed(test_data)
        check(np.all(np.isfinite(decisions[name])) and decisions[name].shape == (SPARSE_TEST,),
              f"{name} tier decision values are not {SPARSE_TEST} finite numbers")
        rc, log = run_cli(predict_main, ["--use_float", "-b", "cuda", "-p", "gpu_nvidia",
                                         test, model, out])
        check(rc == 0, f"sparse predict CLI ({name} tier) returned {rc}")
        m = re.search(r"Accuracy = ([0-9.]+)%", log)
        check(m is not None and float(m.group(1)) >= SPARSE_ACCURACY,
              f"{name} tier accuracy {m and m.group(1)}% < {SPARSE_ACCURACY}%")
        labels = np.loadtxt(out)
        agree = np.mean(labels == np.where(decisions[name] > 0, 1.0, -1.0))
        check(agree >= 0.999, f"predict CLI labels agree with the decision values on {agree:.4f}")
        launches[name] = counts
        print(f"[8 sparse] {name} tier: mode {mode}, {iters} CG iterations, train CLI "
              f"{train_s:.1f} s, accuracy {m.group(1)}%, launches {nonzero(counts)}", flush=True)
        del made, svm
    scale = float(np.abs(decisions["auto"]).max())
    for name in ("dense", "implicit"):
        err = float(np.abs(decisions[name] - decisions["auto"]).max()) / scale
        same = float(np.mean((decisions[name] > 0) == (decisions["auto"] > 0)))
        print(f"[8 sparse] {name} vs auto (gram) decision values: max|d| {err:.2e} of the "
              f"scale (tol {TIER_TOL:g}), equal labels {same:.4f}", flush=True)
        check(err <= TIER_TOL and same >= TIER_LABELS,
              f"{name} tier disagrees with the gram tier: {err:.2e}, labels {same:.4f}")

    # one panel of the implicit tier's packing, densified both ways
    dept = n - 1
    D = -(-dept // 256) * 256
    th = ops_sparse.TiledHybrid.from_csr(csr[:dept], dtype=np.float32, pad_rows=D, device=dev)
    vals, lcols = th.tell.vals[:4096], th.tell.lcols[:4096]
    args = (vals, lcols, th.tell.ntiles, th.tell.Lt)
    got, want = ops_sparse.densify_tiled(*args), densify_compare(*args)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "index-put densify differs from the broadcast compare")
    put_ms, cmp_ms = timed_ms(lambda: ops_sparse.densify_tiled(*args), 20), \
        timed_ms(lambda: densify_compare(*args), 20)
    print(f"[8 sparse] densify one 4096-row panel (ntiles {th.tell.ntiles}, Lt {th.tell.Lt}, "
          f"{len(th.heavy_idx)} heavy rows): index-put {put_ms:.3f} ms, broadcast compare "
          f"{cmp_ms:.3f} ms", flush=True)
    return {"csr": csr[:n], "y": y[:n], "launches": launches, "train": train, "test": test}


def phase_sparse_more(sparse):
    """The sparse-linear CLI, CG it/s of every sparse tier, repeatability,
    and the gather arm."""
    from plssvm_sparse_fp22_tpu_torch.cli import train as train_cli
    from plssvm_sparse_fp22_tpu_torch.cli.predict import main as predict_main
    from plssvm_sparse_fp22_tpu_torch.ops import gram_matvec as gm
    from plssvm_sparse_fp22_tpu_torch.types import KernelType

    csr, y = sparse["csr"], sparse["y"]
    model, out = os.path.join(WORK, "sparse.linear.model"), os.path.join(WORK, "s.predict")
    with recording_csvms(train_cli) as made:
        t0 = time.perf_counter()
        rc, _ = run_cli(train_cli.main, ["-t", "0", "-e", "1e-6", "--use_float", "-b", "cuda",
                                         "-p", "gpu_nvidia", sparse["train"], model])
        train_s = time.perf_counter() - t0
    check(rc == 0, f"sparse-linear train CLI returned {rc}")
    info = made[-1].last_cg_info
    check(info["mode"] == "sparse_linear", f"linear run took mode {info['mode']}")
    rc, log = run_cli(predict_main, ["--use_float", "-b", "cuda", "-p", "gpu_nvidia",
                                     sparse["test"], model, out])
    m = re.search(r"Accuracy = ([0-9.]+)%", log)
    check(rc == 0 and m is not None and float(m.group(1)) >= SPARSE_ACCURACY,
          f"sparse-linear predict CLI rc {rc}, accuracy {m and m.group(1)}%")
    print(f"[9 sparse] linear CLI: mode sparse_linear, {info['iterations']} CG iterations, "
          f"train CLI {train_s:.1f} s, accuracy {m.group(1)}%", flush=True)

    # the cheap tiers' iterations (a GEMV, two sparse products) get a longer
    # span, so the slope rises above the host's timing noise
    for name, kernel, env, caps in [
            ("gram", KernelType.rbf, {"PLSSVM_SPARSE_MODE": "gram"}, (10, 210)),
            ("dense", KernelType.rbf, {"PLSSVM_SPARSE_MODE": "dense"}, (4, 16)),
            ("implicit", KernelType.rbf, {"PLSSVM_SPARSE_MODE": "implicit",
                                          "PLSSVM_K_CACHE_BYTES": str(PANEL_BUDGET)}, (4, 16)),
            ("linear", KernelType.linear, {}, (10, 210))]:
        with environ(**env):
            rate = pinned_rate(csr, y, kernel, caps)
        print(f"[9 sparse] {name} tier, {SPARSE_N} x {SPARSE_F}: {rate:.1f} CG it/s "
              f"(eps = 0, slope {caps[0]} -> {caps[1]} iterations)", flush=True)

    for name, kernel, env in [("linear", KernelType.linear, {}),
                              ("implicit", KernelType.rbf,
                               {"PLSSVM_SPARSE_MODE": "implicit",
                                "PLSSVM_K_CACHE_BYTES": str(PANEL_BUDGET)})]:
        with environ(**env):
            a, _ = sparse_learn(csr, y, kernel, eps=1e-6, max_iter=500)
            b, _ = sparse_learn(csr, y, kernel, eps=1e-6, max_iter=500)
        same = (a.last_cg_info["iterations"] == b.last_cg_info["iterations"]
                and np.array_equal(a.alphas, b.alphas) and a.bias_ == b.bias_)
        check(same, f"two {name} sparse learns differ")
        print(f"[9 sparse] {name} tier repeats bitwise: {a.last_cg_info['iterations']} CG "
              f"iterations twice, equal alphas and bias", flush=True)

    rng = np.random.default_rng(SEED + 2)
    gcsr, gy = planted_sparse(8192, 262144, 1e-4, rng)
    with environ(PLSSVM_SPARSE_MODE="implicit"):
        gm.reset_launches()
        svm, learn_s = sparse_learn(gcsr, gy, KernelType.rbf, eps=1e-6, max_iter=20,
                                    gamma=1.0 / 32)
        counts = dict(gm.launches)
        rate = pinned_rate(gcsr, gy, KernelType.rbf, (2, 6), gamma=1.0 / 32)
    info = svm.last_cg_info
    check(info["mode"] == "sparse_implicit" and not any(counts.values()),
          f"gather arm: mode {info['mode']}, launches {counts} (the gather arm is plain torch)")
    check(np.all(np.isfinite(svm.alphas)), "gather-arm alphas are not finite")
    print(f"[9 sparse] gather arm, rbf 8192 x 262144 at 0.01 % ({gcsr.nnz} nonzeros): "
          f"{info['iterations']} CG iterations in {learn_s:.2f} s, {rate:.1f} CG it/s "
          f"(eps = 0, slope 2 -> 6)", flush=True)


def profiled_cg(csr, y, kernel, imax: int, **kw):
    """One learn at eps = 0 and ``imax`` iterations (after a warm-up learn)
    with its CG solve under ``torch.profiler``: the solve's wall seconds and
    the device time of each kernel it ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from plssvm_sparse_fp22_tpu_torch.models import base, sparse_learn as learns

    sparse_learn(csr, y, kernel, eps=0.0, max_iter=imax, **kw)  # warm-up
    solve, traced = learns.cg_solve, {}

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = solve(*args, **kwargs)
            torch.cuda.synchronize()
            traced["wall"] = time.perf_counter() - t0
        traced["prof"] = prof
        return res

    base.cg_solve = learns.cg_solve = timed
    try:
        svm, _ = sparse_learn(csr, y, kernel, eps=0.0, max_iter=imax, **kw)
    finally:
        base.cg_solve = learns.cg_solve = solve
    check(svm.last_cg_info["iterations"] == imax, "profiled CG did not run its pinned count")
    # device microseconds per kernel name; older torch names the field cuda
    per_kernel = {}
    for ev in traced["prof"].key_averages():
        us = getattr(ev, "self_device_time_total", None)
        us = getattr(ev, "self_cuda_time_total", 0) if us is None else us
        if us > 0:
            per_kernel[ev.key] = (us / 1e3, ev.count)
    return traced["wall"], per_kernel


def phase_profile(sparse):
    """Opt-in (``--profile``): where each sparse tier's CG time goes, as
    device time per kernel and the device's idle share of the CG wall time
    (1 - summed kernel time / wall); the profiler's own overhead is inside
    the wall time."""
    from plssvm_sparse_fp22_tpu_torch.types import KernelType

    panel = {"PLSSVM_SPARSE_MODE": "implicit", "PLSSVM_K_CACHE_BYTES": str(PANEL_BUDGET)}
    rng = np.random.default_rng(SEED + 2)
    gcsr, gy = planted_sparse(8192, 262144, 1e-4, rng)
    cases = [("gram", sparse["csr"], sparse["y"], KernelType.rbf, {"PLSSVM_SPARSE_MODE": "gram"},
              12, {}),
             ("dense", sparse["csr"], sparse["y"], KernelType.rbf, {"PLSSVM_SPARSE_MODE": "dense"},
              12, {}),
             ("implicit", sparse["csr"], sparse["y"], KernelType.rbf, panel, 12, {}),
             ("linear", sparse["csr"], sparse["y"], KernelType.linear, {}, 12, {}),
             ("gather", gcsr, gy, KernelType.rbf, {"PLSSVM_SPARSE_MODE": "implicit"}, 4,
              {"gamma": 1.0 / 32})]
    for name, csr, y, kernel, env, imax, kw in cases:
        with environ(**env):
            wall, per_kernel = profiled_cg(csr, y, kernel, imax, **kw)
        busy = sum(ms for ms, _ in per_kernel.values())
        check(busy > 0, f"profile of the {name} tier saw no device time")
        print(f"[10 profile] {name}: {imax} CG iterations (+1 initial A·v), CG wall "
              f"{wall * 1e3:.1f} ms, device busy {busy:.1f} ms, idle share "
              f"{1 - busy / (wall * 1e3):.3f}", flush=True)
        for key, (ms, count) in sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:6]:
            print(f"  {ms:10.3f} ms x {count:4d}  {key[:60]}", flush=True)


def compare_tier(name, tier, got, want, exact, ms, plain_ms, label):
    """A bf16-tier kernel against its plain version at the tier (``TOL``)
    and against the exact kernel (``TIER_BUDGET``); returns max|got - want|."""
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    off = float((got - exact).abs().max()) / float(exact.abs().max())
    print(f"  {name} {tier} {label}: max|d| vs plain {err:.3e} (rel {err / scale:.2e}, tol "
          f"{TOL:g}), vs exact rel {off:.2e} (budget {TIER_BUDGET[tier]:g}); kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms per call", flush=True)
    check(err <= TOL * scale, f"{name} {tier} {label} disagrees with its plain version: "
          f"{err} > {TOL} * {scale}")
    check(off <= TIER_BUDGET[tier], f"{name} {tier} {label} is {off:.2e} off the exact kernel")
    return err


def repeats_bitwise(name: str, fn, got) -> None:
    """A second run of a kernel on the same inputs gives the same bits."""
    import torch

    again = fn()
    again = again if torch.is_tensor(again) else torch.cat(again)
    check(torch.equal(again, got), f"{name}: two runs on the same inputs differ")


def special_floats(rng, rows: int, f: int) -> np.ndarray:
    """Seeded float32 data for the split: a third normal draws, the rest
    random bit patterns (every exponent: subnormals, infinities and NaNs of
    both signs among them), and at the front of the first row the cases
    written out: zeros, subnormals, the smallest normal and its neighbour
    (a remainder of one subnormal ulp), remainders that are subnormal at
    small exponents, rounding ties of the remainder, infinities, and NaNs
    with the payload in the upper or the lower 16 bits."""
    bits = rng.integers(0, 2**32, size=(rows, f), dtype=np.uint64).astype(np.uint32)
    normal = rng.normal(size=(rows, f)).astype(np.float32).view(np.uint32)
    bits = np.where(rng.random((rows, f)) < 1 / 3, normal, bits)
    cases = [0x00000000, 0x80000000, 0x00000001, 0x80000001, 0x007FFFFF, 0x807FFFFF,
             0x00800000, 0x00800001, 0x80810001, 0x01000001, 0x0100FFFF, 0x81008000,
             0x3F808000, 0x3F818000, 0x3F800180, 0xBF800080, 0x3F80FFFF, 0x7F7FFFFF,
             0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF80FFFF]
    flat = bits.reshape(-1)
    flat[:min(len(cases), flat.size)] = cases[:flat.size]
    return bits.view(np.float32)


def same_bits(a, b) -> bool:
    """Two bf16 tensors hold the same bits; a NaN matches any NaN at its
    place (a cast makes every NaN the canonical one of its library)."""
    import torch

    nan = a.isnan()
    return a.shape == b.shape and torch.equal(nan, b.isnan()) and torch.equal(
        a.view(torch.int16).masked_fill(nan, 0), b.view(torch.int16).masked_fill(nan, 0))


def phase_split(dev, rng, probe: bool = False):
    """The split kernel against ``split_bf16_plain`` (and the padding copy
    the eager path made), bit for bit, and its time at the main paths' two
    shapes: a 4096 x 4096 panel of the sparse panel tier (the record) and
    the 32768 x 256 matrix of the dense learn and the predict."""
    import torch

    from plssvm_sparse_fp22_tpu_torch.ops import gram_matvec as gm

    def plain(X, pad):
        parts = gm.split_bf16_plain(X)
        return tuple(gm._pad_features(t) for t in parts) if pad else parts

    print("[11 K4] split_bf16 (one pass, padded outputs) vs split_bf16_plain, bit for bit",
          flush=True)
    for shape, pad in [((257, 1001), True), ((64, 4), True), ((3, 1), True), ((33, 12), True),
                       ((130, 63), False), ((1000003,), False), ((129, 256), True)]:
        rows, f = (1, shape[0]) if len(shape) == 1 else shape
        X = torch.tensor(special_floats(rng, rows, f).reshape(shape), device=dev)
        got, want = gm.split_bf16(X, pad=pad), plain(X, pad)
        torch.cuda.synchronize()
        ok = all(same_bits(g, w) for g, w in zip(got, want))
        fp = got[0].shape[-1]
        nan_bits = all(torch.equal(g.view(torch.int16), w.view(torch.int16))
                       for g, w in zip(got, want))
        print(f"  {shape} -> feature axis {fp} ({'padded' if pad else 'as is'}): "
              f"{'equal bits' if ok else 'DIFFERENT'} ({int(X.isnan().sum())} NaN, "
              f"{int(X.isinf().sum())} inf, {int(((X != 0) & (X.abs() < 1.2e-38)).sum())} "
              f"subnormal inputs; NaN payloads equal too: {nan_bits})", flush=True)
        check(ok, f"split_bf16 {shape} differs from its plain version")
        check(all(g.is_contiguous() and not g[..., f:].any() for g in got),
              f"split_bf16 {shape}: pad columns are not zero")
        check(not pad or gm._pad_features(got[0]) is got[0],
              "the split kernel's output would be padded again")
    record = {}
    for rows, f in [(4096, 4096), (32768, 256)]:
        X = torch.tensor(rng.normal(size=(rows, f)), dtype=torch.float32, device=dev)
        got, want = gm.split_bf16(X, pad=True), plain(X, True)
        torch.cuda.synchronize()
        check(all(same_bits(g, w) for g, w in zip(got, want)),
              f"split_bf16 ({rows}, {f}) differs from its plain version")
        err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
        n = 2 if probe else 50
        traced = device_ms(lambda: gm.split_bf16(X, pad=True), n, "split_bf16_kernel")
        call_ms = timed_ms(lambda: gm.split_bf16(X, pad=True), n)
        ms = call_ms if traced is None else traced
        plain_ms = timed_ms(lambda: plain(X, True), 1 if probe else 10)
        cast_ms = timed_ms(lambda: gm.tier_operands("bf16cast", X), n)
        bound = bound_ms("split_bf16", rows, 0, f)["bound_ms"]
        how = ("the profiler saw no device time: CUDA events" if traced is None
               else "on the device, by the profiler")
        print(f"  ({rows}, {f}): kernel {ms:.4f} ms ({how}; {call_ms:.4f} ms per call by CUDA "
              f"events, the host's launch path included), plain (nine eager passes) "
              f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({rows * f * 8 / ms / 1e9:.2f} TB/s of "
              f"3.35); the bf16cast operand (one Tensor.to) {cast_ms:.4f} ms", flush=True)
        if rows == 4096:
            record = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "ms_per_call": call_ms}
        else:
            record["ms_32768x256"], record["plain_ms_32768x256"] = ms, plain_ms
    return record


def phase_k4(dev, rng, probe: bool = False):
    """The bf16x3 and bf16cast tiers of K1, K2 and K3 at the main path's
    shapes, three kernels, against their plain versions at the tier and the
    exact kernel.  K1 splits once, as ``make_sym_matvec`` does for a CG
    loop; K2 is timed on prepared operands (the kernel) and, at the
    predict's shape, with the split or cast of points and support vectors
    inside, as the predict pays for it; K3 takes each panel's operands from
    the caller, as the panel schedules hand them over, and the preparation
    is timed per panel beside it.  ``probe``: one launch per check."""
    import torch

    from plssvm_sparse_fp22_tpu_torch.ops import gram_matvec as gm
    from plssvm_sparse_fp22_tpu_torch.types import KernelType

    def reps(n: int) -> int:
        return 1 if probe else n

    print(f"[11 K4] bf16x3 / bf16cast tiers vs their plain versions (tol {TOL:g}) and the exact "
          f"kernel (budgets {TIER_BUDGET}), float32 inputs, on the TMA-fed wgmma tile (K2 in its "
          f"row-only mode), each run twice and compared bitwise", flush=True)
    f = 256
    X = torch.tensor(rng.normal(size=(32768, f)), dtype=torch.float32, device=dev)
    v = torch.tensor(rng.normal(size=32768), dtype=torch.float32, device=dev)
    Y = torch.tensor(rng.normal(size=(32768, f)), dtype=torch.float32, device=dev)
    a = torch.tensor(rng.normal(size=32768), dtype=torch.float32, device=dev)
    P = torch.tensor(rng.normal(size=(4096, f)), dtype=torch.float32, device=dev)
    Pr = torch.tensor(rng.normal(size=(3000, 1001)), dtype=torch.float32, device=dev)
    Yr = torch.tensor(rng.normal(size=(1700, 1001)), dtype=torch.float32, device=dev)
    sqx = gm.row_sqnorms(X)
    # K2's cases: the predict's batch, one point, a ragged pair
    cases2 = [("P (4096, 256) vs 32768 SVs", P, Y, a), ("P (1, 256) vs 32768 SVs", P[:1], Y, a),
              ("P (3000, 1001) vs 1700 SVs", Pr, Yr, a[:1700].contiguous())]
    records = {}
    for kernel in KernelType:
        kw = {"degree": 3, "gamma": 1.0 / f, "coef0": 1.0}
        exact1 = gm.make_sym_matvec(kernel, X, tier="exact", **kw)(v)
        for tier in TIER_BUDGET:
            mv = gm.make_sym_matvec(kernel, X, tier=tier, **kw)
            ops = gm.tier_operands(tier, X)

            def plain1():
                return gm.gram_matvec_sym_plain(kernel, X, v, sq=sqx, tier=tier, operands=ops,
                                                **kw)

            got, want = mv(v), plain1()
            torch.cuda.synchronize()
            repeats_bitwise(f"K1 {tier} {kernel.name}", lambda: mv(v), got)
            ms, plain_ms = timed_ms(lambda: mv(v), reps(20)), timed_ms(plain1, reps(3))
            err = compare_tier("K1", tier, got, want, exact1, ms, plain_ms,
                               f"{kernel.name} (32768, {f})")
            if kernel == KernelType.rbf:
                records[f"gram_matvec_sym/{tier}"] = {"max_abs_err": err, "ms": ms,
                                                      "plain_ms": plain_ms}
        for label, Pc, Yc, ac in cases2:
            kw2 = {"Y": Yc, "sqx": gm.row_sqnorms(Pc), "sqy": gm.row_sqnorms(Yc), "degree": 3,
                   "gamma": 1.0 / Pc.shape[1], "coef0": 1.0}
            exact2 = gm.gram_matvec(kernel, Pc, ac, tier="exact", **kw2)
            for tier in TIER_BUDGET:
                ops2 = (gm.tier_operands(tier, Pc), gm.tier_operands(tier, Yc))

                def kern2():
                    return gm.gram_matvec(kernel, Pc, ac, tier=tier, operands=ops2, **kw2)

                def plain2():
                    return gm.gram_matvec_plain(kernel, Pc, ac, tier=tier, operands=ops2, **kw2)

                def predict2():  # the split or cast of both sides inside, as the predict
                    return gm.gram_matvec(kernel, Pc, ac, tier=tier, **kw2)

                got, want = kern2(), plain2()
                torch.cuda.synchronize()
                repeats_bitwise(f"K2 {tier} {kernel.name} {label}", kern2, got)
                repeats_bitwise(f"K2 {tier} {kernel.name} {label}, operands prepared inside",
                                predict2, got)
                ms, plain_ms = timed_ms(kern2, reps(20)), timed_ms(plain2, reps(5))
                err = compare_tier("K2", tier, got, want, exact2, ms, plain_ms,
                                   f"{kernel.name} {label}")
                if Pc is P:
                    with_prep = timed_ms(predict2, reps(20))
                    parts = [device_ms(kern2, reps(20), name)
                             for name in ("gram_wgmma", "reduce_slab")]
                    tile_ms, sum_ms = ("not measured" if t is None else f"{t:.3f} ms"
                                       for t in parts)
                    print(f"    on the device (profiler): tile walk {tile_ms}, slab "
                          f"reduction {sum_ms}; with the "
                          f"{'split' if tier == 'bf16x3' else 'cast'} of both sides inside, as "
                          f"the predict: {with_prep:.3f} ms per call", flush=True)
                    if kernel == KernelType.rbf:
                        records[f"gram_matvec_rect/{tier}"] = {
                            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                            "ms_with_preparation": with_prep}
    del X, Y, P, Pr, Yr, cases2, exact1, exact2, ops, ops2
    # K3's panel pairs: the main path's, the ragged one, one pair of 512-row
    # panels (16 tile pairs on 132 SMs), and the diagonal panel on K1
    for Di, Dj, f, same in [(4096, 4096, 4096, False), (3000, 1700, 1001, False),
                            (512, 512, 4096, False), (4096, 4096, 4096, True)]:
        Xi = torch.tensor(rng.normal(size=(Di, f)), dtype=torch.float32, device=dev)
        Xj = Xi if same else torch.tensor(rng.normal(size=(Dj, f)), dtype=torch.float32,
                                          device=dev)
        vi = torch.tensor(rng.normal(size=Di), dtype=torch.float32, device=dev)
        vj = vi if same else torch.tensor(rng.normal(size=Dj), dtype=torch.float32, device=dev)
        sqi, sqj = gm.row_sqnorms(Xi), gm.row_sqnorms(Xj)
        which = "K1" if same else "K3"
        shape = f"({Di}, {Dj}, f {f}){' same: the diagonal panel' if same else ''}"
        for tier in TIER_BUDGET:
            Xio = gm.tier_operands(tier, Xi)
            Xjo = Xio if same else gm.tier_operands(tier, Xj)
            torch.cuda.synchronize()
            prep = timed_ms(lambda: gm.tier_operands(tier, Xi), reps(5))
            print(f"  {tier} operands of one ({Di}, {f}) panel (split or cast, features padded "
                  f"to {Xio[0].shape[1]}): {prep:.3f} ms per panel", flush=True)
            for kernel in KernelType:
                kw = {"same": same, "sq_i": sqi, "sq_j": sqj, "degree": 3, "gamma": 1.0 / f,
                      "coef0": 1.0}

                def kern3():
                    return gm.pair_gram_contrib(kernel, Xi, Xj, vi, vj, tier=tier,
                                                operands=(Xio, Xjo), **kw)

                def plain3():
                    return gm.pair_gram_contrib_plain(kernel, Xi, Xj, vi, vj, tier=tier,
                                                      operands=(Xio, Xjo), **kw)

                # both sides of a cross pair; with same=True their sum is the contract
                join = sum if same else torch.cat
                exact3 = join(gm.pair_gram_contrib(kernel, Xi, Xj, vi, vj, tier="exact", **kw))
                got, want = join(kern3()), join(plain3())
                torch.cuda.synchronize()
                repeats_bitwise(f"{which} {tier} {kernel.name} {shape}",
                                lambda: join(kern3()), got)
                ms, plain_ms = timed_ms(kern3, reps(10)), timed_ms(plain3, reps(5))
                err = compare_tier(which, tier, got, want, exact3, ms, plain_ms,
                                   f"{kernel.name} {shape}")
                if (Di, same, kernel) == (4096, False, KernelType.rbf):
                    records[f"gram_pair_contrib/{tier}"] = {"max_abs_err": err, "ms": ms,
                                                            "plain_ms": plain_ms}
    return records


def check_adaptive(tag: str, info: dict, counts: dict, per_mv: dict, eps: float,
                   splits_per_mv: int = 0) -> None:
    """An adaptive learn's contract: the final residual is the accurate
    tier's and meets eps^2 delta0, and each tier launched its kernels once
    per A·v of its leg (``per_mv`` launches of each kernel per A·v): the
    fast leg's initial residual, iterations and refreshes on bf16cast; the
    verify step, the escalated iterations and their refreshes on bf16x3.
    The split kernel runs once when the accurate operator is built from a
    resident matrix (``splits_per_mv`` 0), or ``splits_per_mv`` times per
    accurate A·v where the panels are densified anew for each."""
    iters, kf = info["iterations"], info["fast_iterations"]
    check(info["delta"] <= eps ** 2 * info["delta0"],
          f"{tag}: residual {info['delta']} above eps^2 delta0 = {eps ** 2 * info['delta0']}")
    fast_mvs = kf + 1 + kf // 50
    acc_mvs = 1 + (iters - kf) + (iters // 50 - kf // 50)
    for kernel, n in per_mv.items():
        got = (counts[f"{kernel}/bf16cast"], counts[f"{kernel}/bf16x3"])
        check(got == (n * fast_mvs, n * acc_mvs),
              f"{tag}: {kernel} launched {got} times on (bf16cast, bf16x3), expected "
              f"{(n * fast_mvs, n * acc_mvs)} ({kf} fast of {iters} iterations)")
    check(not any(v for k, v in counts.items() if k.endswith("/exact")),
          f"{tag}: an exact kernel launched in an adaptive learn: {nonzero(counts)}")
    splits = splits_per_mv * acc_mvs if splits_per_mv else 1
    check(counts["split_bf16"] == splits,
          f"{tag}: the split kernel launched {counts['split_bf16']} times, expected {splits}")


def cg_ms(log: str) -> int:
    """The train CLI's own learn time ("... using CG in <ms>ms")."""
    m = re.search(r"using CG in (\d+)ms", log)
    check(m is not None, "train CLI printed no learn time")
    return int(m.group(1))


def phase_adaptive_dense(main):
    """The dense main path with the default plan: train on phase 6's file,
    then predict with each bf16 tier pinned (K2 at that tier)."""
    from plssvm_sparse_fp22_tpu_torch.cli import train as train_cli
    from plssvm_sparse_fp22_tpu_torch.cli.predict import main as predict_main
    from plssvm_sparse_fp22_tpu_torch.ops import gram_matvec as gm
    from plssvm_sparse_fp22_tpu_torch.utils.timing import Timings

    model, out = os.path.join(WORK, "adaptive.model"), os.path.join(WORK, "adaptive.predict")
    with environ(PLSSVM_MATMUL_PRECISION=""), recording_csvms(train_cli) as made:
        gm.reset_launches()
        t0 = time.perf_counter()
        rc, log = run_cli(train_cli.main, ["-t", "2", "-e", "1e-6", "--use_float", "-b", "cuda",
                                           "-p", "gpu_nvidia", main["train"], model],
                          timings=Timings())
        train_s = time.perf_counter() - t0
        counts = dict(gm.launches)
    check(rc == 0, f"adaptive train CLI returned {rc}")
    info = made[-1].last_cg_info
    check(info["mode"] == "implicit", f"adaptive learn ran mode {info['mode']}")
    check_adaptive("adaptive dense learn", info, counts, {"gram_matvec_sym": 1}, 1e-6)
    print(f"[12 adaptive] dense rbf 32768 x 256 train CLI (default plan): {info['iterations']} "
          f"CG iterations, fast_iterations {info['fast_iterations']}, escalated "
          f"{info['escalated']}, learn {cg_ms(log)} ms, CLI {train_s:.1f} s, residual "
          f"{info['delta']!r} <= eps^2 delta0 {1e-12 * info['delta0']:.3e}, launches "
          f"{nonzero(counts)}; {learn_split(made[-1], log)}; {cli_split(made[-1].timings)}; "
          f"model sha256 {file_digest(model)}", flush=True)
    check(made[-1].last_cg_loop["graph"], "the adaptive learn replayed no CUDA graph")
    launches = {k: counts[k] for k in ("gram_matvec_sym/bf16cast", "gram_matvec_sym/bf16x3",
                                       "split_bf16")}
    for pinned, tier in (("high", "bf16x3"), ("default", "bf16cast")):
        with environ(PLSSVM_MATMUL_PRECISION=pinned):
            gm.reset_launches()
            timings = Timings()
            rc, log = run_cli(predict_main, ["--use_float", "-b", "cuda", "-p", "gpu_nvidia",
                                             main["test"], model, out], timings=timings)
            counts = dict(gm.launches)
        m = re.search(r"Accuracy = ([0-9.]+)%", log)
        check(rc == 0 and m is not None and float(m.group(1)) >= 95.0,
              f"predict CLI at {pinned}: rc {rc}, accuracy {m and m.group(1)}%")
        # one K2; at bf16x3 the split of the points and of the support vectors
        want = {f"gram_matvec_rect/{tier}": 1, **({"split_bf16": 2} if tier == "bf16x3" else {})}
        check(nonzero(counts) == want, f"predict CLI at {pinned} launched {nonzero(counts)}")
        launches[f"gram_matvec_rect/{tier}"] = counts[f"gram_matvec_rect/{tier}"]
        launches["split_bf16"] += counts["split_bf16"]
        print(f"[12 adaptive] predict CLI, PLSSVM_MATMUL_PRECISION={pinned}: accuracy "
              f"{m.group(1)}%, launches {nonzero(counts)}; {cli_split(timings)}; predictions "
              f"sha256 {file_digest(out)}", flush=True)
    return launches


def phase_adaptive_sparse(sparse):
    """The sparse ``dense`` and ``implicit`` tiers with the default plan,
    through the CLIs on phase 8's files."""
    from plssvm_sparse_fp22_tpu_torch.cli import train as train_cli
    from plssvm_sparse_fp22_tpu_torch.cli.predict import main as predict_main
    from plssvm_sparse_fp22_tpu_torch.ops import gram_matvec as gm

    launches = {}
    model, out = os.path.join(WORK, "sparse.adaptive.model"), os.path.join(WORK, "s.predict")
    for name, env, mode, per_mv, splits in [
            ("dense", {"PLSSVM_SPARSE_MODE": "dense"}, "sparse_dense_implicit",
             {"gram_matvec_sym": 1}, 0),
            # 4 panels, densified and split anew for each A·v
            ("implicit", {"PLSSVM_SPARSE_MODE": "implicit",
                          "PLSSVM_K_CACHE_BYTES": str(PANEL_BUDGET)}, "sparse_implicit",
             {"gram_matvec_sym": 4, "gram_pair_contrib": 6}, 4)]:
        with environ(PLSSVM_MATMUL_PRECISION="", **env), recording_csvms(train_cli) as made:
            gm.reset_launches()
            t0 = time.perf_counter()
            rc, log = run_cli(train_cli.main, ["-t", "2", "-g", repr(SPARSE_GAMMA), "-e", "1e-6",
                                               "--use_float", "-b", "cuda", "-p", "gpu_nvidia",
                                               sparse["train"], model])
            train_s = time.perf_counter() - t0
            counts = dict(gm.launches)
            check(rc == 0, f"adaptive sparse train CLI ({name} tier) returned {rc}")
            rc, plog = run_cli(predict_main, ["--use_float", "-b", "cuda", "-p", "gpu_nvidia",
                                              sparse["test"], model, out])
        info = made[-1].last_cg_info
        check(info["mode"] == mode, f"adaptive {name} tier ran mode {info['mode']}")
        check_adaptive(f"adaptive sparse {name} tier", info, counts, per_mv, 1e-6, splits)
        m = re.search(r"Accuracy = ([0-9.]+)%", plog)
        check(rc == 0 and m is not None and float(m.group(1)) >= SPARSE_ACCURACY,
              f"adaptive {name} tier predict: rc {rc}, accuracy {m and m.group(1)}%")
        if name == "implicit":
            launches = {k: counts[k] for k in ("gram_pair_contrib/bf16cast",
                                               "gram_pair_contrib/bf16x3", "split_bf16")}
        print(f"[13 adaptive] sparse {name} tier, {SPARSE_N} x {SPARSE_F} at 1 % (default "
              f"plan): {info['iterations']} CG iterations, fast_iterations "
              f"{info['fast_iterations']}, escalated {info['escalated']}, learn {cg_ms(log)} ms, "
              f"CLI {train_s:.1f} s, accuracy {m.group(1)}%, launches {nonzero(counts)}",
              flush=True)
    return launches


def phase_tiers(dev, rng, sparse):
    """A forced escalation, and CG it/s per tier at a pinned count."""
    import scipy.sparse as sp
    import torch

    from plssvm_sparse_fp22_tpu_torch import make_csvm
    from plssvm_sparse_fp22_tpu_torch.io.libsvm import ParsedData
    from plssvm_sparse_fp22_tpu_torch.ops import gram_matvec as gm
    from plssvm_sparse_fp22_tpu_torch.ops.matvec import build_operator, tier_precision
    from plssvm_sparse_fp22_tpu_torch.params import Parameter
    from plssvm_sparse_fp22_tpu_torch.types import BackendType, KernelType

    n, f, imax, eps = 4096, 256, 300, 1e-9
    X, y = two_blobs(n, f, rng)
    with environ(PLSSVM_MATMUL_PRECISION="", PLSSVM_CG_STAG_PATIENCE="2"):
        p = Parameter(kernel=KernelType.rbf, gamma=1.0 / f, epsilon=eps, max_iter=imax,
                      dtype=np.float32, backend=BackendType.cuda, print_info=False)
        p.data = ParsedData(csr=sp.csr_matrix(X), values=y, _dense=X)
        p.values = y
        svm = make_csvm(p)
        gm.reset_launches()
        t0 = time.perf_counter()
        svm.learn()
        torch.cuda.synchronize()
        learn_s = time.perf_counter() - t0
        counts = dict(gm.launches)
    info = svm.last_cg_info
    reached = info["delta"] <= eps ** 2 * info["delta0"]
    check(info["escalated"] and info["iterations"] > info["fast_iterations"],
          f"forced escalation did not escalate: {info}")
    check(reached or info["iterations"] == imax,
          f"forced escalation stopped at {info['iterations']} < imax without its target")
    check(counts["gram_matvec_sym/bf16x3"] > 1, f"escalation ran no bf16x3 K1: {counts}")
    print(f"[14 tiers] forced escalation, rbf {n} x {f}, patience 2, eps {eps:g}: "
          f"{info['fast_iterations']} iterations on default, "
          f"{info['iterations'] - info['fast_iterations']} on high, "
          f"{'target reached' if reached else 'stopped at imax'} (residual {info['delta']:.3e}, "
          f"target {eps ** 2 * info['delta0']:.3e}), {learn_s:.2f} s, launches {nonzero(counts)}",
          flush=True)

    n, f = 32768, 256
    X, y = two_blobs(n, f, rng)
    Xd, q, mask, QA, cost_inv, b = dense_system(dev, X, y, 1.0 / f)
    rates = {}
    for name in ("highest", "high", "default", "default", "high", "highest"):
        op = build_operator(KernelType.rbf, Xd, q, mask, QA, cost_inv, gamma=1.0 / f,
                            mode="implicit", backend=BackendType.cuda,
                            precision=tier_precision(name))
        rates.setdefault(name, []).append(pinned_cg_rate(op, b, mask, (5, 25)))
    print(f"[14 tiers] dense rbf {n} x {f}, implicit, CG it/s at eps = 0 (slope 5 -> 25, in "
          f"turns): " + ", ".join(f"{k} {' / '.join(f'{r:.1f}' for r in v)}"
                                  for k, v in rates.items()), flush=True)
    panel = {"PLSSVM_SPARSE_MODE": "implicit", "PLSSVM_K_CACHE_BYTES": str(PANEL_BUDGET)}
    srates = {}
    for name in ("highest", "high", "default"):
        with environ(PLSSVM_MATMUL_PRECISION=name, **panel):
            srates[name] = pinned_rate(sparse["csr"], sparse["y"], KernelType.rbf, (4, 16))
    print(f"[14 tiers] sparse implicit tier, {SPARSE_N} x {SPARSE_F} at 1 %, CG it/s at eps = 0 "
          f"(slope 4 -> 16): " + ", ".join(f"{k} {r:.1f}" for k, r in srates.items()),
          flush=True)


def phase_checkpoint(main):
    """Phase 15: the chunked CG loop on the card, through the train CLI on
    phase 6's file at the exact tier."""
    from plssvm_sparse_fp22_tpu_torch.cli import train as train_cli
    from plssvm_sparse_fp22_tpu_torch.ops import gram_matvec as gm

    base = ["-t", "2", "-e", "1e-6", "--use_float", "-b", "cuda", "-p", "gpu_nvidia"]
    ckpt_a, ckpt_b = os.path.join(WORK, "cg_a.npz"), os.path.join(WORK, "cg_b.npz")
    models = {k: os.path.join(WORK, f"ckpt_{k}.model") for k in "abc"}

    def train(tag, extra, model):
        with recording_csvms(train_cli, timings=True) as made:
            gm.reset_launches()
            t0 = time.perf_counter()
            rc, log = run_cli(train_cli.main, [*base, *extra, main["train"], model])
            wall = time.perf_counter() - t0
            counts = dict(gm.launches)
        check(rc == 0, f"checkpoint phase, run {tag}: train CLI returned {rc}")
        svm = made[-1]
        check(svm.last_cg_info["mode"] == "implicit", f"run {tag} ran {svm.last_cg_info['mode']}")
        check(nonzero(counts) == {"gram_matvec_sym/exact": counts["gram_matvec_sym/exact"]},
              f"run {tag} launched {nonzero(counts)}, expected K1 on the exact tier only")
        return svm, log, counts["gram_matvec_sym/exact"], wall

    # (a) stopped after 5 iterations, then resumed to the end
    part, _, k1_part, _ = train("a, interrupted", ["--checkpoint", ckpt_a,
                                                  "--checkpoint_interval", "3",
                                                  "--max_iter", "5"], models["a"])
    check(part.last_cg_info["iterations"] == 5 and k1_part == 6,
          f"interrupted run: {part.last_cg_info['iterations']} iterations, {k1_part} K1 launches "
          "(expected 5 and 6: the initial residual and one per iteration)")
    resumed, log, k1_resumed, _ = train("a, resumed", ["--checkpoint", ckpt_a,
                                                      "--checkpoint_interval", "3"], models["a"])
    check(re.search(r"Resumed CG from checkpoint '.*' at iteration 5\.", log) is not None,
          "the resumed run did not print its 'Resumed CG ... at iteration 5' line")
    iters = resumed.last_cg_info["iterations"]
    check(k1_resumed == iters - 5, f"resumed run launched K1 {k1_resumed} times for "
          f"{iters - 5} iterations (no initial residual on a resume)")
    # (b) uninterrupted, with a checkpoint and per-iteration output
    whole, log, k1_whole, wall = train("b, uninterrupted", ["--checkpoint", ckpt_b,
                                                          "--verbose_cg"], models["b"])
    lines = re.findall(r"^Start Iteration (\d+) \(max: 256\) with current residuum \S+ "
                       r"\(target: \S+\)\. $", log, flags=re.M)
    check([int(k) for k in lines] == list(range(1, iters + 1)),
          f"--verbose_cg printed iterations {lines}, expected 1..{iters}")
    check(k1_whole == iters + 1 + iters // 50, f"uninterrupted run: {k1_whole} K1 launches")
    # (c) one shot, the same pinned tier
    shot, _, k1_shot, _ = train("c, one shot", [], models["c"])
    counts = [s.last_cg_info["iterations"] for s in (resumed, whole, shot)]
    check(len(set(counts)) == 1, f"resumed / uninterrupted / one-shot iterations differ: {counts}")
    with open(models["a"], "rb") as fa, open(models["b"], "rb") as fb:
        check(fa.read() == fb.read(), "the resumed model file differs from the uninterrupted one")
    scale = float(np.abs(whole.alphas).max())
    err = float(np.abs(shot.alphas - whole.alphas).max()) / scale
    check(err <= 1e-6 and abs(shot.bias_ - whole.bias_) <= 1e-6 * max(1.0, abs(whole.bias_)),
          f"one-shot learn off the chunked one by {err:.2e} of the alphas' scale")
    spans = whole.timings.summary()
    print(f"[15 checkpoint] rbf 32768 x 256, exact tier: interrupted at 5 and resumed, "
          f"uninterrupted (--verbose_cg, {len(lines)} lines) and one-shot learns all end on "
          f"{iters} iterations; resumed and uninterrupted model files byte-equal; one shot "
          f"within {err:.1e}; K1 launches {k1_part} + {k1_resumed} / {k1_whole} / {k1_shot}",
          flush=True)
    print(f"[15 checkpoint] uninterrupted learn, wall split (Timings sink, device "
          f"synchronised): set-up {spans['setup']:.1f} ms (system and operator "
          f"{whole.timings.records['setup'][0]:.1f}, initial residual "
          f"{whole.timings.records['setup'][1]:.1f}), CG {spans['cg']:.1f} ms in "
          f"{len(whole.timings.records['cg'])} chunks of one iteration, learn {cg_ms(log)} ms, "
          f"train CLI {wall:.1f} s", flush=True)
    return {"gram_matvec_sym/exact": k1_whole}


def phase_small_clis():
    """Phase 16: generate-data, train, predict and detect through their CLIs."""
    import torch

    from plssvm_sparse_fp22_tpu_torch.cli.detect import main as detect_main
    from plssvm_sparse_fp22_tpu_torch.cli.generate_data import main as generate_main
    from plssvm_sparse_fp22_tpu_torch.cli.predict import main as predict_main
    from plssvm_sparse_fp22_tpu_torch.cli.train import main as train_main
    from plssvm_sparse_fp22_tpu_torch.ops import gram_matvec as gm

    base = os.path.join(WORK, "gen")
    rc, _ = run_cli(generate_main, ["--output", base, "--format", "libsvm", "--samples", "8192",
                                    "--test_samples", "1024", "--features", "64",
                                    "--problem", "blobs", "--seed", str(SEED % 2**31)])
    check(rc == 0, f"generate-data CLI returned {rc}")
    train, test = base + ".libsvm", base + "_test.libsvm"
    model, out = os.path.join(WORK, "gen.model"), os.path.join(WORK, "gen.predict")
    gm.reset_launches()
    rc, log = run_cli(train_main, ["-t", "2", "-e", "1e-6", "--use_float", "-b", "cuda",
                                   "-p", "gpu_nvidia", train, model])
    check(rc == 0, f"train CLI on the generated file returned {rc}")
    m = re.search(r"Finished after (\d+) iterations", log)
    check(m is not None and gm.launches["gram_matvec_sym/bf16cast"] > 0,
          f"training on the generated file: {nonzero(gm.launches)}")
    rc, plog = run_cli(predict_main, ["--use_float", "-b", "cuda", "-p", "gpu_nvidia",
                                      test, model, out])
    acc = re.search(r"Accuracy = ([0-9.]+)%", plog)
    check(rc == 0 and acc is not None and float(acc.group(1)) >= 95.0,
          f"predict CLI on the generated test file: rc {rc}, accuracy {acc and acc.group(1)}%")
    check(gm.launches["gram_matvec_rect/exact"] == 1, "prediction did not launch K2")
    print(f"[16 CLIs] generate-data 8192 + 1024 x 64 blobs -> train ({m.group(1)} CG "
          f"iterations, adaptive plan) -> predict accuracy {acc.group(1)}%, launches "
          f"{nonzero(gm.launches)}", flush=True)

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = detect_main(["--json"])
    lines = buf.getvalue().strip().splitlines()
    check(rc == 0 and len(lines) == 1, f"detect --json: rc {rc}, {len(lines)} lines")
    info = json.loads(lines[0])
    check(info["platform"] == "cuda" and info["default_backend"] == "cuda"
          and info["num_devices"] == torch.cuda.device_count()
          and info["devices"][0]["name"] == torch.cuda.get_device_name(0)
          and info["devices"][0]["compute_capability"] == "9.0" and info["nvcc"],
          f"detect --json reports {info}")
    print(f"[16 CLIs] detect --json: {lines[0]}", flush=True)


#: the ring's A·v against the single-device operator (K1) of the same tier,
#: relative to the result's scale: the same Gram entries summed in another
#: order (measured 3e-7 to 2e-6 on an H100)
RING_TOL = 5e-5
#: what holds a sharded learn: its iteration count (within one of the
#: single-device learn's), its residual (at or under the target), and its
#: residual as the exact single-device operator sees it, ``TRUE_RESIDUAL``
#: times the target at most (the recursive residual of a float32 CG drifts
#: from the true one, and a bf16 tier's A is not the exact A; measured 0.83 on
#: every tier).  Its alphas are printed beside the single-device learn's and
#: not held to them: float32 CG from x0 = 1 stops at eps 1e-6 far from the
#: solution (the float64 solves at eps 1e-6 and 1e-9 differ by 0.3 of the
#: alphas' scale) and amplifies any change in the order of the sums.  On an
#: H100 two correct float32 learns (K1 against K2 on one device, either
#: against float64) sat 3e-2 to 4e-2 of the scale apart, K1 with its dot
#: products summed in four parts 0.15, and the linear kernel's 0.5.
TRUE_RESIDUAL = 4.0


def cards() -> str:
    """The cards' names and power limits, as ``nvidia-smi`` gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    return "; ".join(f"{smi.count(card)} x {card}" if len(smi) > 1 else card
                     for card in dict.fromkeys(smi))


def phase_sharded(dev, rng):
    """Phase 17: the row-sharded dense learn and predict on the card."""
    import torch

    from plssvm_sparse_fp22_tpu_torch import make_csvm
    from plssvm_sparse_fp22_tpu_torch.io.libsvm import ParsedData
    from plssvm_sparse_fp22_tpu_torch.ops import gram_matvec as gm
    from plssvm_sparse_fp22_tpu_torch.ops.matvec import build_operator, tier_precision
    from plssvm_sparse_fp22_tpu_torch.parallel import sharded
    from plssvm_sparse_fp22_tpu_torch.parallel.mesh import make_mesh
    from plssvm_sparse_fp22_tpu_torch.params import Parameter
    from plssvm_sparse_fp22_tpu_torch.solver.cg import cg_solve, cg_solve_adaptive
    from plssvm_sparse_fp22_tpu_torch.types import BackendType, KernelType

    import scipy.sparse as sp

    cuda, rbf = BackendType.cuda, KernelType.rbf
    n, f, eps, imax = 32768, 256, 1e-6, 256
    gamma = 1.0 / f
    X, y = two_blobs(n, f, rng)
    Xd, q, mask, QA, cost_inv, b = dense_system(dev, X, y, gamma)
    x_last = torch.tensor(X[-1], dtype=torch.float32, device=dev)
    meshes = [("2 logical shards of cuda:0", make_mesh(2, devices=[dev])),
              ("4 logical shards of cuda:0", make_mesh(4, devices=[dev]))]
    if torch.cuda.device_count() > 1:
        meshes.append((f"{torch.cuda.device_count()} cards", make_mesh()))
        meshes.append((f"2 shards on each of {torch.cuda.device_count()} cards",
                       make_mesh(2 * torch.cuda.device_count())))
    print(f"[17 sharded] rbf {n} x {f} float32, implicit ring, every hop K2; meshes: "
          + "; ".join(name for name, _ in meshes), flush=True)

    def single_op(name):
        return build_operator(rbf, Xd, q, mask, QA, cost_inv, gamma=gamma, mode="implicit",
                              backend=cuda, precision=tier_precision(name)).matvec

    # the single-device learns (K1), one per tier and the adaptive one
    tiers = ("highest", "high", "default")
    ops1 = {name: single_op(name) for name in tiers}
    single = {name: cg_solve(ops1[name], b, mask, eps, imax) for name in tiers}
    single["adaptive"] = cg_solve_adaptive(ops1["default"], ops1["high"], b, mask, eps, imax)
    v = torch.tensor(rng.normal(size=n), dtype=torch.float32, device=dev) * mask
    want_v = {name: ops1[name](v) for name in tiers}

    def true_residual(x):
        r = b - ops1["highest"](x)
        return float(torch.dot(r, r))

    print("  single device (K1): " + ", ".join(
        f"{name} {res.iterations} iterations, true residual "
        f"{true_residual(res.x) / (eps * eps * float(res.delta0)):.2f} x target"
        for name, res in single.items()), flush=True)
    ring_launches, ring_ops = {}, {}
    for mesh_name, mesh in meshes:
        p = len(mesh)
        Xs, bs, ms = sharded.shard_system(mesh, Xd, b, mask)
        for name in (*tiers, "adaptive"):
            plan = ("default", "high") if name == "adaptive" else None
            if plan is None:
                # one A·v of the ring against K1 at the same tier
                gm.reset_launches()
                mv = sharded._prepare_local(rbf, mesh, Xs, x_last, ms, gamma, 0.0, 1.0, 3,
                                            "implicit", cuda, "none",
                                            precision=tier_precision(name))[3]
                got = mv(v)
                torch.cuda.synchronize()
                hops = gm.launches[f"gram_matvec_rect/{tier_precision(name)}"]
                err_v = float((got - want_v[name]).abs().max()) / float(want_v[name].abs().max())
                check(hops == p * p and err_v <= RING_TOL,
                      f"{mesh_name}, {name}: one A·v of the ring launched K2 {hops} times "
                      f"(expected {p * p}) and is {err_v:.2e} of its scale off K1's "
                      f"(tol {RING_TOL:g})")
                ring_ops[(mesh_name, name)] = mv
            learn = sharded.make_sharded_learn(mesh, rbf, 3, "implicit", backend=cuda,
                                               mxu_plan=plan)
            with environ(PLSSVM_MATMUL_PRECISION="" if plan else name):
                gm.reset_launches()
                out = learn(Xs, x_last, bs, ms, gamma, 0.0, 1.0, eps, imax)
                torch.cuda.synchronize()
                counts = dict(gm.launches)
            x, iters, delta, delta0 = out[0], out[4], float(out[5]), float(out[6])
            ref = single[name]
            target = eps * eps * delta0
            check(abs(iters - ref.iterations) <= 1, f"{mesh_name}, {name}: {iters} iterations, "
                  f"the single-device learn took {ref.iterations}")
            check(delta <= target, f"{mesh_name}, {name}: residual {delta} above its target "
                  f"{target}")
            true = true_residual(x) / target
            check(true <= TRUE_RESIDUAL, f"{mesh_name}, {name}: the exact operator sees a "
                  f"residual of {true:.2f} x the target (bound {TRUE_RESIDUAL:g})")
            err = float((x - ref.x).abs().max()) / float(ref.x.abs().max())
            if plan is None:
                tier = tier_precision(name)
                want = {f"gram_matvec_rect/{tier}": p * p * (iters + 1 + iters // 50)}
                if tier == "bf16x3":
                    want["split_bf16"] = p  # each shard's operands, once per operator
            else:
                kf = out[7]
                want = {"gram_matvec_rect/bf16cast": p * p * (kf + 1 + kf // 50),
                        "gram_matvec_rect/bf16x3": p * p * (1 + iters - kf
                                                            + iters // 50 - kf // 50),
                        "split_bf16": p}
            check(nonzero(counts) == want,
                  f"{mesh_name}, {name}: launches {nonzero(counts)}, expected {want}")
            if p == 4 and mesh[0] == mesh[-1]:
                for key in want:
                    ring_launches[key] = ring_launches.get(key, 0) + counts[key]
            print(f"  {mesh_name}, {name}: "
                  + (f"A·v within {err_v:.2e} of K1's (tol {RING_TOL:g}); " if plan is None
                     else "")
                  + f"{iters} CG iterations (single device {ref.iterations})"
                  + (f", {out[7]} on the fast tier" if plan else "")
                  + f", residual {delta / target:.2f} x target, by the exact operator "
                  f"{true:.2f} x (bound {TRUE_RESIDUAL:g}), alphas {err:.2e} of their scale "
                  f"from the single-device learn's (not held), launches {nonzero(counts)}",
                  flush=True)

        # two runs of the exact ring are the same bits
        with environ(PLSSVM_MATMUL_PRECISION="highest"):
            learn = sharded.make_sharded_learn(mesh, rbf, 3, "implicit", backend=cuda)
            one = learn(Xs, x_last, bs, ms, gamma, 0.0, 1.0, eps, imax)
            two = learn(Xs, x_last, bs, ms, gamma, 0.0, 1.0, eps, imax)
        check(one[4] == two[4] and torch.equal(one[0], two[0]) and torch.equal(one[5], two[5]),
              f"{mesh_name}: two runs of the sharded learn differ")

        # a chunked sharded learn, interrupted and resumed, through the CSVM's chunked CG loop
        path = os.path.join(WORK, f"ring_{p}_{len(set(mesh))}.npz")
        small = Parameter(kernel=rbf, gamma=gamma, epsilon=eps, dtype=np.float32, backend=cuda,
                          checkpoint_path=path, checkpoint_interval=3, print_info=True)
        small.data = ParsedData(csr=sp.csr_matrix(X[:8]), values=y[:8], _dense=X[:8])
        small.values = y[:8]
        chunker = make_csvm(small)

        def chunked(stop_at):
            setup_fn, chunk_fn = sharded.make_sharded_learn_fns(mesh, rbf, 3, "implicit",
                                                                backend=cuda)
            buf = io.StringIO()
            with environ(PLSSVM_MATMUL_PRECISION="highest"), contextlib.redirect_stdout(buf):
                _, _, state = chunker._drive_chunked_cg(
                    lambda: setup_fn(Xs, x_last, bs, ms, gamma, 0.0, 1.0),
                    lambda q_, QA_, end, st: chunk_fn(Xs, bs, ms, x_last, gamma, 0.0, 1.0, eps,
                                                      end, st),
                    stop_at, n - 1, device=mesh[0])
            return state, buf.getvalue()

        part, _ = chunked(5)
        check(part.k == 5 and os.path.exists(path), f"{mesh_name}: the interrupted chunked "
              f"learn stopped at {part.k}")
        state, log = chunked(imax)
        check("at iteration 5." in log, f"{mesh_name}: no 'Resumed CG' line: {log!r}")
        check(state.k == one[4] and torch.equal(state.x, one[0]),
              f"{mesh_name}: the resumed chunked learn ({state.k} iterations) differs from "
              f"the one-shot sharded learn ({one[4]})")
        os.remove(path)
        print(f"  {mesh_name}: two exact runs bitwise equal; chunked learn interrupted at 5, "
              f"resumed from its checkpoint, ends on the one-shot learn's bits after {state.k} "
              f"iterations", flush=True)

        # predict and w against the single-device ones
        alphas = torch.tensor(rng.normal(size=n), dtype=torch.float32, device=dev)
        P = torch.tensor(rng.normal(size=(4096, f)), dtype=torch.float32, device=dev)
        Xsv = torch.tensor(X, dtype=torch.float32, device=dev)
        bias = torch.tensor(0.25, device=dev)
        with environ(PLSSVM_MATMUL_PRECISION="highest"):
            want = gm.gram_matvec(rbf, P, alphas, Y=Xsv, gamma=gamma) + bias
            gm.reset_launches()
            got = sharded.make_sharded_predict(mesh, rbf, 3, backend=cuda)(
                P, sharded.shard_rows(mesh, Xsv), sharded.shard_rows(mesh, alphas), bias,
                gamma, 0.0)
            torch.cuda.synchronize()
        check(gm.launches["gram_matvec_rect/exact"] == p, "the sharded predict did not launch "
              f"K2 once per shard: {nonzero(gm.launches)}")
        err_p = float((got - want).abs().max()) / float(want.abs().max())
        w = sharded.make_sharded_w(mesh)(sharded.shard_rows(mesh, Xsv),
                                         sharded.shard_rows(mesh, alphas))
        w_ref = Xsv.T @ alphas
        err_w = float((w - w_ref).abs().max()) / float(w_ref.abs().max())
        check(err_p <= TOL and err_w <= TOL, f"{mesh_name}: sharded predict {err_p:.2e}, w "
              f"{err_w:.2e} off the single-device ones (tol {TOL:g})")
        print(f"  {mesh_name}: sharded predict (K2 per shard) within {err_p:.2e}, w within "
              f"{err_w:.2e} of the single-device ones (tol {TOL:g})", flush=True)
        del Xsv, P, alphas

    # the linear and cached modes at 4096 x 256
    n2 = 4096
    X2, y2 = two_blobs(n2, f, rng)
    for kernel, mode in ((KernelType.linear, "linear"), (rbf, "cached")):
        Xd2, q2, m2, QA2, ci2, b2 = dense_system(dev, X2, y2, gamma, kernel)
        xl2 = torch.tensor(X2[-1], dtype=torch.float32, device=dev)
        with environ(PLSSVM_MATMUL_PRECISION="highest"):
            op = build_operator(kernel, Xd2, q2, m2, QA2, ci2, gamma=gamma, mode=mode,
                                backend=cuda)
            ref = cg_solve(op.matvec, b2, m2, eps, imax)
            for mesh_name, mesh in meshes:
                Xs2, bs2, ms2 = sharded.shard_system(mesh, Xd2, b2, m2)
                _, _, _, mv, _ = sharded._prepare_local(kernel, mesh, Xs2, xl2, ms2, gamma, 0.0,
                                                        1.0, 3, mode, cuda, "none")
                v2 = torch.tensor(rng.normal(size=len(b2)), dtype=torch.float32, device=dev) * m2
                got, want = mv(v2), op.matvec(v2)
                err_mv = float((got - want).abs().max()) / float(want.abs().max())
                out = sharded.make_sharded_learn(mesh, kernel, 3, mode, backend=cuda)(
                    Xs2, xl2, bs2, ms2, gamma, 0.0, 1.0, eps, imax)
                target = eps * eps * float(out[6])
                r = b2 - op.matvec(out[0])
                true = float(torch.dot(r, r)) / target
                err = float((out[0] - ref.x).abs().max()) / float(ref.x.abs().max())
                check(err_mv <= RING_TOL and float(out[5]) <= target and true <= TRUE_RESIDUAL
                      and abs(out[4] - ref.iterations) <= 2,
                      f"{mode} mode, {mesh_name}: A·v {err_mv:.2e} off (tol {RING_TOL:g}), "
                      f"{out[4]} iterations against {ref.iterations}, residual "
                      f"{float(out[5]) / target:.2f} x target, by the single-device operator "
                      f"{true:.2f} x (bound {TRUE_RESIDUAL:g})")
                print(f"  {mode} mode, {kernel.name} {n2} x {f}, {mesh_name}: A·v within "
                      f"{err_mv:.2e} of the single-device operator (tol {RING_TOL:g}), "
                      f"{out[4]} CG iterations (single device {ref.iterations}), residual by the "
                      f"single-device operator {true:.2f} x target (bound {TRUE_RESIDUAL:g}), "
                      f"alphas {err:.2e} of their scale from the single-device learn's (not "
                      f"held)", flush=True)

    # ms per A·v of the ring beside K1
    smi = cards()
    for name in tiers:
        cells = [f"K1 (one device, symmetric) {timed_ms(lambda: ops1[name](v), 10):.3f}"]
        mesh1 = make_mesh(1, devices=[dev])
        Xs, bs, ms = sharded.shard_system(mesh1, Xd, b, mask)
        ring_ops[("p = 1", name)] = sharded._prepare_local(
            rbf, mesh1, Xs, x_last, ms, gamma, 0.0, 1.0, 3, "implicit", cuda, "none",
            precision=tier_precision(name))[3]
        for label in ("p = 1", *(mesh_name for mesh_name, _ in meshes)):
            mv = ring_ops[(label, name)]
            cells.append(f"ring, {label} {timed_ms(lambda: mv(v), 10):.3f}")
        print(f"[17 sharded] ms per A·v, rbf {n} x {f}, {name} ({smi}): " + ", ".join(cells)
              + "; shards that share a card show the ring's overhead, not a scaling",
              flush=True)
    return ring_launches


#: phase 18: the feature-sharded learn's dense set, wide enough that f / p > D
#: at p = 2 and 4 (1 GiB of float32), and the gather ring's sparse set (phase
#: 9's shape, density and seed)
FEATURE_N, FEATURE_F = 4096, 65536
GATHER_N, GATHER_F, GATHER_DENSITY = 8192, 262144, 1e-4


def feature_problem(dev, n: int, f: int) -> dict:
    """The feature-sharded learn's dense set (phases 18 and 19), from a seed
    on ``dev``: ``n - 1`` rows padded to a multiple of 256, float32.  Rows
    of independent gaussians are nearly orthogonal at this width and CG
    ends in two or three iterations; rows on a 64-dimensional subspace
    (labels on its first axis) take more."""
    import torch

    rank = 64
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    y = torch.where(torch.arange(n, device=dev) % 2 == 0, 1.0, -1.0)
    Z = torch.randn((n, rank), generator=gen, device=dev)
    Z[:, 0] += y
    W = torch.randn((rank, f), generator=gen, device=dev) / rank ** 0.5
    dept = n - 1
    D = -(-dept // 256) * 256
    X_pad = torch.zeros((D, f), device=dev)
    X_pad[:dept] = Z[:dept] @ W
    b, mask = torch.zeros(D, device=dev), torch.zeros(D, device=dev)
    b[:dept], mask[:dept] = y[:dept] - y[-1], 1.0
    return {"X": X_pad, "x_last": Z[-1] @ W, "b": b, "mask": mask, "dept": dept,
            "v": torch.randn(D, generator=gen, device=dev) * mask, "gamma": 1.0 / f}


def main_sparse_set():
    """The sparse main path's planted set (phases 8, 9 and 18): ``(csr, y)``
    of ``SPARSE_N + SPARSE_TEST`` rows, the first ``SPARSE_N`` to train."""
    return planted_sparse(SPARSE_N + SPARSE_TEST, SPARSE_F, SPARSE_DENSITY,
                          np.random.default_rng(SEED + 1))


def phase_sharded_rest(dev, sparse=None):
    """Phase 18: the feature-sharded learn and the three sparse rings on
    logical shards of the card (and on the cards, where there are several),
    float32, each against its one-device counterpart.  ``sparse`` is phase
    8's set (made again where phase 8 did not run).  Returns K2's launches
    in the panel ring's learn."""
    import torch

    from plssvm_sparse_fp22_tpu_torch import make_csvm
    from plssvm_sparse_fp22_tpu_torch.io.libsvm import ParsedData
    from plssvm_sparse_fp22_tpu_torch.ops import gram_matvec as gm
    from plssvm_sparse_fp22_tpu_torch.ops import sparse as ops_sparse
    from plssvm_sparse_fp22_tpu_torch.ops.kernel_functions import gram_block, kernel_scalar
    from plssvm_sparse_fp22_tpu_torch.ops.matvec import (_corrections, build_operator,
                                                         tier_precision)
    from plssvm_sparse_fp22_tpu_torch.parallel import sharded
    from plssvm_sparse_fp22_tpu_torch.parallel.mesh import make_mesh
    from plssvm_sparse_fp22_tpu_torch.params import Parameter
    from plssvm_sparse_fp22_tpu_torch.solver.cg import cg_solve
    from plssvm_sparse_fp22_tpu_torch.types import BackendType, KernelType, TargetPlatform

    import scipy.sparse as sp

    on_card = dev.type == "cuda"
    backend = BackendType.cuda if on_card else BackendType.torch
    target = TargetPlatform.automatic if on_card else TargetPlatform.cpu
    rbf, eps, imax = KernelType.rbf, 1e-6, 256
    ndev = torch.cuda.device_count() if on_card else 1
    meshes = [(f"{p} logical shards of {dev}", make_mesh(p, devices=[dev])) for p in (2, 4)]
    if ndev > 1:
        meshes.append((f"{ndev} cards", make_mesh(ndev)))
    label = cards() if on_card else str(dev)
    ms_lines = []

    def padded(dept, D):
        b, m = np.zeros(D, np.float32), np.zeros(D, np.float32)
        m[:dept] = 1.0
        return b, m

    def csvm(csr, y, kernel, **params):
        """A one-device float32 CSVM on sparse data."""
        p = Parameter(kernel=kernel, epsilon=eps, dtype=np.float32, backend=backend,
                      target=target, devices=1, print_info=False, **params)
        p.data = ParsedData(csr=csr, values=y)
        p.values = y
        return make_csvm(p)

    def learn_csvm(csr, y, kernel, **params):
        svm = csvm(csr, y, kernel, **params)
        svm.learn()
        return svm

    def held(tag, out, ref_iters, true_op, b, cap=imax, slack=1):
        """A sharded learn's iterations (within ``slack`` of the one-device
        learn's), residual (falling; at its target unless the learn ran to
        ``cap``) and residual by the one-device operator; returns the
        printable part."""
        iters, delta, delta0 = out[4], float(out[5]), float(out[6])
        goal = eps * eps * delta0
        check(abs(iters - ref_iters) <= slack, f"{tag}: {iters} iterations, the one-device "
              f"learn took {ref_iters} (slack {slack})")
        check(delta < delta0 and (delta <= goal or iters == cap)
              and bool(torch.isfinite(out[0]).all()),
              f"{tag}: residual {delta} from {delta0}, target {goal}, {iters} iterations")
        r = b - true_op(out[0])
        true = float(torch.dot(r, r)) / goal
        check(iters == cap or true <= TRUE_RESIDUAL, f"{tag}: the one-device operator sees a "
              f"residual of {true:.2f} x the target (bound {TRUE_RESIDUAL:g})")
        return (f"{iters} CG iterations (one device {ref_iters}), residual {delta / goal:.2f} x "
                f"target, by the one-device operator {true:.2f} x (bound {TRUE_RESIDUAL:g})")

    def av_close(tag, got, want):
        err = float((got - want).abs().max()) / float(want.abs().max())
        check(err <= RING_TOL, f"{tag}: one A·v is {err:.2e} of its scale off the one-device "
              f"operator's (tol {RING_TOL:g})")
        return err

    # (a) the feature-sharded learn, dense 4096 x 65536: f / p > D
    n, f = FEATURE_N, FEATURE_F
    fe = feature_problem(dev, n, f)
    X_pad, x_last, b, mask, v, dept = (fe[k] for k in ("X", "x_last", "b", "mask", "v", "dept"))
    del fe
    one = torch.tensor(1.0, device=dev)
    print(f"[18 sharded rest] (a) feature-sharded learn, {n} x {f} float32 (f / p > D at p = 2, "
          f"4): each A·v against the one-device exact operator (tol {RING_TOL:g})", flush=True)
    for kernel in KernelType:
        kw = {"degree": 3, "gamma": 1.0 / f, "coef0": 1.0 if kernel == KernelType.polynomial
              else 0.0}
        q = gram_block(kernel, X_pad, x_last[None, :], **kw)[:, 0] * mask
        QA = kernel_scalar(kernel, x_last, x_last, **kw) + one
        op = build_operator(kernel, X_pad, q, mask, QA, one, backend=backend, precision="exact",
                            mode="linear" if kernel == KernelType.linear else "implicit",
                            **kw).matvec
        ref = cg_solve(op, b, mask, eps, imax)
        cells = [f"one device ({'two GEMVs' if kernel == KernelType.linear else 'K1'}) "
                 f"{timed_ms(lambda: op(v), 5):.3f}"]
        for mesh_name, mesh in meshes:
            tag = f"(a) {kernel.name}, {mesh_name}"
            Xs, xls, bs, ms = sharded.shard_system_feature(mesh, X_pad, x_last, b, mask)
            mv = sharded._prepare_feature_local(kernel, mesh, Xs, xls, ms, kw["gamma"],
                                                kw["coef0"], 1.0, 3, "none")[3]
            err = av_close(tag, mv(v), op(v))
            learn = sharded.make_feature_sharded_learn(mesh, kernel, 3)
            out = learn(Xs, xls, bs, ms, kw["gamma"], kw["coef0"], 1.0, eps, imax)
            line = held(tag, out, ref.iterations, op, b)
            dist = float((out[0] - ref.x).abs().max()) / float(ref.x.abs().max())
            extra = ""
            if kernel == rbf:
                # a chunked learn interrupted at 5 and resumed ends on the one-shot bits
                path = os.path.join(WORK, f"feature_{len(mesh)}.npz")
                small = Parameter(kernel=rbf, gamma=kw["gamma"], epsilon=eps, dtype=np.float32,
                                  checkpoint_path=path, checkpoint_interval=3, print_info=True,
                                  target=target)
                X8 = np.ones((8, 2))
                small.data = ParsedData(csr=sp.csr_matrix(X8), values=np.ones(8), _dense=X8)
                small.values = np.ones(8)
                chunker = make_csvm(small)

                def chunked(stop_at):
                    setup_fn, chunk_fn = sharded.make_feature_sharded_learn_fns(mesh, rbf, 3)
                    with contextlib.redirect_stdout(io.StringIO()):
                        return chunker._drive_chunked_cg(
                            lambda: setup_fn(Xs, xls, bs, ms, kw["gamma"], 0.0, 1.0),
                            lambda q_, QA_, end, st: chunk_fn(Xs, bs, ms, xls, kw["gamma"], 0.0,
                                                              1.0, eps, end, st),
                            stop_at, dept, device=mesh[0])[2]

                stop = max(1, min(5, out[4] - 1))
                check(chunked(stop).k == stop, f"{tag}: the interrupted chunked learn did not "
                      f"stop at {stop}")
                state = chunked(imax)
                check(state.k == out[4] and torch.equal(state.x, out[0]),
                      f"{tag}: the resumed chunked learn ({state.k} iterations) differs from "
                      f"the one-shot learn ({out[4]})")
                os.remove(path)
                extra = f"; interrupted at {stop} and resumed, the one-shot learn's bits"
            print(f"  {tag}: A·v within {err:.2e}; {line}; alphas {dist:.2e} of their scale "
                  f"from the one-device learn's (not held){extra}", flush=True)
            cells.append(f"{mesh_name} {timed_ms(lambda: mv(v), 5):.3f}")
            del Xs, xls, mv
        ms_lines.append(f"(a) feature-sharded {kernel.name} {n} x {f}: " + ", ".join(cells))
    del X_pad, op

    # (b) the sparse linear ring on the sparse main path's set
    csr, ys = (sparse["csr"], sparse["y"]) if sparse else \
        (lambda c, l: (c[:SPARSE_N], l[:SPARSE_N]))(*main_sparse_set())
    n, f = csr.shape
    dept = n - 1
    x_last = torch.tensor(csr[-1].toarray().ravel(), dtype=torch.float32, device=dev)
    D = -(-dept // 256) * 256
    Xd = torch.zeros((D, f), device=dev)
    Xd[:dept] = torch.tensor(csr[:dept].toarray(), dtype=torch.float32, device=dev)
    b, mask = torch.zeros(D, device=dev), torch.zeros(D, device=dev)
    b[:dept] = torch.tensor(ys[:dept] - ys[-1], dtype=torch.float32, device=dev)
    mask[:dept] = 1.0
    v = torch.tensor(np.random.default_rng(SEED + 18).normal(size=D), dtype=torch.float32,
                     device=dev) * mask
    lin = KernelType.linear
    q = (Xd @ x_last) * mask
    op = build_operator(lin, Xd, q, mask, torch.dot(x_last, x_last) + one, one, mode="linear",
                        backend=backend, precision="exact").matvec
    single = learn_csvm(csr, ys, lin)
    check(single.last_cg_info["mode"] == "sparse_linear", "(b): the one-device learn took "
          f"{single.last_cg_info['mode']}")
    h1 = ops_sparse.HybridSparse.from_csr(csr[:dept], dtype=np.float32, pad_rows=D, device=dev)
    xt = ops_sparse.HybridSparse.from_csr(csr[:dept].T.tocsr(), dtype=np.float32, device=dev)
    sparse_op = (lambda u: _corrections(ops_sparse.hybrid_matvec(h1, ops_sparse.hybrid_matvec(
        xt, u)), u, q, mask, torch.dot(x_last, x_last) + one, one))
    cells = [f"one device (ELL+COO, as sparse_linear) {timed_ms(lambda: sparse_op(v), 10):.3f}"]
    print(f"[18 sharded rest] (b) sparse linear ring, {n} x {f} at {SPARSE_DENSITY:.0%}: A·v "
          f"against the dense one-device operator", flush=True)
    for mesh_name, mesh in meshes:
        tag = f"(b) {mesh_name}"
        p = len(mesh)
        Dp = -(-dept // (128 * p)) * (128 * p)
        check(Dp == D, f"{tag}: padded to {Dp} rows, the one-device system has {D}")
        h = ops_sparse.HybridSparse.from_csr(csr[:dept], dtype=np.float32, pad_rows=Dp)
        system = sharded.shard_sparse_system(mesh, h, b.cpu().numpy(), mask.cpu().numpy())
        mv = sharded._prepare_sparse_linear(mesh, *system[:5], x_last, system[6], 1.0, "none")[3]
        err = av_close(tag, mv(v), op(v))
        gm.reset_launches()
        out = sharded.make_sharded_sparse_linear_learn(mesh)(*system[:5], x_last, *system[5:],
                                                             1.0, eps, imax)
        check(not any(gm.launches.values()), f"{tag}: the sparse linear ring launched "
              f"{nonzero(gm.launches)}")
        # the linear kernel's float32 CG moves by up to two iterations with the
        # order of the sums, as phase 17's linear mode does
        line = held(tag, out, single.last_cg_info["iterations"], op, b, slack=2)
        print(f"  {tag}: A·v within {err:.2e}; {line}", flush=True)
        cells.append(f"{mesh_name} {timed_ms(lambda: mv(v), 10):.3f}")
    ms_lines.append(f"(b) sparse linear ring {n} x {f}: " + ", ".join(cells))

    # (c) the panel ring, rbf, over 2 shards, at the largest budget that routes
    # the learn there: dense X beyond the budget of both devices, the Gram too
    gamma = SPARSE_GAMMA
    ring_launches = {}
    p = 2
    budget = (D * f * 4 - 1) // p
    check(D * D * 4 > budget, "(c): the Gram would fit the budget")
    with environ(PLSSVM_K_CACHE_BYTES=str(budget)):
        plan = csvm(csr, ys, rbf, gamma=gamma)._plan_sparse_panel(csr, dept, D, ndev=p)
    check(plan is not None, "(c): no panel plan for 2 shards")
    th = plan[0]
    panel_rows = ops_sparse.stream_panel_rows(D // p, th.tell.padded_features, 4, budget)
    nP = -(-(D // p) // panel_rows)
    # the one-device panel tier on phase 8's 4096-row panels
    with environ(PLSSVM_SPARSE_MODE="implicit", PLSSVM_K_CACHE_BYTES=str(PANEL_BUDGET),
                 PLSSVM_MATMUL_PRECISION="highest"):
        single = learn_csvm(csr, ys, rbf, gamma=gamma, max_iter=20)
    check(single.last_cg_info["mode"] == "sparse_implicit", "(c): the one-device learn took "
          f"{single.last_cg_info['mode']}")
    th1 = ops_sparse.TiledHybrid.from_csr(csr[:dept], dtype=np.float32, pad_rows=D, device=dev)
    hs = np.zeros(D, np.float32)
    if len(th1.heavy_idx):
        hrows = csr[th1.heavy_idx]
        hs[th1.heavy_idx] = np.asarray(hrows.multiply(hrows).sum(axis=1)).ravel()
    print(f"[18 sharded rest] (c) panel ring, rbf {n} x {f}, 2 shards, PLSSVM_K_CACHE_BYTES "
          f"{budget} (dense X needs {D * f * 4} over 2 devices): panels of {panel_rows} rows, "
          f"{nP} per shard, {len(th.heavy_idx)} heavy rows; K2 launches p² nP² = "
          f"{p * p * nP * nP} per A·v", flush=True)
    panel_meshes = [m for m in meshes if len(m[1]) == 2]
    if ndev > 1:
        panel_meshes.append(("2 cards", make_mesh(2)))
    for mesh_name, mesh in panel_meshes:
        tv, tc, hv, hr, bs, ms = sharded.shard_sparse_tiled_system(mesh, th, b.cpu().numpy(),
                                                                   mask.cpu().numpy())
        shape = {"ntiles": th.tell.ntiles, "Lt": th.tell.Lt}
        for name in ("highest", "default"):
            tag = f"(c) {mesh_name}, {name}"
            tier = tier_precision(name)
            q_r, QA_r, ci_r, mv, _ = sharded._prepare_sparse_panel_local(
                rbf, mesh, tv, tc, hv, hr, x_last, ms, gamma, 0.0, 1.0, 3, panel_rows=panel_rows,
                backend=backend, precond="none", precision=tier, **shape)
            kv1 = ops_sparse.make_tiled_panel_matvec(
                th1.tell.vals, th1.tell.lcols, int(rbf), 3, gamma, 0.0, panel_rows=PANEL_ROWS,
                use_cuda=backend == BackendType.cuda, heavy=th1.heavy,
                heavy_rows=tuple(int(r) for r in th1.heavy_idx),
                heavy_sq_vec=torch.from_numpy(hs).to(dev), precision=tier, **shape)[0]

            def op1(u):
                return _corrections(kv1(u), u, q_r, ms, QA_r, ci_r)

            gm.reset_launches()
            got = mv(v)
            torch.cuda.synchronize()
            hops = gm.launches[f"gram_matvec_rect/{tier}"]
            check(hops == p * p * nP * nP, f"{tag}: one A·v launched K2 {hops} times, "
                  f"expected {p * p * nP * nP}")
            err = av_close(tag, got, op1(v))
            ring_ms, one_ms = timed_ms(lambda: mv(v), 3), timed_ms(lambda: op1(v), 3)
            if name == "highest":
                true_op, exact_av = op1, got
            off = float((got - exact_av).abs().max()) / float(exact_av.abs().max())
            print(f"  {tag}: A·v within {err:.2e} of the one-device panel operator at this "
                  f"tier, {off:.2e} from the ring's exact A·v, {hops} K2 launches", flush=True)
            ms_lines.append(f"(c) panel ring rbf {n} x {f}, {name}: one device (K1/K3 on "
                            f"{PANEL_ROWS}-row panels) {one_ms:.3f}, {mesh_name} {ring_ms:.3f}")
        learn = sharded.make_sharded_sparse_panel_learn(mesh, rbf, 3, panel_rows=panel_rows,
                                                        backend=backend, **shape)
        with environ(PLSSVM_MATMUL_PRECISION="highest"):
            gm.reset_launches()
            out = learn(tv, tc, hv, hr, x_last, bs, ms, gamma, 0.0, 1.0, eps, 20)
            torch.cuda.synchronize()
            counts = dict(gm.launches)
        iters = out[4]
        want = {"gram_matvec_rect/exact": p * p * nP * nP * (iters + 1 + iters // 50)}
        check(nonzero(counts) == want, f"(c) {mesh_name}: the learn's launches "
              f"{nonzero(counts)}, expected {want}")
        if mesh[0] == mesh[-1]:
            ring_launches = want
        line = held(f"(c) {mesh_name}", out, single.last_cg_info["iterations"], true_op, b,
                    cap=20)
        print(f"  (c) {mesh_name}, learn on highest to eps {eps:g}: {line}, launches "
              f"{nonzero(counts)}", flush=True)
    del Xd, th1

    # (d) the gather ring on phase 9's 8192 x 262144 set at 0.01 %
    gcsr, gy = planted_sparse(GATHER_N, GATHER_F, GATHER_DENSITY, np.random.default_rng(SEED + 2))
    gamma = 1.0 / 32
    n, f = gcsr.shape
    dept = n - 1
    D = -(-dept // 256) * 256
    with environ(PLSSVM_SPARSE_MODE="implicit"):
        single = learn_csvm(gcsr, gy, rbf, gamma=gamma, max_iter=20)
    check(single.last_cg_info["mode"] == "sparse_implicit", "(d): the one-device learn took "
          f"{single.last_cg_info['mode']}")
    x_last = torch.tensor(gcsr[-1].toarray().ravel(), dtype=torch.float32, device=dev)
    b, mask = torch.zeros(D, device=dev), torch.zeros(D, device=dev)
    b[:dept] = torch.tensor(gy[:dept] - gy[-1], dtype=torch.float32, device=dev)
    mask[:dept] = 1.0
    v = torch.tensor(np.random.default_rng(SEED + 19).normal(size=D), dtype=torch.float32,
                     device=dev) * mask
    h1 = ops_sparse.HybridSparse.from_csr(gcsr[:dept], dtype=np.float32, pad_rows=D, device=dev)
    kv1, sq1 = ops_sparse.make_streaming_gram_matvec(h1, int(rbf), 3, gamma, 0.0)
    q, QA = ops_sparse.sparse_q_qa_kii(int(rbf), 3, gamma, 0.0,
                                       ops_sparse.hybrid_matvec(h1, x_last),
                                       torch.dot(x_last, x_last), sq1, mask, one)[:2]

    def op1(u):
        return _corrections(kv1(u), u, q, mask, QA, one)

    cells = [f"one device (gather arm) {timed_ms(lambda: op1(v), 3):.3f}"]
    print(f"[18 sharded rest] (d) gather ring, rbf {n} x {f} at {GATHER_DENSITY:.2%} "
          f"({gcsr.nnz} nonzeros)", flush=True)
    for mesh_name, mesh in meshes:
        tag = f"(d) {mesh_name}"
        p = len(mesh)
        check(-(-dept // (128 * p)) * (128 * p) == D, f"{tag}: padded otherwise than the "
              "one-device system")
        h = ops_sparse.HybridSparse.from_csr(gcsr[:dept], dtype=np.float32, pad_rows=D)
        system = sharded.shard_sparse_system(mesh, h, b.cpu().numpy(), mask.cpu().numpy())
        mv = sharded._prepare_sparse_gather_local(rbf, mesh, *system[:5], x_last, system[6],
                                                  gamma, 0.0, 1.0, 3, "none")[3]
        err = av_close(tag, mv(v), op1(v))
        gm.reset_launches()
        out = sharded.make_sharded_sparse_streaming_learn(mesh, rbf, 3)(
            *system[:5], x_last, *system[5:], gamma, 0.0, 1.0, eps, 20)
        check(not any(gm.launches.values()), f"{tag}: the gather ring launched "
              f"{nonzero(gm.launches)}")
        line = held(tag, out, single.last_cg_info["iterations"], op1, b, cap=20)
        print(f"  {tag}: A·v within {err:.2e}; {line}", flush=True)
        cells.append(f"{mesh_name} {timed_ms(lambda: mv(v), 3):.3f}")
    ms_lines.append(f"(d) gather ring rbf {n} x {f}: " + ", ".join(cells))

    for line in ms_lines:
        print(f"[18 sharded rest] ms per A·v ({label}), {line}; shards that share a card show "
              "the ring's overhead, not a scaling", flush=True)
    return ring_launches


#: phase 19: two ranks of two logical shards each, the global mesh of four;
#: the dense main path's shape, phase 9's gather set, phase 18's feature set
#: and phase 8's sparse set (the sparse linear and panel rings, 768-row
#: panels: six per shard of 4096 rows); seconds a pair of workers may take
#: (rendezvous, build check and all)
DIST_RANKS, DIST_SHARDS, DIST_TIMEOUT = 2, 4, 300
DIST_SPEC = {"n": 32768, "f": 256, "gather": [GATHER_N, GATHER_F, GATHER_DENSITY],
             "feature": [FEATURE_N, FEATURE_F], "sparse": [SPARSE_N, SPARSE_F, SPARSE_DENSITY],
             "panel_rows": 768}
#: the capped learns of phase 19's gather, feature-sharded and panel rings
DIST_CAPPED_ITERS = 20
#: the chunked learn stops here and is resumed by a fresh pair of workers
DIST_CKPT_AT = 5


def dist_problem(dev, spec: dict, stage: str = "main") -> dict:
    """Phase 19's data on ``dev``, from a seed: the same bits in the parent
    and in every worker.  The "resume" stage needs the dense set only."""
    import torch

    from plssvm_sparse_fp22_tpu_torch.ops import sparse as ops_sparse

    rng = np.random.default_rng(SEED + 19)
    n, f = spec["n"], spec["f"]
    X, y = two_blobs(n, f, rng)
    Xd, _q, mask, _QA, _ci, b = dense_system(dev, X, y, 1.0 / f)
    on = {"dtype": torch.float32, "device": dev}
    data = {"Xd": Xd, "b": b, "mask": mask, "x_last": torch.tensor(X[-1], **on),
            "v": torch.tensor(rng.normal(size=len(b)), **on) * mask,
            "P": torch.tensor(rng.normal(size=(4096, f)), **on),
            "Xsv": torch.tensor(X, **on), "alphas": torch.tensor(rng.normal(size=n), **on),
            "gamma": 1.0 / f}
    if stage == "resume":
        return data
    data["panel_rows"] = spec["panel_rows"]

    def sparse_system(csr, y, seed, **packings):
        """A padded float32 sparse system: its targets, ``x_last``, a
        masked ``v`` from ``seed`` and the packings asked for."""
        dept = csr.shape[0] - 1
        D = -(-dept // 256) * 256
        b, mask = np.zeros(D, np.float32), np.zeros(D, np.float32)
        b[:dept], mask[:dept] = y[:dept] - y[-1], 1.0
        out = {name: pack.from_csr(csr[:dept], dtype=np.float32, pad_rows=D)
               for name, pack in packings.items()}
        return {**out, "b": b, "mask": mask,
                "x_last": torch.tensor(csr[-1].toarray().ravel(), **on),
                "v": torch.tensor(np.random.default_rng(seed).normal(size=D), **on)
                * torch.tensor(mask, device=dev)}

    gn, gf, density = spec["gather"]
    data["gather"] = sparse_system(*planted_sparse(gn, gf, density,
                                                   np.random.default_rng(SEED + 2)),
                                   SEED + 19, h=ops_sparse.HybridSparse)
    # phase 8's training rows, for the sparse linear and the panel ring
    sn, sf, density = spec["sparse"]
    csr, ys = planted_sparse(sn + SPARSE_TEST, sf, density, np.random.default_rng(SEED + 1))
    data["sparse"] = sparse_system(csr[:sn], ys[:sn], SEED + 18, h=ops_sparse.HybridSparse,
                                   th=ops_sparse.TiledHybrid)
    data["feature"] = feature_problem(dev, *spec["feature"])
    return data


def dist_runs(mesh, data, stage: str, ckpt: str) -> dict:
    """What phase 19 computes on ``mesh``: the parent runs it on one
    process's four logical shards, each worker on the global mesh of two
    ranks; the results (CPU tensors, launch counts, seconds) are compared
    bit for bit.  ``stage`` "main": one A·v of the ring on ``highest`` and on
    ``default`` and their ms, the ring learn on ``highest`` and on the
    adaptive plan, the chunked learn stopped at ``DIST_CKPT_AT`` (rank 0
    writes ``ckpt``), the sharded predict, the gather ring's A·v and learn,
    and (:func:`dist_rest`) the feature-sharded, sparse linear and panel
    rings'; "resume": the chunked learn resumed from ``ckpt``."""
    import torch

    from plssvm_sparse_fp22_tpu_torch.ops import gram_matvec as gm
    from plssvm_sparse_fp22_tpu_torch.ops.matvec import tier_precision
    from plssvm_sparse_fp22_tpu_torch.parallel import distributed, sharded
    from plssvm_sparse_fp22_tpu_torch.parallel.mesh import local_shards
    from plssvm_sparse_fp22_tpu_torch.solver.checkpoint import (load_cg_checkpoint,
                                                                save_cg_checkpoint)
    from plssvm_sparse_fp22_tpu_torch.types import BackendType, KernelType

    on_card = mesh[0].type == "cuda"
    backend = BackendType.cuda if on_card else BackendType.torch
    rbf, eps, imax, gamma = KernelType.rbf, 1e-6, 256, data["gamma"]
    rank = getattr(mesh, "rank", 0)
    n = data["Xd"].shape[0]
    # this rank's rows: an equal share of them per rank
    Xs = distributed.make_global_row_sharded(
        mesh, data["Xd"].chunk(len(mesh) // len(local_shards(mesh)))[rank])
    b, ms, x_last = data["b"], data["mask"], data["x_last"]
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    res = {}

    def timed(fn):
        sync()
        start = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - start

    setup, chunk = sharded.make_sharded_learn_fns(mesh, rbf, 3, "implicit", backend=backend)
    with environ(PLSSVM_MATMUL_PRECISION="highest"):
        if stage == "resume":
            state = load_cg_checkpoint(ckpt, device=sharded._home(mesh))[0]
            check(state.k == DIST_CKPT_AT, f"the checkpoint holds k = {state.k}")
            state = chunk(Xs, b, ms, x_last, gamma, 0.0, 1.0, eps, imax, state)
            return {"resumed_x": state.x.cpu(), "resumed_k": state.k}
        # one A·v of the ring on the exact and on the bf16cast tier: the
        # blocks that cross ranks are half the bytes on the second
        for tier in ("highest", "default"):
            mv = sharded._prepare_local(rbf, mesh, Xs, x_last, ms, gamma, 0.0, 1.0, 3,
                                        "implicit", backend, "none",
                                        precision=tier_precision(tier))[3]
            res[f"av_{tier}"] = mv(data["v"]).cpu()
            res[f"av_ms_{tier}"] = timed_ms(lambda: mv(data["v"]), 10) if on_card else 0.0
            del mv
        for name, plan in (("highest", None), ("adaptive", ("default", "high"))):
            learn = sharded.make_sharded_learn(mesh, rbf, 3, "implicit", backend=backend,
                                               mxu_plan=plan)
            with environ(PLSSVM_MATMUL_PRECISION="" if plan else "highest"):
                gm.reset_launches()
                out, seconds = timed(lambda: learn(Xs, x_last, b, ms, gamma, 0.0, 1.0, eps,
                                                   imax))
            res[name] = {"x": out[0].cpu(), "iters": out[4], "delta": out[5].cpu(),
                         "fast": out[7] if plan else out[4], "seconds": seconds,
                         "launches": nonzero(gm.launches)}
        q, QA, state = setup(Xs, x_last, b, ms, gamma, 0.0, 1.0)
        state = chunk(Xs, b, ms, x_last, gamma, 0.0, 1.0, eps, DIST_CKPT_AT, state)
        if rank == 0:
            save_cg_checkpoint(ckpt, state, q, QA, {"dept": n - 1, "kernel": int(rbf)})
        if sharded.spans_processes(mesh):
            torch.distributed.barrier()
        gm.reset_launches()
        res["predict"] = sharded.make_sharded_predict(mesh, rbf, 3, backend=backend)(
            data["P"], sharded.shard_rows(mesh, data["Xsv"]),
            sharded.shard_rows(mesh, data["alphas"]), torch.tensor(0.25, device=b.device),
            gamma, 0.0).cpu()
        res["predict_launches"] = nonzero(gm.launches)
    g = data["gather"]
    system = sharded.shard_sparse_system(mesh, g["h"], g["b"], g["mask"])
    mvg = sharded._prepare_sparse_gather_local(rbf, mesh, *system[:5], g["x_last"], system[6],
                                               1.0 / 32, 0.0, 1.0, 3, "none")[3]
    res["gather_av"] = mvg(g["v"]).cpu()
    del mvg
    out, seconds = timed(lambda: sharded.make_sharded_sparse_streaming_learn(mesh, rbf, 3)(
        *system[:5], g["x_last"], *system[5:], 1.0 / 32, 0.0, 1.0, eps, DIST_CAPPED_ITERS))
    res["gather"] = {"x": out[0].cpu(), "iters": out[4], "seconds": seconds}
    del system
    with environ(PLSSVM_MATMUL_PRECISION="highest"):
        res.update(dist_rest(mesh, data, timed, backend))
    return res


def dist_rest(mesh, data, timed, backend) -> dict:
    """Phase 19's feature-sharded rbf learn, sparse linear ring and panel
    ring (rbf, at ``highest`` and ``default``) on ``mesh``: for each, one
    A·v, its ms and its launches, and a learn (the feature-sharded and
    panel learns capped at ``DIST_CAPPED_ITERS``) with its launches; on the
    card also the ms of the feature-sharded A·v's reduction alone."""
    import torch

    from plssvm_sparse_fp22_tpu_torch.ops import gram_matvec as gm
    from plssvm_sparse_fp22_tpu_torch.ops.matvec import tier_precision
    from plssvm_sparse_fp22_tpu_torch.parallel import sharded
    from plssvm_sparse_fp22_tpu_torch.parallel.mesh import local_shards
    from plssvm_sparse_fp22_tpu_torch.types import BackendType, KernelType

    on_card = backend == BackendType.cuda
    rbf, eps = KernelType.rbf, 1e-6
    res = {}

    def av(name, mv, v):
        """One A·v of ``mv``, its launches and, on the card, its ms."""
        gm.reset_launches()
        res[f"{name}_av"] = mv(v).cpu()
        res[f"{name}_av_launches"] = nonzero(gm.launches)
        res[f"{name}_av_ms"] = timed_ms(lambda: mv(v), 3) if on_card else 0.0

    def learned(name, learn):
        gm.reset_launches()
        out, seconds = timed(learn)
        res[name] = {"x": out[0].cpu(), "iters": out[4], "seconds": seconds,
                     "launches": nonzero(gm.launches)}

    fe = data["feature"]
    Xs, xls, bs, ms = sharded.shard_system_feature(mesh, fe["X"], fe["x_last"], fe["b"],
                                                   fe["mask"])
    av("feature", sharded._prepare_feature_local(rbf, mesh, Xs, xls, ms, fe["gamma"], 0.0, 1.0,
                                                 3, "none")[3], fe["v"])
    learn = sharded.make_feature_sharded_learn(mesh, rbf, 3)
    learned("feature", lambda: learn(Xs, xls, bs, ms, fe["gamma"], 0.0, 1.0, eps,
                                     DIST_CAPPED_ITERS))
    del Xs, xls
    if on_card:
        # the A·v's reduction alone: the shards' partial Grams, one (D, D)
        # block each at this D, added in shard order on the home device
        D = len(fe["b"])
        parts = {i: torch.zeros((D, D), device=mesh[i]) for i in local_shards(mesh)}
        res["feature_reduce_ms"] = timed_ms(lambda: sharded._reduce(mesh, parts), 3)
        del parts

    sp_ = data["sparse"]
    system = sharded.shard_sparse_system(mesh, sp_["h"], sp_["b"], sp_["mask"])
    av("linear", sharded._prepare_sparse_linear(mesh, *system[:5], sp_["x_last"], system[6], 1.0,
                                                "none")[3], sp_["v"])
    learn = sharded.make_sharded_sparse_linear_learn(mesh)
    learned("linear", lambda: learn(*system[:5], sp_["x_last"], *system[5:], 1.0, eps, 256))

    th = sp_["th"]
    tv, tc, hv, hr, bs, ms = sharded.shard_sparse_tiled_system(mesh, th, sp_["b"], sp_["mask"])
    shape = {"ntiles": th.tell.ntiles, "Lt": th.tell.Lt, "panel_rows": data["panel_rows"]}
    for tier in ("highest", "default"):
        av(f"panel_{tier}", sharded._prepare_sparse_panel_local(
            rbf, mesh, tv, tc, hv, hr, sp_["x_last"], ms, SPARSE_GAMMA, 0.0, 1.0, 3,
            backend=backend, precond="none", precision=tier_precision(tier), **shape)[3],
            sp_["v"])
    learn = sharded.make_sharded_sparse_panel_learn(mesh, rbf, 3, backend=backend, **shape)
    learned("panel", lambda: learn(tv, tc, hv, hr, sp_["x_last"], bs, ms, SPARSE_GAMMA, 0.0, 1.0,
                                   eps, DIST_CAPPED_ITERS))
    res["heavy_rows"] = len(th.heavy_idx)
    return res


def dist_worker(spec: dict) -> int:
    """One rank of phase 19 (``--worker``): joins the group, runs
    :func:`dist_runs` on the global mesh and saves what it got."""
    import torch

    from plssvm_sparse_fp22_tpu_torch.parallel import distributed
    from plssvm_sparse_fp22_tpu_torch.parallel.mesh import GlobalMesh, make_mesh

    rank, backend = spec["rank"], spec["backend"]
    check(distributed.initialize_distributed(spec["coordinator"], DIST_RANKS, rank,
                                             backend=backend, timeout=DIST_TIMEOUT / 2),
          "the process group did not form")
    check(distributed.transport() == backend, f"transport {distributed.transport()}")
    dev = torch.device(spec["device"]) if backend == "gloo" else distributed.rank_device()
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = make_mesh(DIST_SHARDS, devices=[dev])
    check(isinstance(mesh, GlobalMesh) and mesh.ranks == (0, 0, 1, 1),
          f"the global mesh's owners are {getattr(mesh, 'ranks', None)}")
    res = dist_runs(mesh, dist_problem(dev, spec, spec["stage"]), spec["stage"], spec["ckpt"])
    res["device"] = str(dev)
    torch.save(res, spec["out"])
    torch.distributed.destroy_process_group()
    return 0


def spawn_workers(spec: dict) -> list:
    """Two worker processes of this script, one per rank, with a rendezvous
    on 127.0.0.1; each under ``DIST_TIMEOUT`` seconds, killed beyond it.
    Their results, in rank order; a worker that fails, hangs or exits
    non-zero fails the phase, its output printed."""
    import socket
    import torch

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    outs = [os.path.join(WORK, f"dist_{spec['backend']}_{spec['stage']}_{r}.pt")
            for r in range(DIST_RANKS)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker",
         json.dumps({**spec, "coordinator": f"127.0.0.1:{port}", "rank": r, "out": outs[r]})],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "LOCAL_WORLD_SIZE": str(DIST_RANKS), "LOCAL_RANK": str(r)})
        for r in range(DIST_RANKS)]
    deadline = time.monotonic() + DIST_TIMEOUT
    logs = []
    try:
        for proc in procs:
            try:
                logs.append(proc.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
            except subprocess.TimeoutExpired:
                logs.append("(killed at the time limit)")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for r, (proc, log) in enumerate(zip(procs, logs)):
        check(proc.returncode == 0, f"phase 19 worker, rank {r} of {spec['stage']} on "
              f"{spec['backend']}, exited with {proc.returncode}:\n{log[-4000:]}")
    return [torch.load(out, weights_only=True) for out in outs]


#: phase 19's A·v beyond the dense ring: (key, what it is)
DIST_REST = (("feature", "feature-sharded rbf"), ("linear", "sparse linear ring"),
             ("panel_highest", "panel ring rbf, highest"),
             ("panel_default", "panel ring rbf, default"))


def phase_distributed(dev, spec: dict = DIST_SPEC):
    """Phase 19: the sharded learns and predict across two processes
    (``parallel/distributed.py``), each holding two logical shards: both on
    ``dev`` over gloo, and, where there are two cards or more, one per card
    over NCCL; every result bitwise the one-process learn's over the same
    four shards.  Returns K2's and the split's launches in the distributed
    dense ring learns and K2's in the panel ring's learn, each summed over
    the ranks."""
    import torch

    from plssvm_sparse_fp22_tpu_torch.ops.matvec import tier_precision
    from plssvm_sparse_fp22_tpu_torch.parallel.mesh import make_local_mesh

    on_card = dev.type == "cuda"
    phase_start = time.perf_counter()
    ckpt = os.path.join(WORK, "dist_cg.npz")
    data = dist_problem(dev, spec)
    one = dist_runs(make_local_mesh(DIST_SHARDS, devices=[dev]), data, "main",
                    os.path.join(WORK, "one_cg.npz"))
    del data
    if on_card:
        torch.cuda.empty_cache()
        # one process runs every panel pair of the 4 shards: p² nP² per A·v
        m = -(-(spec["sparse"][0] - 1) // 256) * 256 // DIST_SHARDS
        pairs = DIST_SHARDS ** 2 * (-(-m // spec["panel_rows"])) ** 2
        for tier in ("highest", "default"):
            want = {f"gram_matvec_rect/{tier_precision(tier)}": pairs}
            check(one[f"panel_{tier}_av_launches"] == want, f"one process: the panel ring's A·v "
                  f"on {tier} launched {one[f'panel_{tier}_av_launches']}, expected {want}")
        iters = one["panel"]["iters"]
        want = {"gram_matvec_rect/exact": pairs * (iters + 1 + iters // 50)}
        check(one["panel"]["launches"] == want, f"one process: the panel ring's learn launched "
              f"{one['panel']['launches']}, expected {want}")
    for name in ("feature", "linear"):
        check(not one[name]["launches"] and not one[f"{name}_av_launches"],
              f"one process: the {name} learn launched {one[name]['launches']}")
    n, f = spec["n"], spec["f"]
    label = cards() if on_card else str(dev)
    print(f"[19 distributed] rbf {n} x {f} float32, implicit ring over {DIST_SHARDS} shards on "
          f"{DIST_RANKS} processes ({label}); feature-sharded rbf {spec['feature'][0]} x "
          f"{spec['feature'][1]}; sparse linear and panel rings (rbf, {spec['panel_rows']}-row "
          f"panels, {one['heavy_rows']} heavy rows) on {spec['sparse'][0]} x {spec['sparse'][1]} "
          f"at {spec['sparse'][2]:.0%}", flush=True)
    setups = [("gloo", f"both ranks on {dev}")]
    if on_card and torch.cuda.device_count() > 1:
        setups.append(("nccl", "one rank per card"))
    launches, panel_launches = {}, {}
    for backend, where in setups:
        base = {"backend": backend, "device": str(dev), "ckpt": ckpt, **spec}
        start = time.perf_counter()
        ranks = spawn_workers({**base, "stage": "main"})
        resumed = spawn_workers({**base, "stage": "resume"})
        wall = time.perf_counter() - start
        tag = f"{backend}, {where}"
        for r, (got, back) in enumerate(zip(ranks, resumed)):
            for key in ("av_highest", "av_default", "predict", "gather_av",
                        *(f"{k}_av" for k, _ in DIST_REST)):
                check(torch.equal(got[key], one[key]), f"{tag}, rank {r}: {key} differs from "
                      "the one-process run's")
            for name in ("highest", "adaptive", "gather", "feature", "linear", "panel"):
                check(got[name]["iters"] == one[name]["iters"]
                      and torch.equal(got[name]["x"], one[name]["x"]),
                      f"{tag}, rank {r}: the {name} learn ({got[name]['iters']} iterations) "
                      f"differs from the one-process one ({one[name]['iters']})")
            check(back["resumed_k"] == one["highest"]["iters"]
                  and torch.equal(back["resumed_x"], one["highest"]["x"]),
                  f"{tag}, rank {r}: the resumed chunked learn ({back['resumed_k']} "
                  "iterations) differs from the one-shot learn")
            if on_card:
                for name in ("highest", "adaptive"):
                    mine = got[name]["launches"]
                    want = {k: v // DIST_RANKS for k, v in one[name]["launches"].items()}
                    check(mine == want, f"{tag}, rank {r}: the {name} learn launched {mine}, "
                          f"expected half the one-process learn's {want}")
                check(got["predict_launches"] == {"gram_matvec_rect/exact": 2},
                      f"{tag}, rank {r}: the predict launched {got['predict_launches']}")
                # each rank runs the panel pairs of its own shards, half of them
                for mine, want in ((got[f"panel_{t}_av_launches"], one[f"panel_{t}_av_launches"])
                                   for t in ("highest", "default")):
                    check(mine == {k: v // DIST_RANKS for k, v in want.items()},
                          f"{tag}, rank {r}: a panel ring A·v launched {mine}, expected half "
                          f"the one-process A·v's {want}")
                mine, want = got["panel"]["launches"], one["panel"]["launches"]
                check(mine == {k: v // DIST_RANKS for k, v in want.items()},
                      f"{tag}, rank {r}: the panel ring learn launched {mine}, expected half the "
                      f"one-process learn's {want}")
            for name in ("feature", "linear"):
                check(not got[name]["launches"] and not got[f"{name}_av_launches"],
                      f"{tag}, rank {r}: the {name} learn launched {got[name]['launches']}")
        if backend == "gloo":
            for name in ("highest", "adaptive"):
                for key in one[name]["launches"]:
                    launches[key] = launches.get(key, 0) + sum(
                        got[name]["launches"][key] for got in ranks)
            for key in one["panel"]["launches"]:
                panel_launches[key] = sum(got["panel"]["launches"][key] for got in ranks)
        hi, ad, ga = (ranks[0][k] for k in ("highest", "adaptive", "gather"))
        print(f"  {tag}: A·v, predict, gather A·v and the {hi['iters']}-, "
              f"{ad['iters']}- ({ad['fast']} fast) and {ga['iters']}-iteration learns "
              "bitwise the one-process run's on both ranks; the chunked learn stopped at "
              f"{DIST_CKPT_AT} and resumed by a fresh pair ends on the one-shot bits; "
              f"launches per rank {hi['launches']} (highest), {ad['launches']} (adaptive)",
              flush=True)
        print(f"[19 distributed] {tag} ({label}): ms per A·v (ranks 0 / 1, one process) "
              + ", ".join(f"{tier} {ranks[0][f'av_ms_{tier}']:.3f} / "
                          f"{ranks[1][f'av_ms_{tier}']:.3f}, {one[f'av_ms_{tier}']:.3f}"
                          for tier in ("highest", "default"))
              + f"; learn s highest {hi['seconds']:.3f} (one process "
              f"{one['highest']['seconds']:.3f}), adaptive {ad['seconds']:.3f} "
              f"({one['adaptive']['seconds']:.3f}), gather ring {ga['seconds']:.3f} "
              f"({one['gather']['seconds']:.3f}); two launches of two workers {wall:.1f} s",
              flush=True)
        fe, li, pa = (ranks[0][k] for k in ("feature", "linear", "panel"))
        print(f"  {tag}: the feature-sharded rbf A·v and {fe['iters']}-iteration learn (capped "
              f"at {DIST_CAPPED_ITERS}), the sparse linear ring's A·v and {li['iters']}-iteration "
              f"learn, the panel ring's A·v on highest and default and {pa['iters']}-iteration "
              f"learn (capped at {DIST_CAPPED_ITERS}) bitwise the one-process run's on both "
              f"ranks; panel ring K2 launches per rank {ranks[0]['panel_highest_av_launches']} "
              f"and {ranks[0]['panel_default_av_launches']} per A·v, {pa['launches']} in the "
              f"learn (one process {one['panel']['launches']})", flush=True)
        print(f"[19 distributed] {tag} ({label}): ms per A·v (ranks 0 / 1, one process) "
              + ", ".join(f"{what} {ranks[0][f'{k}_av_ms']:.3f} / {ranks[1][f'{k}_av_ms']:.3f}, "
                          f"{one[f'{k}_av_ms']:.3f}" for k, what in DIST_REST)
              + "; learn s (one process) " + ", ".join(
                  f"{k} {ranks[0][k]['seconds']:.3f} ({one[k]['seconds']:.3f})"
                  for k in ("feature", "linear", "panel"))
              + ("; of the feature-sharded A·v, the reduction of the partial Grams alone "
                 f"{ranks[0]['feature_reduce_ms']:.3f} / {ranks[1]['feature_reduce_ms']:.3f}, "
                 f"{one['feature_reduce_ms']:.3f}" if on_card else ""), flush=True)
    print(f"[19 distributed] phase 19 took {time.perf_counter() - phase_start:.1f} s", flush=True)
    return launches, panel_launches


#: the strip phase: K1 at D = 131072, f = 256 under one strip's scratch budget
#: and under the default one (4 strips); K1 at D = 524288, bf16cast, where one
#: slab would take 8 GiB
STRIP_D, STRIP_BIG_D, STRIP_F = 131072, 524288, 256
#: stripped against one strip: the partials are added in the same order, so
#: the two agree bit for bit; held to 1e-6 of the result's scale
STRIP_TOL = 1e-6


def strip_compare(name: str, got, want) -> float:
    rel = float((got - want).abs().max()) / float(want.abs().max())
    check(rel <= STRIP_TOL, f"{name}: stripped result {rel:.2e} off one strip")
    return rel


def phase_strips(dev):
    """20. the kernels' scratch in strips (``ops/gram_matvec.SCRATCH_BYTES``):
    K1 rbf at D = 131072, f = 256, at each tier, with one strip (a 512 MiB
    budget) and with the default budget (4 strips), the two held to each
    other (``STRIP_TOL``, and said whether bitwise) and the stripped one to
    the plain version (``TOL``), with their ms; K1 bf16cast at D = 524288,
    whose slab's peak memory must stay within ``SCRATCH_BYTES`` plus the
    output, held to K2 on the same operands (which strips X's rows
    instead), with its ms; K2 (4096 points against 32768 support vectors,
    f 256) and K3 (4096 x 4096 panels, f 4096) in 4 strips against one, at
    each tier.  Every input is drawn on the card from a seeded generator."""
    import torch

    from plssvm_sparse_fp22_tpu_torch.ops import gram_matvec as gm
    from plssvm_sparse_fp22_tpu_torch.types import KernelType

    gen = torch.Generator(device=dev).manual_seed(SEED + 20)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32)

    rbf = KernelType.rbf
    D, f = STRIP_D, STRIP_F
    nb = -(-D // 128)
    one = nb * nb * 128 * 4  # one strip's slab
    S = gm.sym_strip_blocks(nb, gm.SCRATCH_BYTES)
    print(f"[20 strips] K1 rbf ({D}, {f}): one strip ({one >> 20} MiB of slab) against "
          f"{-(-nb // S)} strips of {S} row blocks under SCRATCH_BYTES "
          f"({gm.SCRATCH_BYTES >> 20} MiB)", flush=True)
    X, v = randn(D, f), randn(D)
    kw = {"degree": 3, "gamma": 1.0 / f, "coef0": 1.0}
    out = {}
    for tier in TIERS_ALL:
        whole = gm.make_sym_matvec(rbf, X, tier=tier, scratch_bytes=one, **kw)
        strips = gm.make_sym_matvec(rbf, X, tier=tier, **kw)
        gm.reset_launches()
        got = strips(v)
        check(gm.launches[f"gram_matvec_sym/{tier}"] == -(-nb // S),
              f"K1 {tier} launched {gm.launches[f'gram_matvec_sym/{tier}']} strips")
        want = whole(v)
        rel = strip_compare(f"K1 {tier}", got, want)
        repeats_bitwise(f"K1 {tier} in strips", lambda: strips(v), got)
        plain = gm.gram_matvec_sym_plain(rbf, X, v, tier=tier, operands=gm.tier_operands(tier, X),
                                         **kw)
        err = float((got - plain).abs().max())
        check(err <= TOL * float(plain.abs().max()), f"K1 {tier} in strips disagrees with its "
              f"plain version: {err}")
        ms1, msS = timed_ms(lambda: whole(v), 5), timed_ms(lambda: strips(v), 5)
        out[f"gram_matvec_sym/{tier}"] = {"one_strip_ms": ms1, "strips_ms": msS}
        print(f"  K1 {tier}: one strip {ms1:.3f} ms, {-(-nb // S)} strips {msS:.3f} ms "
              f"({100 * (msS / ms1 - 1):+.2f} %), rel {rel:.1e} ({'bitwise' if torch.equal(got, want) else 'not bitwise'}) vs one "
              f"strip, max|d| {err:.3e} vs plain", flush=True)
    del X, v, whole, strips, plain

    # the case one slab cannot hold: 8 GiB at D = 524288
    D = STRIP_BIG_D
    X, v = randn(D, f), randn(D)
    sq = gm.row_sqnorms(X)
    ops = gm.tier_operands("bf16cast", X)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    got = gm._launch_sym(rbf, "bf16cast", ops, v, sq, 3, 1.0 / f, 1.0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    check(peak <= gm.SCRATCH_BYTES + D * 4, f"K1 at D = {D} held {peak} bytes beyond its inputs, "
          f"more than SCRATCH_BYTES + the output ({gm.SCRATCH_BYTES + D * 4})")
    want = gm.gram_matvec(rbf, X, v, tier="bf16cast", sqx=sq, sqy=sq, operands=(ops, ops), **kw)
    err = float((got - want).abs().max())
    check(err <= TOL * float(want.abs().max()), f"K1 at D = {D} disagrees with K2: {err}")
    ms = timed_ms(lambda: gm._launch_sym(rbf, "bf16cast", ops, v, sq, 3, 1.0 / f, 1.0), 3)
    nbig = -(-D // 128)
    Sb = gm.sym_strip_blocks(nbig)
    out["gram_matvec_sym/bf16cast"]["big"] = {"D": D, "ms": ms, "peak_bytes": peak,
                                              "strips": -(-nbig // Sb)}
    print(f"  K1 bf16cast ({D}, {f}): {-(-nbig // Sb)} strips of {Sb} row blocks, {ms:.3f} ms, "
          f"peak {peak / 2**20:.1f} MiB beyond its inputs (one slab: {nbig * nbig * 512 >> 30} "
          f"GiB), max|d| {err:.3e} vs K2", flush=True)
    del X, v, sq, ops, got, want

    # K2 and K3 in 4 strips of 8 row blocks against one
    Y, a, P = randn(32768, f), randn(32768), randn(4096, f)
    Xi, Xj, vi, vj = randn(4096, 4096), randn(4096, 4096), randn(4096), randn(4096)
    kw3 = {"same": False, "degree": 3, "gamma": 1.0 / 4096, "coef0": 1.0}
    for tier in TIERS_ALL:
        ops2 = (gm.tier_operands(tier, P), gm.tier_operands(tier, Y))
        ops3 = (gm.tier_operands(tier, Xi), gm.tier_operands(tier, Xj))

        def k2(budget=gm.SCRATCH_BYTES):
            return gm.gram_matvec(rbf, P, a, Y=Y, tier=tier, operands=ops2,
                                  scratch_bytes=budget, **kw)

        def k3(budget=gm.SCRATCH_BYTES):
            return torch.cat(gm.pair_gram_contrib(rbf, Xi, Xj, vi, vj, tier=tier, operands=ops3,
                                                  scratch_bytes=budget, **kw3))

        b2, b3 = 8 * 256 * 512, 2 * 8 * 32 * 512  # 8 row blocks a strip
        gm.reset_launches()
        g2, g3 = k2(b2), k3(b3)
        check(gm.launches[f"gram_matvec_rect/{tier}"] == 4
              and gm.launches[f"gram_pair_contrib/{tier}"] == 4,
              f"K2 / K3 {tier} did not run 4 strips: {nonzero(gm.launches)}")
        r2, r3 = strip_compare(f"K2 {tier}", g2, k2()), strip_compare(f"K3 {tier}", g3, k3())
        t2 = (timed_ms(k2, 10), timed_ms(lambda: k2(b2), 10))
        t3 = (timed_ms(k3, 5), timed_ms(lambda: k3(b3), 5))
        out[f"gram_matvec_rect/{tier}"] = {"one_strip_ms": t2[0], "strips_ms": t2[1]}
        out[f"gram_pair_contrib/{tier}"] = {"one_strip_ms": t3[0], "strips_ms": t3[1]}
        print(f"  K2 {tier}: one strip {t2[0]:.3f} ms, 4 strips {t2[1]:.3f} ms (rel {r2:.1e}); "
              f"K3 {tier}: one strip {t3[0]:.3f} ms, 4 strips {t3[1]:.3f} ms (rel {r3:.1e})",
              flush=True)
    return out


#: the tools' arguments in the smoke: small sizes, the card
TOOLS = (("gpu_validate", []),
         ("profile_cg", ["--sizes", "4096x256", "--reps", "16", "--caps", "16,64",
                         "--trials", "1"]),
         ("precision_study", ["--n", "2048", "--f", "128", "--caps", "16,48", "--trials", "1"]),
         ("comms_check", ["--rows", "1024"]),
         ("scaling_bench", ["--logical", "--rows-per-dev", "2048", "--caps", "4,16",
                            "--grow-to", "0"]))


def phase_tools():
    """21. the port's on-chip tools (``plssvm_sparse_fp22_tpu_torch/scripts``)
    at small sizes on the card, in this process (``comms_check`` starts its
    two ranks): each must return its JSON, ``gpu_validate`` with no failed
    check; prints one line per tool."""
    import importlib

    for name, argv in TOOLS:
        mod = importlib.import_module(f"plssvm_sparse_fp22_tpu_torch.scripts.{name}")
        buf = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                res = mod.main(argv)
        except Exception as exc:
            sys.stdout.write(buf.getvalue()[-4000:])
            raise SmokeError(f"tool {name} failed: {type(exc).__name__}: {exc}") from exc
        lines = buf.getvalue().strip().splitlines()
        check(bool(lines) and json.loads(lines[-1]) == json.loads(json.dumps(res)),
              f"tool {name} did not print its JSON last")
        if name == "gpu_validate":
            check(res["failures"] == 0, f"gpu_validate failed {res['failed']}")
            summary = (f"{res['checks']} checks passed, max rel err by tier "
                       f"{ {k: float(f'{v:.2e}') for k, v in res['max_rel_err_by_tier'].items()} }")
        elif name == "profile_cg":
            shape = res["shapes"][0]
            summary = (f"CG skeleton {1e3 / shape['skeleton_it_per_s']:.3f} ms/it; "
                       + ", ".join(f"{t} {r['cg_iteration_ms']:.3f} ms/it idle "
                                   f"{r['idle_share']:.3f}" for t, r in shape["tiers"].items()))
        elif name == "precision_study":
            summary = ", ".join(f"{r['tier']}/{r['kernel']} {r['iterations']} it"
                                + (f" (fast {r['fast_iterations']})" if "fast_iterations" in r
                                   else "") for r in res["results"])
        elif name == "comms_check":
            summary = (f"{res['transport']}, within 2x: {res['agreement_within_2x']}, ratios "
                       + ", ".join(f"{k} {c['ratio_measured_over_predicted']:.2f}"
                                   for k, c in res["cases"].items()))
        else:
            summary = ", ".join(f"p={p} {r:.1f} it/s" for p, r in res["iters_per_s"].items())
        print(f"[21 tools] {name} ({time.perf_counter() - t0:.1f} s): {summary}", flush=True)


#: phase 22: the float64 CLI learn's size, beyond the K-cache budget at
#: float64 (K 12.5 GiB against 8 GiB: 32768 points is the last that caches)
F64_N, F64_TEST, F64_F = 40960, 4096, 256
#: (b) and (c): two float64 A·v of one system, through different products
#: (the blocked implicit against the cached K; the plain panel pairs against
#: the gram tier's assembled K), differ only in the order of float64 sums
F64_AV_TOL = 1e-12
#: (d): the float64 rbf learn at eps 1e-10 against the direct float64 solve:
#: a CPU rehearsal of this check (torch backend, forced implicit, seeds
#: SEED + 22 ... SEED + 26) put the decision values 2.7e-8 to 4.8e-8 of
#: their scale from the solve; the bound is ten times the largest
F64_REFERENCE_TOL = 5e-7
#: (e): the default linear learn's data, two blobs at -0.2 and +0.2: CG
#: stops at eps 1e-6 near enough to the solution that the training
#: accuracies compare (a CPU rehearsal: 86.35 % against the solve's 86.38 %)
LINEAR_N, LINEAR_F = 4096, 32


@contextlib.contextmanager
def captured_matvecs():
    """The A·v of every CG solve the sparse learns run, in order: each
    learn's operator, to be held against another's after the learns."""
    from plssvm_sparse_fp22_tpu_torch.models import sparse_learn as learns

    seen, solve = [], learns.cg_solve

    def keep(matvec, *args, **kw):
        seen.append(matvec)
        return solve(matvec, *args, **kw)

    learns.cg_solve = keep
    try:
        yield seen
    finally:
        learns.cg_solve = solve


def direct_solve(X, y, kernel_matrix):
    """The direct float64 solve of the full LS-SVM system [[K + I, 1],
    [1^T, 0]] [alpha; b] = [y; 0] (C = 1): ``(alpha, b)``."""
    n = len(y)
    M = np.zeros((n + 1, n + 1))
    M[:n, :n] = kernel_matrix(X, X) + np.eye(n)
    M[:n, n] = M[n, :n] = 1.0
    sol = np.linalg.solve(M, np.concatenate([y, [0.0]]))
    return sol[:n], sol[n]


def float64_clis():
    """22 (a): the train and predict CLIs at their default precision,
    float64, on two blobs of ``F64_N`` x ``F64_F`` (rbf, ``implicit``: the
    blocked float64 product), no kernel launched; each CLI's split.  Returns
    the blobs."""
    import torch

    from plssvm_sparse_fp22_tpu_torch.cli import train as train_cli
    from plssvm_sparse_fp22_tpu_torch.cli.predict import main as predict_main
    from plssvm_sparse_fp22_tpu_torch.ops import gram_matvec as gm
    from plssvm_sparse_fp22_tpu_torch.utils.timing import Timings

    rng = np.random.default_rng(SEED + 22)
    f = F64_F
    X, y = two_blobs(F64_N + F64_TEST, f, rng)
    train, test = os.path.join(WORK, "f64.libsvm"), os.path.join(WORK, "f64.test.libsvm")
    model, out = os.path.join(WORK, "f64.model"), os.path.join(WORK, "f64.predict")
    write_libsvm(train, X[:F64_N], y[:F64_N])
    write_libsvm(test, X[F64_N:], y[F64_N:])
    with recording_csvms(train_cli) as made:
        gm.reset_launches()
        t0 = time.perf_counter()
        rc, log = run_cli(train_cli.main, ["-t", "2", "-e", "1e-6", "-b", "cuda",
                                           "-p", "gpu_nvidia", train, model], timings=Timings())
        train_s = time.perf_counter() - t0
        counts = nonzero(gm.launches)
    check(rc == 0, f"(a) the float64 train CLI returned {rc}")
    info = made[-1].last_cg_info
    check(made[-1].dtype == torch.float64 and info["mode"] == "implicit",
          f"(a) the train CLI ran {made[-1].dtype} in mode {info['mode']}, not float64 implicit")
    check(info["delta"] <= 1e-12 * info["delta0"], f"(a) the learn stopped at residual "
          f"{info['delta']:.3e} > eps^2 delta0 = {1e-12 * info['delta0']:.3e}")
    learn_line = f"{learn_split(made[-1], log)}; {cli_split(made[-1].timings)}"
    del made
    gm.reset_launches()
    t0 = time.perf_counter()
    timings = Timings()
    rc, plog = run_cli(predict_main, ["-b", "cuda", "-p", "gpu_nvidia", test, model, out],
                       timings=timings)
    predict_s = time.perf_counter() - t0
    counts.update(nonzero(gm.launches))
    m = re.search(r"Accuracy = ([0-9.]+)%", plog)
    check(rc == 0 and m is not None and float(m.group(1)) >= 95.0,
          f"(a) the float64 predict CLI: rc {rc}, accuracy {m and m.group(1)}% (bar 95 %)")
    check(not counts, f"(a) a float64 learn or predict launched a kernel: {counts}")
    print(f"[22 float64] (a) train CLI without --use_float, rbf {F64_N} x {f}: mode implicit "
          f"(blocked float64 product), {info['iterations']} CG iterations, residual "
          f"{info['delta']!r} of delta0 {info['delta0']!r}, {train_s:.1f} s; predict CLI "
          f"{F64_TEST} points {predict_s:.1f} s, accuracy {m.group(1)}%; no kernel launched; "
          f"train {learn_line}; model sha256 {file_digest(model)}; predict {cli_split(timings)}; "
          f"predictions sha256 {file_digest(out)}", flush=True)
    return X, y


def phase_float64(dev):
    """22. float64 on the card: every learn routes around the kernels, which
    are float32 only, as the JAX package routes float64 around Pallas.
    (a) the train and predict CLIs without ``--use_float`` at rbf 40960 x
    256 (``implicit``: the blocked float64 product), (b) its A·v against
    the float64 cached K, (c) the sparse panel tier at float64 on phase 8's
    set (plain pairs) against the gram tier, (d) phase 6's reference check
    at float64, (e) the default float32 ``linear`` learn on the exact tier
    at the float64 solve's accuracy.  No kernel may launch in (a)-(d)."""
    import scipy.sparse as sp
    import torch

    from plssvm_sparse_fp22_tpu_torch import make_csvm
    from plssvm_sparse_fp22_tpu_torch.cli import train as train_cli
    from plssvm_sparse_fp22_tpu_torch.cli.predict import main as predict_main
    from plssvm_sparse_fp22_tpu_torch.io.libsvm import ParsedData
    from plssvm_sparse_fp22_tpu_torch.ops import gram_matvec as gm
    from plssvm_sparse_fp22_tpu_torch.ops.matvec import build_operator
    from plssvm_sparse_fp22_tpu_torch.params import Parameter
    from plssvm_sparse_fp22_tpu_torch.types import BackendType, KernelType

    smi = cards()
    t_phase = time.perf_counter()
    rbf, f = KernelType.rbf, F64_F
    X, y = float64_clis()

    # (b) that system's float64 A·v, blocked implicit against the cached K
    Xd, q, mask, QA, ci, b = dense_system(dev, X[:F64_N], y[:F64_N], 1.0 / f, dtype=np.float64)
    v = torch.tensor(np.random.default_rng(SEED + 221).normal(size=len(b)),
                     dtype=torch.float64, device=dev) * mask
    gm.reset_launches()
    op = build_operator(rbf, Xd, q, mask, QA, ci, gamma=1.0 / f, backend=BackendType.cuda)
    check(op.mode == "implicit", f"(b) float64 at {F64_N} took mode {op.mode}")
    got = op.matvec(v)
    implicit_ms = timed_ms(lambda: op.matvec(v), 5)
    check(not any(gm.launches.values()), f"(b) the blocked product launched "
          f"{nonzero(gm.launches)}")
    torch.cuda.reset_peak_memory_stats(dev)
    with environ(PLSSVM_K_CACHE_BYTES=str(16 * 1024**3)):
        cached = build_operator(rbf, Xd, q, mask, QA, ci, gamma=1.0 / f,
                                backend=BackendType.cuda)
    check(cached.mode == "cached", f"(b) a 16 GiB budget took mode {cached.mode}")
    want = cached.matvec(v)
    cached_ms = timed_ms(lambda: cached.matvec(v), 5)
    peak = torch.cuda.max_memory_allocated(dev) / 1024**3
    err = float((got - want).abs().max()) / float(want.abs().max())
    check(err <= F64_AV_TOL, f"(b) the blocked float64 A·v is {err:.2e} of the scale off the "
          f"cached one (tol {F64_AV_TOL:g})")
    print(f"[22 float64] (b) rbf {F64_N} x {f} float64 A·v ({smi}): blocked implicit "
          f"{implicit_ms:.3f} ms, within {err:.2e} of the cached K's ({cached_ms:.3f} ms; "
          f"K {len(b) ** 2 * 8 / 1024**3:.1f} GiB, peak {peak:.1f} GiB while built)", flush=True)
    del op, cached, got, want, Xd, q, mask, b, v
    torch.cuda.empty_cache()

    # (c) the sparse panel tier at float64 (plain pairs) against the gram tier
    # float64 values, as the CLIs parse them: the gram tier's q from a float32
    # CSR would be summed in float32 by scipy, as the JAX package's would be
    csr, ys = main_sparse_set()
    csr = csr.astype(np.float64)
    n = SPARSE_N
    runs = {}
    for name, env in (("implicit", {"PLSSVM_SPARSE_MODE": "implicit",
                                     "PLSSVM_K_CACHE_BYTES": str(PANEL_BUDGET)}),
                      ("gram", {"PLSSVM_SPARSE_MODE": "gram"})):
        with environ(**env), captured_matvecs() as seen:
            gm.reset_launches()
            svm, learn_s = sparse_learn(csr[:n], ys[:n], rbf, eps=1e-6, max_iter=500,
                                        dtype=np.float64)
            runs[name] = (svm, learn_s, seen[-1], nonzero(gm.launches))
    svm, learn_s, panel_mv, counts = runs["implicit"]
    info = svm.last_cg_info
    check(info["mode"] == "sparse_implicit" and runs["gram"][0].last_cg_info["mode"]
          == "sparse_gram", f"(c) the tiers ran {info['mode']} and "
          f"{runs['gram'][0].last_cg_info['mode']}")
    check(not counts, f"(c) the float64 panel tier launched {counts}")
    check(info["delta"] <= 1e-12 * info["delta0"], f"(c) the panel learn did not converge: "
          f"{info['iterations']} iterations, residual {info['delta'] / info['delta0']:.2e}")
    D = -(-(n - 1) // 256) * 256
    vs = torch.tensor(np.random.default_rng(SEED + 222).normal(size=D), dtype=torch.float64,
                      device=dev)
    vs[n - 1:] = 0.0
    got, want = panel_mv(vs), runs["gram"][2](vs)
    err = float((got - want).abs().max()) / float(want.abs().max())
    check(err <= F64_AV_TOL, f"(c) the panel tier's float64 A·v is {err:.2e} of the scale off "
          f"the gram tier's (tol {F64_AV_TOL:g})")
    panel_ms = timed_ms(lambda: panel_mv(vs), 3)
    test = ParsedData(csr=csr[n:], values=ys[n:])
    acc = 100.0 * float(np.mean(np.sign(svm.predict_parsed(test)) == ys[n:]))
    check(acc >= SPARSE_ACCURACY, f"(c) the float64 panel tier's accuracy {acc:.2f}% < "
          f"{SPARSE_ACCURACY}%")
    print(f"[22 float64] (c) sparse panel tier, rbf {n} x {SPARSE_F} at 1 %, float64, "
          f"PLSSVM_K_CACHE_BYTES {PANEL_BUDGET} ({smi}): plain pairs, no kernel launched, "
          f"{info['iterations']} CG iterations in {learn_s:.2f} s (gram tier "
          f"{runs['gram'][0].last_cg_info['iterations']} in {runs['gram'][1]:.2f} s), A·v "
          f"{panel_ms:.3f} ms within {err:.2e} of the gram tier's, accuracy {acc:.2f}%",
          flush=True)
    del runs, svm, panel_mv, got, want

    # (d) phase 6's reference check at float64, forced to implicit
    rng_d = np.random.default_rng(SEED + 23)
    n, fd, gamma = 300, 16, 1.0 / 16
    Xr, yr = two_blobs(n + 100, fd, rng_d)
    P, Xr, yr = Xr[n:], Xr[:n], yr[:n]
    p = Parameter(kernel=rbf, gamma=gamma, epsilon=1e-10, max_iter=500, dtype=np.float64,
                  backend=BackendType.cuda, print_info=False)
    p.data = ParsedData(csr=sp.csr_matrix(Xr), values=yr, _dense=Xr)
    p.values = yr
    with environ(PLSSVM_K_CACHE_BYTES="1000"):
        svm = make_csvm(p)
        gm.reset_launches()
        svm.learn()
        dec = svm.predict(P)
    check(svm.last_cg_info["mode"] == "implicit" and not any(gm.launches.values()),
          f"(d) mode {svm.last_cg_info['mode']}, launches {nonzero(gm.launches)}")

    def rbf_k(A, B):
        d = (A * A).sum(1)[:, None] + (B * B).sum(1)[None, :] - 2.0 * A @ B.T
        return np.exp(-gamma * np.maximum(d, 0.0))

    alpha, bias = direct_solve(Xr, yr, rbf_k)
    ref = rbf_k(P, Xr) @ alpha + bias
    err = float(np.abs(dec - ref).max() / np.abs(ref).max())
    check(np.all(np.isfinite(dec)) and err <= F64_REFERENCE_TOL,
          f"(d) the float64 learn is {err:.2e} of the scale off the direct solve "
          f"(tol {F64_REFERENCE_TOL:g})")
    print(f"[22 float64] (d) rbf {n} x {fd} float64 cuda learn, implicit, eps 1e-10 "
          f"({svm.last_cg_info['iterations']} CG iterations): decision values within "
          f"{err:.2e} of a direct float64 solve (tol {F64_REFERENCE_TOL:g})", flush=True)

    # (e) the default float32 linear learn: the exact tier, not the bf16 plan
    check("PLSSVM_MATMUL_PRECISION" not in os.environ,
          "(e) PLSSVM_MATMUL_PRECISION is set: the default linear learn cannot run")
    rng_e = np.random.default_rng(SEED + 24)
    half = LINEAR_N // 2
    Xl = np.concatenate([rng_e.normal(-0.2, 1.0, (half, LINEAR_F)),
                         rng_e.normal(0.2, 1.0, (LINEAR_N - half, LINEAR_F))]).astype(np.float32)
    yl = np.concatenate([-np.ones(half), np.ones(LINEAR_N - half)])
    lin_file, lin_model = os.path.join(WORK, "linear.libsvm"), os.path.join(WORK, "lin.model")
    out = os.path.join(WORK, "lin.predict")
    write_libsvm(lin_file, Xl, yl)
    with recording_csvms(train_cli) as made:
        gm.reset_preparations()
        rc, _ = run_cli(train_cli.main, ["-t", "0", "-e", "1e-6", "--use_float", "-b", "cuda",
                                         "-p", "gpu_nvidia", lin_file, lin_model])
        preps = dict(gm.preparations)
    check(rc == 0 and made[-1].last_cg_info["mode"] == "linear",
          f"(e) the linear train CLI: rc {rc}, mode {made[-1].last_cg_info['mode']}")
    check(preps["bf16x3"] == preps["bf16cast"] == 0,
          f"(e) the default linear learn prepared bf16 operands: {preps}")
    iters = made[-1].last_cg_info["iterations"]
    del made
    rc, plog = run_cli(predict_main, ["--use_float", "-b", "cuda", "-p", "gpu_nvidia",
                                      lin_file, lin_model, out])
    m = re.search(r"Accuracy = ([0-9.]+)%", plog)
    Xl64 = Xl.astype(np.float64)
    alpha, bias = direct_solve(Xl64, yl, lambda A, B: A @ B.T)
    direct = 100.0 * float(np.mean(np.sign(Xl64 @ (Xl64.T @ alpha) + bias) == yl))
    check(rc == 0 and m is not None and float(m.group(1)) >= direct - 1.0,
          f"(e) the default linear learn's accuracy {m and m.group(1)}% against the float64 "
          f"solve's {direct:.2f}% less 1")
    print(f"[22 float64] (e) default linear learn, float32 {LINEAR_N} x {LINEAR_F}: fixed "
          f"exact tier (no bf16 operand prepared), {iters} CG iterations, training accuracy "
          f"{m.group(1)}% against the direct float64 solve's {direct:.2f}%", flush=True)
    print(f"[22 float64] phase {time.perf_counter() - t_phase:.1f} s", flush=True)


def timed_solve(op, b, mask) -> float:
    """Seconds of one CG solve of ``op`` to eps 1e-6, synchronised."""
    import torch

    from plssvm_sparse_fp22_tpu_torch.solver.cg import cg_solve

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cg_solve(op.matvec, b, mask, 1e-6, 500)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


#: phase 23's shapes: the JAX headline (``bench.py:532``) and the main path's
LOOP_SHAPES = ((4096, 256), (32768, 256))
#: phase 23's slope caps and its profiled solve's iterations
LOOP_CAPS = (20, 120)


def phase_cg_loop(dev):
    """23. The CG loop on the device at rbf 4096 x 256 and 32768 x 256
    (``scripts/profile_cg.system``), each tier: CG it/s by the two-cap
    slope on the chunk graphs and in the eager masked loop, the idle share
    of a pinned solve under ``torch.profiler`` (``profile_cg.idle_share``)
    with its host reads, slots issued and steps executed, the device µs of
    a chunk launched after the stop (``profile_cg.stopped_chunk_us``: one
    skipped slot), and the chunk-graph
    solve's ``x``, ``delta`` and ``k`` bit for bit the eager loop's,
    pinned across the refresh at 49, to eps 1e-6 and resumed from 37."""
    import torch

    from plssvm_sparse_fp22_tpu_torch.ops import gram_matvec as gm
    from plssvm_sparse_fp22_tpu_torch.ops.matvec import build_operator
    from plssvm_sparse_fp22_tpu_torch.scripts.profile_cg import idle_share, system
    from plssvm_sparse_fp22_tpu_torch.solver import cg as cg_loop
    from plssvm_sparse_fp22_tpu_torch.types import BackendType, KernelType

    smi = subprocess.run(["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    driver = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    c = cg_loop.CHUNK
    print(f"[23 cg loop] torch {torch.__version__}, CUDA {torch.version.cuda}, driver {driver}; "
          f"chunk graphs of c = {c} slots", flush=True)
    out = {}
    for D, f in LOOP_SHAPES:
        X, q, mask, QA, ci = system(dev, D, f)
        b = torch.tensor(np.random.default_rng(D).normal(size=D), dtype=torch.float32,
                         device=dev)
        for tier in TIERS_ALL:
            tag = f"[{D} x {f} {tier}]"
            k1_name = f"gram_matvec_sym/{tier}"
            op = build_operator(KernelType.rbf, X, q, mask, QA, ci, gamma=1.0 / f,
                                mode="implicit", backend=BackendType.cuda, precision=tier)
            # a solve to eps 1e-6 on the fresh operator (its first step eager,
            # the loop's one capture), again on its chunk graph, and eagerly
            cg_loop.reset_counts()
            first_ms = 1e3 * timed_solve(op, b, mask)
            check(cg_loop.counts["captures"] == 1,
                  f"{tag} the first solve captured {cg_loop.counts['captures']} graphs, not 1")
            again_ms = 1e3 * timed_solve(op, b, mask)
            with cg_loop.eager_loop():
                eager_ms = 1e3 * timed_solve(op, b, mask)
            start = cg_loop.cg_init(op.matvec, b, mask)
            with cg_loop.eager_loop():
                at37 = cg_loop.cg_run(op.matvec, b, mask, 0.0, 37, start)
            solves = {}
            for label, eps, imax, state in (("pinned 60", 0.0, 60, None),
                                            ("eps 1e-6", 1e-6, 500, None),
                                            ("from 37", 0.0, 120, at37)):
                k0 = 0 if state is None else state.k

                def solve():
                    if state is None:
                        res = cg_loop.cg_solve(op.matvec, b, mask, eps, imax)
                        return res.iterations, res.x, res.delta
                    res = cg_loop.cg_run(op.matvec, b, mask, eps, imax, state)
                    return res.k, res.x, res.delta

                cg_loop.reset_counts()
                gm.reset_launches()
                k, x, delta = solve()
                counts, k1 = dict(cg_loop.counts), gm.launches[k1_name]
                check(cg_loop.last_run["graph"] and counts["replays"] > 0
                      and counts["captures"] == 0,
                      f"{tag} {label}: replays {counts['replays']}, captures "
                      f"{counts['captures']} (want replays of the loop's one graph)")
                ran = counts["executed"]
                refreshes = k // 50 - k0 // 50
                check(ran == k - k0, f"{tag} {label}: {ran} steps executed for k {k0} -> {k}")
                # one K1 per step executed, one for the initial residual, one
                # more per refresh (a capture launches none, a skipped slot none)
                check(k1 == ran + (state is None) + refreshes,
                      f"{tag} {label}: K1 counted {k1} for {ran} steps executed and "
                      f"{refreshes} refreshes")
                check(counts["host_reads"] <= math.ceil(ran / c) + 2,
                      f"{tag} {label}: {counts['host_reads']} host reads for {ran} steps, "
                      f"c = {c}")
                gm.reset_launches()
                with cg_loop.eager_loop():
                    k_e, x_e, delta_e = solve()
                check(gm.launches[k1_name] == k1,
                      f"{tag} {label}: the eager loop launched K1 {gm.launches[k1_name]} "
                      f"times, the chunk graphs {k1}")
                check(k == k_e and torch.equal(x, x_e) and torch.equal(delta, delta_e),
                      f"{tag} {label}: the chunk-graph solve (k {k}) is not bitwise the eager "
                      f"loop's (k {k_e})")
                solves[label] = {"iterations": k - k0, "host_reads": counts["host_reads"],
                                 "slots_issued": counts["steps"], "steps_executed": ran}
            rate = pinned_cg_rate(op, b, mask, LOOP_CAPS)
            with cg_loop.eager_loop():
                eager_rate = pinned_cg_rate(op, b, mask, LOOP_CAPS)
            prof = idle_share(dev, op.matvec, mask, D, LOOP_CAPS[1])
            idle, stopped = prof["idle_share"], prof["stopped_chunk_us"]
            # the profiled solve's device time per iteration against the
            # slope's iteration, which leaves out the set-up and the tracing
            busy = None if idle is None else prof["device_busy_ms"] / LOOP_CAPS[1]
            out[f"{D}x{f}/{tier}"] = {"it_per_s": rate, "eager_it_per_s": eager_rate, **prof,
                                     "solves": solves,
                                     "solve_ms": (first_ms, again_ms, eager_ms)}
            per_solve = "; ".join(f"{label}: {v['iterations']} iterations, {v['host_reads']} "
                                  f"host reads, {v['slots_issued']} slots issued, "
                                  f"{v['steps_executed']} steps executed"
                                  for label, v in solves.items())
            print(f"[23 cg loop] rbf {D} x {f} {tier:8s}: {rate:.1f} CG it/s on the chunk "
                  f"graphs, {eager_rate:.1f} in the eager loop (slope {LOOP_CAPS[0]} -> "
                  f"{LOOP_CAPS[1]}); idle share {'n/a' if idle is None else f'{idle:.3f}'} over "
                  f"a pinned {LOOP_CAPS[1]}-iteration solve ({prof['cg_wall_ms']:.2f} ms wall, "
                  f"{prof['host_reads']} host reads, {prof['slots_issued']} slots issued), "
                  f"device busy {'n/a' if busy is None else f'{busy:.4f}'} ms per iteration, "
                  f"{'n/a' if busy is None else f'{busy * rate / 1e3:.3f}'} of the slope's; "
                  f"a chunk after the stop (one skipped slot) "
                  f"{'n/a' if stopped is None else f'{stopped:.3f}'} us; "
                  f"{per_solve}; solve to 1e-6 {first_ms:.2f} ms on the fresh operator "
                  f"(warm-up and capture), {again_ms:.2f} ms on its chunk graph, "
                  f"{eager_ms:.2f} ms eager; bitwise the eager loop's in all three", flush=True)
    return out


#: phase 23 (b)'s layout: rbf, float32, the JAX headline's 4096 CG unknowns
#: (``bench.py:532``)
RELEARN_N, RELEARN_F = 4097, 256


def second_learns():
    """23 (b): ``learn()`` on fresh ``CSVM``s of one layout (rbf 4096 x 256,
    float32, ``cuda``, eps 1e-6), with the default plan and on ``highest``:
    after :func:`~plssvm_sparse_fp22_tpu_torch.solver.cg.clear_graphs` a
    first learn captures its step graphs; a second learn of the same data
    captures none and is bit for bit the first (alphas, bias, iterations);
    one at another ``cost`` and one at eps 1e-8 capture only loops the
    layout has not run (the plan's escalation; on ``highest`` none: the
    chunk holds the refresh step), their repeats none, and no learn of the
    layout captures a graph twice; one at another ``gamma`` captures its
    own.  Prints each learn's wall ms and captures."""
    import scipy.sparse as sp
    import torch

    from plssvm_sparse_fp22_tpu_torch import make_csvm
    from plssvm_sparse_fp22_tpu_torch.io.libsvm import ParsedData
    from plssvm_sparse_fp22_tpu_torch.params import Parameter
    from plssvm_sparse_fp22_tpu_torch.solver import cg as cg_loop
    from plssvm_sparse_fp22_tpu_torch.types import BackendType, KernelType

    f = RELEARN_F
    X, y = two_blobs(RELEARN_N, f, np.random.default_rng(SEED + 231))
    csr = sp.csr_matrix(X)

    def kept_graphs() -> int:
        """Chunk graphs of the kept layout; one per loop it has run."""
        kept = cg_loop._LAYOUTS.get(torch.device("cuda", 0))
        return 0 if kept is None else sum(g.handles is not None for g in kept.graphs.values())

    def learn(gamma=1.0 / f, cost=1.0, eps=1e-6):
        p = Parameter(kernel=KernelType.rbf, gamma=gamma, cost=cost, epsilon=eps,
                      max_iter=1000, dtype=np.float32, backend=BackendType.cuda,
                      print_info=False)
        p.data = ParsedData(csr=csr, values=y, _dense=X)
        p.values = y
        svm = make_csvm(p)
        before, graphs = cg_loop.counts["captures"], kept_graphs()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svm.learn()  # ends on a device-to-host copy of the alphas
        ms = (time.perf_counter() - t0) * 1e3
        captured = cg_loop.counts["captures"] - before
        # on the first learn's layout a capture is a loop not run before
        check(gamma != 1.0 / f or not graphs or captured == kept_graphs() - graphs,
              f"(b) a learn of one layout captured {captured} graphs for "
              f"{kept_graphs() - graphs} new loops: a graph was captured twice")
        return svm, ms, captured

    out = {}
    for precision in ("", "highest"):
        name = precision or "plan"
        with environ(PLSSVM_MATMUL_PRECISION=precision):
            cg_loop.clear_graphs()
            runs = {"first": learn(), "second": learn(), "cost 2": learn(cost=2.0),
                    "cost 2 again": learn(cost=2.0), "eps 1e-8": learn(eps=1e-8),
                    "eps 1e-8 again": learn(eps=1e-8), "gamma 2/f": learn(gamma=2.0 / f)}
        first, second = runs["first"][0], runs["second"][0]
        check(runs["first"][2] > 0, f"(b) {name}: the first learn of the layout captured no "
              "graph")
        again = ("second", "cost 2 again", "eps 1e-8 again")
        for what in again + (("cost 2", "eps 1e-8") if precision else ()):
            check(runs[what][2] == 0, f"(b) {name}: the {what} learn of one layout captured "
                  f"{runs[what][2]} graphs")
        check(runs["gamma 2/f"][2] > 0, f"(b) {name}: a learn at another gamma captured none")
        check(np.array_equal(first.alphas, second.alphas) and first.bias_ == second.bias_
              and first.last_cg_info["iterations"] == second.last_cg_info["iterations"],
              f"(b) {name}: the second learn of one layout is not bitwise the first")
        out[name] = {k: (ms, caps, svm.last_cg_info["iterations"])
                     for k, (svm, ms, caps) in runs.items()}
        print(f"[23 cg loop] (b) learn() to eps 1e-6 on fresh CSVMs, rbf {RELEARN_N - 1} x {f} "
              f"float32, {name}: " + "; ".join(
                  f"{k} {ms:.2f} ms ({iters} iterations, {caps} captures)"
                  for k, (ms, caps, iters) in out[name].items())
              + "; the second bitwise the first", flush=True)
    return out


#: phase 24: the benchmark's rcv1 configuration, made by its generator at
#: this seed on the card
GRAM_CONFIG = "lssvm_bench/configs/rcv1-rbf.json"
GRAM_SEED = 12345
#: thresholds the modelled and measured Gram times are compared at
GRAM_THRESHOLDS = (64, 256, 512, 1024, 2048, 4096, 1 << 40)
#: the slab widths the product's rate is taken between
GRAM_SLAB_WIDTHS = (64, 512)
#: the thresholds the pair kernel's rate is taken between: the columns
#: whose counts lie between them, where the split falls at rcv1's D
GRAM_PAIR_THRESHOLDS = (1024, 4096)


def phase_sparse_gram(dev):
    """24. The sparse gram tier's Gram from the CSR rows
    (``ops/sparse_gram.py``, the pair kernel ``csrc/sparse_gram.cu``) at
    rcv1's shape: the split at ``split_threshold``, the kernel path twice
    (the same bits), the plain version on the card (the same slab product,
    so the same bits), sampled rows against the float64 Gram and the dense
    float32 product ``Xd @ Xd.T``, ``sq`` against G's diagonal; ms of the
    split, the slab's product, the pair kernel, the whole Gram, the plain
    version and ``Xd @ Xd.T`` (``library_ms``), beside the bound (the
    Gram's write, or the sum over all columns of count² multiply-adds at
    the float32 peak, whichever is larger; the slab's own, its product's
    flops or the write, beside it); the split's two rates measured (the
    slab's product between two widths, the pairs between two thresholds)
    and the modelled ms beside the measured ones at several thresholds;
    then the products with the last point (``rows_matvec``, the kernel
    ``sparse_rows_matvec``): twice the same bits, bitwise the plain
    version, within float32 rounding of scipy's float64 products, ms beside
    its bound (the entries' and ``q``'s bytes) and the host's scipy
    products it replaced; then two learns of the gram tier, the launches
    counted from zero before each: one of each kernel.  Returns the pair
    kernel's record, its launches those of the last learn, with the
    products' record under ``rows_matvec``."""
    import torch

    from lssvm_bench.data import sparse_docs
    from plssvm_sparse_fp22_tpu_torch.constants import (SPARSE_GRAM_PAIR_RATE,
                                                        SPARSE_GRAM_SLAB_RATE)
    from plssvm_sparse_fp22_tpu_torch.io.libsvm import ParsedData
    from plssvm_sparse_fp22_tpu_torch.models import make_csvm
    from plssvm_sparse_fp22_tpu_torch.ops import sparse_gram as sg
    from plssvm_sparse_fp22_tpu_torch.params import Parameter
    from plssvm_sparse_fp22_tpu_torch.types import BackendType, KernelType

    with open(os.path.join(ROOT, GRAM_CONFIG)) as fh:
        cfg = json.load(fh)
    data = sparse_docs.make(cfg, GRAM_SEED, dev)
    n, f = data.csr.shape
    dept = n - 1
    D = -(-dept // 256) * 256
    rows = data.csr[:dept]
    counts = torch.tensor(np.diff(rows.indptr), dtype=torch.int64, device=dev)
    cols = torch.tensor(rows.indices, dtype=torch.int64, device=dev)
    vals = torch.tensor(rows.data, dtype=torch.float32, device=dev)

    def split(threshold=None):
        return sg.split_rows(counts, cols, vals, D, f, threshold=threshold)

    sp_ = split()
    light_rows = int((sp_.rptr[1:] > sp_.rptr[:-1]).sum())
    print(f"[24 sparse gram] rcv1 {dept} x {f} (seed {GRAM_SEED}), {rows.nnz} entries, D {D}: "
          f"T {sp_.threshold}, {sp_.heavy} heavy columns (slab {tuple(sp_.slab.shape)}), "
          f"{sp_.light_pairs} light pairs, {sp_.rcol.numel()} light entries in {light_rows} "
          "rows", flush=True)
    sg.reset_launches()
    G, sq = sg.gram_from_rows(sp_)
    torch.cuda.synchronize()
    check(sg.launches["sparse_gram_pairs"] == 1, f"launches {sg.launches}")
    G2, _ = sg.gram_from_rows(split())
    check(torch.equal(G, G2), "two calls of the Gram from the rows differ")
    del G2
    check(torch.equal(sq, torch.diagonal(G)), "sq is not G's diagonal")
    check(torch.equal(G, G.T), "G is not symmetric")
    Gp = sp_.slab @ sp_.slab.T
    sg.sparse_gram_pairs_plain(Gp, sp_.rptr, sp_.rcol, sp_.rval, sp_.cptr, sp_.crow, sp_.cval)
    check(torch.equal(G, Gp), "the kernel's Gram is not bitwise the plain version's")
    del Gp
    check(not G[dept:].any() and not G[:, dept:].any(), "padding rows or columns not zero")
    Xd = torch.zeros((D, f), dtype=torch.float32, device=dev)
    rix = torch.repeat_interleave(torch.arange(dept, device=dev), counts)
    Xd.view(-1).index_copy_(0, rix * f + cols, vals)
    pick = torch.tensor(np.random.default_rng(GRAM_SEED).choice(dept, 512, replace=False),
                        device=dev)
    X64 = Xd[:dept].double()
    want = X64[pick] @ X64.T
    del X64
    lib_rows = Xd[pick] @ Xd.T
    scale = float(want.abs().max())
    err = float((G[pick, :dept].double() - want).abs().max()) / scale
    lib_err = float((lib_rows[:, :dept].double() - want).abs().max()) / scale
    print(f"  512 sampled rows against the float64 Gram: max rel {err:.3e} (Xd @ Xd.T in float32: "
          f"{lib_err:.3e})", flush=True)
    check(err <= 1e-5, f"the Gram from the rows is {err} from the float64 Gram")

    ms_split = timed_ms(split, 3)
    ms_slab = timed_ms(lambda: sp_.slab @ sp_.slab.T, 5)
    Gw = sp_.slab @ sp_.slab.T
    ms_pairs = timed_ms(lambda: sg.sparse_gram_pairs(Gw, sp_.rptr, sp_.rcol, sp_.rval, sp_.cptr,
                                                     sp_.crow, sp_.cval), 5)
    del Gw
    ms_gram = timed_ms(lambda: sg.gram_from_rows(sp_), 5)
    ms_whole = timed_ms(lambda: sg.gram_from_rows(split()), 3)

    def plain():
        Gq = sp_.slab @ sp_.slab.T
        sg.sparse_gram_pairs_plain(Gq, sp_.rptr, sp_.rcol, sp_.rval, sp_.cptr, sp_.crow,
                                   sp_.cval)
        return Gq

    ms_plain = timed_ms(plain, 1)
    ms_lib = timed_ms(lambda: Xd @ Xd.T, 3)
    del Xd
    hp = sp_.slab.shape[1]
    col_counts = torch.bincount(cols, minlength=f).double()
    bound = max(4.0 * D * D / PEAK_BYTES,
                2.0 * float((col_counts * col_counts).sum()) / PEAK_F32) * 1e3
    slab_bound = max(4.0 * D * D / PEAK_BYTES, 2.0 * D * D * hp / PEAK_F32) * 1e3
    print(f"  ms: split {ms_split:.3f}, slab product {ms_slab:.3f}, pair kernel {ms_pairs:.3f}, "
          f"Gram (product, pairs, sq) {ms_gram:.3f}, with the split {ms_whole:.3f}; bound "
          f"{bound:.3f} (the Gram's write, or its sum of count^2 multiply-adds at the float32 "
          f"peak), the slab product's {slab_bound:.3f}; plain {ms_plain:.1f}; Xd @ Xd.T "
          f"{ms_lib:.3f}", flush=True)

    # the split's two rates, each the slope between two sizes, so that what
    # both share (the Gram's write, the touched rows' read and write, the
    # short columns' entries) drops out: the slab's product between two
    # widths, the pair kernel between two thresholds (the pairs of the
    # columns whose counts lie between them)
    slab_ms = {}
    for w in GRAM_SLAB_WIDTHS:
        S = torch.rand((D, w), dtype=torch.float32, device=dev)
        slab_ms[w] = timed_ms(lambda: S @ S.T, 5)
    del S
    lo, hi = GRAM_SLAB_WIDTHS
    slab_rate = D * D * (hi - lo) / ((slab_ms[hi] - slab_ms[lo]) / 1e3)
    pair_ms = {}
    for T in GRAM_PAIR_THRESHOLDS:
        st = split(T)
        Gt = st.slab @ st.slab.T
        pair_ms[T] = (st.light_pairs,
                      timed_ms(lambda: sg.sparse_gram_pairs(Gt, st.rptr, st.rcol, st.rval,
                                                            st.cptr, st.crow, st.cval), 5))
        del st, Gt
    (p_lo, t_lo), (p_hi, t_hi) = (pair_ms[T] for T in GRAM_PAIR_THRESHOLDS)
    pair_rate = (p_hi - p_lo) / ((t_hi - t_lo) / 1e3)
    print(f"  rates: slab product {slab_rate:.4g} multiply-adds/s (widths {lo}: "
          f"{slab_ms[lo]:.3f} ms, {hi}: {slab_ms[hi]:.3f} ms); pairs {pair_rate:.4g} /s "
          f"(thresholds " + ", ".join(f"{T}: {p} pairs in {t:.3f} ms"
                                       for T, (p, t) in pair_ms.items())
          + f"; at the split: {sp_.light_pairs} pairs in {ms_pairs:.3f} ms, "
          f"{light_rows} rows read and written)", flush=True)
    sweep = []
    for T in (*GRAM_THRESHOLDS, sp_.threshold):
        st = split(T)
        ms = timed_ms(lambda: sg.gram_from_rows(st), 2)
        model = (D * D * st.slab.shape[1] / SPARSE_GRAM_SLAB_RATE
                 + st.light_pairs / SPARSE_GRAM_PAIR_RATE) * 1e3
        sweep.append((T, st.heavy, st.light_pairs, round(ms, 3), round(model, 3)))
        del st
    print("  threshold, heavy, light pairs, measured ms, modelled ms (the slab's product and "
          "the pairs at the two rates): " + "; ".join(str(x) for x in sweep), flush=True)

    # the products with the last point, from the same rows
    x_last = torch.tensor(data.csr[-1].toarray().ravel(), dtype=torch.float32, device=dev)
    q = sg.rows_matvec(counts, cols, vals, x_last, D)
    check(torch.equal(q, sg.rows_matvec(counts, cols, vals, x_last, D)),
          "two calls of rows_matvec differ")
    rptr = torch.zeros(dept + 1, dtype=torch.int64, device=dev)
    rptr[1:] = torch.cumsum(counts, 0)
    check(torch.equal(q, sg.rows_matvec_plain(rptr, cols, vals, x_last, D)),
          "rows_matvec's kernel is not bitwise its plain version")
    check(not q[dept:].any(), "rows_matvec's padding not zero")
    t0 = time.perf_counter()
    q_host = np.asarray((rows @ data.csr[-1].T).todense()).ravel()
    qa_host = float((data.csr[-1] @ data.csr[-1].T).toarray()[0, 0])
    host_ms = (time.perf_counter() - t0) * 1e3
    q_err = float(np.abs(q[:dept].double().cpu().numpy() - q_host).max() / np.abs(q_host).max())
    qa_err = abs(float(torch.dot(x_last, x_last)) - qa_host) / qa_host
    check(q_err <= 1e-6 and qa_err <= 1e-6, f"q_lin {q_err}, qa_lin {qa_err} from float64")
    ms_q = timed_ms(lambda: sg.rows_matvec(counts, cols, vals, x_last, D), 20)
    ms_q_plain = timed_ms(lambda: sg.rows_matvec_plain(rptr, cols, vals, x_last, D), 1)
    q_bound = (rows.nnz * (8 + 4 + 4) + 8 * (dept + 1) + 4 * D) / PEAK_BYTES * 1e3
    print(f"  q_lin: rows_matvec {ms_q:.4f} ms (bound {q_bound:.4f}: the entries, a gathered "
          f"x_last float each, the offsets and q), plain {ms_q_plain:.2f}, the host's scipy "
          f"products {host_ms:.2f}; max rel {q_err:.3e} from float64, qa_lin {qa_err:.3e}",
          flush=True)

    # two learns of the gram tier on the main path, each one launch of the
    # pair kernel and of the products' kernel counted from zero
    y = data.y
    p = Parameter(kernel=KernelType.rbf, gamma=1.0, cost=1.0, epsilon=1e-3, dtype=np.float32,
                  backend=BackendType.cuda, devices=1, print_info=False)
    p.data = ParsedData(csr=data.csr.astype(np.float32), values=y)
    p.values = y
    learn_ms = []
    for _ in range(2):
        svm = make_csvm(p)
        sg.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svm.learn()
        torch.cuda.synchronize()
        learn_ms.append((time.perf_counter() - t0) * 1e3)
        check(svm.last_cg_info["mode"] == "sparse_gram", f"mode {svm.last_cg_info['mode']}")
        learn_launches = sg.launches["sparse_gram_pairs"]
        check(learn_launches == 1, f"a learn launched the pair kernel {learn_launches} times")
        check(sg.launches["sparse_rows_matvec"] == 1,
              f"a learn launched rows_matvec {sg.launches['sparse_rows_matvec']} times")
    print(f"  learns: {', '.join(f'{ms:.1f}' for ms in learn_ms)} ms, one pair kernel and one "
          "rows_matvec each", flush=True)
    return {"name": "sparse_gram_pairs", "route": "cuda",
            "source": "plssvm_sparse_fp22_tpu_torch/csrc/sparse_gram.cu",
            "replaces": "none: XLA's dense product (plssvm_sparse_fp22_tpu/models/base.py:944)",
            "launches": learn_launches, "ms": round(ms_gram, 4), "plain_ms": round(ms_plain, 3),
            "bound_ms": round(bound, 4),
            "bound_by": ("bytes" if 4.0 * D * D / PEAK_BYTES * 1e3 >= bound
                         else "float32 operations"),
            "slab_bound_ms": round(slab_bound, 4),
            "library_ms": round(ms_lib, 3), "error_vs_float64": err,
            "shape": [dept, f, D], "threshold": sp_.threshold, "heavy": sp_.heavy,
            "light_pairs": sp_.light_pairs, "pair_kernel_ms": round(ms_pairs, 4),
            "slab_ms": round(ms_slab, 4), "split_ms": round(ms_split, 4),
            "slab_rate": slab_rate, "pair_rate": pair_rate,
            "rows_matvec": {"source": "plssvm_sparse_fp22_tpu_torch/csrc/sparse_gram.cu",
                            "replaces": "none: the host's scipy products "
                                        "(plssvm_sparse_fp22_tpu/models/base.py:956)",
                            "launches": sg.launches["sparse_rows_matvec"],
                            "ms": round(ms_q, 5), "plain_ms": round(ms_q_plain, 3),
                            "bound_ms": round(q_bound, 5), "host_ms": round(host_ms, 3),
                            "error_vs_float64": q_err}}


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also run phase 10: torch.profiler over each sparse tier's CG")
    parser.add_argument("--sharded", action="store_true",
                        help="build, then phases 17, 18 and 19 only: the sharded learns and "
                             "predict (over every card where the machine has more than one)")
    parser.add_argument("--distributed", action="store_true",
                        help="build, then phase 19 only: the sharded learns and predict "
                             "across two processes")
    parser.add_argument("--worker", metavar="SPEC",
                        help="one rank of phase 19 (started by phase 19 itself)")
    parser.add_argument("--strips", action="store_true",
                        help="build, then phase 20 only: the kernels' scratch in strips")
    parser.add_argument("--tools", action="store_true",
                        help="build, then phase 21 only: the on-chip tools at small sizes")
    parser.add_argument("--float64", action="store_true",
                        help="build, then phase 22 only: float64 learns on the card")
    parser.add_argument("--cg", action="store_true",
                        help="build, then phase 23 only: the CG loop on the device")
    parser.add_argument("--cli", action="store_true",
                        help="build, then the CLIs with their splits: phases 6 and 12 (dense "
                             "rbf 32768 x 256, float32), 22 (a) (float64) and 23 (b) (learns "
                             "of one layout)")
    parser.add_argument("--gram", action="store_true",
                        help="build, then phase 24 only: the sparse gram tier's Gram from the "
                             "CSR rows at rcv1's shape")
    parser.add_argument("--probe", action="store_true",
                        help="build, show the compiler's resource lines, check the split and "
                             "every bf16 kernel with one launch each, and stop")
    args = parser.parse_args(argv)
    if args.worker:
        sys.path.insert(0, ROOT)
        return dist_worker(json.loads(args.worker))
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this smoke test needs an NVIDIA GPU",
              flush=True)
        return 1
    sys.path.insert(0, ROOT)
    import plssvm_sparse_fp22_tpu_torch  # noqa: F401  (fails outside the repository)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    rng = np.random.default_rng(SEED)
    os.makedirs(WORK, exist_ok=True)
    try:
        phase_device()
        info = phase_build()
        if args.probe:
            show_build_log(info)
            phase_split(dev, rng, probe=True)
            phase_k4(dev, rng, probe=True)
            print("probe passed", flush=True)
            return 0
        if args.sharded:
            phase_sharded(dev, rng)
            check(phase_sharded_rest(dev).get("gram_matvec_rect/exact", 0) > 0,
                  "the panel ring's learn launched no K2")
            phase_distributed(dev)
            print("sharded phases passed", flush=True)
            return 0
        if args.distributed:
            phase_distributed(dev)
            print("distributed phase passed", flush=True)
            return 0
        if args.strips:
            phase_strips(dev)
            print("strip phase passed", flush=True)
            return 0
        if args.tools:
            phase_tools()
            print("tools phase passed", flush=True)
            return 0
        if args.float64:
            os.environ["PLSSVM_DEVICES"] = "1"
            phase_float64(dev)
            print("float64 phase passed", flush=True)
            return 0
        if args.cg:
            phase_cg_loop(dev)
            second_learns()
            print("cg loop phase passed", flush=True)
            return 0
        if args.gram:
            os.environ["PLSSVM_DEVICES"] = "1"
            print(json.dumps(phase_sparse_gram(dev)), flush=True)
            print("sparse gram phase passed", flush=True)
            return 0
        if args.cli:
            os.environ["PLSSVM_DEVICES"] = "1"
            with environ(PLSSVM_MATMUL_PRECISION="highest"):
                # a first learn and predict, as phases 3-5 launch the kernels
                # before phase 6 in the full run: phase 6's split is then the
                # learn's own, not the process's first use of the card
                phase_reference(np.random.default_rng(SEED + 6))
                dense = phase_main_path(rng)
            phase_adaptive_dense(dense)
            float64_clis()
            second_learns()
            print("cli phases passed", flush=True)
            return 0
        # phases 3-16 are the one-device paths, whatever the machine holds
        os.environ["PLSSVM_DEVICES"] = "1"
        # phases 3-10 hold the exact tier; the plan is off while a tier is pinned
        with environ(PLSSVM_MATMUL_PRECISION="highest"):
            records = {"gram_matvec_sym/exact": phase_k1(dev, rng),
                       "gram_matvec_rect/exact": phase_k2(dev, rng),
                       "gram_pair_contrib/exact": phase_k3(dev, rng)}
            dense = phase_main_path(rng)
            phase_reference(rng)
            phase_timing(dev, rng)
            sparse = phase_sparse_main(dev)
            phase_sparse_more(sparse)
        records["split_bf16"] = phase_split(dev, rng)
        records.update(phase_k4(dev, rng))
        # each kernel x tier counted over a main path's run: the exact tier's
        # K1 and K2 over the dense train and predict CLIs, K3 over the sparse
        # implicit tier; the bf16 tiers over the adaptive learns and the
        # predicts with a tier pinned; the split over the adaptive dense learn,
        # the predict on bf16x3 and the adaptive sparse implicit learn together
        launches = {k: dense["launches"][k]
                    for k in ("gram_matvec_sym/exact", "gram_matvec_rect/exact")}
        launches["gram_pair_contrib/exact"] = \
            sparse["launches"]["implicit"]["gram_pair_contrib/exact"]
        launches.update(phase_adaptive_dense(dense))
        dense_splits = launches["split_bf16"]
        launches.update(phase_adaptive_sparse(sparse))
        launches["split_bf16"] += dense_splits
        phase_tiers(dev, rng, sparse)
        with environ(PLSSVM_MATMUL_PRECISION="highest"):
            chunked = phase_checkpoint(dense)
        phase_small_clis()
        ring = phase_sharded(dev, rng)
        sparse_ring = phase_sharded_rest(dev, sparse)
        distributed, dist_panel = phase_distributed(dev)
        strips = phase_strips(dev)
        phase_tools()
        phase_float64(dev)
        phase_cg_loop(dev)
        second_learns()
        sparse_gram = phase_sparse_gram(dev)
        if args.profile:
            with environ(PLSSVM_MATMUL_PRECISION="highest"):
                phase_profile(sparse)
        print("library_ms is null for every kernel but sparse_gram_pairs: no single PyTorch call "
              "computes K(X, Y) v (a Gram product, a kernel transform and one or two GEMVs) or "
              "both parts of the bf16 split; the plain versions are those calls in sequence. "
              "sparse_gram_pairs's record is the whole Gram from the rows (slab product, pairs, "
              "sq) beside Xd @ Xd.T", flush=True)
        kernels = [{"name": name, "route": "cuda", "source": source_of(name),
                    "replaces": REPLACES[name], "launches": launches[name], **rec,
                    **bound_ms(name, *RECORD_SHAPES[name.partition("/")[0]]),
                    "library_ms": None}
                   for name, rec in records.items()]
        kernels.append(sparse_gram)
        # the later paths beside the earlier ones: K1 under the chunked CG loop
        # (phase 15), K2 and the split on the ring of 4 shards (phase 17), K2
        # on the sparse panel ring of 2 shards (phase 18), K2 and the split on
        # the ring of 4 shards across two processes and K2 on the panel ring
        # of 4 shards across two processes (phase 19, both ranks)
        for k in kernels:
            if k["name"] in chunked:
                k["launches_chunked_learn"] = chunked[k["name"]]
            if k["name"] in ring:
                k["launches_ring"] = ring[k["name"]]
            if k["name"] in sparse_ring:
                k["launches_sparse_ring"] = sparse_ring[k["name"]]
            if k["name"] in distributed:
                k["launches_distributed"] = distributed[k["name"]]
            if k["name"] in dist_panel:
                k["launches_distributed_sparse_ring"] = dist_panel[k["name"]]
            if k["name"] in strips:
                k["strips"] = strips[k["name"]]
        check(len(kernels) == 11 and all(k["launches"] > 0 for k in kernels),
              f"a kernel of the path never launched: {launches}")
        check(chunked["gram_matvec_sym/exact"] > 0
              and all(ring.get(f"gram_matvec_rect/{t}", 0) > 0 for t in TIERS_ALL)
              and sparse_ring.get("gram_matvec_rect/exact", 0) > 0
              and all(distributed.get(f"gram_matvec_rect/{t}", 0) > 0 for t in TIERS_ALL)
              and distributed.get("split_bf16", 0) > 0
              and dist_panel.get("gram_matvec_rect/exact", 0) > 0,
              f"the chunked learn or a ring launched no kernel: {chunked}, {ring}, "
              f"{sparse_ring}, {distributed}, {dist_panel}")
    except SmokeError as exc:
        print(f"FAIL: {exc}", flush=True)
        return 1
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
