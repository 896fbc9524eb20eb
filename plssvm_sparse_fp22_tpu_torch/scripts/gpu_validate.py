"""Numeric validation sweep of the port: every compute path against the
numpy oracle, at each precision tier, on the card.

The twin of the JAX repository's ``scripts/tpu_validate.py``, with its
checks, their names, data (D = 512, f = 160, seed 0) and tolerances: 2e-4
at the ``exact`` and ``bf16x3`` tiers, 2e-2 at ``bf16cast`` (the fast
tier, ``tpu_validate.py:68, 77``), 1e-5 for the gather arm and the
panel norms, 1e-6 for the densify, 5e-3 for the learns' alphas.  The CPU
suite runs the plain PyTorch versions; only the card runs the hand kernels
(K1, K2, K3 and the split), so this is where their lowering and their
tensor-core rounding are held to the oracle.

Each kernel, operator and panel check runs at every tier (the cached
operator, the panel norms, the gather arm and the densify have none); the
learns run at ``exact`` and ``bf16x3`` (the JAX script's learns run its
default tier, ``high``), and ``learn[adaptive]`` on the two-tier plan,
forced onto the ``implicit`` mode so that the plan applies.

Prints one line per check and a JSON summary last; exits 1 on any failure::

    python -m plssvm_sparse_fp22_tpu_torch.scripts.gpu_validate [--cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import scipy.sparse as sp
import torch

from ..models import make_csvm
from ..ops.gram_matvec import gram_matvec, make_sym_matvec, pair_gram_contrib
from ..ops.matvec import build_operator
from ..ops.sparse import (HybridSparse, TiledHybrid, densify_tiled, make_streaming_gram_matvec,
                          make_tiled_panel_matvec, make_tiled_panel_matvec_windowed)
from ..types import KernelType
from ..utils import oracle
from . import _common

KERNELS = [KernelType.linear, KernelType.polynomial, KernelType.rbf]
HYPER = {"degree": 3, "gamma": 0.01, "coef0": 1.0}
#: the tolerance of each tier's checks, relative to max|oracle|
#: (``tpu_validate.py:68`` for the f32-grade tiers, ``:77`` for the fast one)
TIER_TOL = {"exact": 2e-4, "bf16x3": 2e-4, "bf16cast": 2e-2}
TIERS = tuple(TIER_TOL)
#: the tiers the learns run at: the exact tier and the JAX script's default
#: (``high``); a learn pinned to bf16cast solves a perturbed system, which
#: the adaptive plan exists to correct
LEARN_TIERS = {"exact": "highest", "bf16x3": "high"}
D, F = 512, 160


class _Checks:
    def __init__(self):
        self.results = []

    def __call__(self, name: str, tier: str | None, got, want, tol: float) -> bool:
        got = np.asarray(torch.as_tensor(got).detach().cpu(), np.float64)
        want = np.asarray(want, np.float64)
        err = float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))
        ok = bool(got.shape == want.shape and err <= tol)
        self.results.append({"check": name, "tier": tier, "rel_err": err, "tol": tol,
                             "ok": ok})
        label = name if tier is None else f"{name} @{tier}"
        print(f"{'PASS' if ok else 'FAIL'}  {label:62s} rel_err={err:.2e} (tol {tol:.0e})",
              flush=True)
        return ok


def _t(a, dev):
    return torch.as_tensor(np.asarray(a), device=dev)


def _kernels(check, dev, rng, X, v):
    """Checks 1-3: K1, K2 and K3 through their wrappers."""
    Xd, vd = _t(X, dev), _t(v, dev)
    for tier in TIERS:
        for kernel in KERNELS:
            K = oracle.kernel_matrix(kernel, X, X, **HYPER)
            check(f"sym_pallas[{kernel.name}]", tier,
                  make_sym_matvec(kernel, Xd, tier=tier, **HYPER)(vd), K @ v, TIER_TOL[tier])
    K = oracle.kernel_matrix(KernelType.rbf, X, X, **HYPER)
    check("sym_pallas[rbf,fast-tier]", "bf16cast",
          make_sym_matvec(KernelType.rbf, Xd, tier="bf16cast", **HYPER)(vd), K @ v,
          TIER_TOL["bf16cast"])

    P = rng.normal(size=(96, F)).astype(np.float32)
    for tier in TIERS:
        for kernel in KERNELS:
            Kc = oracle.kernel_matrix(kernel, P, X, **HYPER)
            check(f"cross_pallas[{kernel.name}]", tier,
                  gram_matvec(kernel, _t(P, dev), vd, Y=Xd, tier=tier, **HYPER), Kc @ v,
                  TIER_TOL[tier])

    Xj = rng.normal(size=(384, F)).astype(np.float32)
    vj = rng.normal(size=384).astype(np.float32)
    Kc = oracle.kernel_matrix(KernelType.rbf, X, Xj, **HYPER)
    for tier in TIERS:
        oi, oj = pair_gram_contrib(KernelType.rbf, Xd, Xd, vd, vd, same=True, tier=tier,
                                   **HYPER)
        check("pair_same[rbf]", tier, (oi + oj), K @ v, TIER_TOL[tier])
        oi, oj = pair_gram_contrib(KernelType.rbf, Xd, _t(Xj, dev), vd, _t(vj, dev),
                                   same=False, tier=tier, **HYPER)
        check("pair_cross[rbf] out_i", tier, oi, Kc @ vj, TIER_TOL[tier])
        check("pair_cross[rbf] out_j", tier, oj, Kc.T @ v, TIER_TOL[tier])


def _operators(check, dev, rng, X, v):
    """Check 4: the three modes of ``build_operator``."""
    backend = _common.backend_of(dev)
    dept = D - 40
    mask = np.zeros(D, np.float32)
    mask[:dept] = 1.0
    Xm = X * mask[:, None]
    q = (rng.normal(size=D) * mask).astype(np.float32)
    vm = v * mask
    for mode, kernel in (("linear", KernelType.linear), ("cached", KernelType.rbf),
                         ("implicit", KernelType.rbf)):
        K = oracle.kernel_matrix(kernel, Xm[:dept], Xm[:dept], **HYPER)
        s, t = vm.sum(), q @ vm
        want = np.zeros(D)
        want[:dept] = K @ vm[:dept] + (2.0 * s - t) - s * q[:dept] + 0.5 * vm[:dept]
        for tier in (("exact",) if mode == "cached" else TIERS):
            op = build_operator(kernel, _t(Xm, dev), _t(q, dev), _t(mask, dev), 2.0, 0.5,
                                mode=mode, backend=backend, precision=tier, **HYPER)
            check(f"operator[{mode}]", tier, op.matvec(_t(vm, dev)), want, TIER_TOL[tier])


def _sparse(check, dev, rng, v):
    """Check 5: the panel schedules (K1 and K3), the gather arm and the
    densify on a 5 % matrix with one heavy row."""
    use_cuda = dev.type == "cuda"
    csr = sp.random(D, 640, density=0.05, format="lil", random_state=rng,
                    data_rvs=lambda k: rng.normal(size=k).astype(np.float32))
    csr[7, :] = rng.normal(size=640)  # heavy row exercises the spill
    csr = csr.tocsr().astype(np.float32)
    Xs = csr.toarray()
    Ks = oracle.kernel_matrix(KernelType.rbf, Xs, Xs, **HYPER)
    vd = _t(v, dev)

    th = TiledHybrid.from_csr(csr, dtype=np.float32, device=dev)
    hs = np.zeros(D, np.float32)
    if len(th.heavy_idx):
        hr = csr[th.heavy_idx]
        hs[th.heavy_idx] = np.asarray(hr.multiply(hr).sum(axis=1)).ravel()
    kw = {"ntiles": th.tell.ntiles, "Lt": th.tell.Lt, "panel_rows": 256, "use_cuda": use_cuda,
          "heavy": th.heavy, "heavy_rows": tuple(int(r) for r in th.heavy_idx),
          "heavy_sq_vec": _t(hs, dev)}
    args = (th.tell.vals, th.tell.lcols, int(KernelType.rbf), 3, HYPER["gamma"],
            HYPER["coef0"])
    for tier in TIERS:
        mv, sq = make_tiled_panel_matvec(*args, precision=tier, **kw)
        check("sparse_panel_matvec[rbf,heavy]", tier, mv(vd), Ks @ v, TIER_TOL[tier])
        if tier == "exact":
            check("sparse_panel_sq", None, sq,
                  np.asarray(csr.multiply(csr).sum(axis=1)).ravel(), 1e-5)
        mvw, _ = make_tiled_panel_matvec_windowed(*args, precision=tier, **kw)
        check("sparse_panel_matvec[windowed,heavy]", tier, mvw(vd), Ks @ v, TIER_TOL[tier])

    h = HybridSparse.from_csr(csr, dtype=np.float32, device=dev)
    gmv, _sq = make_streaming_gram_matvec(h, int(KernelType.rbf), 3, HYPER["gamma"],
                                          HYPER["coef0"])
    check("sparse_gather_matvec[rbf]", None, gmv(vd), Ks @ v, 1e-5)

    dense = densify_tiled(th.tell.vals, th.tell.lcols, th.tell.ntiles, th.tell.Lt)
    light = Xs.copy()
    light[th.heavy_idx] = 0.0
    check("densify_tiled(light rows)", None, dense[:, :640], light, 1e-6)
    return Xs


def _learns(check, dev, rng, Xs):
    """Checks 6-7: whole learns against the oracle's solve."""
    backend = _common.backend_of(dev)
    Xl, yl = Xs[:256, :64].copy(), np.where(rng.normal(size=256) > 0, 1., -1.)
    Xl += rng.normal(size=Xl.shape).astype(np.float32) * 0.01  # no empty rows
    a_ref, _b, _ = oracle.solve_lssvm(Xl, yl, kernel=KernelType.rbf, cost=1.0, epsilon=1e-8,
                                      max_iter=300, **HYPER)

    def learn(threshold: float):
        svm = make_csvm(_common.parameter(
            Xl, yl, kernel=KernelType.rbf, cost=1.0, epsilon=1e-8, max_iter=300,
            dtype=np.float32, backend=backend, sparse_threshold=threshold, **HYPER))
        svm.learn()
        return svm

    for tier, precision in LEARN_TIERS.items():
        for label, threshold, mode in (("dense", -1.0, None), ("sparse_panel", 1.0, "implicit")):
            with _common.environ(PLSSVM_MATMUL_PRECISION=precision, PLSSVM_SPARSE_MODE=mode):
                svm = learn(threshold)
            check(f"learn[{label}] alphas", tier, svm.alphas[:-1], a_ref[:-1], 5e-3)

    # the two-tier plan, on the implicit mode (a zero K-cache budget), where
    # it applies on either backend
    with _common.environ(PLSSVM_MATMUL_PRECISION="adaptive", PLSSVM_K_CACHE_BYTES=0):
        svm = learn(-1.0)
    check("learn[adaptive] alphas", "adaptive", svm.alphas[:-1], a_ref[:-1], 5e-3)
    info = svm.last_cg_info
    print(f"      adaptive: {info['iterations']} iters, {info['fast_iterations']} on the fast "
          f"tier, escalated={info['escalated']}, mode {info['mode']}", flush=True)
    return {k: info[k] for k in ("iterations", "fast_iterations", "escalated", "mode")}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cpu", action="store_true",
                        help="run the plain versions on the CPU (no card needed)")
    args = parser.parse_args(argv)
    dev = _common.device(args.cpu)
    print(f"platform: {dev.type} ({_common.card(dev) or 'CPU, plain versions'})", flush=True)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(D, F)).astype(np.float32)
    v = rng.normal(size=D).astype(np.float32)
    check = _Checks()
    _kernels(check, dev, rng, X, v)
    _operators(check, dev, rng, X, v)
    Xs = _sparse(check, dev, rng, v)
    adaptive = _learns(check, dev, rng, Xs)
    failures = [f"{r['check']} @{r['tier']}" for r in check.results if not r["ok"]]
    return _common.emit({
        "metric": "gpu_validation", "platform": dev.type, "card": _common.card(dev),
        "checks": len(check.results), "failures": len(failures), "failed": failures,
        "names": sorted({r["check"] for r in check.results}),
        "max_rel_err": max(r["rel_err"] for r in check.results),
        "max_rel_err_by_tier": {
            t: max(r["rel_err"] for r in check.results if r["tier"] == t)
            for t in (*TIERS, "adaptive")},
        "adaptive": adaptive})


if __name__ == "__main__":
    sys.exit(1 if main()["failures"] else 0)
