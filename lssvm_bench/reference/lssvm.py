"""Float64 LS-SVM: the kernel, the implicit system, CG as the reference
implementation runs it, the bias, and the decision values, in row blocks
so that a card holds them after the program's state is freed.

With ``n`` points the system has ``n - 1`` unknowns.  With ``K`` the kernel
matrix of the first ``n - 1`` points, ``q_i = k(x_i, x_last)`` and
``QA = k(x_last, x_last) + 1/C``::

    A v = K v + QA sum(v) - sum(v) q - (q . v) + v / C,   b_i = y_i - y_last

CG starts at ``x = 1``, recomputes ``r = b - A x`` every 50 iterations,
stops at ``r.r <= eps^2 r0.r0`` or after ``max_iter`` iterations (default:
the number of features).  Then ``bias = y_last + QA sum(x) - q . x`` and
``alpha = [x, -sum(x)]``.

``precision="tf32"`` rounds the inputs of every product to TF32's 10
mantissa bits and computes in float32: the control that a sound
comparison has to fail."""

from __future__ import annotations

import math

import numpy as np
import torch

REFRESH = 50
_MANTISSA = {"tf32": 10}


def round_mantissa(t: torch.Tensor, bits: int) -> torch.Tensor:
    """float32 ``t`` rounded to ``bits`` explicit mantissa bits, to nearest
    even (what a TF32 or bf16 product does to its inputs)."""
    shift = 23 - bits
    i = t.contiguous().view(torch.int32)
    half = (1 << (shift - 1)) - 1
    i = (i + half + ((i >> shift) & 1)) & ~((1 << shift) - 1)
    return i.view(torch.float32)


class Arithmetic:
    """float64, or float32 with the products' inputs rounded (the control)."""

    def __init__(self, precision: str = "float64"):
        self.precision = precision
        self.dtype = torch.float64 if precision == "float64" else torch.float32

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision in _MANTISSA:
            bits = _MANTISSA[self.precision]
            a, b = round_mantissa(a, bits), round_mantissa(b, bits)
        return a @ b


def kernel_block(A, B, sqa, sqb, kernel: str, gamma: float, degree: int, coef0: float,
                 ar: Arithmetic) -> torch.Tensor:
    G = ar.mm(A, B.T)
    if kernel == "linear":
        return G
    if kernel == "polynomial":
        return (gamma * G + coef0) ** degree
    if kernel == "rbf":
        return torch.exp(-gamma * torch.clamp(sqa[:, None] + sqb[None, :] - 2.0 * G, min=0.0))
    raise ValueError(f"unknown kernel {kernel}")


def block_rows(cols: int, budget_bytes: int, itemsize: int = 8) -> int:
    return max(1, min(65536, budget_bytes // max(1, cols * itemsize)))


def dense_rows(csr, dense, device) -> torch.Tensor:
    """The rows as a dense float64 tensor on ``device``: the dense array
    where the data has one, else the CSR densified there."""
    device = torch.device(device)
    if dense is not None:
        return torch.as_tensor(dense, dtype=torch.float64).to(device)
    t = torch.sparse_csr_tensor(torch.as_tensor(csr.indptr, dtype=torch.int64),
                                torch.as_tensor(csr.indices, dtype=torch.int64),
                                torch.as_tensor(csr.data, dtype=torch.float64),
                                size=csr.shape)
    return t.to(device).to_dense()


class System:
    """The LS-SVM system of the rows ``X`` (a dense tensor, ``n`` x f) and
    labels ``y`` at one kernel; the cost ``C`` is given per call, so one
    system serves a column of the grid.  ``K`` is kept whole where
    ``cache_bytes`` allows, else recomputed in blocks per A v, its rows
    split over ``spread`` (devices that each compute their share of K v)."""

    def __init__(self, X, y: np.ndarray, *, kernel: str, gamma: float,
                 degree: int = 3, coef0: float = 0.0, device="cpu",
                 precision: str = "float64", cache_bytes: int = 32 << 30,
                 block_bytes: int = 4 << 30, spread=None):
        self.ar = Arithmetic(precision)
        dt = self.ar.dtype
        self.device = torch.device(device)
        self.X = X.to(self.device, dt)
        n = self.X.shape[0]
        self.m = n - 1
        self.kw = dict(kernel=kernel, gamma=float(gamma), degree=int(degree),
                       coef0=float(coef0), ar=self.ar)
        self.sq = torch.sum(self.X * self.X, dim=1)
        x_last, sq_last = self.X[-1:], self.sq[-1:]
        self.q = kernel_block(self.X[:-1], x_last, self.sq[:-1], sq_last, **self.kw)[:, 0]
        self.k_last = float(kernel_block(x_last, x_last, sq_last, sq_last, **self.kw)[0, 0])
        yt = torch.as_tensor(np.asarray(y, np.float64), device=self.device, dtype=dt)
        self.y_last = float(y[-1])
        self.b = yt[:-1] - yt[-1]
        self.rows = block_rows(self.m, block_bytes, dt.itemsize)
        self.K = None
        if self.m * self.m * dt.itemsize <= cache_bytes:
            self.K = torch.empty(self.m, self.m, dtype=dt, device=self.device)
            for r0 in range(0, self.m, self.rows):
                r1 = min(self.m, r0 + self.rows)
                self.K[r0:r1] = self._block(self.X, self.sq, r0, r1)
            return
        devices = [torch.device(d) for d in (spread or [self.device])]
        per = -(-self.m // len(devices))
        #: (device, its copy of X and the norms, its first and last row)
        self.shares = [(d, self.X.to(d), self.sq.to(d), i * per, min(self.m, (i + 1) * per))
                       for i, d in enumerate(devices) if i * per < self.m]

    def _block(self, X, sq, r0: int, r1: int) -> torch.Tensor:
        return kernel_block(X[r0:r1], X[:self.m], sq[r0:r1], sq[:self.m], **self.kw)

    def _block_kv(self, X, sq, r0: int, r1: int, v: torch.Tensor) -> torch.Tensor:
        """Rows ``r0:r1`` of K v.  The rbf kernel is taken as
        ``exp(-g |x_i|^2) exp(2 g x_i.x_j) exp(-g |x_j|^2)``, the same
        numbers in fewer passes over a block that is never kept."""
        kw = self.kw
        if kw["kernel"] != "rbf":
            return self._block(X, sq, r0, r1) @ v
        g = kw["gamma"]
        E = kw["ar"].mm(X[r0:r1] * (2.0 * g), X[:self.m].T).exp_()
        return torch.exp(-g * sq[r0:r1]) * (E @ (torch.exp(-g * sq[:self.m]) * v))

    def kv(self, v: torch.Tensor) -> torch.Tensor:
        if self.K is not None:
            return self.K @ v
        parts = []
        for dev, X, sq, lo, hi in self.shares:  # queued on every device before any is read
            vd = v.to(dev)
            parts.append(torch.cat([self._block_kv(X, sq, r0, min(hi, r0 + self.rows), vd)
                                    for r0 in range(lo, hi, self.rows)]))
        return torch.cat([p.to(self.device) for p in parts])

    def qa(self, cost: float) -> float:
        return self.k_last + 1.0 / cost

    def matvec(self, v: torch.Tensor, cost: float) -> torch.Tensor:
        s, t = torch.sum(v), torch.dot(self.q, v)
        return self.kv(v) + self.qa(cost) * s - s * self.q - t + v / cost

    def vector(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float64), device=self.device).to(self.ar.dtype)

    def residual(self, x: torch.Tensor, cost: float) -> torch.Tensor:
        return self.b - self.matvec(x, cost)

    def bias(self, x: torch.Tensor, cost: float) -> float:
        """``bias = y_last + QA sum(x) - q . x`` (``csvm.cpp:257``)."""
        return (self.y_last + self.qa(cost) * float(torch.sum(x))
                - float(torch.dot(self.q, x)))

    def solve(self, cost: float, eps: float, imax: int):
        """CG from x = 1: ``(x, iterations, delta, delta0)``."""
        x = torch.ones(self.m, dtype=self.ar.dtype, device=self.device)
        r = self.residual(x, cost)
        delta = delta0 = float(torch.dot(r, r))
        d = r.clone()
        k = 0
        while k < imax and delta > eps * eps * delta0:
            Ad = self.matvec(d, cost)
            a = delta / float(torch.dot(d, Ad))
            x = x + a * d
            r = self.residual(x, cost) if k % REFRESH == REFRESH - 1 else r - a * Ad
            k += 1
            delta, old = float(torch.dot(r, r)), delta
            d = r + (delta / old) * d
        return x, k, delta, delta0


def decision_values(X_sv, alphas, bias: float, P, *, kernel: str, gamma: float,
                    degree: int = 3, coef0: float = 0.0, device="cpu",
                    precision: str = "float64", block_bytes: int = 2 << 30) -> np.ndarray:
    """``f(p) = sum_i alpha_i k(x_i, p) + bias`` for every row of ``P``."""
    ar = Arithmetic(precision)
    dt, device = ar.dtype, torch.device(device)
    X = torch.as_tensor(X_sv).to(device, dt)
    a = torch.as_tensor(np.asarray(alphas, np.float64)).to(device, dt)
    sqx = torch.sum(X * X, dim=1)
    P = torch.as_tensor(P)
    rows = block_rows(X.shape[0], block_bytes, dt.itemsize)
    out = []
    for r0 in range(0, P.shape[0], rows):
        p = P[r0:r0 + rows].to(device, dt)
        K = kernel_block(p, X, torch.sum(p * p, dim=1), sqx, kernel=kernel, gamma=gamma,
                         degree=degree, coef0=coef0, ar=ar)
        out.append((K @ a + bias).double().cpu())
    return torch.cat(out).numpy()


def norm(t: torch.Tensor) -> float:
    return math.sqrt(float(torch.dot(t.double(), t.double())))
