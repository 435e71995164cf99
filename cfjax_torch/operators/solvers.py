"""Solvers: CG, the Cholesky policy and factorize (counterpart of
`cfjax.operators.solvers`, reference src/gramian.jl:193-238 and
src/lazy_linear_algebra.jl:135-144).

CG is a Python loop with one host sync per residual check (cfjax's is a
`lax.while_loop`). `torch.linalg.cholesky` raises on a matrix that is not
positive definite where `jnp.linalg.cholesky` returns NaN, so the
rank-revealing tests use `torch.linalg.cholesky_ex` and its `info`.
MINRES, GMRES, CGNR and the refinement solvers are not ported yet
(ROADMAP.md, queue 1, item 5).
"""

from __future__ import annotations

import torch

from .. import config as _config
from .linop import LinearOperator, LowRankOperator


def cg(matvec, b, x0=None, tol: float = None, maxiter: int = None, M=None):
    """Preconditioned conjugate gradients for SPD operators.

    matvec: callable v -> A v. M: callable v -> M^-1 v. Returns (x, info)
    with info = (iterations, final residual norm).

    A float32 solve accumulates its iterate x in float64 (and returns it
    in float32): the rounding of a float32 x after every update, times
    A's spread of eigenvalues, otherwise caps the true residual far above
    the recursive one (measured on an H100 at n = 2^17: 7.3e-4 true vs
    1e-5 recursive after 316 PCG iterations). The operator and every
    other vector stay in b's dtype."""
    tol = _config.DEFAULT.cg_tol if tol is None else tol
    maxiter = _config.DEFAULT.cg_maxiter if maxiter is None else maxiter
    b = torch.as_tensor(b)
    x = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0)
    acc = torch.float64 if b.dtype == torch.float32 else b.dtype
    xa = x.to(acc)
    Minv = (lambda v: v) if M is None else M

    atol2 = float(tol * torch.linalg.norm(b)) ** 2
    r = b - matvec(x)
    z = Minv(r)
    p = z
    gamma = torch.dot(r, z)
    i = 0
    while i < maxiter and float(torch.dot(r, r)) > atol2:
        Ap = matvec(p)
        alpha = gamma / torch.dot(p, Ap)
        xa = xa + alpha.to(acc) * p.to(acc)
        r = r - alpha * Ap
        z = Minv(r)
        gamma_new = torch.dot(r, z)
        p = z + (gamma_new / gamma) * p
        gamma = gamma_new
        i += 1
    return xa.to(b.dtype), (i, torch.linalg.norm(r))


def _tri_solve(L, b, upper=False, left_transpose=False):
    A = L.mT if left_transpose else L
    B = b[:, None] if b.ndim == 1 else b
    out = torch.linalg.solve_triangular(A, B, upper=upper)
    return out[:, 0] if b.ndim == 1 else out


def _dense(op):
    return op.todense() if isinstance(op, LinearOperator) else torch.as_tensor(op)


class CholeskyFactorization:
    """Dense Cholesky of a lazy operator (reference `cholesky`/`factorize`
    small-n branch, src/gramian.jl:193-213). A tol-scaled jitter is added
    only when the clean factorization fails."""

    def __init__(self, op, jitter: float = None, _L0=None):
        A = _dense(op)
        n = A.shape[0]
        jitter = _config.DEFAULT.default_tol if jitter is None else jitter
        if _L0 is None:
            _L0, info = torch.linalg.cholesky_ex(A)
            if int(info) != 0:
                scale = torch.mean(torch.diagonal(A))
                shift = (jitter * scale) * torch.eye(n, dtype=A.dtype, device=A.device)
                _L0 = torch.linalg.cholesky(A + shift)
        self.L = _L0
        self.shape = tuple(A.shape)

    def solve(self, b):
        z = _tri_solve(self.L, b, upper=False)
        return _tri_solve(self.L, z, upper=True, left_transpose=True)

    def logdet(self):
        return 2 * torch.sum(torch.log(torch.diagonal(self.L)))


class LowRankFactorization:
    """Rank-revealing factorization of a numerically rank-deficient PSD
    operator: the semantics of the reference's pivoted Cholesky with
    tolerance (src/gramian.jl:193-199), through one eigendecomposition,
    keeping the eigenpairs above tol * lambda_max. solve() is the
    minimum-norm pseudo-inverse solve; logdet() the pseudo-determinant."""

    def __init__(self, op, tol: float = None):
        tol = _config.DEFAULT.default_tol if tol is None else tol
        if (isinstance(op, LowRankOperator) and op.is_psd
                and op.U.shape[1] < op.shape[0]):
            # already a factor A = U0 U0^T: eigendecompose the r x r Gram
            # matrix instead of densifying — O(n r^2)
            U0 = op.U
            s, W = torch.linalg.eigh(U0.T @ U0)
            smax = torch.clamp(s[-1], min=torch.finfo(U0.dtype).tiny)
            r = max(1, int(torch.sum(s > tol * smax)))
            w = s[-r:]
            Q = U0 @ (W[:, -r:] / torch.sqrt(w)[None, :])
            self.shape = op.shape
        else:
            A = _dense(op)
            w, Q = torch.linalg.eigh(A)
            wmax = torch.clamp(w[-1], min=torch.finfo(A.dtype).tiny)
            r = max(1, int(torch.sum(w > tol * wmax)))
            w = w[-r:]
            Q = Q[:, -r:]
            self.shape = tuple(A.shape)
        self.rank = r
        self.U = Q * torch.sqrt(w)[None, :]   # A ~= U U^T, (n, r)
        self._w = w
        self._Q = Q

    def solve(self, b):
        t = self._Q.T @ b
        return self._Q @ (t / (self._w if b.ndim == 1 else self._w[:, None]))

    def logdet(self):
        return torch.sum(torch.log(self._w))


def factorize(op, max_cholesky_size: int = None, rank_tol: float = None):
    """Policy: dense factorization below the size threshold, else the lazy
    operator itself (solved iteratively) — src/gramian.jl:201-213. A
    failed clean Cholesky (numerically rank-deficient matrix) re-factors
    as a rank-revealing `LowRankFactorization` at `rank_tol`."""
    mcs = _config.DEFAULT.max_cholesky_size if max_cholesky_size is None else max_cholesky_size
    n = op.shape[0]
    sym = op.is_symmetric if isinstance(op, LinearOperator) else True
    if n <= mcs and sym:
        if isinstance(op, LowRankOperator) and op.U.shape[1] < n:
            return LowRankFactorization(op, tol=rank_tol)
        A = _dense(op)
        L0, info = torch.linalg.cholesky_ex(A)
        if int(info) != 0:
            return LowRankFactorization(A, tol=rank_tol)
        return CholeskyFactorization(A, _L0=L0)
    return op


def solve(op, b, tol: float = None, maxiter: int = None, method: str = "auto"):
    """A \\ b: dense Cholesky for small symmetric PSD operators (the
    reference policy up to max_cholesky_size, src/gramian.jl:201-213), CG
    for larger PSD ones."""
    return solve_with_info(op, b, tol, maxiter, method)[0]


def solve_with_info(op, b, tol: float = None, maxiter: int = None, method: str = "auto"):
    """`solve`, returning (x, info): info is CG's (iterations, final
    residual norm) on the CG branch (a list of them for a 2-D b), else None."""
    if isinstance(op, (CholeskyFactorization, LowRankFactorization)):
        return op.solve(b), None
    b = torch.as_tensor(b)
    if method == "auto":
        if not (op.is_symmetric and op.is_psd):
            raise NotImplementedError(
                "solving a non-PSD operator needs MINRES or CGNR, which are not "
                "ported yet (ROADMAP.md, queue 1, item 5)")
        method = "cholesky" if op.shape[0] <= _config.DEFAULT.max_cholesky_size else "cg"
    if method == "cholesky":
        return CholeskyFactorization(op).solve(b), None
    if method == "cg":
        f = lambda bb: cg(op._matvec, bb, tol=tol, maxiter=maxiter)
        if b.ndim == 1:
            return f(b)
        cols = [f(b[:, j]) for j in range(b.shape[1])]
        return torch.stack([c[0] for c in cols], dim=1), [c[1] for c in cols]
    raise NotImplementedError(
        f"solve method {method!r} is not ported yet (ROADMAP.md, queue 1, item 5)")
