"""Lazy Kronecker-product operator (counterpart of
`cfjax.operators.kronecker`, reference KroneckerProducts.jl as used by
src/algebra.jl:91-95 and src/separable.jl:29-42).

The MVM is the vec-trick: reshape to the tensor grid and contract each
factor along its own axis, one einsum per mode, O(n sum n_i) instead of
O(n^2). A matrix right-hand side rides along as a trailing axis. Solves
factor per dimension (a dense Cholesky of each small factor). torch's
default full-fp32 matmuls are kept: TF32 would cost the float32 MVM its
accuracy.
"""

from __future__ import annotations

import math

import torch

from .. import config as _config
from ..utils.roofline import Work
from .linop import DenseOperator, LinearOperator

_MODES_LO = "abcdefgh"
_MODES_HI = "ABCDEFGH"


def _mode_chain(mats, v):
    """(A_1 ⊗ ... ⊗ A_k) v for v of shape (prod m_i,) or (prod m_i, r):
    one einsum contraction per mode."""
    tail = tuple(v.shape[1:])
    z = "z" if tail else ""
    X = v.reshape([A.shape[1] for A in mats] + list(tail))
    subs = list(_MODES_LO[:len(mats)])
    for i, A in enumerate(mats):
        out = subs.copy()
        out[i] = _MODES_HI[i]
        X = torch.einsum(f"{_MODES_HI[i]}{_MODES_LO[i]},{''.join(subs)}{z}->{''.join(out)}{z}",
                         A, X)
        subs = out
    return X.reshape((-1,) + tail)


def work_kron_mvm(ms, itemsize: int = 4) -> Work:
    """The least work of the Kronecker MVM on this card for factors of
    sides `ms`: one contraction per mode, 2 n m_i flops for n = prod m_i,
    as products on the tensor cores at three tf32 passes (full fp32
    accuracy). Bytes: v and the factors read once, K v written once."""
    n = math.prod(ms)
    return Work(tc_flops=2.0 * n * sum(ms), tc_passes=3,
                hbm_bytes=itemsize * (2.0 * n + sum(m * m for m in ms)))


def work_kron_solve(ms, itemsize: int = 4) -> Work:
    """The least work of `KroneckerCholesky.solve` on this card: per mode
    the two triangular solves with L_i and L_i^T, n m_i flops each, i.e.
    the flops of one full mode product (`work_kron_mvm`). Bytes: b and
    the triangular factors read once, x written once."""
    n = math.prod(ms)
    return Work(tc_flops=2.0 * n * sum(ms), tc_passes=3,
                hbm_bytes=itemsize * (2.0 * n + sum(m * (m + 1) / 2 for m in ms)))


class KroneckerOperator(LinearOperator):
    """K = F_1 ⊗ F_2 ⊗ ... ⊗ F_d (row-major vec: last factor's axis
    fastest, matching LazyGrid.points ordering)."""

    def __init__(self, factors):
        self.factors = tuple(f if isinstance(f, LinearOperator) else DenseOperator(f)
                             for f in factors)
        self.shape = (math.prod(f.shape[0] for f in self.factors),
                      math.prod(f.shape[1] for f in self.factors))
        self.dtype = self.factors[0].dtype
        self.device = getattr(self.factors[0], "device", None)
        self._dense_cache = None

    @property
    def is_symmetric(self):
        return all(f.is_symmetric for f in self.factors)

    @property
    def is_psd(self):
        return all(f.is_psd for f in self.factors)

    def _apply_modes(self, v, op_per_factor, in_dims=None):
        """vec-trick through each factor's own `_matmat` (LinearOperators
        stay lazy) or a dense matrix, mode by mode; v is (prod in_dims,)
        or (prod in_dims, r)."""
        in_dims = in_dims or [f.shape[1] for f in self.factors]
        tail = tuple(v.shape[1:])
        X = v.reshape(list(in_dims) + list(tail))
        for i, A in enumerate(op_per_factor):
            X = torch.movedim(X, i, -1)
            shp = X.shape
            X2 = X.reshape(-1, shp[-1])
            Y2 = A._matmat(X2.T).T if isinstance(A, LinearOperator) else X2 @ A.T
            X = torch.movedim(Y2.reshape(shp[:-1] + (Y2.shape[-1],)), -1, i)
        return X.reshape((-1,) + tail)

    def _dense_mats(self):
        """The dense factor matrices when every factor is small enough to
        materialize (max side <= 2048: 64 KB per 128 x 128 float32
        factor), for the einsum mode chain; else None. Cached unless they
        carry an autograd graph."""
        if self._dense_cache is not None:
            return self._dense_cache
        if any(max(f.shape) > 2048 for f in self.factors):
            return None
        mats = [f.todense() for f in self.factors]
        if torch.is_grad_enabled() and not any(m.requires_grad for m in mats):
            self._dense_cache = mats
        return mats

    def _matvec(self, v):
        mats = self._dense_mats()
        if mats is not None:
            return _mode_chain(mats, v)
        return self._apply_modes(v, self.factors)

    _matmat = _matvec

    def todense(self):
        out = self.factors[0].todense()
        for f in self.factors[1:]:
            out = torch.kron(out, f.todense())
        return out

    def diagonal(self):
        out = self.factors[0].diagonal()
        for f in self.factors[1:]:
            out = torch.outer(out, f.diagonal()).reshape(-1)
        return out

    def cholesky(self):
        return KroneckerCholesky(self)

    def solve(self, b, **kw):
        if all(f.shape[0] <= _config.DEFAULT.max_cholesky_size for f in self.factors):
            return self.cholesky().solve(b)
        from .solvers import solve as _solve

        return _solve(self, b, method="cg", **kw)

    def logdet(self):
        n = self.shape[0]
        return sum((n // f.shape[0]) * torch.linalg.slogdet(f.todense())[1]
                   for f in self.factors)


class KroneckerCholesky:
    """Per-factor Cholesky of a Kronecker operator (reference
    `cholesky(G::KroneckerProduct)` demo, README.md:194-198): d small
    n_i x n_i factorizations instead of one prod(n_i)^2 matrix. Each
    factor gets a jitter of `jitter` times its mean diagonal."""

    def __init__(self, K: KroneckerOperator, jitter: float = 1e-10):
        self.K = K
        self.Ls = []
        for f in K.factors:
            A = f.todense()
            scale = torch.mean(torch.diagonal(A))
            eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
            self.Ls.append(torch.linalg.cholesky(A + jitter * scale * eye))
        self.shape = K.shape

    def solve(self, b):
        """x = (⊗_i A_i)^{-1} b through each factor's explicit inverse and
        the mode chain."""
        return _mode_chain([torch.cholesky_inverse(L) for L in self.Ls], torch.as_tensor(b))

    def logdet(self):
        n = self.shape[0]
        return sum((n // L.shape[0]) * 2 * torch.sum(torch.log(torch.diagonal(L)))
                   for L in self.Ls)
