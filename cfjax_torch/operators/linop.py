"""Lazy linear-operator core (counterpart of `cfjax.operators.linop`,
reference src/lazy_linear_algebra.jl). A LinearOperator is a plain Python
object over tensors: shape + `_matvec`, with sums, products, scalings,
transposes, diagonals, fills and low-rank factors routing their MVMs
through each constituent's own fast path.
"""

from __future__ import annotations

import torch


class LinearOperator:
    """Base lazy operator: shape + matvec. Subclasses define `_matvec`
    (and optionally `_rmatvec`, `_matmat`, `todense`, `diagonal`)."""

    shape: tuple
    dtype = None

    # -- core ----------------------------------------------------------------
    def _matvec(self, v):
        raise NotImplementedError

    def _rmatvec(self, v):
        if self.is_symmetric:
            return self._matvec(v)
        raise NotImplementedError(f"{type(self).__name__} has no rmatvec")

    def _matmat(self, V):
        return torch.stack([self._matvec(V[:, j]) for j in range(V.shape[1])], dim=1)

    @property
    def is_symmetric(self) -> bool:
        return False

    @property
    def is_psd(self) -> bool:
        return False

    # -- public --------------------------------------------------------------
    def matvec(self, v):
        # a vector without a device (numpy, a list) goes to the operator's
        v = v if isinstance(v, torch.Tensor) else torch.as_tensor(
            v, device=getattr(self, "device", None))
        if v.ndim == 1:
            return self._matvec(v)
        return self._matmat(v)

    def __matmul__(self, other):
        if isinstance(other, LinearOperator):
            return ProductOperator((self, other))
        return self.matvec(other)

    def __add__(self, other):
        if isinstance(other, LinearOperator):
            return SumOperator((self, other))
        return NotImplemented

    def __mul__(self, c):
        return ScaledOperator(self, c)

    __rmul__ = __mul__

    @property
    def T(self):
        if self.is_symmetric:
            return self
        return TransposeOperator(self)

    def todense(self):
        n, m = self.shape
        return self._matmat(torch.eye(m, dtype=self.dtype or torch.get_default_dtype(),
                                      device=getattr(self, "device", None)))

    def diagonal(self):
        return torch.diagonal(self.todense())

    def add_diagonal(self, d):
        """Lazy diagonal shift (reference src/gramian.jl:55-60 `+ Diagonal`)."""
        n, m = self.shape
        if n != m:
            raise ValueError("diagonal shift needs a square operator")
        d = torch.as_tensor(d, dtype=self.dtype)
        device = getattr(self, "device", None)
        if device is not None:
            d = d.to(device)
        return SumOperator((self, DiagonalOperator(torch.broadcast_to(d, (n,)))))

    def solve(self, b, **kw):
        """Default policy: Cholesky or CG by size and structure
        (reference src/lazy_linear_algebra.jl:135-144)."""
        from .solvers import solve as _solve

        return _solve(self, b, **kw)

    def __repr__(self):
        return f"{type(self).__name__}(shape={self.shape})"


class DenseOperator(LinearOperator):
    def __init__(self, A, symmetric: bool | None = None, psd: bool = False):
        self.A = torch.as_tensor(A)
        self.shape = tuple(self.A.shape)
        self.dtype = self.A.dtype
        self.device = self.A.device
        self._sym = bool(symmetric) if symmetric is not None else False
        self._psd = psd

    @property
    def is_symmetric(self):
        return self._sym

    @property
    def is_psd(self):
        return self._psd

    def _matvec(self, v):
        return self.A @ v

    def _matmat(self, V):
        return self.A @ V

    def todense(self):
        return self.A

    def diagonal(self):
        return torch.diagonal(self.A)


class DiagonalOperator(LinearOperator):
    def __init__(self, d):
        self.d = torch.as_tensor(d)
        self.shape = (self.d.shape[0], self.d.shape[0])
        self.dtype = self.d.dtype
        self.device = self.d.device

    @property
    def is_symmetric(self):
        return True

    @property
    def is_psd(self):
        return bool(torch.all(self.d >= 0))

    def _matvec(self, v):
        return self.d * v

    def _matmat(self, V):
        return self.d[:, None] * V

    def todense(self):
        return torch.diag(self.d)

    def diagonal(self):
        return self.d

    def solve(self, b, **kw):
        return (b.T / self.d).T if b.ndim > 1 else b / self.d


class FillOperator(LinearOperator):
    """Lazy constant-fill matrix (reference `Fill` gramian of a Constant
    kernel, src/stationary.jl:34): rank-1, O(1) storage."""

    def __init__(self, c, shape):
        self.c = torch.as_tensor(c)
        self.shape = tuple(shape)
        self.dtype = self.c.dtype
        self.device = self.c.device

    @property
    def is_symmetric(self):
        return self.shape[0] == self.shape[1]

    def _matvec(self, v):
        c = self.c.to(v.device)
        return torch.full((self.shape[0],), 1.0, dtype=torch.result_type(c, v),
                          device=v.device) * torch.sum(v) * c

    def todense(self):
        return torch.full(self.shape, float(self.c), dtype=self.dtype)

    def diagonal(self):
        return torch.full((min(self.shape),), float(self.c), dtype=self.dtype)


class ZeroOperator(LinearOperator):
    def __init__(self, shape):
        self.shape = tuple(shape)

    @property
    def is_symmetric(self):
        return self.shape[0] == self.shape[1]

    def _matvec(self, v):
        return torch.zeros((self.shape[0],), dtype=v.dtype, device=v.device)

    def todense(self):
        return torch.zeros(self.shape)


class SumOperator(LinearOperator):
    """Lazy sum routing matvec through each term's fast path
    (reference LazyMatrixSum, src/lazy_linear_algebra.jl:91-133)."""

    def __init__(self, terms):
        terms = self._flatten(terms)
        shapes = {t.shape for t in terms}
        if len(shapes) != 1:
            raise ValueError(f"shape mismatch in SumOperator: {shapes}")
        self.terms = tuple(terms)
        self.shape = self.terms[0].shape
        self.dtype = self.terms[0].dtype
        self.device = getattr(self.terms[0], "device", None)

    @staticmethod
    def _flatten(terms):
        out = []
        for t in terms:
            if isinstance(t, SumOperator):
                out.extend(t.terms)
            else:
                out.append(t)
        return out

    @property
    def is_symmetric(self):
        return all(t.is_symmetric for t in self.terms)

    @property
    def is_psd(self):
        return all(t.is_psd for t in self.terms)

    def _matvec(self, v):
        out = self.terms[0]._matvec(v)
        for t in self.terms[1:]:
            out = out + t._matvec(v)
        return out

    def _matmat(self, V):
        out = self.terms[0]._matmat(V)
        for t in self.terms[1:]:
            out = out + t._matmat(V)
        return out

    def todense(self):
        out = self.terms[0].todense()
        for t in self.terms[1:]:
            out = out + t.todense()
        return out

    def diagonal(self):
        out = self.terms[0].diagonal()
        for t in self.terms[1:]:
            out = out + t.diagonal()
        return out


class ProductOperator(LinearOperator):
    """Lazy product (reference LazyMatrixProduct, src/lazy_linear_algebra.jl:17-85)."""

    def __init__(self, factors):
        factors = self._flatten(factors)
        for a, b in zip(factors[:-1], factors[1:]):
            if a.shape[1] != b.shape[0]:
                raise ValueError(f"inner shape mismatch: {a.shape} @ {b.shape}")
        self.factors = tuple(factors)
        self.shape = (factors[0].shape[0], factors[-1].shape[1])
        self.dtype = factors[0].dtype
        self.device = getattr(factors[0], "device", None)

    @staticmethod
    def _flatten(factors):
        out = []
        for f in factors:
            if isinstance(f, ProductOperator):
                out.extend(f.factors)
            else:
                out.append(f)
        return out

    def _matvec(self, v):
        for f in reversed(self.factors):
            v = f._matvec(v)
        return v

    def _matmat(self, V):
        for f in reversed(self.factors):
            V = f._matmat(V)
        return V

    def todense(self):
        out = self.factors[-1].todense()
        for f in reversed(self.factors[:-1]):
            out = f.todense() @ out
        return out


class ScaledOperator(LinearOperator):
    def __init__(self, op, c):
        self.op = op
        self.c = c
        self.shape = op.shape
        self.dtype = op.dtype
        self.device = getattr(op, "device", None)

    @property
    def is_symmetric(self):
        return self.op.is_symmetric

    def _matvec(self, v):
        return self.c * self.op._matvec(v)

    def _matmat(self, V):
        return self.c * self.op._matmat(V)

    def todense(self):
        return self.c * self.op.todense()

    def diagonal(self):
        return self.c * self.op.diagonal()


class TransposeOperator(LinearOperator):
    def __init__(self, op):
        self.op = op
        self.shape = (op.shape[1], op.shape[0])
        self.dtype = op.dtype
        self.device = getattr(op, "device", None)

    def _matvec(self, v):
        return self.op._rmatvec(v)

    def todense(self):
        return self.op.todense().T


class LowRankOperator(LinearOperator):
    """U @ V — e.g. the FiniteBasis low-rank gramian
    (reference src/mercer.jl:61-70 -> LazyMatrixProduct(U, V'))."""

    def __init__(self, U, V=None, psd=None):
        self.U = torch.as_tensor(U)
        self.V = self.U.T if V is None else torch.as_tensor(V)
        self.shape = (self.U.shape[0], self.V.shape[1])
        self.dtype = self.U.dtype
        self.device = self.U.device
        self._psd = bool(psd) if psd is not None else V is None

    @property
    def is_symmetric(self):
        return self._psd

    @property
    def is_psd(self):
        return self._psd

    @property
    def rank(self):
        return self.U.shape[1]

    def _matvec(self, v):
        return self.U @ (self.V @ v)

    def _rmatvec(self, v):
        return self.V.T @ (self.U.T @ v)

    def _matmat(self, Vm):
        return self.U @ (self.V @ Vm)

    def todense(self):
        return self.U @ self.V

    def diagonal(self):
        n = min(self.shape)
        return torch.sum(self.U[:n, :] * self.V[:, :n].T, dim=1)
