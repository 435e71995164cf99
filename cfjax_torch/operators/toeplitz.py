"""Toeplitz / circulant fast paths (counterpart of `cfjax.operators.toeplitz`,
reference src/gramian.jl:167-189 and src/toeplitz.jl).

The MVMs are FFT products (`torch.fft`, cuFFT on a GPU) with the 2n
circulant embedding. The direct O(n^2) solvers durbin, levinson and trench
run their recurrences on the live prefix (`y[:k]`, `torch.flip(y[:k])`):
one Python step per k, about ten small launches each, so on a GPU they are
bound by launch latency (O(n) sequential steps). Above n = 8192 the
symmetric solve is CG on the FFT MVM with a Strang circulant
preconditioner.

Lazy columns: a CirculantOperator or ToeplitzOperator may take a zero-arg
callable for its column (with `num`, `dtype` and `device` declared), so
construction evaluates nothing. The column is evaluated at first use and
cached, unless it carries an autograd graph (a kernel hyperparameter that
requires grad) or grad mode is off: then it is rebuilt at every use, so no
graph is reused across two backward passes.
"""

from __future__ import annotations

import math

import torch

from ..config import default_device
from .linop import LinearOperator
from .solvers import cg


# --------------------------------------------------------------------------
# FFT MVMs
# --------------------------------------------------------------------------


def circulant_matvec(c, v, m=None):
    """C v where C_ij = c[(i - j) mod n]; v is (n,) or (n, r). With `m`,
    v is zero-padded to length m (the circulant is then m x m)."""
    n = c.shape[0] if m is None else m
    if c.is_complex() or v.is_complex():
        fc = torch.fft.fft(c, n=n)
        fv = torch.fft.fft(v, n=n, dim=0)
        out = torch.fft.ifft(fc[(...,) + (None,) * (v.ndim - 1)] * fv, dim=0)
        return out if v.is_complex() else out.real.to(v.dtype)
    fc = torch.fft.rfft(c, n=n)
    fv = torch.fft.rfft(v, n=n, dim=0)
    out = torch.fft.irfft(fc[(...,) + (None,) * (v.ndim - 1)] * fv, n=n, dim=0)
    return out.to(v.dtype)


def toeplitz_matvec(col, row, v):
    """T v via circulant embedding of size 2n: T_ij = col[i-j] (i>=j),
    row[j-i] (j>i)."""
    n = col.shape[0]
    c = torch.cat([col, col.new_zeros(1), torch.flip(row[1:], (0,))])
    return circulant_matvec(c, v, 2 * n)[:n]


def _toeplitz_dense(col, row):
    n = col.shape[0]
    i = torch.arange(n, device=col.device)
    d = i[:, None] - i[None, :]
    return torch.where(d >= 0, col[d.abs()], row[d.abs()])


def _circulant_dense(c):
    n = c.shape[0]
    i = torch.arange(n, device=c.device)
    return c[torch.remainder(i[:, None] - i[None, :], n)]


def _lazy(op, name):
    """The tensor held in op.<name>, evaluating a callable source (and
    caching it when that is safe, see the module docstring)."""
    src = getattr(op, name)
    if not callable(src):
        return src
    v = torch.as_tensor(src()).to(device=op.device, dtype=op.dtype)
    if v.shape[0] != op.shape[0]:
        raise ValueError(f"lazy column evaluated to length {v.shape[0]}, "
                         f"declared num={op.shape[0]}")
    if torch.is_grad_enabled() and not v.requires_grad:
        setattr(op, name, v)
    return v


class _Lazy1D(LinearOperator):
    """Shape, dtype and device of an operator given by an O(n) column
    that may be a callable."""

    def _declare(self, src, num, dtype, device):
        if callable(src):
            if num is None:
                raise ValueError(
                    f"{type(self).__name__} with a callable column needs `num` (the size): "
                    "shape metadata must exist before the first column evaluation")
            self.dtype = torch.get_default_dtype() if dtype is None else dtype
            self.device = default_device(device)
            self.shape = (num, num)
            return src
        src = torch.as_tensor(src)
        self.dtype, self.device = src.dtype, src.device
        self.shape = (src.shape[0], src.shape[0])
        return src


class CirculantOperator(_Lazy1D):
    """Lazy circulant matrix (reference `Circulant` path,
    src/gramian.jl:186-189): O(n) storage, FFT MVM, exact spectral solve.
    `c` is the first column, or a zero-arg callable returning it."""

    def __init__(self, c, *, num=None, dtype=None, device=None):
        self._c_src = self._declare(c, num, dtype, device)

    @property
    def c(self):
        return _lazy(self, "_c_src")

    @property
    def is_symmetric(self):
        # circulant from an even symbol (c[k] == c[n-k]) is symmetric
        c = self.c
        return bool(torch.allclose(c[1:], torch.flip(c[1:], (0,))))

    @property
    def is_psd(self):
        return bool(torch.all(torch.fft.fft(self.c).real > 0))

    def _matvec(self, v):
        return circulant_matvec(self.c, v)

    _matmat = _matvec

    def eigenvalues(self):
        return torch.fft.fft(self.c)

    def solve(self, b, **kw):
        b = torch.as_tensor(b)
        c = self.c
        n = self.shape[0]
        if c.is_complex() or b.is_complex():
            fc = torch.fft.fft(c)[(...,) + (None,) * (b.ndim - 1)]
            x = torch.fft.ifft(torch.fft.fft(b, dim=0) / fc, dim=0)
            return x if b.is_complex() else x.real.to(b.dtype)
        fc = torch.fft.rfft(c)[(...,) + (None,) * (b.ndim - 1)]
        return torch.fft.irfft(torch.fft.rfft(b, dim=0) / fc, n=n, dim=0).to(b.dtype)

    def logdet(self):
        return torch.sum(torch.log(torch.abs(torch.fft.fft(self.c))))

    def todense(self):
        return _circulant_dense(self.c)

    def diagonal(self):
        return self.c[:1].expand(self.shape[0])


class ToeplitzOperator(_Lazy1D):
    """Lazy (possibly non-symmetric) Toeplitz matrix: O(n) storage, FFT MVM
    (reference SymmetricToeplitz/Toeplitz gramians, src/gramian.jl:167-183).
    `col`/`row` may be zero-arg callables (with `num` giving the size)."""

    def __init__(self, col, row=None, *, num=None, dtype=None, device=None):
        if callable(row) and num is None:
            raise ValueError("ToeplitzOperator with a callable row needs `num` (the size)")
        self._col_src = self._declare(col, num, dtype, device)
        self._row_src = row if row is None or callable(row) else torch.as_tensor(row)
        if (not callable(col) and row is not None and not callable(row)
                and self._row_src.shape[0] != self.shape[0]):
            raise ValueError("only square Toeplitz supported")
        self._sym = row is None

    @property
    def col(self):
        return _lazy(self, "_col_src")

    @property
    def row(self):
        if self._row_src is None:
            return self.col
        return _lazy(self, "_row_src")

    @property
    def is_symmetric(self):
        return self._sym

    @property
    def is_psd(self):
        # symmetry alone does NOT imply PSD (a Cosine-kernel Toeplitz is
        # indefinite). Sufficient check: if the 2n-2 circulant embedding's
        # symbol is nonnegative, the Toeplitz (a principal submatrix) is
        # PSD. A false negative only routes solve() to MINRES, which is
        # correct for any symmetric system. The relative tolerance is
        # cfjax's 1e-10, widened to the dtype's resolution: rounding a
        # float32 column moves the symbol by ~eps * max|symbol| (Exp on a
        # 65536-point grid: true minimum +4.8e-6, float32 minimum -1e-3).
        if not self._sym:
            return False
        col = self.col
        n = self.shape[0]
        rtol = max(1e-10, 8 * torch.finfo(col.dtype).eps * math.log2(max(n, 2)))
        c = torch.cat([col, torch.flip(col[1:-1], (0,))])
        lam = torch.fft.fft(c).real
        if bool(torch.all(lam >= -rtol * torch.max(torch.abs(lam)))):
            return True
        # embedding-indefinite does not decide the Toeplitz itself; for
        # modest n settle it exactly, else stay conservative
        if n <= 2048:
            ev = torch.linalg.eigvalsh(self.todense())
            return bool(ev[0] >= -rtol * max(float(torch.abs(ev[-1])), 1.0))
        return False

    def _matvec(self, v):
        return toeplitz_matvec(self.col, self.row, v)

    _matmat = _matvec

    def _rmatvec(self, v):
        return toeplitz_matvec(self.row, self.col, v)

    def todense(self):
        return _toeplitz_dense(self.col, self.row)

    def diagonal(self):
        return self.col[:1].expand(self.shape[0])

    def strang_preconditioner(self):
        """Strang circulant preconditioner solve-closure for PCG."""
        n = self.shape[0]
        col = self.col
        k = torch.arange(n, device=col.device)
        c = torch.where(k <= n // 2, col, col[(n - k) % n])
        fc = torch.fft.rfft(c).real
        # relative eigenvalue floor: near-singular circulant modes would
        # amplify roundoff and destabilize PCG (esp. in float32)
        fc = torch.maximum(fc, 1e-4 * torch.max(torch.abs(fc)))

        def Minv(v):
            return torch.fft.irfft(torch.fft.rfft(v) / fc, n=n).to(v.dtype)

        return Minv

    def solve(self, b, method: str = "auto", tol=None, maxiter=None, **kw):
        """Direct O(n^2) Levinson up to n = 8192, else CG on the FFT MVM
        with the Strang preconditioner (reference levinson,
        src/toeplitz.jl:100-111). A non-symmetric Toeplitz is solved by
        CGNR on the FFT MVM (src/lazy_linear_algebra.jl:135-144)."""
        from .solvers import solve as _solve

        if not self._sym:
            return _solve(self, b, tol=tol, maxiter=maxiter, method="cgnr")
        b = torch.as_tensor(b)
        if method == "auto":
            method = "levinson" if self.shape[0] <= 8192 else "cg"
        if method == "levinson":
            f = lambda bb: levinson(self.col, bb)
        else:
            Minv = self.strang_preconditioner()
            f = lambda bb: cg(self._matvec, bb, tol=tol, maxiter=maxiter, M=Minv)[0]
        if b.ndim > 1:
            return torch.stack([f(b[:, j]) for j in range(b.shape[1])], dim=1)
        return f(b)


# --------------------------------------------------------------------------
# Direct O(n^2) recurrences (durbin / levinson / trench)
# --------------------------------------------------------------------------


def durbin(r):
    """Solve T y = -r where T = SymToeplitz([1, r[:n-1]]) (Yule-Walker),
    reference src/toeplitz.jl:12-27."""
    r = torch.as_tensor(r)
    n = r.shape[0]
    y = torch.zeros_like(r)
    y[0] = -r[0]
    alpha, beta = -r[0], torch.ones((), dtype=r.dtype, device=r.device)
    for k in range(1, n):
        beta = beta * (1 - alpha * alpha)
        yrev = torch.flip(y[:k], (0,))
        alpha = -(r[k] + torch.dot(r[:k], yrev)) / beta
        y[:k] += alpha * yrev
        y[k] = alpha
    return y


def _levinson_normalized(r, b):
    """Solve K x = b, K = SymToeplitz([1, r]) (diagonal normalized to 1),
    reference src/toeplitz.jl:76-96."""
    n = b.shape[0]
    x = torch.zeros_like(b)
    x[0] = b[0]
    y = torch.zeros_like(r)
    y[0] = -r[0]
    alpha, beta = -r[0], torch.ones((), dtype=b.dtype, device=b.device)
    for k in range(1, n):
        beta = beta * (1 - alpha * alpha)
        r_k = r[:k]
        yrev = torch.flip(y[:k], (0,))
        mu = (b[k] - torch.dot(r_k, torch.flip(x[:k], (0,)))) / beta
        x[:k] += mu * yrev
        x[k] = mu
        if k < n - 1:
            alpha = -(r[k] + torch.dot(r_k, yrev)) / beta
            y[:k] += alpha * yrev
            y[k] = alpha
    return x


def levinson(col, b):
    """Solve SymToeplitz(col) x = b; normalizes the diagonal like the
    reference (src/toeplitz.jl:100-111)."""
    col = torch.as_tensor(col)
    b = torch.as_tensor(b)
    r0 = col[0]
    return _levinson_normalized(col[1:] / r0, b) / r0


def _trench_normalized(r):
    """Inverse of K = SymToeplitz([1, r]) (Trench's algorithm, reference
    src/toeplitz.jl:56-71). The reference's sequential fill
    B[i,j] = B[i-1,j-1] + w_ij is a prefix sum along diagonals, computed
    as a cumulative sum over a skewed copy of W (one gather)."""
    n = r.shape[0] + 1
    y = durbin(r)
    gamma = 1.0 / (1.0 + torch.dot(r, y))
    nu = gamma * torch.flip(y, (0,))  # nu[i] = gamma * y[n-2-i], length n-1
    row0 = torch.cat([gamma[None], gamma * y])

    # W[i-1, j-1] = (nu[n-1-j] nu[n-1-i] - nu[i-1] nu[j-1]) / gamma, i, j in 1..n-1
    u = torch.flip(nu, (0,))
    W = (torch.outer(u, u) - torch.outer(nu, nu)) / gamma
    # skew W so diagonals become columns: S[t, d] = W[t, (d + t) mod (n-1)]
    t = torch.arange(n - 1, device=r.device)
    S = torch.gather(W, 1, (t[None, :] + t[:, None]) % (n - 1))
    C = torch.cumsum(S, dim=0)  # C[i-1, d] = sum_{t<=i} W[t, d+t]

    # upper triangle: B[i, j] = row0[j-i] + C[i-1, j-i] for 1 <= i <= j
    i = torch.arange(n, device=r.device)
    ii, d = i[:, None], i[None, :] - i[:, None]
    dc = d.clamp(0, n - 1)
    valid = (ii >= 1) & (d >= 0) & (d <= n - 1 - ii)
    Cpad = torch.nn.functional.pad(C, (0, 1, 1, 0))  # row for i = 0, column guard
    B = torch.where(d >= 0, row0[dc] + torch.where(valid, Cpad[ii, dc], 0.0), 0.0)
    return B + torch.triu(B, 1).T


def trench(col):
    """Inverse of SymToeplitz(col) (src/toeplitz.jl:31-54)."""
    col = torch.as_tensor(col)
    r0 = col[0]
    return _trench_normalized(col[1:] / r0) / r0
