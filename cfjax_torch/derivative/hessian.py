"""Hessian kernels: cov of Hessian observations — O(n^2 d^2) block MVMs
(counterpart of `cfjax.derivative.hessian`, reference src/hessian.jl).
Plain torch only: cfjax has no fused kernel for these blocks.

The closed-form action of the d^2 x d^2 block on a per-point d x d
matrix is evaluated as batched einsums over row tiles
(k(x,y) = f(s), s = |x-y|^2, r = x - y, f_i = i-th derivative of the
profile):

  HH (hessian-hessian) acting on a matrix A (col-point block):
    T(A) = (16 f4 q + 8 f3 trA) r r^T + (8 f3 q + 4 f2 trA) I
           + 8 f3 (w r^T + r w^T) + 4 f2 As
  with As = A + A^T, w = As r, q = r^T A r = (1/2) r^T As r.

Dot-product trait (s = <x,y>, row point p = x_i, col point z = y_j):
    T(A) = f4 (p^T A p) z z^T + f3 ((As p) z^T + z (As p)^T) + f2 As

The ValueGradientHessian (1+d+d^2)-block forms use the cross blocks
  VG = -2 f1 r,            GV = 2 f1 r,
  VH = 4 f2 r r^T + 2 f1 I,     HV = same,
  GH_{i,kl} = 8 f3 r_i r_k r_l + 4 f2 (d_ik r_l + d_il r_k + r_i d_kl),
  HG = -GH (by x<->y antisymmetry of odd orders).
(cf. reference src/hessian.jl:279-479.)
"""

from __future__ import annotations

import dataclasses

import torch
from torch.func import grad, hessian, jacfwd, vmap

from ..kernels.base import InputTrait, Kernel, MultiKernel, input_trait
from ..kernels.derivatives import elementwise_derivatives
from ..operators.linop import LinearOperator
from ..ops.tiles import inner_tile, map_rows, sqdist_tile
from ..utils.grids import as_points
from ..utils.roofline import Work

_es = torch.einsum


# --------------------------------------------------------------------------
# Hessian-Hessian MVM
# --------------------------------------------------------------------------


def hess_matvec_iso(k, x, y, A, block=32):
    """A: (m, d, d) per-point input blocks -> (n, d, d)."""
    d = x.shape[1]
    As = A + A.transpose(1, 2)
    trA = torch.diagonal(A, dim1=1, dim2=2).sum(-1)
    eye = torch.eye(d, dtype=x.dtype, device=x.device)

    def body(xb):
        _, f1, f2, f3, f4 = elementwise_derivatives(k.profile, sqdist_tile(xb, y), 4)
        r = xb[:, None, :] - y[None, :, :]          # (B, m, d)
        w = _es("mde,bme->bmd", As, r)              # As r
        q = 0.5 * _es("bmd,bmd->bm", r, w)          # r^T A r
        c_rr = 16 * f4 * q + 8 * f3 * trA[None, :]
        c_I = torch.sum(8 * f3 * q + 4 * f2 * trA[None, :], dim=1)  # (B,)
        out = _es("bm,bmd,bme->bde", c_rr, r, r)
        wr = _es("bm,bmd,bme->bde", 8 * f3, w, r)
        out = out + wr + wr.transpose(1, 2)
        out = out + _es("bm,mde->bde", 4 * f2, As)
        return out + c_I[:, None, None] * eye[None]

    return map_rows(body, x, block, x.shape[1] ** 2)


def hess_matvec_dot(k, x, y, A, block=32):
    As = A + A.transpose(1, 2)

    def body(xb):
        _, f1, f2, f3, f4 = elementwise_derivatives(k.profile, inner_tile(xb, y), 4)
        w = _es("mde,be->bmd", As, xb)              # As p
        q = 0.5 * _es("be,bme->bm", xb, w)          # p^T A p
        out = _es("bm,md,me->bde", f4 * q, y, y)
        zw = _es("bm,bmd,me->bde", f3, w, y)        # (As p) z^T
        return out + zw.transpose(1, 2) + zw + _es("bm,mde->bde", f2, As)

    return map_rows(body, x, block, x.shape[1] ** 2)


def hess_matvec_generic(k, x, y, A, block=8):
    """4th-order nested autodiff fallback (reference src/hessian.jl:28-41)."""

    def pair(xi, yj, Aj):
        # jacfwd appends axes: hessian [i, j], then [i, j, k], then [i, j, k, l]
        T = jacfwd(jacfwd(lambda y_: hessian(lambda x_: k(x_, y_))(xi)))(yj)
        return _es("ijkl,kl->ij", T, Aj)

    def one_row(xi):
        return torch.sum(vmap(lambda yj, Aj: pair(xi, yj, Aj))(y, A), dim=0)

    return map_rows(vmap(one_row), x, block, x.shape[1] ** 2)


# --------------------------------------------------------------------------
# ValueGradientHessian MVM (isotropic closed form + generic fallback)
# --------------------------------------------------------------------------


def vgh_matvec_iso(k, x, y, a0, A1, A2, block=32):
    """(1 + d + d^2)-block MVM, isotropic. a0: (m,), A1: (m,d), A2: (m,d,d)."""
    d = x.shape[1]
    As2 = A2 + A2.transpose(1, 2)
    trA2 = torch.diagonal(A2, dim1=1, dim2=2).sum(-1)
    eye = torch.eye(d, dtype=x.dtype, device=x.device)

    def body(xb):
        f0, f1, f2, f3, f4 = elementwise_derivatives(k.profile, sqdist_tile(xb, y), 4)
        r = xb[:, None, :] - y[None, :, :]          # (B, m, d)
        rA1 = _es("bmd,md->bm", r, A1)              # <r, A1>
        w2 = _es("mde,bme->bmd", As2, r)            # As2 r
        q2 = 0.5 * _es("bmd,bmd->bm", r, w2)        # r^T A2 r

        # b0 = sum_j f0 a0 - 2 f1 <r,A1> + 4 f2 q2 + 2 f1 trA2
        b0 = torch.sum(f0 * a0[None, :] - 2 * f1 * rA1 + 4 * f2 * q2
                       + 2 * f1 * trA2[None, :], dim=1)
        # B1 = sum_j 2 f1 a0 r - 2 f1 A1 - 4 f2 <r,A1> r
        #      + 8 f3 q2 r + 4 f2 (As2 r + trA2 r)
        c_r = 2 * f1 * a0[None, :] - 4 * f2 * rA1 + 8 * f3 * q2 + 4 * f2 * trA2[None, :]
        B1 = _es("bm,bmd->bd", c_r, r) - 2 * (f1 @ A1) + 4 * _es("bm,bmd->bd", f2, w2)
        # B2 = sum_j a0 (4 f2 r r^T + 2 f1 I)
        #      - [8 f3 <r,A1> r r^T + 4 f2 (A1 r^T + r A1^T + <r,A1> I)]
        #      + HH(A2)
        c_rr = 4 * f2 * a0[None, :] - 8 * f3 * rA1 + 16 * f4 * q2 + 8 * f3 * trA2[None, :]
        c_I = torch.sum(2 * f1 * a0[None, :] - 4 * f2 * rA1 + 8 * f3 * q2
                        + 4 * f2 * trA2[None, :], dim=1)
        B2 = _es("bm,bmd,bme->bde", c_rr, r, r)
        A1r = _es("bm,md,bme->bde", 4 * f2, A1, r)  # A1 r^T weighted
        B2 = B2 - A1r - A1r.transpose(1, 2)
        wr = _es("bm,bmd,bme->bde", 8 * f3, w2, r)
        B2 = B2 + wr + wr.transpose(1, 2)
        B2 = B2 + _es("bm,mde->bde", 4 * f2, As2)
        return b0, B1, B2 + c_I[:, None, None] * eye[None]

    return map_rows(body, x, block, x.shape[1] ** 2)


def vgh_matvec_generic(k, x, y, a0, A1, A2, block=4):
    def pair(xi, yj, a0j, A1j, A2j):
        kv = k(xi, yj)
        gx = grad(lambda x_: k(x_, yj))(xi)
        gy = grad(lambda y_: k(xi, y_))(yj)
        GG = jacfwd(lambda y_: grad(lambda x_: k(x_, y_))(xi))(yj)
        HV = hessian(lambda x_: k(x_, yj))(xi)
        VH = hessian(lambda y_: k(xi, y_))(yj)
        GH = jacfwd(jacfwd(lambda y_: grad(lambda x_: k(x_, y_))(xi)))(yj)
        HG = jacfwd(lambda y_: hessian(lambda x_: k(x_, y_))(xi))(yj)
        HH = jacfwd(jacfwd(lambda y_: hessian(lambda x_: k(x_, y_))(xi)))(yj)
        b0 = kv * a0j + gy @ A1j + _es("kl,kl->", VH, A2j)
        B1 = gx * a0j + GG @ A1j + _es("ikl,kl->i", GH, A2j)
        B2 = HV * a0j + _es("ijl,l->ij", HG, A1j) + _es("ijkl,kl->ij", HH, A2j)
        return b0, B1, B2

    def one_row(xi):
        b0s, B1s, B2s = vmap(lambda yj, a0j, A1j, A2j: pair(xi, yj, a0j, A1j, A2j))(
            y, a0, A1, A2)
        return torch.sum(b0s), torch.sum(B1s, dim=0), torch.sum(B2s, dim=0)

    return map_rows(vmap(one_row), x, block, x.shape[1] ** 2)


# --------------------------------------------------------------------------
# operators + kernel wrappers
# --------------------------------------------------------------------------


class HessianGramian(LinearOperator):
    """Flat (n d^2) x (m d^2) operator; layout per point: row-major vec of
    the d x d block (reference src/hessian.jl:2-23)."""

    def __init__(self, k, x, y=None, block=None):
        self.k = k
        self.x = as_points(x)
        self.y = self.x if y is None else as_points(y)
        self._same = y is None
        self.d = self.x.shape[1]
        D = self.d * self.d
        self.shape = (self.x.shape[0] * D, self.y.shape[0] * D)
        self.dtype = self.x.dtype
        self.device = self.x.device
        t = input_trait(k)
        self.mode = ("iso" if t == InputTrait.ISOTROPIC
                     else "dot" if t == InputTrait.DOT else "generic")
        self.block = block

    @property
    def is_symmetric(self):
        return self._same

    @property
    def is_psd(self):
        return self._same and getattr(self.k, "is_mercer", False)

    def _matvec(self, v):
        d = self.d
        A = v.reshape(self.y.shape[0], d, d)
        kws = {} if self.block is None else dict(block=self.block)
        fn = {"iso": hess_matvec_iso, "dot": hess_matvec_dot}.get(self.mode, hess_matvec_generic)
        return fn(self.k, self.x, self.y, A, **kws).reshape(-1)


def work_hessian_mvm(n: int, d: int) -> Work:
    """The least work of an isotropic Hessian-gramian MVM on this card, x
    (n, d) and a flat v of n d^2, counted as cfjax's benchmark counts it
    (`benchmarks/run_baseline.py` `work_hessian_mvm`): the closed form's
    O(d^2) block contractions, 8 n^2 d^2 tensor-core flops at "highest"'s
    3 tf32 passes, ~20 fp32 instructions a pair for the profile's
    derivatives and weights. Bytes: x and v read once, the product written
    once, float32."""
    e = float(n) * n
    return Work(fp32=20 * e, tc_flops=8 * d * d * e, tc_passes=3,
                hbm_bytes=4.0 * (n * d + 2 * n * d * d))


@dataclasses.dataclass(frozen=True)
class HessianKernel(MultiKernel):
    """d^2 x d^2 matrix-valued kernel cov(hess f(x), hess f(y))
    (reference HessianKernel, src/hessian.jl:2-23)."""

    k: Kernel

    def block_shape(self, d):
        return (d * d, d * d)

    def __call__(self, x, y):
        x = torch.atleast_1d(torch.as_tensor(x))
        y = torch.atleast_1d(torch.as_tensor(y))
        d = x.shape[0]
        T = jacfwd(jacfwd(lambda y_: hessian(lambda x_: self.k(x_, y_))(x)))(y)
        return T.reshape(d * d, d * d)

    def gramian(self, x, y=None, **opts):
        return HessianGramian(self.k, x, y, **opts)


class ValueGradientHessianGramian(LinearOperator):
    """Flat (n (1+d+d^2)) x (m (1+d+d^2)) operator; per-point layout
    [value, grad (d), vec(hessian) (d^2)] (reference src/hessian.jl:279-479)."""

    def __init__(self, k, x, y=None, block=None):
        self.k = k
        self.x = as_points(x)
        self.y = self.x if y is None else as_points(y)
        self._same = y is None
        self.d = self.x.shape[1]
        self.D = 1 + self.d + self.d * self.d
        self.shape = (self.x.shape[0] * self.D, self.y.shape[0] * self.D)
        self.dtype = self.x.dtype
        self.device = self.x.device
        self.mode = "iso" if input_trait(k) == InputTrait.ISOTROPIC else "generic"
        self.block = block

    @property
    def is_symmetric(self):
        return self._same

    @property
    def is_psd(self):
        return self._same and getattr(self.k, "is_mercer", False)

    def _matvec(self, v):
        d, D = self.d, self.D
        V = v.reshape(self.y.shape[0], D)
        a0, A1, A2 = V[:, 0], V[:, 1:1 + d], V[:, 1 + d:].reshape(-1, d, d)
        kws = {} if self.block is None else dict(block=self.block)
        fn = vgh_matvec_iso if self.mode == "iso" else vgh_matvec_generic
        b0, B1, B2 = fn(self.k, self.x, self.y, a0, A1, A2, **kws)
        return torch.cat([b0[:, None], B1, B2.reshape(-1, d * d)], dim=1).reshape(-1)


@dataclasses.dataclass(frozen=True)
class ValueGradientHessianKernel(MultiKernel):
    """(1+d+d^2)^2-block kernel of (f, grad f, hess f) observations."""

    k: Kernel

    def block_shape(self, d):
        D = 1 + d + d * d
        return (D, D)

    def __call__(self, x, y):
        x = torch.atleast_1d(torch.as_tensor(x))
        y = torch.atleast_1d(torch.as_tensor(y))
        d = x.shape[0]
        k = self.k
        kv = k(x, y).reshape(1)
        gx = grad(lambda x_: k(x_, y))(x)
        gy = grad(lambda y_: k(x, y_))(y)
        GG = jacfwd(lambda y_: grad(lambda x_: k(x_, y_))(x))(y)
        HV = hessian(lambda x_: k(x_, y))(x).reshape(d * d)
        VH = hessian(lambda y_: k(x, y_))(y).reshape(d * d)
        GH = jacfwd(jacfwd(lambda y_: grad(lambda x_: k(x_, y_))(x)))(y).reshape(d, d * d)
        HG = jacfwd(lambda y_: hessian(lambda x_: k(x_, y_))(x))(y).reshape(d * d, d)
        HH = jacfwd(jacfwd(lambda y_: hessian(lambda x_: k(x_, y_))(x)))(y).reshape(d * d, d * d)
        top = torch.cat([kv, gy, VH])[None, :]
        mid = torch.cat([gx[:, None], GG, GH], dim=1)
        bot = torch.cat([HV[:, None], HG, HH], dim=1)
        return torch.cat([top, mid, bot], dim=0)

    def gramian(self, x, y=None, **opts):
        return ValueGradientHessianGramian(self.k, x, y, **opts)
