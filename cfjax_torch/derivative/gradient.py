"""Gradient kernels: cov(grad f(x), grad f(y)), the O(n^2 d) path
(counterpart of `cfjax.derivative.gradient`, reference src/gradient.jl).

The whole block MVM is organized as a few dense products per row block:

isotropic trait (src/gradient.jl:86-92: block = -2 f' I - 4 f'' r r^T):
    b_i = sum_j [-2 K1_ij A_j - 4 K2_ij r_ij <r_ij, A_j>]
dot-product trait (src/gradient.jl:109-115: block = f' I + f'' y x^T):
    b = K1 @ A + (K2 * (X A^T)) @ Y
stationary-linear-functional (src/gradient.jl:129-136: block = -f'' c c^T):
    b = -(K2 @ (A c)) outer c

On float32 CUDA tensors the iso and dot MVMs run on the hand-written
kernel K3 (`cfjax_torch.ops.grad_mvm`) when the kernel has a derivative
spec; `GradientGramian.kernel_reason` says why not otherwise, and
`operators.dispatch.explain` prints it. The scalar derivative stacks come
from `torch.func.grad` of the (possibly composite) profile, so
Sum/Product/Power/Chained composites of one trait need no special-casing
(cf. src/gradient_algebra.jl). Heterogeneous-trait Sums are operator sums
of per-term plans (src/gradient_algebra.jl:31-36); everything else falls
back to a vmap-of-jacobian generic path (src/gradient.jl:27-42).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.func import grad, jacfwd, jvp, vmap

from ..kernels.base import InputTrait, Kernel, MultiKernel, input_trait
from ..kernels.derivatives import elementwise_derivatives
from ..kernels.parameters import to_points
from ..kernels.profile_spec import to_spec
from ..operators.gramian import slf_vector
from ..operators.linop import LinearOperator, SumOperator, ZeroOperator
from ..ops import grad_mvm as _grad_mvm
from ..ops.tiles import inner_tile, map_rows, matmul_p, sqdist_tile
from ..utils.grids import as_points
from ..utils.roofline import Work


# --------------------------------------------------------------------------
# trait-specialized full-gramian block MVMs
# --------------------------------------------------------------------------


def grad_matvec_iso(k, x, y, A, block=256):
    """(n d) x (m d) gradient-gramian MVM, isotropic trait. A: (m, d)."""
    return _grad_mvm.grad_matvec_plain(k, x, y, A, "iso", block)


def grad_matvec_dot(k, x, y, A, block=256):
    return _grad_mvm.grad_matvec_plain(k, x, y, A, "dot", block)


def grad_matvec_slf(k, x, y, A, block=512):
    c = slf_vector(k).to(device=x.device, dtype=x.dtype)
    u = A @ c  # <c, A_j>
    ty = y @ c

    def body(xb):
        _, _, k2 = elementwise_derivatives(k.profile, (xb @ c)[:, None] - ty[None, :], 2)
        return -matmul_p(k2, u)[:, None] * c[None, :]

    return map_rows(body, x, block, x.shape[1])


def _pair_block_apply(k):
    """Generic per-pair (grad_x grad_y^T k) @ a (src/gradient.jl:27-42
    fallback, via forward-over-reverse)."""

    def f(xi, yj, aj):
        gx = lambda y_: grad(lambda x_: k(x_, y_))(xi)
        return jvp(gx, (yj,), (aj,))[1]

    return f


def grad_matvec_generic(k, x, y, A, block=32):
    pair = _pair_block_apply(k)

    def one_row(xi):
        return torch.sum(vmap(lambda yj, aj: pair(xi, yj, aj))(y, A), dim=0)

    return map_rows(vmap(one_row), x, block, x.shape[1])


# --------------------------------------------------------------------------
# value+gradient (d+1 blocks) MVMs
# --------------------------------------------------------------------------


def valgrad_matvec_iso(k, x, y, a0, A, block=256):
    """(1+d)-block MVM, isotropic: K = [[f, (grad_y f)^T], [grad_x f, GG]]
    with grad_x k = 2 f' r, grad_y k = -2 f' r (reference
    value_gradient_covariance!, src/gradient.jl:480-544)."""
    t = torch.sum(y * A, dim=1)

    def body(xb):
        k0, k1, k2 = elementwise_derivatives(k.profile, sqdist_tile(xb, y), 2)
        R = inner_tile(xb, A) - t[None, :]  # <r_ij, A_j>
        b0 = matmul_p(k0, a0) - 2.0 * torch.sum(k1 * R, dim=1)
        Wa = k1 * a0[None, :]
        W = k2 * R
        b1 = (2.0 * (torch.sum(Wa, dim=1)[:, None] * xb - matmul_p(Wa, y))
              - 2.0 * matmul_p(k1, A)
              - 4.0 * (torch.sum(W, dim=1)[:, None] * xb - matmul_p(W, y)))
        return torch.cat([b0[:, None], b1], dim=1)

    return map_rows(body, x, block, 1 + x.shape[1])


def valgrad_matvec_dot(k, x, y, a0, A, block=256):
    """(1+d)-block MVM, dot trait: grad_x k = f' y, grad_y k = f' x."""

    def body(xb):
        k0, k1, k2 = elementwise_derivatives(k.profile, inner_tile(xb, y), 2)
        P = inner_tile(xb, A)
        b0 = matmul_p(k0, a0) + torch.sum(k1 * P, dim=1)
        b1 = matmul_p(k1 * a0[None, :], y) + matmul_p(k1, A) + matmul_p(k2 * P, y)
        return torch.cat([b0[:, None], b1], dim=1)

    return map_rows(body, x, block, 1 + x.shape[1])


def valgrad_matvec_generic(k, x, y, a0, A, block=32):
    def pair(xi, yj, a0j, aj):
        kv = k(xi, yj)
        gy = grad(lambda y_: k(xi, y_))(yj)
        gx_fn = lambda y_: grad(lambda x_: k(x_, y_))(xi)
        gx, blk_a = jvp(gx_fn, (yj,), (aj,))
        return kv * a0j + torch.dot(gy, aj), gx * a0j + blk_a

    def one_row(xi):
        b0s, b1s = vmap(lambda yj, a0j, aj: pair(xi, yj, a0j, aj))(y, a0, A)
        return torch.cat([torch.sum(b0s)[None], torch.sum(b1s, dim=0)])

    return map_rows(vmap(one_row), x, block, 1 + x.shape[1])


# --------------------------------------------------------------------------
# operators + kernel wrappers
# --------------------------------------------------------------------------


def select_grad_kernel(g):
    """(derivative spec, decline reason) for a GradientGramian. The rules
    are correctness-only: an iso or dot gramian of float32 CUDA tensors,
    nothing requiring grad and a kernel with a derivative spec takes K3, at
    every matmul tier; the plain path keeps the reason."""
    if g.mode not in ("iso", "dot"):
        return None, f"gradient mode {g.mode!r} (K3 covers iso/dot)"
    if not (g.x.is_cuda and g.y.is_cuda):
        return None, f"tensors on {g.x.device.type}: K3 needs a CUDA device"
    if g.x.dtype != torch.float32 or g.y.dtype != torch.float32:
        return None, f"dtype {g.x.dtype}: K3 takes float32"
    if g.x.requires_grad or g.y.requires_grad or any(
            b.requires_grad for b in g.k.buffers()):
        return None, "an input requires grad (K3 is forward-only)"
    spec, why = to_spec(g.k, derivative=True)
    if spec is None:
        return None, f"no derivative spec: {why}"
    return spec, None


class GradientGramian(LinearOperator):
    """Flat (n d) x (m d) lazy operator over d x d gradient blocks.

    Flat vector layout is point-major: v[j*d + l] = A[j, l] (the analogue
    of the reference's BlockFactorization flattening, src/gramian.jl:120-130)."""

    def __init__(self, k, x, y=None, block=None):
        self.k = k
        self.x = as_points(x).contiguous()
        self.y = self.x if y is None else as_points(y).contiguous()
        self._same = y is None
        self.d = self.x.shape[1]
        self.shape = (self.x.shape[0] * self.d, self.y.shape[0] * self.d)
        self.dtype = self.x.dtype if self.x.is_floating_point() else torch.get_default_dtype()
        self.device = self.x.device
        self.mode = _grad_mode(k)
        self.block = block
        self._spec, self.kernel_reason = select_grad_kernel(self)
        # the hyperparameters on the points' device and dtype, once (the spec
        # above reads the kernel as given); a real-nu Matern's jet tables go
        # to the card here too
        self.k = to_points(k, self.x)
        if self._spec is not None:
            _grad_mvm.jet_table(self._spec, self.device)

    @property
    def is_symmetric(self):
        return self._same

    @property
    def is_psd(self):
        # PSD holds for the derivative gramian of a genuine Mercer kernel
        # (cov of derivatives); don't claim it from symmetry alone
        return self._same and getattr(self.k, "is_mercer", False)

    def _apply(self, A):
        if (self._spec is not None and A.dtype == torch.float32
                and not A.requires_grad):
            return _grad_mvm.grad_matvec(self.k, self.x, self.y, A.contiguous(),
                                         self.mode, spec=self._spec)
        kws = {} if self.block is None else dict(block=self.block)
        if self.mode == "iso":
            return grad_matvec_iso(self.k, self.x, self.y, A, **kws)
        if self.mode == "dot":
            return grad_matvec_dot(self.k, self.x, self.y, A, **kws)
        if self.mode == "slf":
            return grad_matvec_slf(self.k, self.x, self.y, A, **kws)
        if self.mode == "pair":
            from .pair import grad_matvec_pair

            return grad_matvec_pair(self.k, self.x, self.y, A, **kws)
        return grad_matvec_generic(self.k, self.x, self.y, A, **kws)

    def _matvec(self, v):
        A = v.reshape(self.y.shape[0], self.d)
        return self._apply(A).reshape(-1)


def work_gradient_mvm(n: int, d: int) -> Work:
    """The least work of a gradient-gramian MVM on this card, x (n, d) and
    a flat v of n d, counted as cfjax's benchmark counts it
    (`benchmarks/run_baseline.py` `work_gradient_mvm`): four (n, d) x (d, n)
    products, 8 n^2 d tensor-core flops at "highest"'s 3 tf32 passes; per
    pair the derivative evaluations off one shared exp (one SFU operation)
    and ~12 elementwise fp32 instructions (the weights, row sums and
    epilogue). A composite in the "pair" form shares one tile and one set
    of contractions whatever its terms, so it counts as one. Bytes: x and v
    read once, the product written once, float32."""
    e = float(n) * n
    return Work(fp32=12 * e, sfu=e, tc_flops=8 * d * e, tc_passes=3,
                hbm_bytes=4.0 * 3 * n * d)


def _grad_mode(k) -> str:
    from .pair import pair_family_available

    t = input_trait(k)
    if t == InputTrait.ISOTROPIC:
        return "iso"
    if t == InputTrait.DOT:
        return "dot"
    if t == InputTrait.STATIONARY_LINEAR_FUNCTIONAL:
        try:
            slf_vector(k)
            return "slf"
        except ValueError:
            return "generic"
    if pair_family_available(k):
        return "pair"  # NN kernel + heterogeneous iso/dot/NN composites
    return "generic"


def _flat_size(x, y):
    xp = as_points(x)
    m = xp.shape[0] if y is None else as_points(y).shape[0]
    return xp.shape[0] * xp.shape[1], m * xp.shape[1]


def _linear_map(U):
    return lambda z: U.to(device=z.device, dtype=z.dtype) @ z


@dataclasses.dataclass(frozen=True)
class GradientKernel(MultiKernel):
    """d x d matrix-valued kernel cov(grad f(x), grad f(y))
    (reference GradientKernel, src/gradient.jl:7-24)."""

    k: Kernel

    def block_shape(self, d):
        return (d, d)

    def __call__(self, x, y):
        x = torch.atleast_1d(torch.as_tensor(x))
        y = torch.atleast_1d(torch.as_tensor(y))
        return jacfwd(lambda y_: grad(lambda x_: self.k(x_, y_))(x))(y)

    def gramian(self, x, y=None, **opts):
        from ..kernels.algebra import SeparableProduct, SeparableSum, Sum
        from ..kernels.stationary import Constant
        from ..kernels.transforms import Chained, ScaledInputKernel, VerticalRescaling, Warped

        k = self.k
        # per-dimension separable kernels (src/gradient_algebra.jl:93-145)
        if isinstance(k, (SeparableProduct, SeparableSum)):
            return SeparableGradientGramian(k, x, y, **opts)
        # input-transform chain rule: J^T Block J conjugation
        # (src/gradient_algebra.jl:149-163)
        if isinstance(k, Warped):
            return JacobianConjugatedGradientGramian(k.k, k.u, x, y, **opts)
        if isinstance(k, ScaledInputKernel):
            return JacobianConjugatedGradientGramian(k.k, _linear_map(k.U), x, y, **opts)
        # f(x) h f(y): one value+gradient MVM of h (rank-2 Woodbury
        # analogue, src/gradient_algebra.jl:177-202)
        if isinstance(k, VerticalRescaling):
            return VerticalRescalingGradientGramian(k.k, k.f, x, y, **opts)
        # Chained of a trait-less kernel: diag(f') H + rank-1 f''
        # correction (src/gradient_algebra.jl:207-227); trait-carrying
        # Chained stays on the composed-profile fast paths
        if isinstance(k, Chained) and _grad_mode(k) == "generic":
            return ChainedGradientGramian(k, x, y, **opts)
        if isinstance(k, Constant):
            return ZeroOperator(_flat_size(x, y))
        # heterogeneous-trait sum -> operator sum of per-term plans
        # (src/gradient_algebra.jl:31-36)
        if isinstance(k, Sum) and _grad_mode(k) == "generic":
            terms = [GradientKernel(a).gramian(x, y, **opts) for a in k.args
                     if not isinstance(a, Constant)]  # constants: zero blocks
            if not terms:
                n = _flat_size(x, None)[0]
                return ZeroOperator((n, n))
            return terms[0] if len(terms) == 1 else SumOperator(tuple(terms))
        return GradientGramian(k, x, y, **opts)


@dataclasses.dataclass(frozen=True)
class ValueGradientKernel(MultiKernel):
    """(1+d) x (1+d) matrix-valued kernel of (f, grad f) observations
    (reference ValueGradientKernel, src/gradient.jl:400-474)."""

    k: Kernel

    def block_shape(self, d):
        return (d + 1, d + 1)

    def __call__(self, x, y):
        x = torch.atleast_1d(torch.as_tensor(x))
        y = torch.atleast_1d(torch.as_tensor(y))
        kv = self.k(x, y)
        gx = grad(lambda x_: self.k(x_, y))(x)
        gy = grad(lambda y_: self.k(x, y_))(y)
        blk = jacfwd(lambda y_: grad(lambda x_: self.k(x_, y_))(x))(y)
        top = torch.cat([kv.reshape(1), gy])[None, :]
        bottom = torch.cat([gx[:, None], blk], dim=1)
        return torch.cat([top, bottom], dim=0)

    def gramian(self, x, y=None, **opts):
        """Combinator-routed (1+d)-block gramian (reference
        value_gradient_covariance! Sum/Product recursion,
        src/gradient.jl:480-544, and the gradient_algebra.jl transform
        rules lifted to the value row)."""
        from ..kernels.algebra import Sum
        from ..kernels.stationary import Constant
        from ..kernels.transforms import ScaledInputKernel, VerticalRescaling, Warped

        k = self.k
        if isinstance(k, Warped):
            return JacobianConjugatedValueGradientGramian(k.k, k.u, x, y, **opts)
        if isinstance(k, ScaledInputKernel):
            return JacobianConjugatedValueGradientGramian(k.k, _linear_map(k.U), x, y, **opts)
        if isinstance(k, VerticalRescaling):
            return VerticalRescalingValueGradientGramian(k.k, k.f, x, y, **opts)
        if isinstance(k, Constant):
            return ConstantValueGradientGramian(k.c, x, y)
        if isinstance(k, Sum) and _grad_mode(k) == "generic":
            terms = [ValueGradientKernel(a).gramian(x, y, **opts) for a in k.args]
            return terms[0] if len(terms) == 1 else SumOperator(tuple(terms))
        return ValueGradientGramian(self.k, x, y, **opts)


class ValueGradientGramian(LinearOperator):
    """Flat (n (1+d)) x (m (1+d)) operator; layout per point: [value, grad...].
    Plain torch only: cfjax has no fused kernel for value+gradient blocks."""

    def __init__(self, k, x, y=None, block=None):
        self.x = as_points(x)
        self.k = to_points(k, self.x)
        self.y = self.x if y is None else as_points(y)
        self._same = y is None
        self.d = self.x.shape[1]
        D = self.d + 1
        self.shape = (self.x.shape[0] * D, self.y.shape[0] * D)
        self.dtype = self.x.dtype
        self.device = self.x.device
        self.mode = _grad_mode(k)
        self.block = block

    @property
    def is_symmetric(self):
        return self._same

    @property
    def is_psd(self):
        return self._same and getattr(self.k, "is_mercer", False)

    def _matvec(self, v):
        V = v.reshape(self.y.shape[0], self.d + 1)
        a0, A = V[:, 0], V[:, 1:]
        kws = {} if self.block is None else dict(block=self.block)
        if self.mode == "iso":
            out = valgrad_matvec_iso(self.k, self.x, self.y, a0, A, **kws)
        elif self.mode == "dot":
            out = valgrad_matvec_dot(self.k, self.x, self.y, a0, A, **kws)
        elif self.mode == "pair":
            from .pair import valgrad_matvec_pair

            out = valgrad_matvec_pair(self.k, self.x, self.y, a0, A, **kws)
        else:
            out = valgrad_matvec_generic(self.k, self.x, self.y, a0, A, **kws)
        return out.reshape(-1)


class ConstantValueGradientGramian(LinearOperator):
    """(1+d)-block gramian of a Constant kernel: value block = c fill,
    all derivative blocks zero (reference value_gradient_covariance! on
    Constant terms; cf. src/gradient.jl:158-168 for the gradient case)."""

    def __init__(self, c, x, y=None, **_):
        xp = as_points(x)
        yp = xp if y is None else as_points(y)
        self._same = y is None
        self.c = torch.as_tensor(c)
        self.d = xp.shape[1]
        self.n, self.m = xp.shape[0], yp.shape[0]
        D = self.d + 1
        self.shape = (self.n * D, self.m * D)
        self.dtype = xp.dtype
        self.device = xp.device

    @property
    def is_symmetric(self):
        return self._same

    @property
    def is_psd(self):
        return self._same

    def _matvec(self, v):
        D = self.d + 1
        a0 = v.reshape(self.m, D)[:, 0]
        out = torch.zeros((self.n, D), dtype=v.dtype, device=v.device)
        out[:, 0] = self.c.to(device=v.device, dtype=v.dtype) * torch.sum(a0)
        return out.reshape(-1)


def _jacobians(u, xp, yp, same):
    """Warped points and per-point Jacobians (n, d_out, d_in) of u."""
    def warp(p):
        w = vmap(u)(p)
        return w[:, None] if w.ndim == 1 else w

    def jac(p):
        J = vmap(jacfwd(u))(p)
        return J[:, None, :] if J.ndim == 2 else J

    ux, Jx = warp(xp), jac(xp)
    uy, Jy = (ux, Jx) if same else (warp(yp), jac(yp))
    return ux, uy, Jx, Jy


class JacobianConjugatedValueGradientGramian(LinearOperator):
    """(1+d)-block gramian of k(u(x), u(y)): the value row is untouched,
    the gradient rows are conjugated by the per-point Jacobians — i.e.
    blockdiag(1, J_x)^T [VG of k at u-points] blockdiag(1, J_y)
    (reference src/gradient_algebra.jl:149-163 lifted to the value row,
    src/gradient.jl:480-544)."""

    def __init__(self, inner_kernel, u, x, y=None, block=None):
        xp = as_points(x)
        yp = xp if y is None else as_points(y)
        self._same = y is None
        ux, uy, self.Jx, self.Jy = _jacobians(u, xp, yp, self._same)
        self.inner = ValueGradientGramian(inner_kernel, ux, None if self._same else uy,
                                          block=block)
        self.d = xp.shape[1]
        self.d_out = ux.shape[1]
        self.shape = (xp.shape[0] * (self.d + 1), yp.shape[0] * (self.d + 1))
        self.dtype = self.inner.dtype
        self.device = self.inner.device

    @property
    def is_symmetric(self):
        return self._same

    @property
    def is_psd(self):
        return self._same and getattr(self.inner.k, "is_mercer", False)

    def _matvec(self, v):
        m = self.shape[1] // (self.d + 1)
        V = v.reshape(m, self.d + 1)
        a0, A = V[:, 0], V[:, 1:]
        A_up = torch.einsum("moi,mi->mo", self.Jy, A)
        Vin = torch.cat([a0[:, None], A_up], dim=1)
        out_up = (self.inner @ Vin.reshape(-1)).reshape(-1, self.d_out + 1)
        B = torch.einsum("noi,no->ni", self.Jx, out_up[:, 1:])
        return torch.cat([out_up[:, :1], B], dim=1).reshape(-1)


def _rescaling(f, xp, yp, same):
    fx, gfx = vmap(f)(xp), vmap(grad(f))(xp)
    fy, gfy = (fx, gfx) if same else (vmap(f)(yp), vmap(grad(f))(yp))
    return fx, gfx, fy, gfy


class VerticalRescalingValueGradientGramian(LinearOperator):
    """(1+d)-block gramian of k(x,y) = f(x) h(x,y) f(y). Rides ONE inner
    value+gradient MVM of h (same trick as the gradient-only case below):
    with alpha_j = f_j a0_j + <grad f_j, A_j> and beta_j = f_j A_j,
        out0_i = f_i * vg0_i
        outg_i = grad f_i * vg0_i + f_i * vg1_i
    where (vg0, vg1) = VG(h) @ (alpha, beta) (reference
    src/gradient_algebra.jl:177-202 + src/gradient.jl:480-544)."""

    def __init__(self, h, f, x, y=None, block=None):
        self.f = f
        xp = as_points(x)
        yp = xp if y is None else as_points(y)
        self._same = y is None
        self.d = xp.shape[1]
        self.fx, self.gfx, self.fy, self.gfy = _rescaling(f, xp, yp, self._same)
        self.inner = ValueGradientGramian(h, xp, None if self._same else yp, block=block)
        D = self.d + 1
        self.shape = (xp.shape[0] * D, yp.shape[0] * D)
        self.dtype = self.inner.dtype
        self.device = self.inner.device

    @property
    def is_symmetric(self):
        return self._same

    @property
    def is_psd(self):
        return self._same and getattr(self.inner.k, "is_mercer", False)

    def _matvec(self, v):
        m = self.shape[1] // (self.d + 1)
        V = v.reshape(m, self.d + 1)
        a0, A = V[:, 0], V[:, 1:]
        alpha = self.fy * a0 + torch.sum(self.gfy * A, dim=1)
        Vin = torch.cat([alpha[:, None], self.fy[:, None] * A], dim=1)
        vg = (self.inner @ Vin.reshape(-1)).reshape(-1, self.d + 1)
        out0 = self.fx * vg[:, 0]
        outg = self.gfx * vg[:, :1] + self.fx[:, None] * vg[:, 1:]
        return torch.cat([out0[:, None], outg], dim=1).reshape(-1)


# --------------------------------------------------------------------------
# input-transform chain rule: U^T Block U conjugation
# --------------------------------------------------------------------------


class JacobianConjugatedGradientGramian(LinearOperator):
    """Gradient gramian of k(u(x), u(y)): per-pair block J_u(x)^T B J_u(y)
    (reference src/gradient_algebra.jl:149-163: Warped/ScaledInput gramians
    factored as U^T G U with block-diagonal Jacobians). Realized as
    per-point Jacobian contraction around the inner fast-path MVM, which
    takes K3 where its GradientGramian does."""

    def __init__(self, inner_kernel, u, x, y=None, block=None):
        self.u = u
        xp = as_points(x)
        yp = xp if y is None else as_points(y)
        self._same = y is None
        ux, uy, self.Jx, self.Jy = _jacobians(u, xp, yp, self._same)
        self.inner = GradientGramian(inner_kernel, ux, None if self._same else uy,
                                     block=block)
        self.d = xp.shape[1]
        self.shape = (xp.shape[0] * self.d, yp.shape[0] * self.d)
        self.dtype = self.inner.dtype
        self.device = self.inner.device

    @property
    def is_symmetric(self):
        return self._same

    @property
    def is_psd(self):
        return self._same and getattr(self.inner.k, "is_mercer", False)

    def _matvec(self, v):
        m = self.shape[1] // self.d
        A = v.reshape(m, self.d)
        A_up = torch.einsum("moi,mi->mo", self.Jy, A)  # J_y a_j
        B_up = self.inner._apply(A_up)
        return torch.einsum("noi,no->ni", self.Jx, B_up).reshape(-1)  # J_x^T b_i


class VerticalRescalingGradientGramian(LinearOperator):
    """Gradient gramian of k(x,y) = f(x) h(x,y) f(y) (reference
    src/gradient_algebra.jl:177-202: per-block Woodbury rank-2 correction
    of D_f H D_f). Whole-gramian form — the MVM collapses to ONE
    value+gradient block MVM of the inner kernel h:

        out_i    = grad f(x_i) * vg0_i + f(x_i) * vg1_i,
        (vg0, vg1) = ValueGradient(h) @ [c_j, f(y_j) a_j],
        c_j = <grad f(y_j), a_j>."""

    def __init__(self, h, f, x, y=None, block=None):
        self.f = f
        xp = as_points(x)
        yp = xp if y is None else as_points(y)
        self._same = y is None
        self.d = xp.shape[1]
        self.fx, self.gfx, self.fy, self.gfy = _rescaling(f, xp, yp, self._same)
        self.inner = ValueGradientGramian(h, xp, None if self._same else yp, block=block)
        self.shape = (xp.shape[0] * self.d, yp.shape[0] * self.d)
        self.dtype = self.inner.dtype
        self.device = self.inner.device

    @property
    def is_symmetric(self):
        return self._same

    @property
    def is_psd(self):
        return self._same and getattr(self.inner.k, "is_mercer", False)

    def _matvec(self, v):
        m = self.shape[1] // self.d
        A = v.reshape(m, self.d)
        c = torch.sum(self.gfy * A, dim=1)                  # <grad f(y_j), a_j>
        Vin = torch.cat([c[:, None], self.fy[:, None] * A], dim=1)
        vg = (self.inner @ Vin.reshape(-1)).reshape(-1, self.d + 1)
        return (self.gfx * vg[:, :1] + self.fx[:, None] * vg[:, 1:]).reshape(-1)


def chained_grad_matvec(k, x, y, A, block=32):
    """Gradient-block MVM of f(h(x,y)) for generic h (reference
    src/gradient_algebra.jl:207-227: diag(f') H + rank-1 f'' correction).
    Per pair: f'(h) (H_ij a_j) + f''(h) <grad_y h, a_j> grad_x h, with
    H_ij a_j via forward-over-reverse on h alone — O(n^2 d) total, and f
    is differentiated only as a scalar."""
    from ..utils.linalg import nth_derivatives

    f, h = k.f, k.k

    def pair(xi, yj, aj):
        gx_fn = lambda y_: grad(lambda x_: h(x_, y_))(xi)
        hv, gy_dot_a = jvp(lambda y_: h(xi, y_), (yj,), (aj,))
        gx, blk_a = jvp(gx_fn, (yj,), (aj,))   # grad_x h, H_ij a_j
        _, f1, f2 = nth_derivatives(f, hv, 2)
        return f1 * blk_a + f2 * gy_dot_a * gx

    def one_row(xi):
        return torch.sum(vmap(lambda yj, aj: pair(xi, yj, aj))(y, A), dim=0)

    return map_rows(vmap(one_row), x, block, x.shape[1])


class ChainedGradientGramian(LinearOperator):
    """Gradient gramian of Chained(f, h) with generic-trait h
    (src/gradient_algebra.jl:207-227). Trait-carrying h never lands here —
    Chained preserves iso/dot/pair traits via profile composition."""

    def __init__(self, k, x, y=None, block=None):
        self.x = as_points(x)
        self.k = to_points(k, self.x)
        self.y = self.x if y is None else as_points(y)
        self._same = y is None
        self.d = self.x.shape[1]
        self.shape = (self.x.shape[0] * self.d, self.y.shape[0] * self.d)
        self.dtype = self.x.dtype
        self.device = self.x.device
        self.block = block

    @property
    def is_symmetric(self):
        return self._same

    @property
    def is_psd(self):
        return self._same and getattr(self.k, "is_mercer", False)

    def _matvec(self, v):
        A = v.reshape(self.y.shape[0], self.d)
        kws = {} if self.block is None else dict(block=self.block)
        return chained_grad_matvec(self.k, self.x, self.y, A, **kws).reshape(-1)


class DerivativeKernel:
    """1-D derivative kernel cov(f'(x), f'(y)) (reference src/gradient.jl:549-560):
    the d=1 GradientKernel on scalar inputs."""

    def __init__(self, k):
        self.k = GradientKernel(k)

    def __call__(self, x, y):
        return self.k(torch.atleast_1d(torch.as_tensor(x)),
                      torch.atleast_1d(torch.as_tensor(y)))[0, 0]

    def gramian(self, x, y=None, **opts):
        return self.k.gramian(x, y, **opts)


class ValueDerivativeKernel:
    """1-D value+derivative kernel (reference src/gradient.jl:561-579):
    the d=1 ValueGradientKernel on scalar inputs."""

    def __init__(self, k):
        self.k = ValueGradientKernel(k)

    def __call__(self, x, y):
        return self.k(torch.atleast_1d(torch.as_tensor(x)),
                      torch.atleast_1d(torch.as_tensor(y)))

    def gramian(self, x, y=None, **opts):
        return self.k.gramian(x, y, **opts)


class SeparableGradientGramian(LinearOperator):
    """Gradient gramian of SeparableProduct/SeparableSum kernels
    (reference src/gradient_algebra.jl:93-145)."""

    def __init__(self, k, x, y=None, block=None):
        from ..kernels.algebra import SeparableProduct

        self.x = as_points(x)
        self.k = to_points(k, self.x)
        self.y = self.x if y is None else as_points(y)
        self._same = y is None
        self.d = self.x.shape[1]
        if len(k.args) != self.d:
            raise ValueError(f"separable kernel has {len(k.args)} factors for d={self.d}")
        self.shape = (self.x.shape[0] * self.d, self.y.shape[0] * self.d)
        self.dtype = self.x.dtype
        self.device = self.x.device
        self._prod = isinstance(k, SeparableProduct)
        self.block = block

    @property
    def is_symmetric(self):
        return self._same

    @property
    def is_psd(self):
        return self._same and getattr(self.k, "is_mercer", False)

    def _matvec(self, v):
        from .separable_grad import grad_matvec_separable_prod, grad_matvec_separable_sum

        A = v.reshape(self.y.shape[0], self.d)
        kws = {} if self.block is None else dict(block=self.block)
        fn = grad_matvec_separable_prod if self._prod else grad_matvec_separable_sum
        return fn(self.k, self.x, self.y, A, **kws).reshape(-1)
