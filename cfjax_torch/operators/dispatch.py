"""The smart `gramian()` constructor: automatic structure detection
(counterpart of `cfjax.operators.dispatch`, reference src/gramian.jl:144-189).

One explicit decision tree over (kernel metadata, input container), run
once at operator construction:
  1. matrix-valued kernels          -> derivative layer (gradient, value+
                                       gradient, Hessian gramians; the
                                       SeparableKernel's Kronecker)
  2. Constant                       -> lazy Fill (rank-1)
  2b. MatrixKernel                  -> dense A[ix][:, iy]
  3. FiniteBasis with n > rank      -> low-rank U V^T
  4. SeparableProduct on LazyGrid   -> Kronecker of per-axis gramians
  5. input transforms (ARD/Energetic/Warped/ScaledInput/Periodic)
                                    -> pre-transform points once, recurse
  6. VerticalRescaling              -> D G D lazy product
  7. Sum with Delta terms (x is y)  -> diagonal split + recurse
  8. uniform 1-D grid + stationary  -> SymmetricToeplitz / Toeplitz;
     periodic kernel on grid        -> Circulant (in step 5)
  9. fallback                       -> lazy Gramian (CUDA kernel or blocked MVM)
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.func import vmap

from ..kernels.algebra import Product, SeparableProduct, Sum
from ..kernels.base import InputTrait, Kernel, MultiKernel, input_trait
from ..kernels.mercer import FiniteBasis, MatrixKernel
from ..kernels.stationary import Constant, Delta
from ..kernels.transforms import (
    ARDKernel,
    Energetic,
    Periodic,
    ScaledInputKernel,
    VerticalRescaling,
    Warped,
)
from ..utils.grids import LazyGrid, UniformGrid, as_points, detect_uniform_grid
from .gramian import Gramian, kernel_decline_reason
from .kronecker import KroneckerOperator
from .linop import (
    DenseOperator,
    DiagonalOperator,
    FillOperator,
    LowRankOperator,
    ProductOperator,
    SumOperator,
)
from .toeplitz import CirculantOperator, ToeplitzOperator


class LambdaKernel(Kernel):
    """Wrap a plain callable as a GENERIC-trait kernel (the reference tests'
    closure-wrapping trick that erases structure, test/gradient.jl:38-45)."""

    FIELDS = (("fn", None),)
    STATIC = ("fn",)

    def forward(self, x, y):
        return self.fn(x, y)


def _as_kernel(k):
    if isinstance(k, (Kernel, MultiKernel)):
        return k
    if callable(k):
        return LambdaKernel(k)
    raise TypeError(f"not a kernel: {k!r}")


def _delta_amplitude(k):
    """If k is Delta or Constant*...*Delta, its scalar amplitude (for the
    exact white-noise diagonal split); else None."""
    if isinstance(k, Delta):
        return torch.tensor(1.0, dtype=torch.float64)
    if isinstance(k, Product):
        amp = torch.tensor(1.0, dtype=torch.float64)
        seen_delta = False
        for a in k.args:
            if isinstance(a, Delta):
                if seen_delta:
                    return None
                seen_delta = True
            elif isinstance(a, Constant):
                amp = amp * a.c
            else:
                return None
        return amp if seen_delta else None
    return None


def _embed_periodic(xp):
    return torch.cat([torch.cos(2 * math.pi * xp), torch.sin(2 * math.pi * xp)], dim=1)


def gramian(k, x, y=None, **opts):
    """Build the structure-detected covariance operator K with
    K[i, j] = k(x_i, y_j) (reference `gramian`, src/gramian.jl:144-163)."""
    k = _as_kernel(k)
    same = y is None

    # 1. matrix-valued (derivative / separable multi-output) kernels
    if isinstance(k, MultiKernel):
        from ..derivative.dispatch import gramian_multikernel

        return gramian_multikernel(k, x, y, **opts)

    # 2. constant kernel -> lazy fill (src/stationary.jl:34)
    if isinstance(k, Constant):
        xp = as_points(x)
        yp = xp if same else as_points(y)
        return FillOperator(k.c.to(device=xp.device), (xp.shape[0], yp.shape[0]))

    # 2b. discrete-input matrix kernel: K = A[ix][:, iy]
    if isinstance(k, MatrixKernel):
        ix = torch.as_tensor(x).reshape(-1).to(torch.long)
        iy = ix if same else torch.as_tensor(y).reshape(-1).to(torch.long)
        return DenseOperator(k.A[ix][:, iy], symmetric=same)

    # 3. finite basis -> low-rank (src/mercer.jl:61-70)
    if isinstance(k, FiniteBasis):
        xp = as_points(x)
        yp = xp if same else as_points(y)
        r = k.rank
        if xp.shape[0] > r and yp.shape[0] > r:
            U = vmap(k.features)(xp)
            V = U if same else vmap(k.features)(yp)
            return LowRankOperator(U, V.T, psd=same)
        return Gramian(k, xp, None if same else yp, **opts)

    # 4. separable product on a lazy grid -> Kronecker (src/algebra.jl:91-95)
    if isinstance(k, SeparableProduct) and isinstance(x, LazyGrid):
        ygrid = x if same else y
        if not isinstance(ygrid, LazyGrid) or len(ygrid.axes) != len(x.axes):
            raise ValueError("SeparableProduct gramian needs LazyGrid for both inputs")
        if len(k.args) != len(x.axes):
            raise ValueError(f"SeparableProduct needs {len(x.axes)} kernels, has {len(k.args)}")
        return KroneckerOperator([gramian(ki, x.axes[i], None if same else ygrid.axes[i], **opts)
                                  for i, ki in enumerate(k.args)])

    # 5. input transforms -> pre-transform points once, recurse
    #    (src/transformation.jl:83-95, 113-121)
    if isinstance(k, ARDKernel):
        xp = as_points(x)
        l = k.l.to(device=xp.device, dtype=xp.dtype)
        return gramian(k.k, xp / l, None if same else as_points(y) / l, **opts)
    if isinstance(k, Energetic):
        xp = as_points(x)
        L = torch.linalg.cholesky(k.A.to(device=xp.device, dtype=xp.dtype))
        return gramian(k.k, xp @ L, None if same else as_points(y) @ L, **opts)
    if isinstance(k, ScaledInputKernel):
        xp = as_points(x)
        U = k.U.to(device=xp.device, dtype=xp.dtype)
        return gramian(k.k, xp @ U.T, None if same else as_points(y) @ U.T, **opts)
    if isinstance(k, Warped):
        def warp(p):
            w = vmap(k.u)(as_points(p))
            return w[:, None] if w.ndim == 1 else w

        return gramian(k.k, warp(x), None if same else warp(y), **opts)
    if isinstance(k, Periodic):
        # circulant on a uniform grid spanning whole periods (lazy column);
        # otherwise embed x -> (cos 2 pi x, sin 2 pi x): the MacKay warp
        # becomes the plain isotropic distance in the embedded space
        grid = _uniform_grid_of(x)
        if grid is not None and same:
            span = grid.step * grid.num
            if np.isclose(span, round(span)) and round(span) >= 1:
                return CirculantOperator(lambda: _grid_col(k, grid.start, grid), num=grid.num,
                                         dtype=grid.dtype, device=grid.device)
        return gramian(_EmbeddedPeriodic(k.k), _embed_periodic(as_points(x)),
                       None if same else _embed_periodic(as_points(y)), **opts)

    # 6. vertical rescaling -> lazy D G D (src/transformation.jl:165-171)
    if isinstance(k, VerticalRescaling):
        xp = as_points(x)
        yp = xp if same else as_points(y)
        Dx = DiagonalOperator(vmap(k.f)(xp))
        Dy = Dx if same else DiagonalOperator(vmap(k.f)(yp))
        G = gramian(k.k, x, None if same else y, **opts)
        return ProductOperator((Dx, G, Dy))

    # 7. exact white-noise split: Sum with Delta terms on shared points
    if same and isinstance(k, Sum):
        deltas, rest = [], []
        for a in k.args:
            amp = _delta_amplitude(a)
            (deltas if amp is not None else rest).append((a, amp))
        if deltas:
            xp = as_points(x)
            amp = sum(a for _, a in deltas)
            diag = DiagonalOperator(torch.full((xp.shape[0],), float(amp),
                                               dtype=xp.dtype, device=xp.device))
            if not rest:
                return diag
            rk = rest[0][0] if len(rest) == 1 else Sum(tuple(a for a, _ in rest))
            return SumOperator((gramian(rk, x, **opts), diag))
    if same and isinstance(k, Delta):
        xp = as_points(x)
        return DiagonalOperator(torch.ones((xp.shape[0],), dtype=xp.dtype, device=xp.device))

    # 8. uniform 1-D grid + stationary kernel -> Toeplitz (src/gramian.jl:167-183)
    gx = _uniform_grid_of(x)
    if gx is not None and input_trait(k) in (
        InputTrait.ISOTROPIC,
        InputTrait.STATIONARY,
        InputTrait.STATIONARY_LINEAR_FUNCTIONAL,
    ):
        # lazy column: construction evaluates no kernel (the reference's
        # Kronecker of grid gramians is lazy too, src/algebra.jl:91-95)
        place = dict(num=gx.num, dtype=gx.dtype, device=gx.device)
        if same:
            return ToeplitzOperator(lambda: _grid_col(k, gx.start, gx), **place)
        gy = _uniform_grid_of(y)
        if gy is not None and np.isclose(gx.step, gy.step) and gx.num == gy.num:
            return ToeplitzOperator(lambda: _grid_col(k, gy.start, gx),
                                    lambda: _grid_col(k, gx.start, gy), **place)

    # 9. fallback: lazy Gramian (CUDA kernel or blocked plain MVM)
    return Gramian(k, x, None if same else y, **opts)


class _EmbeddedPeriodic(Kernel):
    """Isotropic view of a MacKay-periodic kernel on cos/sin-embedded
    points: |z_x - z_y|^2 = sum_i 4 sin^2(pi tau_i) is exactly the MacKay
    warped squared distance, so profile(s) = k.profile(s)."""

    FIELDS = (("k", None),)

    @property
    def trait(self):
        return InputTrait.ISOTROPIC

    @property
    def is_mercer(self):
        return getattr(self.k, "is_mercer", False)

    def profile(self, s):
        return self.k.profile(s)

    def profile_value(self, s):
        return self.k.profile_value(s)


def _uniform_grid_of(x):
    if isinstance(x, UniformGrid):
        return x
    if isinstance(x, LazyGrid):
        return None
    if isinstance(x, torch.Tensor):
        if not (x.ndim == 1 or (x.ndim == 2 and x.shape[1] == 1)):
            return None
        return detect_uniform_grid(x)
    arr = np.asarray(x)
    if arr.ndim == 1 or (arr.ndim == 2 and arr.shape[1] == 1):
        return detect_uniform_grid(arr)
    return None


def _grid_col(k, x0, grid):
    """k(x0, p_j) for the points p_j of a UniformGrid, on the grid's
    device and in its dtype: the first column (or row) of a grid
    Gramian."""
    pts = grid.points()
    x0 = torch.tensor(x0, dtype=pts.dtype, device=pts.device)
    return vmap(lambda xj: k(x0, xj))(pts)


def _tier() -> str:
    """The configured matmul tier and its tensor-core passes in K2 / K3."""
    from ..ops.tiles import resolve_precision, tier_passes

    return f"matmul_precision {resolve_precision()!r}: {tier_passes()} tf32 pass(es)"


def _instance(spec) -> str:
    """Which instance of K2 or K3 a spec runs."""
    from ..kernels.profile_spec import FAMILY_MATERN_NU

    if not spec.family:
        return "interpreted instance"
    if spec.family == FAMILY_MATERN_NU:
        return "family instance: the real-nu Matern's table"
    return "family instance"


def explain(k, x, y=None, **opts) -> str:
    """Describe the structure the dispatcher detected, and whether the
    lazy Gramian's or gradient gramian's MVM runs on a CUDA kernel (and
    which) or why not. The Gramian's reasons are those of a call made
    now: under `torch.no_grad()` inputs that require grad do not decline
    the kernel."""
    from ..derivative.gradient import GradientGramian, JacobianConjugatedGradientGramian

    op = gramian(k, x, y, **opts)
    parts = [f"{type(op).__name__}{op.shape}"]
    if isinstance(op, Gramian):
        parts.append(f"mvm mode = {op.mode}, block = {op.block}")
        why = kernel_decline_reason(op)
        if why is None and op.kernel == "direct":
            if op._spec.family:
                one, cols = "family instance", f"its family instance, tensor cores at {_tier()}"
            else:
                one, cols = "interpreted instance", "the interpreted instance once per column"
            parts.append(f"cuda kernel K1 gramian_matvec_direct ({one}); multi-RHS K1 "
                         f"gramian_matmat_direct ({cols})")
        elif why is None:
            parts.append(f"cuda kernel K2 gramian_matvec_expand ({_instance(op._spec)}; "
                         f"{_tier()}); multi-RHS declined: K2 has no many-column variant "
                         f"(plain path)")
        else:
            parts.append(f"cuda kernel declined: {why}")
    g = op.inner if isinstance(op, JacobianConjugatedGradientGramian) else op
    if isinstance(g, GradientGramian):
        parts.append(f"gradient mode = {g.mode}")
        why = g.kernel_reason
        parts.append(f"cuda kernel K3 grad_matvec ({_instance(g._spec)}; {_tier()})"
                     if why is None else f"cuda kernel declined: {why}")
    if isinstance(op, KroneckerOperator):
        parts.append("factors: " + " ⊗ ".join(f"{type(f).__name__}{f.shape}" for f in op.factors))
    if isinstance(op, SumOperator):
        parts.append("terms: " + " + ".join(type(t).__name__ for t in op.terms))
    if isinstance(op, ProductOperator):
        parts.append("factors: " + " @ ".join(type(f).__name__ for f in op.factors))
    return " | ".join(parts)
