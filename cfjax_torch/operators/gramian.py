"""Lazy Gramian operator: O(n d)-memory kernel matrix with blocked,
trait-specialized MVMs (counterpart of `cfjax.operators.gramian`,
reference src/gramian.jl).

An MVM of float32 tensors on a CUDA device runs on a hand-written kernel
(`cfjax_torch.ops.gramian_mvm`): K1 for isotropic kernels at d <= 16 (a
multi-RHS product through its many-column variant, on the tensor cores
at the matmul tier), K2 for isotropic kernels at larger d and for
dot-product kernels (single RHS). The kernel's hyperparameters are moved
to the points' device and dtype when the Gramian is formed. Everything
else — CPU tensors, float64, kernels without a profile spec, K2's
multi-RHS products, and any product that autograd records — takes the
blocked plain-torch path `gramian_matvec`, which builds one row block of
kernel entries at a time and contracts it at once. The device, dtype and
spec are decided at construction (`Gramian.kernel`); whether autograd
records is decided at each call (`kernel_decline_reason`).
"""

from __future__ import annotations

import torch
from torch.func import vmap
from torch.utils.checkpoint import checkpoint

from .. import config as _config
from ..kernels.base import InputTrait, Kernel, input_trait
from ..kernels.parameters import to_points
from ..kernels.profile_spec import FAMILY_MATERN_NU, to_spec
from ..ops import gramian_mvm as _mvm
from ..ops.tiles import inner_tile, matmul_p, sqdist_tile
from ..utils import trace
from .linop import LinearOperator


def slf_vector(k):
    """The linear-functional direction c of an SLF-trait kernel (Cosine,
    possibly wrapped in Constant products/sums/powers)."""
    from ..kernels.algebra import Power, Product, Sum
    from ..kernels.stationary import Constant, Cosine
    from ..kernels.transforms import Chained

    if isinstance(k, Cosine):
        return torch.atleast_1d(k.c)
    if isinstance(k, (Sum, Product)):
        for a in k.args:
            if not isinstance(a, Constant):
                return slf_vector(a)
    if isinstance(k, (Power, Chained)):
        return slf_vector(k.k)
    raise ValueError(f"cannot extract linear functional from {type(k).__name__}")


def kernel_tile(k, xb, y, mode: str, c=None):
    """(B, m) kernel-matrix tile for row block xb against all y:
      iso : profile(||x - y||^2)   (difference form or expansion by d)
      dot : profile(x.y)
      slf : profile(<c, x> - <c, y>)
    and the per-pair vmap fallback for GENERIC kernels."""
    if mode == "iso":
        return k.profile_value(sqdist_tile(xb, y))
    if mode == "dot":
        return k.profile_value(inner_tile(xb, y))
    if mode == "slf":
        c = c.to(device=xb.device, dtype=xb.dtype)
        return k.profile_value((xb @ c)[:, None] - (y @ c)[None, :])
    return vmap(lambda xi: vmap(lambda yj: k(xi, yj))(y))(xb)


def build_tile(g):
    """(a, b) -> the (B, m) block of kernel entries k(a_i, b_j) that the
    Nystrom build of the Gramian g evaluates, in the dtype of a and b: from
    the kernel as the dispatch handed it to g (`g.k_given`: its
    hyperparameters at the caller's precision, not the copy moved to the
    points), by g's mode. A one-leaf real-nu Matern takes its tabulated
    family's plain version (`ProfileSpec.evaluate(s, family=True)`, the
    function K1 and K2 compute) on the exact difference-form distances: the
    kernel's own profile would run the 400-node quadrature on every entry.
    Every other kernel takes `kernel_tile` in g's mode, as g's plain
    products do; the build's blocks are never float32 (`nystrom_factors`),
    so the matmul tier leaves the tile's products at full precision."""
    k = g.k_given
    if g.mode == "iso":
        spec = g._spec or to_spec(k)[0]
        if spec is not None and spec.family == FAMILY_MATERN_NU:
            return lambda a, b: spec.evaluate(sqdist_tile(a, b, direct_max_d=a.shape[1]),
                                              family=True)
    c = slf_vector(k) if g.mode == "slf" else None
    return lambda a, b: kernel_tile(k, a, b, g.mode, c)


def _needs_grad(k, *ts):
    return torch.is_grad_enabled() and (
        any(t.requires_grad for t in ts) or any(b.requires_grad for b in k.buffers()))


def gramian_matvec(k, x, y, a, mode: str = "iso", block: int = 512):
    """b = K a for the lazy Gramian, K_ij = k(x_i, y_j). a: (m,) or (m, r).

    Under autograd each row block is checkpointed: the backward pass keeps
    only the (block, d) points per block and recomputes its kernel tile,
    so reverse-mode memory stays O(n d) instead of O(n m)."""
    c = slf_vector(k) if mode == "slf" else None

    def body(xb):
        K = kernel_tile(k, xb, y, mode, c)
        if a.ndim == 1:
            # single RHS: multiply + row reduction in the working dtype
            return torch.sum(K * a[None, :], dim=1)
        return matmul_p(K, a)

    remat = _needs_grad(k, x, y, a)
    outs = [checkpoint(body, x[i:i + block], use_reentrant=False) if remat
            else body(x[i:i + block]) for i in range(0, x.shape[0], block)]
    if not outs:
        return a.new_zeros((0,) + tuple(a.shape[1:]))
    return torch.cat(outs)


def gramian_dense(k, x, y, mode: str = "iso", block: int = 512):
    """Materialize the full kernel matrix blockwise (reference `Matrix!`,
    src/gramian.jl:102-114)."""
    c = slf_vector(k) if mode == "slf" else None
    return torch.cat([kernel_tile(k, x[i:i + block], y, mode, c)
                      for i in range(0, x.shape[0], block)])


def mvm_mode(k) -> str:
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
    return "generic"


def select_kernel(g):
    """(kernel name, spec, decline reason) for a Gramian, decided once at
    construction. The rules are correctness-only: an MVM of float32 CUDA
    tensors whose kernel has a profile spec goes to K1 ("direct": iso,
    d <= 16) or to K2 ("expand": iso at larger d, or dot, at every matmul
    tier). Whether autograd records is decided at each call."""
    if g.mode not in ("iso", "dot"):
        return None, None, f"trait mode {g.mode!r} (the CUDA kernels cover iso/dot)"
    if not (g.x.is_cuda and g.y.is_cuda):
        return None, None, f"tensors on {g.x.device.type}: the CUDA kernels need a CUDA device"
    if g.x.dtype != torch.float32 or g.y.dtype != torch.float32:
        return None, None, f"dtype {g.x.dtype}: the CUDA kernels take float32"
    spec, why = to_spec(g.k)
    if spec is None:
        return None, None, f"no profile spec: {why}"
    d = g.x.shape[1]
    if g.mode == "iso" and d <= min(_mvm.DIRECT_MAX_D, _config.DEFAULT.direct_sqdist_max_d):
        return "direct", spec, None
    return "expand", spec, None


GRAD_REASON = "autograd records: an input requires grad (the CUDA kernels are forward-only)"


def kernel_decline_reason(g, *rhs):
    """Why a Gramian's MVM (with right-hand sides `rhs`, if given) stays on
    the plain torch path now (None: it runs on a CUDA kernel). Surfaced by
    dispatch.explain()."""
    if g.kernel_reason is not None:
        return g.kernel_reason
    if _needs_grad(g.k, g.x, g.y, *rhs):
        return GRAD_REASON
    return None


class Gramian(LinearOperator):
    """Lazy kernel matrix K_ij = k(x_i, y_j) (reference Gramian,
    src/gramian.jl:10-21). O(n d) storage."""

    def __init__(self, k: Kernel, x, y=None, block: int = None):
        from ..utils.grids import as_points

        self.k = k
        self.x = as_points(x).contiguous()
        self.y = self.x if y is None else as_points(y).contiguous()
        self._same = y is None or (self.x is self.y)
        self.shape = (int(self.x.shape[0]), int(self.y.shape[0]))
        self.dtype = self.x.dtype if self.x.is_floating_point() else torch.get_default_dtype()
        self.device = self.x.device
        self.mode = mvm_mode(k)
        if block is None:
            block = _config.DEFAULT.mvm_block_rows if self.mode != "generic" else 128
        self.block = max(1, min(block, self.shape[0]))
        self.kernel, self._spec, self.kernel_reason = select_kernel(self)
        # the hyperparameters on the points' device and in their dtype, once
        # (the spec above reads the kernel as given, and so does the Nystrom
        # build, `build_tile`): an MVM copies nothing from the host and can
        # be captured in a CUDA graph; a real-nu Matern's table goes to the
        # card here too
        self.k_given, self.k = k, to_points(k, self.x)
        if self.kernel is not None:
            _mvm.family_table(self._spec, self.device)

    @property
    def is_symmetric(self):
        return self._same

    @property
    def is_psd(self):
        return self._same and self.k.is_mercer

    def _on_kernel(self, v):
        return v.dtype == torch.float32 and kernel_decline_reason(self, v) is None

    def _matvec(self, v):
        if v.ndim == 1 and self._on_kernel(v):
            v = v.contiguous()
            if self.kernel == "direct":
                return _mvm.gramian_matvec_direct(self.k, self.x, self.y, v, spec=self._spec)
            return _mvm.gramian_matvec_expand(self.k, self.x, self.y, v, self.mode,
                                              spec=self._spec)
        return self._plain(self.x, self.y, v)

    def _matmat(self, V):
        # K1's many-column variant runs at the configured matmul tier, as the
        # plain path's tile product does; K2 has no many-column variant: its
        # multi-RHS products stay on the plain path
        if self.kernel == "direct" and self._on_kernel(V):
            return _mvm.gramian_matmat_direct(self.k, self.x, self.y, V.contiguous(),
                                              spec=self._spec)
        return self._plain(self.x, self.y, V)

    def _rmatvec(self, v):
        if self._same:
            return self._matvec(v)
        return self._plain(self.y, self.x, v)

    def _plain(self, x, y, v):
        """The blocked plain-torch product, counted in `mvm.plain` on a CUDA
        device (while spans are recorded)."""
        if self.x.is_cuda:
            trace.count("mvm.plain")
        return gramian_matvec(self.k, x, y, v, self.mode, self.block)

    def todense(self):
        return gramian_dense(self.k, self.x, self.y, self.mode, self.block)

    def diagonal(self):
        n = min(self.shape)
        if self.mode == "iso":
            return self.k.profile_value(torch.zeros((n,), dtype=self.dtype, device=self.device))
        return vmap(lambda xi, yi: self.k(xi, yi))(self.x[:n], self.y[:n])
