"""Sharded structured operators on `torch.distributed`: gradient, value +
gradient and Hessian block MVMs, Barnes-Hut, Kronecker and Toeplitz over
a device mesh (counterpart of `cfjax.parallel.structured`).

  * derivative-kernel block MVMs: the rows of the block matrix split over
    a mesh axis; a second axis may split the source points and input
    blocks, whose partial products are summed over it. Each rank builds
    the local operator on its shard (`GradientGramian`: K3 on float32
    CUDA tensors for iso / dot kernels; `ValueGradientGramian`,
    `HessianGramian`: plain torch, as on one GPU);
  * Barnes-Hut: the target groups of every width bucket split over an
    axis; each rank contracts its groups' precomputed interaction plans;
  * Kronecker: the leading grid mode split; the trailing modes contract
    on each rank's slab, the leading mode's partials reduce-scatter;
  * Toeplitz: the batched FFT MVM with the right-hand side's columns
    split.

As in `mesh`, every function takes full tensors on every rank and returns
the full result on every rank; padding (edge-repeated points, zero input
rows, repeated groups, zero factor rows and columns, zero columns) keeps
each collective's blocks equal, and padded outputs are cut off."""

from __future__ import annotations

import numpy as np
import torch

from ..derivative.gradient import GradientGramian, ValueGradientGramian
from ..derivative.hessian import HessianGramian
from ..operators.linop import LinearOperator
from ..utils.grids import as_points
from .mesh import (_coord, _gather_rows, _global, _pad_rows_zero, _psum, _psum_scatter,
                   _row_block, default_mesh)


def _pad_rows_edge(arr, mult: int):
    """arr with its last row repeated up to a multiple of `mult` rows."""
    p = (-arr.shape[0]) % mult
    if not p:
        return arr
    return torch.cat([arr, arr[-1:].expand((p,) + tuple(arr.shape[1:]))])


def sharded_block_apply(fn, k, x, y, vec_args, mesh, row_axis: str,
                        col_axis: str | None = None, block: int | None = None):
    """Shard a block MVM `fn(k, x, y, *vec_args, block=...) -> (n, D)`
    whose rows are independent and whose output is linear in `vec_args`
    (summed over y's rows): every grad / valgrad / hess matvec of
    `cfjax_torch.derivative`.

    The rows of x split over `row_axis` (edge-padded). With `col_axis`, y
    (edge-padded) and the input blocks (zero-padded: padded rows add 0)
    split too, and each rank's partial sum over its sources is summed over
    that axis."""
    x = as_points(_global(x))
    y = as_points(_global(y))
    vecs = tuple(torch.as_tensor(_global(v), device=x.device) for v in vec_args)
    nr, r = _coord(mesh, row_axis)
    xs = _row_block(_pad_rows_edge(x, nr), nr, r)
    kws = {} if block is None else dict(block=block)
    if col_axis is None:
        return _gather_rows(fn(k, xs, y, *vecs, **kws), mesh, row_axis, x.shape[0])
    nc, c = _coord(mesh, col_axis)
    ys = _row_block(_pad_rows_edge(y, nc), nc, c)
    vs = tuple(_row_block(_pad_rows_zero(v, nc), nc, c) for v in vecs)
    part = _psum(fn(k, xs, ys, *vs, **kws), mesh, col_axis)
    return _gather_rows(part, mesh, row_axis, x.shape[0])


# --------------------------------------------------------------------------
# sharded derivative-kernel gramians
# --------------------------------------------------------------------------


class _ShardedBlockGramian(LinearOperator):
    """Flat (n D) x (m D) operator over per-point D-blocks, rows split on
    `row_axis` (and sources on `col_axis`): each rank holds the local
    operator (`local_class`) of its row block against all of y, or against
    its column block of y, in `self.local`."""

    local_class = None

    def __init__(self, k, x, y=None, mesh=None, row_axis: str = None,
                 col_axis: str = None, block: int = None):
        self.k = k
        self.mesh = mesh if mesh is not None else default_mesh()
        self.row_axis = row_axis or self.mesh.mesh_dim_names[0]
        self.col_axis = col_axis
        self.x = as_points(_global(x))
        self.y = self.x if y is None else as_points(_global(y))
        self._same = y is None
        self.d = self.x.shape[1]
        nr, r = _coord(self.mesh, self.row_axis)
        ys = self.y
        if col_axis is not None:
            nc, c = _coord(self.mesh, col_axis)
            ys = _row_block(_pad_rows_edge(self.y, nc), nc, c)
        self.local = self.local_class(k, _row_block(_pad_rows_edge(self.x, nr), nr, r), ys,
                                      block=block)
        self.mode = self.local.mode
        self._D = self.local.shape[1] // ys.shape[0]
        self.shape = (self.x.shape[0] * self._D, self.y.shape[0] * self._D)
        self.dtype = self.local.dtype
        self.device = self.local.device
        self.block = block

    @property
    def is_symmetric(self):
        return self._same

    @property
    def is_psd(self):
        # PSD holds for the derivative gramian of a genuine Mercer kernel
        # (cov of derivatives); don't claim it from symmetry alone
        return self._same and getattr(self.k, "is_mercer", False)

    def _matvec(self, v):
        V = v.reshape(self.y.shape[0], self._D)
        if self.col_axis is not None:
            nc, c = _coord(self.mesh, self.col_axis)
            V = _row_block(_pad_rows_zero(V, nc), nc, c)
        out = self.local._matvec(V.reshape(-1)).reshape(-1, self._D)
        if self.col_axis is not None:
            out = _psum(out, self.mesh, self.col_axis)
        return _gather_rows(out, self.mesh, self.row_axis, self.x.shape[0]).reshape(-1)


class ShardedGradientGramian(_ShardedBlockGramian):
    """Row(+col)-sharded flat (n d) x (m d) gradient-block operator, the
    mesh version of `GradientGramian` (reference threaded blockmul!,
    src/gramian.jl:242-251). `kernel_reason` is the local operator's: None
    where its shard runs K3."""

    local_class = GradientGramian

    @property
    def kernel_reason(self):
        return self.local.kernel_reason


class ShardedValueGradientGramian(_ShardedBlockGramian):
    """Row(+col)-sharded (n(1+d)) x (m(1+d)) value+gradient operator."""

    local_class = ValueGradientGramian


class ShardedHessianGramian(_ShardedBlockGramian):
    """Row(+col)-sharded (n d^2) x (m d^2) Hessian-block operator."""

    local_class = HessianGramian


# --------------------------------------------------------------------------
# sharded Barnes-Hut
# --------------------------------------------------------------------------


def _plan_checksum(plans) -> int:
    """An integer fingerprint of the interaction plans' index arrays."""
    total = 0
    for flv, fidx, lidx in plans:
        for a in (np.asarray(flv), *fidx, lidx):
            a = np.asarray(a, dtype=np.int64).reshape(-1)
            total += int(np.dot(a, np.arange(1, a.size + 1, dtype=np.int64) % 1009 + 1))
    return total


def sharded_bh_matvec(F, v, mesh, axis: str = None):
    """b = F v with the target groups of every Barnes-Hut width bucket
    split over `axis` (the reference's per-target threaded loop,
    src/barneshut.jl:88). Every rank builds the same factorization from
    the same points, so its plans (the host sweep of the first use) are
    the same on every rank, which a fingerprint all-gathered over the axis
    checks. Each rank contracts only its groups through
    `bh_matvec_planned` (the group count padded by repeating the last
    group) and the group outputs are all-gathered."""
    from ..barneshut.bh import bh_matvec_planned

    axis = axis or mesh.mesh_dim_names[0]
    nd, me = _coord(mesh, axis)
    t = F.tree
    dev = t.points.device
    sums = _gather_rows(torch.tensor([_plan_checksum(F.plans)], device=dev), mesh, axis, nd)
    if bool((sums != sums[0]).any()):
        raise RuntimeError(f"sharded_bh_matvec: the ranks' interaction plans differ "
                           f"(fingerprints {sums.tolist()})")
    wp = F._permuted_weights(torch.as_tensor(_global(v), device=dev))
    flat = torch.zeros((F._tgt_P,), dtype=F.dtype, device=dev)
    on = lambda a: torch.as_tensor(a, device=dev)
    for (xg_b, _, _, rows_b, _), (flv, fidx, lidx) in zip(F.buckets, F.plans):
        ng = xg_b.shape[0]
        part = lambda a: _row_block(_pad_rows_edge(on(a), nd), nd, me)
        out_g = bh_matvec_planned(F.k, part(xg_b), tuple(part(f) for f in fidx), part(lidx),
                                  t.points, wp, flv, t.levels, t.leafsize, F.order)
        out_g = _gather_rows(out_g.to(flat.dtype), mesh, axis, ng)
        flat[on(rows_b.reshape(-1)).long()] = out_g.reshape(-1)
    out = torch.zeros_like(flat)
    out[F._tgt_perm.long()] = flat
    return out[:F.n]


# --------------------------------------------------------------------------
# sharded Kronecker + Toeplitz
# --------------------------------------------------------------------------


def _dense_factor(f):
    return f if isinstance(f, torch.Tensor) else f.todense()


def sharded_kronecker_matvec(K, a, mesh, axis: str = None):
    """(A1 (x) ... (x) Ak) a with the leading grid mode split over `axis`:
    each rank contracts the trailing modes on its slab of the reshaped
    tensor (`kronecker._mode_chain`), then its columns of A1 against the
    slab give a partial of the whole leading mode, reduce-scattered back
    onto the rank's slab (A1 and the slabs zero-padded to a multiple of
    the rank count: inert). The slabs are all-gathered."""
    from ..operators.kronecker import _mode_chain

    axis = axis or mesh.mesh_dim_names[0]
    nd, me = _coord(mesh, axis)
    mats = [_dense_factor(f) for f in K.factors]
    dims = [int(m.shape[0]) for m in mats]
    a = torch.as_tensor(_global(a), device=mats[0].device)
    m1 = dims[0]
    p = (-m1) % nd
    A1 = torch.nn.functional.pad(mats[0], (0, p, 0, p))
    X = _pad_rows_zero(a.reshape(m1, -1), nd)
    c = X.shape[0] // nd
    Xloc = _row_block(X, nd, me)
    # trailing modes on the slab: the slab's rows ride as _mode_chain's
    # trailing right-hand-side axis
    Z = _mode_chain(mats[1:], Xloc.T.contiguous()).T if len(mats) > 1 else Xloc
    part = A1[:, me * c:(me + 1) * c] @ Z
    out = _psum_scatter(part, mesh, axis)
    return _gather_rows(out, mesh, axis, m1).reshape(-1)


def sharded_toeplitz_matmat(T, V, mesh, axis: str = None):
    """T V by the batched circulant-embedding FFT MVM with V's columns
    split over `axis` (zero-padded; the Toeplitz path's batch parallelism:
    a single-vector MVM stays on one GPU). The column blocks are
    all-gathered."""
    from ..operators.toeplitz import toeplitz_matvec

    axis = axis or mesh.mesh_dim_names[0]
    nd, me = _coord(mesh, axis)
    col = T.col
    row = T.row if hasattr(T, "row") else col
    V = torch.as_tensor(_global(V), device=col.device)
    r = V.shape[1]
    Vloc = _row_block(_pad_rows_zero(V.T, nd), nd, me).T
    out = toeplitz_matvec(col, row, Vloc)
    return _gather_rows(out.T, mesh, axis, r).T
