"""Sparsification of lazy Gramians (counterpart of
`cfjax.operators.sparse_op`).

Rebuild of reference src/sparse.jl: entries below a tolerance are dropped
using analytic kernel decay radii (closed forms per kernel,
src/sparse.jl:25-38), and the surviving pattern becomes a sparse operator
whose MVM runs on the points' device: TileELL (`tile_ell.py`, MVM through
K4), ELLPACK (`EllSparseOperator`, plain gathers), a coalesced
`torch.sparse_coo_tensor`, or the lazy leaf-tile `TreeSparseOperator`.

Neighbours come from a blocked distance scan (`method="scan"`) or from a
ball-tree leaf-pair range search (`method="tree"`, `barneshut/tree.py`).
Distances use the exact difference form (`sqdist_tile(direct_max_d=64)`
on the scan, the configured form on the tree), in cfjax's order, so the
counts at the radius cut agree with cfjax's. The decision rules (tree and
lazy above n*m = 2^31, ELL beyond nt = 256 column tiles, the 2^27-entry
scan tile) are cfjax's, set on a TPU v5e; they are kept so that both
packages return the same operator class for the same inputs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import config as _config
from ..kernels.algebra import Power, Product, Sum
from ..kernels.base import InputTrait, input_trait
from ..kernels.stationary import (
    Cauchy,
    Constant,
    EQ,
    Exp,
    GammaExp,
    InverseMultiQuadratic,
    Matern,
    MaternP,
    RQ,
)
from ..kernels.transforms import Lengthscale
from ..ops.tiles import map_rows, sqdist_tile
from .linop import LinearOperator

_INT32_MIN = torch.iinfo(torch.int32).min


def decay_radius(k, tol: float):
    """Radius r beyond which |k(r^2)| < tol (reference src/sparse.jl:25-38).
    Closed forms where known; None -> numeric bisection on the profile."""
    if tol >= 1:
        return 0.0
    if isinstance(k, EQ):
        return math.sqrt(-2 * math.log(tol))
    if isinstance(k, Exp):
        return -math.log(tol)
    if isinstance(k, GammaExp):
        return (-2 * math.log(tol)) ** (1.0 / k.gamma)
    if isinstance(k, Cauchy):
        return math.sqrt(max(1.0 / tol - 1.0, 0.0))
    if isinstance(k, RQ):
        a = float(k.alpha)
        return math.sqrt(max(2 * a * (tol ** (-1.0 / a) - 1.0), 0.0))
    if isinstance(k, InverseMultiQuadratic):
        c = float(k.c)
        return math.sqrt(max(1.0 / tol**2 - c * c, 0.0))
    if isinstance(k, Lengthscale):
        return float(k.l) * decay_radius(k.k, tol)
    if isinstance(k, (Matern, MaternP)):
        return _bisect_radius(k, tol)
    if isinstance(k, Power):
        return decay_radius(k.k, tol ** (1.0 / k.p))
    if isinstance(k, Product):
        return _bisect_radius(k, tol)
    if isinstance(k, Sum):
        rads = [decay_radius(a, tol / len(k.args)) for a in k.args
                if not isinstance(a, Constant)]
        if any(r is None for r in rads):
            return None
        return max(rads) if rads else None
    if input_trait(k) == InputTrait.ISOTROPIC:
        return _bisect_radius(k, tol)
    return None


def _bisect_radius(k, tol: float, r_max: float = 1e6):
    """Numeric decay radius for monotone-decaying isotropic profiles."""
    f = lambda r: float(k.profile(torch.tensor(r * r, dtype=torch.float64)))
    if f(r_max) > tol:
        return None
    lo, hi = 0.0, r_max
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if f(mid) > tol:
            lo = mid
        else:
            hi = mid
    return hi


class EllSparseOperator(LinearOperator):
    """ELLPACK sparse matrix: per-row padded column indices + values; the
    MVM is a gather and a row-wise reduction (plain torch, as cfjax's is
    XLA). A full LinearOperator: `.solve`, `.T`, `add_diagonal` compose."""

    def __init__(self, cols, vals, m, nnz, symmetric=False):
        self.cols = cols          # (n, width) int32, fill = m (points at the pad slot)
        self.vals = vals          # (n, width)
        self.shape = (cols.shape[0], m)
        self.width = cols.shape[1]
        self.nnz = nnz
        self.dtype = vals.dtype
        self.device = vals.device
        self._sym = symmetric and cols.shape[0] == m

    @property
    def is_symmetric(self):
        return self._sym

    def _matvec(self, a):
        return ell_matvec(self.cols, self.vals, a)

    _matmat = _matvec

    def _rmatvec(self, a):
        if self._sym:
            return self._matvec(a)
        return ell_rmatvec(self.cols, self.vals, a, self.shape[1])

    def diagonal(self):
        n, m = self.shape
        hit = self.cols == torch.arange(n, device=self.device)[:, None]
        return torch.sum(torch.where(hit, self.vals, 0.0), dim=1)

    def todense(self):
        n, m = self.shape
        out = torch.zeros((n, m + 1), dtype=self.vals.dtype, device=self.device)
        rows = torch.arange(n, device=self.device)[:, None].expand(self.cols.shape)
        out.index_put_((rows, self.cols.long()), self.vals, accumulate=True)
        return out[:, :m]


def ell_matvec(cols, vals, a):
    ap = torch.cat([a, torch.zeros((1,) + tuple(a.shape[1:]), dtype=a.dtype, device=a.device)])
    gathered = ap[cols.long()]  # (n, width[, r])
    if a.ndim == 1:
        return torch.sum(vals * gathered, dim=1)
    return torch.sum(vals[..., None] * gathered, dim=1)


def ell_rmatvec(cols, vals, a, m):
    """Transpose MVM: out[c] += val * a[row], one scatter-add (the pad
    column m is cropped)."""
    contrib = vals * a[:, None]
    out = torch.zeros((m + 1,), dtype=contrib.dtype, device=contrib.device)
    return out.index_add_(0, cols.reshape(-1).long(), contrib.reshape(-1))[:m]


def _ell_counts(x, yp, r2, block):
    """Per-row neighbour counts, row block by row block, with the exact
    difference-form distance out to d = 64."""
    body = lambda xb: torch.sum(sqdist_tile(xb, yp, direct_max_d=64) <= r2, dim=1)
    return map_rows(body, x, block, 0)


def _first_in_range(mask, w, fill):
    """(idx, valid): the first w column positions of each row where mask
    holds, ascending, padded with `fill`. The key -col where in range makes
    topk return the in-range columns in ascending order (cfjax's
    `_ell_build_topk` key; it stands in for `jnp.nonzero(size=w)`)."""
    C = mask.shape[-1]
    cols = torch.arange(C, dtype=torch.int32, device=mask.device)
    key = torch.where(mask, -cols, _INT32_MIN)
    kv, idx = torch.topk(key, min(w, C), dim=-1)
    valid = kv > _INT32_MIN
    if w > C:
        more = w - C
        idx = torch.cat([idx, idx.new_zeros(idx.shape[:-1] + (more,))], dim=-1)
        valid = torch.cat([valid, valid.new_zeros(valid.shape[:-1] + (more,))], dim=-1)
    return torch.where(valid, idx, fill), valid


def _ell_build_topk(k, xb, yp, r2, w):
    """One row block's ELL rows: (cols (B, w) int32 sorted per row with
    pad = m, vals (B, w))."""
    m = yp.shape[0]
    D = sqdist_tile(xb, yp, direct_max_d=64)
    mask = D <= r2
    idx, valid = _first_in_range(mask, w, 0)
    vals_full = torch.where(mask, k.profile_value(D), 0.0)
    v = torch.where(valid, torch.gather(vals_full, 1, idx), 0.0)
    c = torch.where(valid, idx, m).to(torch.int32)
    return c, v


def _ell_build(k, x, yp, r2, w, block):
    """ELL rows of width w for every row of x, row block by row block."""
    return map_rows(lambda xb: _ell_build_topk(k, xb, yp, r2, w), x, block, w)


# quantized shape menu (cfjax's): the tier widths and the TileELL group
# block counts are rounded up to it, which keeps the packed arrays equal
# to cfjax's
_SHAPE_MENU = np.array(
    [1, 2, 3, 4, 6, 8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512,
     768, 1024, 1536, 2048, 3072, 4096, 6144, 8192, 12288, 16384, 24576,
     32768])


def _menu_roundup(v, lo=8):
    v = max(int(v), lo)
    idx = np.searchsorted(_SHAPE_MENU, v)
    if idx >= len(_SHAPE_MENU):
        return -(-v // 8192) * 8192
    return int(_SHAPE_MENU[idx])


def _width_tiers(counts_sorted, n, align, max_tiers=4):
    """Partition the count-sorted rows into <= max_tiers contiguous tiers,
    each padded to its own menu-quantized width; boundaries are multiples
    of `align` rows. Greedy split minimizing total slot count."""
    n_pad = -(-n // align) * align
    cs = np.concatenate([np.asarray(counts_sorted), np.zeros(n_pad - n, dtype=np.int64)])
    w_of = _menu_roundup
    bounds = [0, n_pad]
    for _ in range(max_tiers - 1):
        best = None
        for s in range(len(bounds) - 1):
            lo, hi = bounds[s], bounds[s + 1]
            if hi - lo < 2 * align:
                continue
            base = w_of(cs[lo]) * (hi - lo)
            for cut in range(lo + align, hi, align):
                cost = w_of(cs[lo]) * (cut - lo) + w_of(cs[cut]) * (hi - cut)
                gain = base - cost
                if best is None or gain > best[0]:
                    best = (gain, cut)
        if best is None or best[0] <= 0:
            break
        bounds.append(best[1])
        bounds.sort()
    return [(bounds[i], bounds[i + 1], w_of(cs[bounds[i]])) for i in range(len(bounds) - 1)]


def _tree_counts(xg3, ygath3, okmask3, r2, chunk=8):
    """Per-row neighbour counts over candidate tiles, `chunk` leaf groups
    at a time. xg3: (G, lsx, d); ygath3: (G, C, d) candidate source
    points; okmask3: (G, C) bool, valid candidate slots."""
    outs = []
    for g in range(0, xg3.shape[0], chunk):
        D = sqdist_tile(xg3[g:g + chunk], ygath3[g:g + chunk])
        outs.append(torch.sum((D <= r2) & okmask3[g:g + chunk, None, :], dim=2))
    return torch.cat(outs)


def _tree_build(k, xg3, ygath3, gcols3, okmask3, r2, w, chunk=8):
    """Per-row (col, val) ELL rows of width w over candidate tiles, columns
    in the original y numbering (gcols3: (G, C) int32 global column of each
    candidate slot), pad column int32 max."""
    sentinel = torch.iinfo(torch.int32).max
    cols, vals = [], []
    for g in range(0, xg3.shape[0], chunk):
        D = sqdist_tile(xg3[g:g + chunk], ygath3[g:g + chunk])
        mask = (D <= r2) & okmask3[g:g + chunk, None, :]
        vals_full = torch.where(mask, k.profile_value(D), 0.0)
        idx, valid = _first_in_range(mask, w, 0)
        gc = gcols3[g:g + chunk, None, :].expand(mask.shape)
        vals.append(torch.where(valid, torch.gather(vals_full, 2, idx), 0.0))
        cols.append(torch.where(valid, torch.gather(gc, 2, idx), sentinel))
    return torch.cat(cols), torch.cat(vals)


class TreeSparseOperator(LinearOperator):
    """Lazy radius-sparsified gramian in leaf-tile block-sparse form.

    The ball-tree range search (reference src/sparse.jl:5-22) yields, for
    every x-leaf, its candidate y-leaves; this operator keeps only the
    candidate slot indices on the device and recomputes kernel tiles inside
    every MVM. Memory: O(n * avg_candidates) int32."""

    def __init__(self, k, r2, tree_pts_x3, ptsy, dsts, slots, masks, n, m, perm_y, nnz,
                 symmetric=False):
        self.k = k
        self.r2 = r2
        self._x3 = tree_pts_x3      # list[(G, lsx, d)]
        self._ptsy = ptsy           # (Py, d) permuted padded sources
        self._dsts = dsts           # list[(G*lsx,)] target rows (n = pad dump)
        self._slots = slots         # list[(G, C)] indices into permuted y
        self._masks = masks         # list[(G, C)] valid-slot masks
        self._perm_y = perm_y       # (Py,) permuted slot -> original col
        self.shape = (n, m)
        self.nnz = nnz
        self.dtype = ptsy.dtype
        self.device = ptsy.device
        self._sym = symmetric and n == m

    @property
    def is_symmetric(self):
        # for x === y the pruned pattern and values are symmetric even
        # though the leaf-tile storage is row-wise
        return self._sym

    def _matvec(self, a):
        n, m = self.shape
        Py = self._ptsy.shape[0]
        ap = torch.cat([a, a.new_zeros((max(Py - m, 0),))])
        w = ap[self._perm_y]
        out = torch.zeros((n + 1,), dtype=self.dtype, device=a.device)
        for xg, dst, slot, ok in zip(self._x3, self._dsts, self._slots, self._masks):
            out.index_add_(0, dst, _tree_tile_contract(self.k, self.r2, xg, self._ptsy,
                                                       slot, ok, w).to(self.dtype))
        return out[:n]

    def todense(self):
        n, m = self.shape
        return self._matmat(torch.eye(m, dtype=self.dtype, device=self.device))


def _tree_tile_contract(k, r2, xg, ptsy, slot, ok, w):
    yg = ptsy[slot]                        # (G, C, d)
    wg = w[slot] * ok                      # (G, C)
    # exact unrolled difference form (the tree path is low-d by construction)
    D = sqdist_tile(xg, yg, direct_max_d=xg.shape[2])
    val = torch.where((D <= r2) & ok[:, None, :], k.profile_value(D), 0.0)
    return torch.einsum("gxc,gc->gx", val, wg.to(val.dtype)).reshape(-1)


def _tree_candidates(xp, yp, same, r, leafsize=None):
    """Ball-tree leaf-pair range search (reference src/sparse.jl:42-54
    in_range_neighbors): balanced trees over targets and sources; leaf
    pairs whose center distance exceeds r + rx + ry are pruned. Returns
    the bucketed candidate structure (host numpy), or None when pruning
    won't pay (high-d: leaf radii swamp the decay radius)."""
    from ..barneshut.tree import build_tree

    n, m, d = xp.shape[0], yp.shape[0], xp.shape[1]
    leafsize = leafsize or max(32, min(256, int(math.sqrt(max(n, 1))) // 2 * 2))
    tx = build_tree(xp, leafsize)
    ty = tx if same else build_tree(yp, leafsize)
    Lx, Ly = tx.levels, ty.levels
    cx, rx = tx.centers_np[Lx], tx.radii_np[Lx]
    cy, ry = ty.centers_np[Ly], ty.radii_np[Ly]
    lsx, lsy = tx.leafsize, ty.leafsize
    Gx = tx.n_leaves

    dist = np.sqrt(np.maximum(
        (cx * cx).sum(1)[:, None] + (cy * cy).sum(1)[None, :] - 2 * cx @ cy.T, 0.0))
    cand = dist <= r + rx[:, None] + ry[None, :]
    kcnt = cand.sum(1)
    # pruning payoff test: candidate fraction of all source leaves
    if kcnt.mean() > 0.5 * ty.n_leaves:
        return None

    perm_x = np.asarray(tx.perm)
    perm_y = np.asarray(ty.perm)

    # bucket x-leaves by padded candidate count (pow2). cfjax also pads each
    # bucket's group count to a menu with dummy groups, so that jitted
    # shapes recur across datasets; eager torch has no such cache, and the
    # dummy groups would only add work
    Kpad = np.maximum(1, 1 << np.ceil(np.log2(np.maximum(kcnt, 1))).astype(int))
    xg_all = tx.points_np.reshape(Gx, lsx, d)
    lsy_ar = np.arange(lsy)
    buckets = []
    for Kb in np.unique(Kpad):
        sel = np.nonzero(Kpad == Kb)[0]
        G = sel.shape[0]
        # candidate-list packing: nonzero is ordered by group
        gi_idx, leaf_idx = np.nonzero(cand[sel])
        cnt_g = kcnt[sel]
        pos = np.arange(gi_idx.shape[0]) - np.repeat(
            np.concatenate([[0], np.cumsum(cnt_g)[:-1]]), cnt_g)
        ids = np.zeros((G, Kb), dtype=np.int64)
        vmask = np.zeros((G, Kb), dtype=bool)
        ids[gi_idx, pos] = leaf_idx
        vmask[gi_idx, pos] = True
        slot = (ids[:, :, None] * lsy + lsy_ar[None, None, :]).reshape(G, Kb * lsy)
        gcols = perm_y[slot]  # (G, C) original column ids (>= m: pad)
        okmask = np.repeat(vmask, lsy, axis=1) & (gcols < m)
        buckets.append((sel, slot, gcols, okmask))
    return dict(tx=tx, ty=ty, buckets=buckets, xg_all=xg_all, perm_x=perm_x, perm_y=perm_y,
                lsx=lsx, Gx=Gx)


def _bucket_tensors(cd, n, device):
    """Per bucket, on the device: (sel, xg (G, lsx, d), candidate points
    (G, C, d), slot (G, C), gcols (G, C) int32, okmask (G, C), dst (G*lsx,)
    the target row of each leaf slot, n for the tree's padding points)."""
    pts_y = cd["ty"].points
    lsx, perm_x = cd["lsx"], cd["perm_x"]
    dev = lambda a: torch.as_tensor(a, device=device)
    out = []
    for sel, slot, gcols, okmask in cd["buckets"]:
        rows_t = (sel[:, None] * lsx + np.arange(lsx)[None, :]).reshape(-1)
        dst = np.where(perm_x[rows_t] < n, perm_x[rows_t], n)
        out.append((sel, dev(cd["xg_all"][sel]), pts_y[dev(slot)], dev(slot),
                    dev(gcols.astype(np.int32)), dev(okmask), dev(dst)))
    return out


def _tree_lazy_operator(k, xp, yp, same, r, cd):
    """The lazy TreeSparseOperator from the candidate structure: slot and
    mask tensors only, no ELL arrays. Returns (operator, nnz)."""
    n, m = xp.shape[0], yp.shape[0]
    r2 = r * r
    device = xp.device
    rowvalid = cd["perm_x"] < n

    x3s, dsts, slots, masks = [], [], [], []
    counts_t = np.zeros((cd["Gx"], cd["lsx"]), dtype=np.int64)
    for sel, xg, ygath, slot, _, okmask, dst in _bucket_tensors(cd, n, device):
        counts_t[sel] = _tree_counts(xg, ygath, okmask, r2).cpu().numpy()
        x3s.append(xg)
        dsts.append(dst)
        slots.append(slot)
        masks.append(okmask)
    nnz = int(counts_t.reshape(-1)[rowvalid].sum())
    op = TreeSparseOperator(k, r2, x3s, cd["ty"].points, dsts, slots, masks, n, m,
                            torch.as_tensor(cd["perm_y"], device=device).long(), nnz,
                            symmetric=same)
    return op, nnz


def _tree_neighbor_lists(k, xp, yp, same, r, leafsize=None, cd=None):
    """Materialized (cols, vals, counts, width) ELL rows via the tree
    candidate structure, cols in the original y numbering (fill m), sorted
    per row, on the points' device. Returns None when pruning won't pay."""
    n, m = xp.shape[0], yp.shape[0]
    if cd is None:
        cd = _tree_candidates(xp, yp, same, r, leafsize)
    if cd is None:
        return None
    perm_x = cd["perm_x"]
    device = xp.device
    bucket_data = _bucket_tensors(cd, n, device)

    r2 = r * r
    # pass 1: global max row count -> shared ELL width
    counts_t = np.zeros((cd["Gx"], cd["lsx"]), dtype=np.int64)
    for sel, xg, ygath, _, _, okmask, _ in bucket_data:
        counts_t[sel] = _tree_counts(xg, ygath, okmask, r2).cpu().numpy()
    counts_t = counts_t.reshape(-1)
    width = max(8, -(-int(counts_t.max()) // 8) * 8)

    # one dump row (n) takes the rows of the tree's padding points
    out_cols = torch.full((n + 1, width), m, dtype=torch.int32, device=device)
    out_vals = torch.zeros((n + 1, width), dtype=xp.dtype, device=device)
    rowvalid = perm_x < n
    sentinel = torch.iinfo(torch.int32).max
    for _, xg, ygath, _, gcols, okmask, dst in bucket_data:
        cols_b, vals_b = _tree_build(k, xg, ygath, gcols, okmask, r2, width)
        c = cols_b.reshape(-1, width)
        out_cols[dst] = torch.where(c == sentinel, m, c)
        out_vals[dst] = vals_b.reshape(-1, width).to(out_vals.dtype)

    counts = np.zeros(n, dtype=np.int64)
    counts[perm_x[rowvalid]] = counts_t[rowvalid]
    # sort each row by column id (pad col = m lands last): the TileELL
    # packer's run-length collision logic requires sorted ELL rows
    out_cols, order = torch.sort(out_cols[:n], dim=1, stable=True)
    out_vals = torch.gather(out_vals[:n], 1, order)
    return out_cols, out_vals, counts, width


def sparse_gramian(k, x, y=None, tol: float = None, block: int = 2048, format: str = "tile",
                   method: str = "auto", leafsize: int = None):
    """Sparse approximation of gramian(k, x, y): keeps entries within the
    analytic decay radius (reference `SparseArrays.sparse(G, tol)`,
    src/sparse.jl:5-22). Returns (operator, nnz_ratio).
    format: "tile" (TileELL, MVM through K4; the default), "ell", "bcoo"
    (a coalesced `torch.sparse_coo_tensor`) or "lazy" (`TreeSparseOperator`).
    method: "tree" (ball-tree leaf-pair pruned range search, reference
    src/sparse.jl:42-54), "scan" (blocked dense distance scan), or
    "auto" — tree when n*m > 2^31 and the leaf test predicts pruning, else
    scan."""
    from ..utils.grids import as_points

    tol = _config.DEFAULT.default_tol if tol is None else tol
    xp = as_points(x)
    yp = xp if y is None else as_points(y)
    r = decay_radius(k, tol)
    if r is None:
        raise ValueError(
            f"no decay radius available for {type(k).__name__}; "
            "sparsification needs an isotropic decaying kernel")
    r2 = r * r
    n, m = xp.shape[0], yp.shape[0]

    # cap the scan's (block, m) distance tile at 2^27 entries by shrinking
    # the block for very wide m
    max_tile = 1 << 27
    if block * m > max_tile:
        block = max(128, 1 << max(0, (max_tile // max(m, 1)).bit_length() - 1))

    if format == "lazy" or method == "tree" or (method == "auto" and n * m > (1 << 31)):
        cd = _tree_candidates(xp, yp, y is None, r, leafsize)
        if cd is not None:
            if format == "lazy" or (format == "tile" and n * m > (1 << 31)):
                op, nnz = _tree_lazy_operator(k, xp, yp, y is None, r, cd)
                return op, nnz / (n * m)
            cols, vals, counts, width = _tree_neighbor_lists(k, xp, yp, y is None, r,
                                                             leafsize, cd=cd)
            nnz = int(counts.sum())
            return _pack_sparse(cols, vals, counts, n, m, nnz, format,
                                symmetric=y is None), nnz / (n * m)
        if method == "tree" or format == "lazy":
            raise ValueError(
                "tree sparsification prunes nothing here (leaf radii >= "
                "decay radius, e.g. high-d data); use method='scan'")

    # pass 1: per-row neighbour counts (a host round trip, as in cfjax)
    counts = _ell_counts(xp, yp, r2, block).cpu().numpy()
    nnz = int(counts.sum())
    ratio = nnz / (n * m)

    if format == "tile" and -(-m // 128) <= 256:
        # count-sorted width-tiered build: rows sorted by neighbour count
        # (the order TileELL wants anyway), tiers sized so one dense row
        # doesn't inflate every row's padded width
        from .tile_ell import build_tile_ell_from_sorted

        perm = np.argsort(-counts, kind="stable")
        # tier boundaries are multiples of both the scan block and the
        # TileELL group granularity (128 lanes x 8 row blocks)
        align = 1024 * block // math.gcd(1024, block)
        tiers = _width_tiers(counts[perm], n, align=align)
        xs = xp[torch.as_tensor(perm, device=xp.device)]
        buckets = []
        for lo, hi, w in tiers:
            w = min(w, m)
            hi_r = min(hi, n)
            if hi_r <= lo:
                continue
            cols_b, vals_b = _ell_build(k, xs[lo:hi_r], yp, r2, w, block)
            buckets.append((lo, cols_b, vals_b, hi_r - lo))
        return build_tile_ell_from_sorted(buckets, perm, nnz, n, m,
                                          symmetric=y is None), ratio

    width = max(8, -(-int(counts.max()) // 8) * 8)
    cols, vals = _ell_build(k, xp, yp, r2, width, block)
    return _pack_sparse(cols, vals, counts, n, m, nnz, format, symmetric=y is None), ratio


def _pack_sparse(cols, vals, counts, n, m, nnz, format, symmetric=False):
    if format == "tile" and -(-m // 128) > 256:
        # TileELL slabs are dense over column tiles (memory ~ n*m*K/16 B);
        # beyond nt = 256 (m > 32768) plain ELL keeps memory at O(nnz)
        format = "ell"
    if format == "ell":
        return EllSparseOperator(cols, vals, m, nnz, symmetric=symmetric)
    if format == "tile":
        from .tile_ell import build_tile_ell_device

        return build_tile_ell_device(cols, vals, counts, n, m, symmetric=symmetric)
    keep = cols < m
    rows = torch.arange(n, device=cols.device)[:, None].expand(cols.shape)
    indices = torch.stack([rows[keep], cols[keep].long()])
    return torch.sparse_coo_tensor(indices, vals[keep], (n, m), check_invariants=False).coalesce()
