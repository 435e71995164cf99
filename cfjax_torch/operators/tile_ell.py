"""TileELL sparse operators (counterpart of `cfjax.operators.tile_ell`).

The layout is cfjax's, element for element, so that packed arrays compare
with cfjax's: the input vector is viewed as a2 = a.reshape(nt, 128)
(tile, lane); a nonzero (i, c, v) sits at (block, k, tile, lane) with
  block = sorted-row(i) // 128, lane = sorted-row(i) % 128 (rows sorted by
  nnz count), tile = c // 128, off = c % 128,
  k = collision counter among slots sharing (block, tile, lane).
Blocks are grouped by collision depth K; each group holds off (int32) and
val slabs of shape (B, K, nt, 128) with B a multiple of 8 (menu-quantized
on the count-sorted build, cropped at MVM time), and `perm` maps sorted
rows back, pad rows to the dump slot n. The MVM of a group is K4
(`ops/tile_ell_mvm.slab_matvec`): the CUDA kernel on CUDA tensors, its
plain version on the CPU. The transpose MVM is a plain `index_add_`
scatter, as cfjax's is XLA.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.tile_ell_mvm import slab_matvec
from .linop import LinearOperator

_LANES = 128
_BLK8 = 8  # row blocks are grouped in multiples of 8 (cfjax's Pallas grid step)


def _build_groups(Kb: np.ndarray, max_groups: int = 6):
    """Partition blocks (sorted by K descending) into contiguous groups,
    each padded to its max K. Greedy split minimizing total padding.
    Bounds are multiples of 8 blocks."""
    nb = len(Kb)
    bounds = [0, nb]
    for _ in range(max_groups - 1):
        best = None
        for s in range(len(bounds) - 1):
            lo, hi = bounds[s], bounds[s + 1]
            if hi - lo < 2 * _BLK8:
                continue
            seg = Kb[lo:hi]
            base = seg.max() * len(seg)
            # candidate cuts: where K changes (Kb ~sorted), rounded to 8
            cand = lo + 1 + np.flatnonzero(seg[1:] != seg[:-1])
            cand = np.unique((cand // _BLK8) * _BLK8)
            cand = cand[(cand > lo) & (cand < hi)]
            for cut in cand:
                c = Kb[lo:cut].max() * (cut - lo) + Kb[cut:hi].max() * (hi - cut)
                gain = base - c
                if best is None or gain > best[0]:
                    best = (gain, cut)
        if best is None or best[0] <= 0:
            break
        bounds.append(int(best[1]))
        bounds.sort()
    return bounds


class TileEllOperator(LinearOperator):
    """Sparse operator in TileELL layout, shape (n, m); rows internally
    permuted by nnz count (perm folds into the MVM). A full
    LinearOperator: `.solve`, `.T`, `add_diagonal` compose."""

    def __init__(self, groups, perm, n, m, nnz, dtype=None, symmetric=False):
        # groups: list of (row_start, row_stop, off (B,K,nt,128) int32,
        #                  val (B,K,nt,128)), rows of the sorted order
        self.groups = groups
        self.perm = torch.as_tensor(perm).long()   # sorted row -> original row
        self.device = self.perm.device
        self.shape = (n, m)
        self.nt = -(-m // _LANES)
        self.nnz = nnz
        self.dtype = dtype if dtype is not None else (
            groups[0][3].dtype if groups else torch.get_default_dtype())
        self._sym = symmetric and n == m

    @classmethod
    def from_reference(cls, groups, perm, n, m, nnz, symmetric=False, device=None):
        """The operator of cfjax's packed arrays (numpy): groups of
        (row_start, row_stop, off, val), perm, shape and nnz."""
        dev = lambda a: torch.tensor(np.asarray(a), device=device)
        return cls([(int(r0), int(r1), dev(off), dev(val)) for r0, r1, off, val in groups],
                   dev(perm), n, m, nnz, symmetric=symmetric)

    @property
    def is_symmetric(self):
        return self._sym

    def _matvec(self, a):
        return tile_ell_matvec(self, a)

    def _matmat(self, A):
        return tile_ell_matvec(self, A)

    def _rmatvec(self, a):
        if self._sym:
            return self._matvec(a)
        return tile_ell_rmatvec(self, a)

    def todense(self):
        n, m = self.shape
        out = torch.zeros((n, m), dtype=self.dtype, device=self.device)
        for r0, r1, off, val in self.groups:
            blocks = (r1 - r0) // _LANES
            off, val = off[:blocks], val[:blocks]
            B, K, nt, L = off.shape
            lane = torch.arange(L, device=self.device)
            rows = self.perm[r0 + (torch.arange(B, device=self.device) * L)[:, None, None, None]
                             + lane].expand(B, K, nt, L)
            cols = (torch.arange(nt, device=self.device) * L)[:, None] + off.long()
            keep = (val != 0) & (cols < m)
            out.index_put_((rows[keep], cols[keep]), val[keep].to(self.dtype), accumulate=True)
        return out


def build_tile_ell(rows, cols, vals, n, m, dtype=None, max_groups: int = 6):
    """Pack COO (rows, cols, vals) into TileELL on the host (numpy); the
    slabs land on the device of `vals` when it is a tensor."""
    device = vals.device if isinstance(vals, torch.Tensor) else None
    host = lambda a: a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    rows, cols, vals = host(rows), host(cols), host(vals)
    dtype = torch.from_numpy(vals[:0]).dtype if dtype is None else dtype
    nt = -(-m // _LANES)
    L = _LANES
    nb = -(-n // L)
    nb = -(-nb // _BLK8) * _BLK8
    n_pad = nb * L

    # sort rows by nnz count (desc) so heavy blocks are contiguous
    cnt = np.bincount(rows, minlength=n)
    perm = np.argsort(-cnt, kind="stable").astype(np.int32)  # sorted -> orig
    inv = np.empty(n, np.int32)
    inv[perm] = np.arange(n, dtype=np.int32)
    perm_full = np.concatenate([perm, np.arange(n, n_pad, dtype=np.int32)]) \
        if n_pad > n else perm

    r = inv[rows]
    b = r // L
    lane = r % L
    t = cols // L
    o = (cols % L).astype(np.int32)

    # collision index k within (b, t, lane)
    order = np.lexsort((o, lane, t, b))
    bb, tt, ll, oo, vv = b[order], t[order], lane[order], o[order], vals[order]
    new = np.r_[True, (bb[1:] != bb[:-1]) | (tt[1:] != tt[:-1]) | (ll[1:] != ll[:-1])]
    pos = np.arange(len(order))
    k = pos - np.maximum.accumulate(np.where(new, pos, 0))

    Kb = np.zeros(nb, np.int64)
    np.maximum.at(Kb, bb, k + 1)
    Kb = np.maximum(Kb, 1)

    bounds = _build_groups(Kb, max_groups)
    groups = []
    for g in range(len(bounds) - 1):
        b0, b1 = bounds[g], bounds[g + 1]
        B = b1 - b0
        K = int(Kb[b0:b1].max())
        sel = (bb >= b0) & (bb < b1)
        off = np.zeros((B, K, nt, L), np.int32)
        val = np.zeros((B, K, nt, L), vals.dtype)
        off[bb[sel] - b0, k[sel], tt[sel], ll[sel]] = oo[sel]
        val[bb[sel] - b0, k[sel], tt[sel], ll[sel]] = vv[sel]
        groups.append((b0 * L, b1 * L, torch.as_tensor(off, device=device),
                       torch.as_tensor(val, device=device).to(dtype)))
    return TileEllOperator(groups, torch.as_tensor(perm_full, device=device), n, m,
                           len(rows), dtype)


_K_QUANTA = np.array([1, 2, 4, 8, 16, 32, 64, 128])


def _quantize_K(Kb):
    """Round collision depths up to a power-of-two menu, as cfjax does (it
    did so to reuse compiled shapes across datasets; here it keeps the
    groups, and so the packed arrays, equal to cfjax's)."""
    idx = np.searchsorted(_K_QUANTA, Kb)
    return _K_QUANTA[np.minimum(idx, len(_K_QUANTA) - 1)]


def _run_index(t, valid, w):
    """Position of each slot within its run of equal tiles (cols sorted
    per row). Pad slots get unique pseudo-tiles so they never form runs."""
    idx = torch.arange(w, device=t.device)
    tt = torch.where(valid, t.long(), -(idx[None, :] + 1))
    new = torch.cat([torch.ones_like(tt[:, :1], dtype=torch.bool), tt[:, 1:] != tt[:, :-1]],
                    dim=1)
    start = torch.where(new, idx[None, :], 0)
    return idx[None, :] - torch.cummax(start, dim=1).values


def _run_kmax(cols, m, w):
    """Per-row max run length of equal column tiles (cols sorted per row,
    pad = col >= m). Determines collision depth K."""
    valid = cols < m
    k = _run_index(torch.div(cols, _LANES, rounding_mode="floor"), valid, w)
    return torch.amax(torch.where(valid, k, 0), dim=1) + 1


def _pack_group(cols, vals, rows_sel, m, B, K, nt, w):
    """Scatter ELL rows into a (B, K, nt, 128) TileELL group.
    rows_sel: (B*128,) row ids into cols/vals, -1 = padding row. Pad
    slots (col >= m, padding rows, run index >= K) are dropped before the
    scatter; every kept index (b, k, t, lane) is unique by construction."""
    L = _LANES
    dev = cols.device
    valid_row = rows_sel >= 0
    rs = torch.clamp(rows_sel, min=0).long()
    c = cols[rs].long()                      # (B*L, w)
    v = vals[rs]
    t = torch.div(c, L, rounding_mode="floor")
    o = (c % L).to(torch.int32)
    kk = _run_index(t, c < m, w)
    lane = (torch.arange(B * L, device=dev) % L)[:, None]
    b_local = (torch.arange(B * L, device=dev) // L)[:, None]
    keep = (c < m) & valid_row[:, None] & (kk < K)
    flat = (((b_local * K + kk) * nt + t) * L + lane)[keep]
    size = B * K * nt * L
    off = torch.zeros(size, dtype=torch.int32, device=dev)
    val = torch.zeros(size, dtype=vals.dtype, device=dev)
    off[flat] = o[keep]
    val[flat] = v[keep]
    return off.reshape(B, K, nt, L), val.reshape(B, K, nt, L)


def _dump_perm(perm_full, n, n_pad):
    """Sorted -> original rows, with padding rows (-1) sent to the dump
    slot n (cropped after the MVM; there are none when n == n_pad)."""
    return np.where(perm_full < 0, n_pad - 1 if n == n_pad else n, perm_full)


def build_tile_ell_from_sorted(buckets, perm, nnz, n, m, max_groups: int = 4,
                               symmetric=False):
    """Device-side TileELL packing from count-sorted, width-tiered ELL
    buckets. `buckets`: list of (lo, cols, vals, R) where rows lo..lo+R-1
    of the count-sorted row order carry the first R rows of cols (Rpad,
    w_b) int32 sorted per row (pad = m) and vals (Rpad, w_b). Bucket
    boundaries (lo, and lo+R rounded up) are multiples of 1024 rows.
    `perm`: (n,) sorted -> original row. Group block counts are
    menu-quantized (shape padding, cropped at MVM time), as in cfjax."""
    from .sparse_op import _menu_roundup

    L = _LANES
    nt = -(-m // L)
    nb = -(-n // L)
    nb = -(-nb // _BLK8) * _BLK8
    n_pad = nb * L

    perm_full = np.concatenate([np.asarray(perm, np.int32), np.full(n_pad - n, -1, np.int32)])
    device = buckets[0][1].device if buckets else None

    groups = []
    for lo, cols_b, vals_b, R in buckets:
        w = cols_b.shape[1]
        hi = min(lo + -(-R // (L * _BLK8)) * (L * _BLK8), n_pad)
        kmax = _run_kmax(cols_b, m, w).cpu().numpy().astype(np.int64)[:R]
        kmax = np.concatenate([kmax, np.ones(hi - lo - R, np.int64)])
        Kb = _quantize_K(kmax.reshape(-1, L).max(axis=1))
        bounds = _build_groups(Kb, max_groups)
        local_rows = np.arange(hi - lo, dtype=np.int32)
        local_rows[R:] = -1
        # rows past n in the sorted order are pure padding
        local_rows[np.nonzero(perm_full[lo:hi] < 0)[0]] = -1
        for g in range(len(bounds) - 1):
            b0, b1 = bounds[g], bounds[g + 1]
            B = b1 - b0
            Bq = _menu_roundup(B, lo=_BLK8)
            Bq = max(_BLK8, -(-Bq // _BLK8) * _BLK8)
            K = int(Kb[b0:b1].max())
            sel = np.full(Bq * L, -1, np.int32)
            sel[: B * L] = local_rows[b0 * L:b1 * L]
            off, val = _pack_group(cols_b, vals_b, torch.as_tensor(sel, device=device), m,
                                   Bq, K, nt, w)
            groups.append((lo + b0 * L, lo + b1 * L, off, val))

    out_perm = torch.as_tensor(_dump_perm(perm_full, n, n_pad), device=device)
    return TileEllOperator(groups, out_perm, n, m, nnz, symmetric=symmetric)


def build_tile_ell_device(cols, vals, counts, n, m, max_groups: int = 6, symmetric=False):
    """Device-side TileELL packing from padded ELL tensors (cols (n, w)
    sorted per row with pad = m, vals (n, w)); only the O(n) counts and
    run lengths cross to the host, to pick the groups' shapes."""
    w = cols.shape[1]
    L = _LANES
    nt = -(-m // L)
    nb = -(-n // L)
    nb = -(-nb // _BLK8) * _BLK8
    n_pad = nb * L

    counts = np.asarray(counts)
    kmax = _run_kmax(cols, m, w).cpu().numpy()      # (n,) small transfer
    perm = np.argsort(-counts, kind="stable").astype(np.int32)
    perm_full = np.concatenate([perm, np.full(n_pad - n, -1, np.int32)])

    kmax_sorted = np.concatenate([kmax[perm], np.ones(n_pad - n, np.int64)])
    Kb = _quantize_K(kmax_sorted.reshape(nb, L).max(axis=1))
    bounds = _build_groups(Kb, max_groups)

    groups = []
    for g in range(len(bounds) - 1):
        b0, b1 = bounds[g], bounds[g + 1]
        B = b1 - b0
        K = int(Kb[b0:b1].max())
        rows_sel = torch.as_tensor(perm_full[b0 * L:b1 * L], device=cols.device)
        off, val = _pack_group(cols, vals, rows_sel, m, B, K, nt, w)
        groups.append((b0 * L, b1 * L, off, val))

    out_perm = torch.as_tensor(_dump_perm(perm_full, n, n_pad), device=cols.device)
    return TileEllOperator(groups, out_perm, n, m, int(counts.sum()), symmetric=symmetric)


def tile_ell_matvec(S: TileEllOperator, a):
    """S @ a: one K4 launch per group (over the group's real row blocks),
    then the sorted rows scattered back to the original order. A matrix
    right-hand side goes through K4 column by column."""
    if a.ndim == 2:
        return torch.stack([tile_ell_matvec(S, a[:, j]) for j in range(a.shape[1])], dim=1)
    m = a.shape[0]
    a2 = F.pad(a, (0, S.nt * _LANES - m)).reshape(S.nt, _LANES)
    outs = []
    for r0, r1, off, val in S.groups:
        blocks = (r1 - r0) // _LANES
        outs.append(slab_matvec(a2, off[:blocks], val[:blocks]).reshape(-1))
    out_sorted = torch.cat(outs)
    n_pad = S.perm.shape[0]
    out = torch.zeros((n_pad,), dtype=out_sorted.dtype, device=out_sorted.device)
    out[S.perm] = out_sorted[:n_pad]
    return out[: S.shape[0]]


def tile_ell_rmatvec(S: TileEllOperator, a):
    """Transpose MVM: scatter val * a[row] into the column tiles (plain
    torch). Used only on non-symmetric operators (the CGNR path)."""
    n, m = S.shape
    L = _LANES
    perm = S.perm
    n_pad = perm.shape[0]
    ap = torch.zeros((n_pad + 1,), dtype=a.dtype, device=a.device)
    ap[:n_pad] = torch.where(perm < n, a[torch.clamp(perm, max=n - 1)], 0.0)
    dtype = torch.promote_types(a.dtype, S.dtype)
    out2 = torch.zeros((S.nt * L,), dtype=dtype, device=a.device)
    tile = (torch.arange(S.nt, device=a.device) * L)[:, None]
    for r0, r1, off, val in S.groups:
        blocks = (r1 - r0) // L
        off, val = off[:blocks], val[:blocks]
        rows = r0 + torch.arange(blocks * L, device=a.device).reshape(blocks, L)
        av = val * ap[rows][:, None, None, :]          # (B, K, nt, L)
        out2.index_add_(0, (tile + off.long()).reshape(-1), av.reshape(-1).to(dtype))
    return out2[:m]
