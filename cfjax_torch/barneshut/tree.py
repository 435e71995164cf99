"""Balanced spatial tree in fixed-depth arrays (counterpart of
`cfjax.barneshut.tree`).

A complete binary tree over the points, replacing the reference's
pointer-based BallTree (NearestNeighbors.jl, src/barneshut.jl:25-36),
stored as a permutation of the points plus per-level center/radius arrays.
Every node at level l covers a contiguous slice of the permuted points, so
node reductions are reshape-sums and a traversal is a level-synchronous
masked sweep.

Three builds: "median" and "morton" run on the host in numpy, as cfjax's
do; "device" is the Hilbert build in torch on the points' own device. Its
codes are int64 (cfjax's are uint32, because the TPU has no 64-bit
integers), sorted with a stable argsort as `jnp.argsort` sorts, so that
ties order the same way. Its host mirrors (`perm`, `points_np`,
`centers_np`, `radii_np`) are one `.cpu().numpy()` each, on first access.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import default_device


class BalancedTree:
    """Complete balanced tree in fixed arrays. `points`, `centers` and
    `radii` are tensors on the build's device; the host mirrors are numpy
    arrays, fetched lazily on device builds."""

    def __init__(self, *, points, pad, leafsize, levels, centers, radii,
                 perm=None, perm_dev=None, centers_np=None, radii_np=None,
                 points_np=None):
        self.points = points      # (P, d) permuted (padded) points
        self.pad = pad            # number of padded duplicate points
        self.leafsize = leafsize
        self.levels = levels      # L: internal levels; leaves = 2^L
        self.centers = centers    # per level l: (2^l, d) centers
        self.radii = radii        # per level l: (2^l,) radii
        self._perm = perm         # (P,) host permutation into padded points
        self._perm_dev = perm_dev
        self._centers_np = centers_np
        self._radii_np = radii_np
        self._points_np = points_np

    @property
    def n_leaves(self):
        return 2 ** self.levels

    @property
    def perm(self):
        if self._perm is None:
            self._perm = self._perm_dev.cpu().numpy()
        return self._perm

    @property
    def perm_dev(self):
        """The permutation as a tensor on the points' device."""
        if self._perm_dev is None:
            self._perm_dev = torch.as_tensor(self.perm, device=self.points.device)
        return self._perm_dev

    @property
    def points_np(self):
        if self._points_np is None:
            self._points_np = self.points.cpu().numpy()
        return self._points_np

    @property
    def centers_np(self):
        if self._centers_np is None:
            self._centers_np = [c.cpu().numpy() for c in self.centers]
        return self._centers_np

    @property
    def radii_np(self):
        if self._radii_np is None:
            self._radii_np = [r.cpu().numpy() for r in self.radii]
        return self._radii_np


def build_tree(y, leafsize: int = 16, method: str = "auto") -> BalancedTree:
    """Build the complete balanced tree. Points are padded to 2^L * ls by
    duplicating the last point (padded weights are zero at matvec time,
    so results are exact; only node radii are mildly affected).

    method: "median" — per-level median splits along the widest dimension
    (host numpy); "morton" — one Hilbert-curve sort, equal-count leaves
    sliced from the curve, boxes bottom-up (host numpy); "device" — the
    Hilbert build in torch on y's device (d <= 4); "auto" — device for
    points on a CUDA device at d <= 4, else morton for big low-d inputs,
    median otherwise. numpy input is placed on the configured device."""
    is_tensor = isinstance(y, torch.Tensor)
    if y.ndim == 1:
        y = y[:, None]
    m, d = y.shape
    L = max(0, math.ceil(math.log2(max(1, m / leafsize))))
    nleaf = 2**L
    ls = math.ceil(m / nleaf)
    P = nleaf * ls
    pad = P - m

    # numpy input goes to the configured device, as a tensor stays on its own
    device = y.device if is_tensor else default_device()
    if method == "auto":
        if device.type == "cuda" and d <= 4 and L > 0 and P >= (1 << 14):
            method = "device"
        else:
            method = "morton" if (P >= (1 << 19) and d <= 8) else "median"
    if method == "device" and d <= 4 and L > 0:
        return _build_tree_device(torch.as_tensor(y, device=device), d, L, ls, P, pad)

    y = y.detach().cpu().numpy() if is_tensor else np.asarray(y)
    yp = np.concatenate([y, np.repeat(y[-1:], pad, axis=0)], axis=0) if pad else y
    if method == "morton" and d <= 16 and L > 0:
        return _build_tree_morton(yp, d, L, ls, P, pad, device)

    perm = np.arange(P)
    pts_run = yp.copy()
    centers_np, radii_np = [], []
    # iterative median splits: at level l all 2^l segments partition at
    # once along their own widest dimension (argpartition, O(n) a level);
    # each level's min/max pass doubles as its bounding-box center
    for l in range(L + 1):
        nl = 1 << l
        seg = P // nl
        pts = pts_run.reshape(nl, seg, d)
        lo = pts.min(axis=1)
        hi = pts.max(axis=1)
        centers_np.append(0.5 * (lo + hi))
        radii_np.append(0.5 * np.sqrt(((hi - lo) ** 2).sum(-1)))
        if l == L:
            break
        dims = np.argmax(hi - lo, axis=1)  # (nl,) widest dimension
        coords = np.take_along_axis(pts, dims[:, None, None], axis=2)[:, :, 0]
        order = np.argpartition(coords, seg // 2, axis=1)
        perm = np.take_along_axis(perm.reshape(nl, seg), order, axis=1).reshape(P)
        pts_run = np.take_along_axis(pts, order[:, :, None], axis=1).reshape(P, d)
    points = pts_run
    _tighten_radii(points.reshape(2**L, -1, d), centers_np, radii_np, L)
    return _host_tree(perm, points, pad, ls, L, centers_np, radii_np, device)


def _tighten_radii(leaf_pts, centers_np, radii_np, L):
    """Exact max-distance radii at the leaves (one O(nd) pass), then every
    internal level tightened with the triangle bound
    r_parent <= max_child (r_child + ||c_child - c_parent||) against the
    bounding-box half-diagonal."""
    leaf_r2 = ((leaf_pts - centers_np[L][:, None, :]) ** 2).sum(-1)
    radii_np[L] = np.sqrt(leaf_r2.max(axis=1))
    d = leaf_pts.shape[-1]
    for l in range(L - 1, -1, -1):
        cc = centers_np[l + 1].reshape(2**l, 2, d)
        rc = radii_np[l + 1].reshape(2**l, 2)
        off = np.sqrt(((cc - centers_np[l][:, None, :]) ** 2).sum(-1))
        radii_np[l] = np.minimum(radii_np[l], (rc + off).max(axis=1))


def _host_tree(perm, points, pad, ls, L, centers_np, radii_np, device):
    dev = lambda a: torch.as_tensor(a, device=device)
    return BalancedTree(
        perm=perm, points=dev(points), pad=pad, leafsize=ls, levels=L,
        centers=[dev(c) for c in centers_np], radii=[dev(r) for r in radii_np],
        centers_np=centers_np, radii_np=radii_np, points_np=points)


def _hilbert_transpose(q, bits, d):
    """Skilling's axes->transposed-Hilbert transform, vectorized over
    points (q: (P, d) unsigned numpy integers, each coordinate `bits`
    bits). A Hilbert curve is continuous: consecutive curve positions are
    spatially adjacent, so equal-count slices never straddle the domain."""
    dt = q.dtype
    X = [q[:, j].copy() for j in range(d)]
    one = dt.type(1)
    M = dt.type(one << dt.type(bits - 1))
    Q = M
    while Q > one:
        p = dt.type(Q - one)
        for i in range(d):
            # branch-free: mask = all-ones where bit Q of X[i] is set
            mask = dt.type(0) - ((X[i] & Q) >> dt.type(int(Q).bit_length() - 1))
            t = (X[0] ^ X[i]) & p & ~mask
            X[0] ^= (p & mask) | t
            X[i] ^= t
        Q = dt.type(Q >> one)
    for i in range(1, d):
        X[i] ^= X[i - 1]
    t = np.zeros_like(X[0])
    Q = M
    while Q > one:
        mask = dt.type(0) - ((X[d - 1] & Q) >> dt.type(int(Q).bit_length() - 1))
        t ^= dt.type(Q - one) & mask
        Q = dt.type(Q >> one)
    for i in range(d):
        X[i] ^= t
    return X


def _build_tree_morton(yp, d, L, ls, P, pad, device) -> BalancedTree:
    """Space-filling-curve build on the host: quantize, Hilbert-transform,
    interleave bits, one argsort; equal-count leaves are contiguous
    slices of the curve; leaf boxes in one pass, internal boxes bottom-up."""
    bits = min(62 // d, 12 if d >= 2 else 16)
    while (1 << (bits * d)) < 16 * P and bits * d <= 60:
        bits += 1
    dt = np.uint32 if bits * d <= 30 else np.uint64
    lo = yp.min(axis=0)
    hi = yp.max(axis=0)
    span = np.where(hi > lo, hi - lo, 1.0)
    q = ((yp - lo) / span * ((1 << bits) - 1)).astype(dt)
    X = _hilbert_transpose(q, bits, d)
    code = np.zeros(P, dtype=dt)
    # transposed-code bit i of axis j -> global bit (i*d + (d-1-j)):
    # axis 0 carries the most significant interleaved bits
    for b in range(bits):
        for j in range(d):
            code |= ((X[j] >> dt(b)) & dt(1)) << dt(b * d + (d - 1 - j))
    perm = np.argsort(code, kind="stable")
    points = yp[perm]

    los = [None] * (L + 1)
    his = [None] * (L + 1)
    pts = points.reshape(2**L, ls, d)
    los[L] = pts.min(axis=1)
    his[L] = pts.max(axis=1)
    for l in range(L - 1, -1, -1):
        los[l] = np.minimum(los[l + 1][0::2], los[l + 1][1::2])
        his[l] = np.maximum(his[l + 1][0::2], his[l + 1][1::2])
    centers_np = [0.5 * (los[l] + his[l]) for l in range(L + 1)]
    radii_np = [0.5 * np.sqrt(((his[l] - los[l]) ** 2).sum(-1)) for l in range(L + 1)]
    _tighten_radii(pts, centers_np, radii_np, L)
    return _host_tree(perm, points, pad, ls, L, centers_np, radii_np, device)


def _hilbert_transpose_torch(q, bits, d):
    """Torch port of _hilbert_transpose on int64 codes (q: (P, d), each
    coordinate `bits` <= 30 bits, so every intermediate is non-negative
    except the all-ones masks, which are -1 in two's complement)."""
    X = [q[:, j] for j in range(d)]
    M = 1 << (bits - 1)
    Q = M
    while Q > 1:
        p = Q - 1
        sh = Q.bit_length() - 1
        for i in range(d):
            mask = -((X[i] & Q) >> sh)
            t = (X[0] ^ X[i]) & p & ~mask
            X[0] = X[0] ^ ((p & mask) | t)
            X[i] = X[i] ^ t
        Q >>= 1
    for i in range(1, d):
        X[i] = X[i] ^ X[i - 1]
    t = torch.zeros_like(X[0])
    Q = M
    while Q > 1:
        mask = -((X[d - 1] & Q) >> (Q.bit_length() - 1))
        t = t ^ ((Q - 1) & mask)
        Q >>= 1
    return [x ^ t for x in X]


def _build_tree_device(y, d, L, ls, P, pad) -> BalancedTree:
    """Device tree build: Hilbert codes, stable argsort, permute, per-level
    bounding boxes bottom-up, exact leaf radii + triangle-bound internal
    radii, all on y's device in y's floating dtype."""
    bits = min(30 // d, 16)
    while (1 << (bits * d)) < 16 * P and bits * d <= 28:
        bits += 1
    yp = y if y.is_floating_point() else y.to(torch.get_default_dtype())
    if pad:
        yp = torch.cat([yp, yp[-1:].expand(pad, d)], dim=0)
    lo = yp.min(dim=0).values
    hi = yp.max(dim=0).values
    span = torch.where(hi > lo, hi - lo, torch.ones_like(hi))
    q = ((yp - lo) / span * ((1 << bits) - 1)).to(torch.int64)
    X = _hilbert_transpose_torch(q, bits, d)
    code = torch.zeros((P,), dtype=torch.int64, device=yp.device)
    for b in range(bits):
        for j in range(d):
            code = code | (((X[j] >> b) & 1) << (b * d + (d - 1 - j)))
    perm = torch.argsort(code, stable=True)
    points = yp[perm]

    pts = points.reshape(2**L, ls, d)
    los = [None] * (L + 1)
    his = [None] * (L + 1)
    los[L] = pts.min(dim=1).values
    his[L] = pts.max(dim=1).values
    for l in range(L - 1, -1, -1):
        los[l] = torch.minimum(los[l + 1][0::2], los[l + 1][1::2])
        his[l] = torch.maximum(his[l + 1][0::2], his[l + 1][1::2])
    centers = [0.5 * (los[l] + his[l]) for l in range(L + 1)]
    radii = [0.5 * torch.sqrt(((his[l] - los[l]) ** 2).sum(-1)) for l in range(L + 1)]
    leaf_r2 = ((pts - centers[L][:, None, :]) ** 2).sum(-1)
    radii[L] = torch.sqrt(leaf_r2.max(dim=1).values)
    for l in range(L - 1, -1, -1):
        cc = centers[l + 1].reshape(2**l, 2, d)
        rc = radii[l + 1].reshape(2**l, 2)
        off = torch.sqrt(((cc - centers[l][:, None, :]) ** 2).sum(-1))
        radii[l] = torch.minimum(radii[l], (rc + off).max(dim=1).values)
    return BalancedTree(points=points, pad=pad, leafsize=ls, levels=L, centers=centers,
                        radii=radii, perm_dev=perm.to(torch.int32))
