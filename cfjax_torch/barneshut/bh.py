"""Barnes-Hut O(n log n) approximate Gramian MVM (counterpart of
`cfjax.barneshut.bh`, reference src/barneshut.jl + src/taylor.jl).

The traversal is group-synchronous, as cfjax's:

  - targets are grouped by tree locality (contiguous segments of the
    spatial sort; for the symmetric case these are tree nodes);
  - each group walks one frontier of candidate nodes with the conservative
    group criterion
        theta * (dist(group_center, node_center) - group_radius) > R
    (a node far for the group's sphere is far for every target in it);
  - far-field terms are evaluated densely for all targets x frontier
    slots about the nodes' |w|-centers of mass (the dipole-corrected
    expansion of src/taylor.jl:7-57, or an order-p tensor-moment one);
  - the leaves still open feed a dense (targets x leaves * leafsize)
    profile tile.

The far/open decision depends only on the geometry, so the build sweeps it
once on the host (`interaction_plan`, numpy, as cfjax's) and every MVM is
batched gathers and dense contractions over groups in chunks
(`bh_matvec_planned`). `bh_matvec`, the per-MVM traversal with a
compaction of the open nodes at every level, is the plain reference of the
planned MVM. cfjax evaluates both with XLA ops (no Pallas kernel): here
they are plain torch on the points' device.
"""

from __future__ import annotations

import math
from math import comb as _comb

import numpy as np
import torch

from .. import config as _config
from ..kernels.base import InputTrait, input_trait
from ..kernels.derivatives import elementwise_derivatives
from ..kernels.parameters import to_points
from ..operators.linop import LinearOperator
from ..ops.tiles import matmul_p, sqdist_tile
from ..utils.roofline import Work
from .tree import BalancedTree, _build_tree_device, build_tree

_LETTERS = "ijklmn"  # tensor-order alphabet: supports order <= 6

# Group chunks of the MVMs hold about this many (target, slot) pairs per
# tile: a chunk's tiles are the MVM's working memory, and every chunk costs
# a fixed number of launches. cfjax's hold 4,000,000; on an H100 at
# n = 10^6 those made a call 617.7 ms against 73.99 ms at 2^27, whose
# peak is 1.68 GiB (`bh_chunks.py`, PERF.md).
CHUNK_ELEMENTS = 2**27


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _node_moments(wl, delta, order):
    """Tensor moments M_{a,b}[node, i1..ia] = sum_j w_j |d_j|^(2b) d_j^(x a)
    for every (a, b) with 1 <= a+b and a + 2b <= order (the general-order
    analogue of the reference's PowersArray scaffold, src/taylor.jl:62-85)."""
    out = {}
    d2j = torch.sum(delta * delta, dim=2)  # (nl, Pl)
    for a in range(0, order + 1):
        for b in range(0, (order - a) // 2 + 1):
            if a + b == 0:
                continue  # (0,0) is the plain node sum S
            wgt = wl * d2j**b if b else wl
            if a == 0:
                out[(a, b)] = torch.sum(wgt, dim=1)
                continue
            letters = _LETTERS[:a]
            sub = "np," + ",".join("np" + c for c in letters) + "->n" + letters
            out[(a, b)] = torch.einsum(sub, wgt, *([delta] * a))
    return out


def _moment_contract(rc, Mc, a):
    """<r^(x a), M> per (group, target, slot): (C, G, W, d) x (C, W, d^a) -> (C, G, W)."""
    if a == 0:
        return Mc[:, None, :]
    letters = _LETTERS[:a]
    sub = ",".join("cgf" + c for c in letters) + ",cf" + letters + "->cgf"
    return torch.einsum(sub, *([rc] * a), Mc)


def _level_stats(w, aw, tree_points, l, order):
    """Node sums, expansion centers and moments of tree level l: S, com,
    (mu, <com, mu>), and Q with its trace (order 2) or the tensor moments
    (order >= 3), all reshape-reductions of the permuted weights."""
    P, d = tree_points.shape
    nl = 2**l
    eps = torch.finfo(w.dtype).eps
    wl = w.reshape(nl, P // nl)
    awl = aw.reshape(nl, P // nl)
    pts = tree_points.reshape(nl, P // nl, d)
    com = torch.sum(awl[:, :, None] * pts, dim=1) / (torch.sum(awl, dim=1)[:, None] + eps)
    delta = pts - com[:, None, :]
    mu = torch.sum(wl[:, :, None] * delta, dim=1)
    st = {"S": torch.sum(wl, dim=1), "com": com, "mu": mu, "commu": torch.sum(com * mu, dim=1)}
    if order == 2:
        Q = torch.einsum("npd,npe->nde", wl[:, :, None] * delta, delta)
        st["Q"], st["trQ"] = Q, torch.diagonal(Q, dim1=1, dim2=2).sum(-1)
    elif order >= 3:
        st["M"] = _node_moments(wl, delta, order)
    return st


def _far_field(k, xt, st, ic, order):
    """Far-field contribution of the nodes ic (C, W) of the node table st,
    expanded about their centers, to the targets xt (C, G, d): (C, G, W)."""
    comc = st["com"][ic]                         # (C, W, d)
    D2 = sqdist_tile(xt, comc)                   # (C, G, W)
    if order >= 3:
        # k(|x-y|^2) = sum_m f^(m)(s0)/m! u^m with u = -2<r,delta> + |delta|^2,
        # truncated to delta-order <= p through
        # u^m = sum_a C(m,a)(-2)^a <r^(xa), M_{a,m-a}>, a + 2(m-a) <= p
        fs = elementwise_derivatives(k.profile, D2, order)
        contrib = fs[0] * st["S"][ic][:, None, :]
        rc = xt[:, :, None, :] - comc[:, None, :, :]     # (C, G, W, d)
        fact = 1.0
        for m_ in range(1, order + 1):
            fact *= m_
            term = None
            for a_ in range(m_, -1, -1):
                b_ = m_ - a_
                if a_ + 2 * b_ > order:
                    continue
                t = (_comb(m_, a_) * (-2.0) ** a_) * _moment_contract(rc, st["M"][(a_, b_)][ic],
                                                                       a_)
                term = t if term is None else term + t
            if term is not None:
                contrib = contrib + (fs[m_] / fact) * term
        return contrib
    fs = elementwise_derivatives(k.profile, D2, order)
    f0, f1 = fs[0], fs[1]
    xdotmu = xt @ st["mu"][ic].mT                # (C, G, W)
    contrib = f0 * st["S"][ic][:, None, :] - 2.0 * f1 * (xdotmu - st["commu"][ic][:, None, :])
    if order == 2:
        rc = xt[:, :, None, :] - comc[:, None, :, :]
        rQr = torch.einsum("cgfd,cfde,cgfe->cgf", rc, st["Q"][ic], rc)
        contrib = contrib + 2.0 * fs[2] * rQr + f1 * st["trQ"][ic][:, None, :]
    return contrib


def _near_field(k, xt, leaf_pts, leaf_w, lic, lmsk):
    """The open leaves lic (C, W) of each group, densely: (C, G)."""
    C, d = lic.shape[0], xt.shape[-1]
    pts = leaf_pts[lic].reshape(C, -1, d)                      # (C, W * ls, d)
    wts = torch.where(lmsk[:, :, None], leaf_w[lic], 0.0).reshape(C, -1, 1)
    return matmul_p(k.profile_value(sqdist_tile(xt, pts)), wts)[..., 0]


def _check_order(order):
    if order > len(_LETTERS):
        raise ValueError(f"far-field order > {len(_LETTERS)} not supported")


def _weights_abs(w, fixed_centers):
    return torch.ones_like(w) if fixed_centers else torch.abs(w)


def bh_matvec(k, xg, gc, gr, tree_points, centers, radii, w, theta: float, levels: int,
              leafsize: int, max_open: int, order: int = 1, fixed_centers: bool = False):
    """Approximate b = K w by a traversal at every call, returned in the
    grouped (ngroups, G) layout: each group walks a frontier of 2F
    candidate slots per level; far nodes add their expansion, open nodes
    are compacted into the first F slots (a stable sort of the open flags:
    open nodes first, in slot order, as `lax.top_k` orders ties) and their
    children are the next level's candidates; the open leaves are
    evaluated densely.

    xg (ngroups, G, d) grouped targets; gc (ngroups, d), gr (ngroups,)
    group centers and radii; centers / radii per tree level (the
    criterion's); w (P,) permuted, padded weights. order: far-field
    expansion order about the node centers (1 dipole, 2 quadrupole, up to
    6); fixed_centers: uniform-weight centers, which make the map linear
    in w (see `bh_matvec_planned`).

    Returns (b, overflow); overflow > 0 means a frontier was truncated to
    F slots (the factorization's probe sizes F so that it never is)."""
    _check_order(order)
    d = tree_points.shape[1]
    F = max_open
    aw = _weights_abs(w, fixed_centers)
    stats = [_level_stats(w, aw, tree_points, l, order) for l in range(levels + 1)]
    leaf_pts = tree_points.reshape(2**levels, leafsize, d)
    leaf_w = w.reshape(2**levels, leafsize)
    ngroups, G = xg.shape[0], xg.shape[1]
    chunk = max(1, min(ngroups, CHUNK_ELEMENTS // max(G * 2 * F, 1)))
    outs, overflow = [], 0
    for g0 in range(0, ngroups, chunk):
        xt, c0, r0 = xg[g0:g0 + chunk], gc[g0:g0 + chunk], gr[g0:g0 + chunk]
        C = xt.shape[0]
        acc = torch.zeros((C, G), dtype=xt.dtype, device=xt.device)
        cand = torch.zeros((C, 2 * F), dtype=torch.long, device=xt.device)
        valid = torch.zeros((C, 2 * F), dtype=torch.bool, device=xt.device)
        valid[:, 0] = True
        for l in range(levels + 1):
            Cc, Rc = centers[l][cand], radii[l][cand]             # (C, 2F, d), (C, 2F)
            dg = torch.sqrt(torch.clamp(torch.sum((c0[:, None, :] - Cc) ** 2, dim=-1), min=0.0))
            # zero-radius nodes (padded duplicate points) are exactly
            # compressible: every point sits at the center of mass
            far = ((theta * torch.clamp(dg - r0[:, None], min=0.0) > Rc) | (Rc <= 0.0)) & valid
            open_ = valid & ~far
            contrib = _far_field(k, xt, stats[l], cand, order)
            acc = acc + torch.sum(torch.where(far[:, None, :], contrib, 0.0), dim=2)
            overflow = max(overflow, int(torch.max(torch.sum(open_, dim=1))) - F)
            vals, pos = torch.sort(open_.to(torch.int32), dim=1, descending=True, stable=True)
            fr = torch.gather(cand, 1, pos[:, :F])
            fv = vals[:, :F] > 0
            if l < levels:
                cand = torch.cat([2 * fr, 2 * fr + 1], dim=1)
                valid = torch.cat([fv, fv], dim=1)
        outs.append(acc + _near_field(k, xt, leaf_pts, leaf_w, fr, fv))
    return torch.cat(outs), overflow


def _ell_from_pairs(a, b, g):
    """COO (group, node) pairs -> ELL (g, W) int32, -1 padded."""
    cnt = np.bincount(a, minlength=g)
    W = int(cnt.max()) if a.size else 0
    if W == 0:
        return None
    out = -np.ones((g, W), dtype=np.int32)
    order = np.argsort(a, kind="stable")
    aa, bb = a[order], b[order]
    starts = np.concatenate([[0], np.cumsum(cnt)])[:-1]
    ranks = np.arange(aa.size) - starts[aa]
    out[aa, ranks] = bb
    return out


def _live_pairs(gc, gr, centers, radii, theta, levels):
    """The live-pair sweep (dual-tree style) of `interaction_plan` and
    `_max_open_nodes`: yields (level, a, b, far) with (a, b) the (group,
    node) pairs still open at the level and `far` the criterion on them;
    each level expands every open pair into its two children, so the work
    is the sum of the true frontier sizes."""
    g = gc.shape[0]
    a = np.arange(g, dtype=np.int64)     # live pair: group index
    b = np.zeros(g, dtype=np.int64)      # live pair: node id at level l
    for l in range(levels + 1):
        C, R = centers[l], radii[l]
        dg = np.sqrt(((gc[a] - C[b]) ** 2).sum(-1))
        Rb = R[b]
        far = (theta * np.maximum(dg - gr[a], 0.0) > Rb) | (Rb <= 0.0)
        yield l, a, b, far
        if l == levels:
            break
        ao, bo = a[~far], b[~far]
        a = np.repeat(ao, 2)
        b = np.empty(2 * bo.size, dtype=np.int64)
        b[0::2] = 2 * bo
        b[1::2] = 2 * bo + 1


def interaction_plan(gc, gr, centers, radii, theta, levels):
    """Host traversal, run once per geometry: the far/open decision
    depends only on the tree geometry, never on the weights, so the
    frontier walk is precomputed into static per-level interaction lists.

    Returns (far_levels, far_idx, leaf_idx): far_levels the tuple of tree
    levels with a nonempty far list, far_idx the matching tuple of
    (ngroups, W_l) int32 node-index arrays (-1 padded), and leaf_idx the
    (ngroups, W_leaf) still-open leaves."""
    g = gc.shape[0]
    far_levels, far_idx = [], []
    leaf_idx = None
    for l, a, b, far in _live_pairs(gc, gr, centers, radii, theta, levels):
        ell = _ell_from_pairs(a[far], b[far], g)
        if ell is not None:
            far_levels.append(l)
            far_idx.append(ell)
        if l == levels:
            leaf_idx = _ell_from_pairs(a[~far], b[~far], g)
    if leaf_idx is None:
        leaf_idx = -np.ones((g, 1), dtype=np.int32)
    return tuple(far_levels), tuple(far_idx), leaf_idx


def _max_open_nodes(gc, gr, centers, radii, theta, levels):
    """Per-group max open-node count over all levels (sizes the frontier
    buckets), by the exact group criterion of the sweep."""
    worst = np.ones((gc.shape[0],), dtype=np.int64)
    for _, a, _, far in _live_pairs(gc, gr, centers, radii, theta, levels):
        np.maximum(worst, np.bincount(a[~far], minlength=gc.shape[0]), out=worst)
    return worst


def bh_matvec_planned(k, xg, far_idx, leaf_idx, tree_points, w, far_levels: tuple,
                      levels: int, leafsize: int, order: int = 1,
                      fixed_centers: bool = False):
    """Approximate b = K w over a precomputed interaction plan, in the
    grouped (ngroups, G) layout: node moments are reshape-reductions of w,
    the far field is a gather and one dense (G, sum of W_l) expansion tile
    over the far nodes of every level at once (the levels' node tables
    stacked, their indices offset), the near field a leaf gather and one
    dense (G, W_leaf * ls) profile tile. The groups go in chunks of about
    `CHUNK_ELEMENTS` tile entries.

    far_idx: tuple of (ngroups, W_l) node indices per level in far_levels,
    leaf_idx (ngroups, W_leaf), both -1 padded (padding is gathered at node
    0 and masked out). fixed_centers: expand about uniform-weight centers
    of mass instead of |w|-weighted ones. The |w|-centers minimise the
    dipole but move with w, so the map w -> b is weakly nonlinear; with
    fixed centers every node moment is linear in w and the MVM is a linear
    operator, which CG, MINRES and GMRES need."""
    _check_order(order)
    d = tree_points.shape[1]
    dev = xg.device
    as_idx = lambda a: torch.as_tensor(a, device=dev).long()
    leaf_idx = as_idx(leaf_idx)
    aw = _weights_abs(w, fixed_centers)
    ngroups, G = xg.shape[0], xg.shape[1]
    stats, far, off = [], [], 0
    for l, idx in zip(far_levels, far_idx):
        idx = as_idx(idx)
        stats.append(_level_stats(w, aw, tree_points, l, order))
        far.append(torch.where(idx >= 0, idx + off, -1))
        off += 2**l
    if off:
        table = {key: torch.cat([st[key] for st in stats]) for key in stats[0] if key != "M"}
        if order >= 3:
            table["M"] = {ab: torch.cat([st["M"][ab] for st in stats]) for ab in stats[0]["M"]}
        far = torch.cat(far, dim=1)
    leaf_pts = tree_points.reshape(2**levels, leafsize, d)
    leaf_w = w.reshape(2**levels, leafsize)
    width = max(leaf_idx.shape[1] * leafsize, off and far.shape[1])
    chunk = max(1, min(ngroups, CHUNK_ELEMENTS // max(G * width, 1)))
    outs = []
    for g0 in range(0, ngroups, chunk):
        xt = xg[g0:g0 + chunk]
        leafi = leaf_idx[g0:g0 + chunk]
        acc = _near_field(k, xt, leaf_pts, leaf_w, torch.clamp(leafi, min=0), leafi >= 0)
        if off:
            idx = far[g0:g0 + chunk]
            contrib = _far_field(k, xt, table, torch.clamp(idx, min=0), order)
            acc = acc + torch.sum(torch.where((idx >= 0)[:, None, :], contrib, 0.0), dim=2)
        outs.append(acc)
    return torch.cat(outs)


class BarnesHutFactorization(LinearOperator):
    """Approximate lazy Gramian with an O(n log n) MVM (reference
    BarnesHutFactorization, src/barneshut.jl:8-43; defaults leafsize 16,
    theta 1/4 from src/barneshut.jl:3-4). Solves by GMRES or MINRES
    (src/barneshut.jl:64-72) through the linear MVM.

    x: target points; y: source points (default x, the symmetric case).
    The build groups the targets (`group_size` targets a group), sizes
    each group's frontier with the exact probe and splits groups whose
    frontier is wide into quarters; the interaction plans are built on
    first use (`plans`), so a build's time excludes the one-time sweep."""

    def __init__(self, k, x, y=None, theta: float = None, leafsize: int = None,
                 max_open: int = None, group_size: int = 256, order: int = 1):
        from ..utils.grids import as_points

        if input_trait(k) != InputTrait.ISOTROPIC:
            raise ValueError("Barnes-Hut requires an isotropic kernel")
        xp = as_points(x)
        yp = xp if y is None else as_points(y)
        # the hyperparameters on the points' device and dtype, once
        self.k = to_points(k, yp)
        self._same = y is None
        self.theta = _config.DEFAULT.barneshut_theta if theta is None else theta
        self.order = order
        leafsize = _config.DEFAULT.barneshut_leafsize if leafsize is None else leafsize
        self.m = yp.shape[0]
        self.n = xp.shape[0]
        self.shape = (self.n, self.m)
        self.dtype = xp.dtype if xp.is_floating_point() else torch.get_default_dtype()
        self.device = yp.device
        self._plans = None
        self._dev = None

        # the symmetric build at d <= 4 groups by tree levels (`_build_fused`)
        mL = max(0, math.ceil(math.log2(max(1, self.m / leafsize))))
        mls = math.ceil(self.m / 2**mL)
        ratio0 = max(1, group_size // max(mls, 1))
        j0 = int(np.log2(ratio0)) if ratio0 & (ratio0 - 1) == 0 else -1
        if self._same and j0 >= 0 and mL - j0 >= 0 and mL > 0 and yp.shape[1] <= 4:
            self._build_fused(yp, mL, mls, j0, max_open)
            return

        self.tree = t = build_tree(yp, leafsize)
        # group the targets by their own spatial tree (contiguous groups with
        # centers and radii); for x is y the source tree's level
        # L - log2(group / leaf) is that grouping
        ratio = max(1, group_size // max(t.leafsize, 1))
        j = int(np.log2(ratio)) if ratio & (ratio - 1) == 0 else -1
        d = xp.shape[1]
        if self._same and j >= 0 and t.levels - j >= 0:
            Lg = t.levels - j
            ngroups = 2**Lg
            G = t.points_np.shape[0] // ngroups
            xg, gc, gr = t.points_np.reshape(ngroups, G, d), t.centers_np[Lg], t.radii_np[Lg]
            self._tgt_perm, self._tgt_P = t.perm_dev, t.points_np.shape[0]
        else:
            tt = build_tree(xp, group_size)
            G, ngroups = tt.leafsize, tt.n_leaves
            xg = tt.points_np.reshape(ngroups, G, d)
            gc, gr = tt.centers_np[tt.levels], tt.radii_np[tt.levels]
            self._tgt_perm, self._tgt_P = tt.perm_dev, tt.points_np.shape[0]

        # Probe per-group frontier widths and bucket the work: groups in
        # sparse regions have large radii and wide frontiers; splitting them
        # shrinks their frontier, so the tail does not widen every group's
        # tiles.
        work = [(xg, gc, gr, np.arange(ngroups * G).reshape(ngroups, G))]
        final = []  # (xg, gc, gr, rows, F)
        min_G = 32
        while work:
            xg_w, gc_w, gr_w, rows_w = work.pop()
            # chunks of 256 keep one wide group's frontier padding local
            counts = np.concatenate([
                _max_open_nodes(gc_w[i0:i0 + 256], gr_w[i0:i0 + 256], t.centers_np, t.radii_np,
                                self.theta, t.levels)
                for i0 in range(0, xg_w.shape[0], 256)])
            f_main = _roundup(np.percentile(counts, 90)) if max_open is None else max_open
            f_max = _roundup(counts.max())
            Gw = xg_w.shape[1]
            narrow = counts <= max(f_main, 8)
            if max_open is not None or f_max <= 2 * f_main or Gw <= min_G:
                final.append((xg_w, gc_w, gr_w, rows_w, f_max))
                continue
            ni = np.nonzero(narrow)[0]
            if len(ni):
                final.append((xg_w[ni], gc_w[ni], gr_w[ni], rows_w[ni], f_main))
            wi = np.nonzero(~narrow)[0]
            if len(wi):
                # split each wide group into 4 contiguous sub-groups,
                # repeat-padded so that 4 divides the group: a repeated
                # target writes the same value to the same output row
                sub = 4
                Gs = -(-Gw // sub)
                pad = sub * Gs - Gw
                xg_wide, rows_wide = xg_w[wi], rows_w[wi]
                if pad:
                    xg_wide = np.concatenate(
                        [xg_wide, np.repeat(xg_wide[:, -1:], pad, axis=1)], axis=1)
                    rows_wide = np.concatenate(
                        [rows_wide, np.repeat(rows_wide[:, -1:], pad, axis=1)], axis=1)
                xs = xg_wide.reshape(-1, Gs, xg_w.shape[2])
                lo, hi = xs.min(axis=1), xs.max(axis=1)
                cs = 0.5 * (lo + hi)
                rs = np.sqrt(((xs - cs[:, None, :]) ** 2).sum(-1)).max(axis=1)
                work.append((xs, cs, rs, rows_wide.reshape(-1, Gs)))
        self._buckets = final
        self._bucket_specs = None
        self.max_open = max(f for *_, f in final)

    def _build_fused(self, yp, L, ls, j, max_open):
        """Symmetric build at d <= 4: the device tree, then the frontier
        probe over the tier ladder of tree levels Lg, Lg + 2, Lg + 4
        (group_size, group_size / 4 and / 16 targets a group: the generic
        build's 4-way split, with the sub-groups' geometry taken from the
        tree). The probe and the plans decide far/open on the tree's
        centers and radii rounded to float32, as cfjax's do (it fetches
        them from the device as float32), whatever the points' dtype."""
        d = yp.shape[1]
        P = 2**L * ls
        t = _build_tree_device(yp, d, L, ls, P, P - self.m)
        small = torch.cat([c.reshape(-1) for c in t.centers] + list(t.radii))
        buf = small.to(torch.float32).cpu().numpy()   # one host fetch
        cs_np, rs_np, o = [], [], 0
        for l in range(L + 1):
            cs_np.append(buf[o:o + (2**l) * d].reshape(2**l, d))
            o += (2**l) * d
        for l in range(L + 1):
            rs_np.append(buf[o:o + 2**l])
            o += 2**l
        self.tree = BalancedTree(points=t.points, pad=t.pad, leafsize=ls, levels=L,
                                 centers=t.centers, radii=t.radii, perm_dev=t.perm_dev,
                                 centers_np=cs_np, radii_np=rs_np)
        self._tgt_perm, self._tgt_P = t.perm_dev, P

        Lg = L - j
        tiers = tuple(Lt for Lt in (Lg, Lg + 2, Lg + 4) if Lt <= L)

        def probe(Lt, idx):
            """Frontier probe of tier-Lt nodes idx, in chunks of 512."""
            return np.concatenate([
                _max_open_nodes(cs_np[Lt][idx[i0:i0 + 512]], rs_np[Lt][idx[i0:i0 + 512]],
                                cs_np, rs_np, self.theta, L)
                for i0 in range(0, idx.size, 512)])

        specs = []  # (tier level, group indices, frontier width)
        active = np.arange(2**tiers[0])
        for t_i, Lt in enumerate(tiers):
            ct = probe(Lt, active)
            f_main = _roundup(np.percentile(ct, 90))
            f_max = _roundup(ct.max())
            if max_open is not None or t_i == len(tiers) - 1 or f_max <= 2 * f_main:
                specs.append((Lt, active, f_max))
                break
            narrow = ct <= max(f_main, 8)
            ni = active[narrow]
            if ni.size:
                specs.append((Lt, ni, _roundup(ct[narrow].max())))
            wide = active[~narrow]
            if not wide.size:
                break
            step = 2 ** (tiers[t_i + 1] - Lt)
            active = (step * wide[:, None] + np.arange(step)[None, :]).reshape(-1)
        self._bucket_specs = specs
        self._buckets = None
        self.max_open = max(f for *_, f in specs)

    @property
    def buckets(self):
        """(xg, gc, gr, rows, F) per width bucket. The fused build stores
        (level, indices, F) specs; their gathers run here on first use."""
        if self._buckets is None:
            t = self.tree
            d = t.points.shape[1]
            out = []
            for Lt, idx, F in self._bucket_specs:
                nl = 2**Lt
                G = self._tgt_P // nl
                ii = torch.as_tensor(idx, device=t.points.device)
                xg = t.points.reshape(nl, G, d)[ii]
                rows = idx[:, None] * G + np.arange(G)[None, :]
                out.append((xg, t.centers[Lt][ii], t.radii[Lt][ii], rows, F))
            self._buckets = out
        return self._buckets

    @property
    def plans(self):
        """Per-bucket interaction plans (`interaction_plan` over the tree's
        host mirrors), built on first use."""
        if self._plans is None:
            t = self.tree
            self._plans = [interaction_plan(_np(gc_b), _np(gr_b), t.centers_np, t.radii_np,
                                            self.theta, t.levels)
                           for _, gc_b, gr_b, _, _ in self.buckets]
        return self._plans

    def _device_plans(self):
        """The buckets' targets, output rows and plans on the device, copied
        once, so an MVM makes no host transfer."""
        if self._dev is None:
            dev = self.device
            on = lambda a: torch.as_tensor(a, device=dev)
            self._dev = [(on(xg_b), on(rows_b.reshape(-1)).long(), flv,
                          tuple(on(f).long() for f in fidx), on(lidx).long())
                         for (xg_b, _, _, rows_b, _), (flv, fidx, lidx)
                         in zip(self.buckets, self.plans)]
        return self._dev

    @property
    def is_symmetric(self):
        return self._same

    def _permuted_weights(self, v):
        t = self.tree
        P = t.points.shape[0]
        vp = torch.cat([v, torch.zeros((P - self.m,), dtype=v.dtype, device=v.device)])
        return vp[t.perm_dev.long()]

    def _matvec(self, v, fixed_centers: bool = False):
        t = self.tree
        wp = self._permuted_weights(v)
        flat = torch.zeros((self._tgt_P,), dtype=self.dtype, device=wp.device)
        for xg_b, rows_b, flv, fidx, lidx in self._device_plans():
            out_g = bh_matvec_planned(self.k, xg_b, fidx, lidx, t.points, wp, flv, t.levels,
                                      t.leafsize, self.order, fixed_centers)
            # a split group's repeat-padded targets write the same value to
            # the same row: which of the duplicate writes lands does not matter
            flat[rows_b] = out_g.reshape(-1).to(flat.dtype)
        out = torch.zeros_like(flat)
        out[self._tgt_perm.long()] = flat
        return out[:self.n]

    def matvec_linear(self, v):
        """The fixed-expansion-center MVM: a linear operator in v (see
        `bh_matvec_planned`'s fixed_centers). Use it inside CG, MINRES,
        GMRES and SLQ: the default MVM moves its expansion points with v."""
        return self._matvec(v, fixed_centers=True)

    def solve(self, b, tol: float = 1e-8, maxiter: int = 500, method: str = "gmres", **kw):
        """Solve F x = b with the Barnes-Hut approximation as the operator,
        through `matvec_linear`. GMRES by default: the approximation's
        error is not symmetric, which breaks the CG and MINRES recurrences
        once it exceeds the residual target; "minres" as the reference
        (src/barneshut.jl:64-72). Well-posed only where the diagonal (noise)
        term exceeds the approximation's spectral error; for GP solves at
        small noise use the exact lazy Gramian with a Nystrom preconditioner."""
        from ..operators.solvers import gmres, minres

        it = gmres if method == "gmres" else minres
        b = b if isinstance(b, torch.Tensor) else torch.as_tensor(b, device=self.device)
        return it(self.matvec_linear, b, tol=tol, maxiter=maxiter)[0]


def _roundup(v):
    return max(8, int(np.ceil(v / 8)) * 8)


def work_bh_mvm(F) -> Work:
    """The least work of one planned MVM of `F` (a BarnesHutFactorization)
    on this card: per pair its plans evaluate, the near field's point
    pairs and the far field's (group, node) pairs, the kernel's exp (one
    SFU operation) and the difference form and weighted sum (2d + 2
    fp32). Bytes: the points and weights read once, the product written
    once. The pairs depend on the points: this counts the plans' own."""
    ls, d = F.tree.leafsize, F.tree.points.shape[1]
    pairs = 0
    for (_, _, _, rows, _), (_, fidx, lidx) in zip(F.buckets, F.plans):
        G = rows.shape[1]
        pairs += G * ls * int((lidx >= 0).sum()) + G * sum(int((f >= 0).sum()) for f in fidx)
    return Work(fp32=pairs * (2.0 * d + 2), sfu=float(pairs),
                hbm_bytes=4.0 * F.n * (d + 2))
