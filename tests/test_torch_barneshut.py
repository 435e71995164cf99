"""Parity of the port's Barnes-Hut layer (`cfjax_torch.barneshut.bh`) with
cfjax's.

Both packages get the same numpy points (float64, on the CPU). The host
planning (`_ell_from_pairs`, `_max_open_nodes`, `interaction_plan`, the
bucket specs) is numpy in both, so its integer arrays are compared for
equality. The MVMs are float64 on both sides and agree within 1e-10
relative: the same terms, summed in another order.

The builds cover the symmetric build at d <= 4 (cfjax's fused route: tree
levels as groups, with a tier split on clustered points), the generic
build (d = 5, x != y, and a case whose wide groups split 4-way with
repeat-padded targets) and a lattice on which the tree's float32 centers
decide a far/open pair differently from its float64 ones."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfjax.kernels as jk
import cfjax_torch
import cfjax_torch.kernels as tk
from cfjax.barneshut import bh as jbh
from cfjax.utils.testing import pairwise
from cfjax_torch.barneshut import BarnesHutFactorization, bh_matvec
from cfjax_torch.barneshut import bh as tbh

torch.set_num_threads(2)

REL = 1e-10   # float64 MVMs: the same terms summed in another order


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """Input without a device goes to the CPU in this module's tests; the
    configured device is restored after them."""
    shipped = cfjax_torch.config.DEFAULT.device
    cfjax_torch.set_config(device="cpu")
    yield
    cfjax_torch.set_config(device=shipped)


def _mixture(r, n, frac, width):
    """A tight cluster and a share `frac` of points spread over a square:
    groups among the spread points have wide frontiers."""
    k = int(frac * n)
    pts = np.concatenate([0.05 * r.standard_normal((n - k, 2)), r.uniform(-width, width, (k, 2))])
    return pts[r.permutation(n)]


def _lattice():
    g = np.arange(40) * 0.3
    return np.stack(np.meshgrid(g, g), -1).reshape(-1, 2)


# name: (x, y, keyword arguments); every build is made once per module
CASES = {
    "fused_d2": (lambda r: r.standard_normal((2048, 2)), None, dict(theta=0.5, group_size=32)),
    "fused_d3": (lambda r: r.standard_normal((1500, 3)), None, dict(theta=0.5, group_size=32)),
    "fused_tiers": (lambda r: _mixture(r, 2000, 0.3, 30), None, dict(theta=0.5, group_size=64)),
    "generic_d5": (lambda r: r.standard_normal((700, 5)), None, dict(theta=0.5, group_size=32)),
    "generic_xy": (lambda r: r.standard_normal((900, 2)), lambda r: r.standard_normal((937, 2)),
                   dict(theta=0.5, group_size=32)),
    "generic_split": (lambda r: _mixture(r, 2000, 0.1, 2), lambda r: _mixture(r, 2100, 0.1, 2),
                      dict(theta=0.5, group_size=64)),
    "lattice": (lambda r: _lattice(), None, dict(theta=0.25, group_size=32)),
}


@pytest.fixture(scope="module")
def builds():
    cache = {}

    def get(name, order=1):
        key = (name, order)
        if key not in cache:
            fx, fy, kw = CASES[name]
            r = np.random.default_rng(sum(map(ord, name)))
            x = fx(r)
            y = None if fy is None else fy(r)
            Fj = jbh.BarnesHutFactorization(jk.EQ(), jnp.asarray(x),
                                            None if y is None else jnp.asarray(y),
                                            order=order, **kw)
            Ft = BarnesHutFactorization(tk.EQ(), torch.tensor(x),
                                        None if y is None else torch.tensor(y), order=order, **kw)
            cache[key] = (x, y, Fj, Ft)
        return cache[key]

    return get


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b))


def _plans_equal(p, q):
    return (p[0] == q[0] and len(p[1]) == len(q[1])
            and all(np.array_equal(a, b) for a, b in zip(p[1], q[1]))
            and np.array_equal(p[2], q[2]))


@pytest.mark.parametrize("g,pairs", [(7, 0), (5, 40), (64, 1000)])
def test_ell_from_pairs_matches_reference(g, pairs, rng):
    a = rng.integers(0, g, pairs).astype(np.int64)
    b = rng.integers(0, 1000, pairs).astype(np.int64)
    ref, out = jbh._ell_from_pairs(a, b, g), tbh._ell_from_pairs(a, b, g)
    if pairs == 0:
        assert ref is None and out is None
        return
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("name", ["fused_d2", "fused_tiers", "generic_d5", "generic_xy",
                                  "lattice"])
def test_probe_and_plan_match_reference_on_its_mirrors(name, builds):
    """`_max_open_nodes` and `interaction_plan` fed cfjax's own tree mirrors
    and group geometry give cfjax's integer arrays."""
    _, _, Fj, _ = builds(name)
    t = Fj.tree
    for _, gc, gr, _, _ in Fj.buckets:
        gc, gr = np.asarray(gc), np.asarray(gr)
        for theta in (Fj.theta, 0.3):
            np.testing.assert_array_equal(
                tbh._max_open_nodes(gc, gr, t.centers_np, t.radii_np, theta, t.levels),
                jbh._max_open_nodes(gc, gr, t.centers_np, t.radii_np, theta, t.levels))
            assert _plans_equal(
                tbh.interaction_plan(gc, gr, t.centers_np, t.radii_np, theta, t.levels),
                jbh.interaction_plan(gc, gr, t.centers_np, t.radii_np, theta, t.levels))


@pytest.mark.parametrize("name", list(CASES))
def test_buckets_and_plans_match_reference(name, builds):
    """The fused build's specs (tree level, group indices, frontier width)
    and the generic build's buckets (targets, centers, radii, output rows,
    width) equal cfjax's, and so do the plans built from them."""
    _, _, Fj, Ft = builds(name)
    fused = Fj._bucket_specs is not None
    assert (Ft._bucket_specs is not None) == fused
    assert Ft.max_open == Fj.max_open
    if fused:
        assert len(Ft._bucket_specs) == len(Fj._bucket_specs)
        for (lj, ij, fj), (lt, it, ft) in zip(Fj._bucket_specs, Ft._bucket_specs):
            assert (lt, ft) == (lj, fj)
            np.testing.assert_array_equal(it, ij)
    for bj, bt in zip(Fj.buckets, Ft.buckets, strict=True):
        for i in (0, 1, 3):
            np.testing.assert_array_equal(tbh._np(bt[i]), np.asarray(bj[i]))
        # the device trees' float64 radii are sums that XLA may fuse: an ulp
        np.testing.assert_allclose(tbh._np(bt[2]), np.asarray(bj[2]), rtol=1e-15, atol=0)
        assert bt[4] == bj[4]
    for pj, pt in zip(Fj.plans, Ft.plans, strict=True):
        assert _plans_equal(pt, pj)
    if name == "fused_tiers":
        assert len({s[0] for s in Ft._bucket_specs}) > 1, "no tier split"
    if name == "generic_split":
        # the wide groups split into quarters; a repeat-padded target's
        # row appears twice and receives the same value from both writes
        rows = np.concatenate([b[3].reshape(-1) for b in Ft.buckets])
        assert len(Ft.buckets) > 1 and rows.size > np.unique(rows).size
        assert np.array_equal(np.unique(rows), np.arange(Ft._tgt_P))


def test_plan_on_float64_centers_differs_from_the_float32_mirrors(builds):
    """On the lattice, a plan decided on the tree's float64 centers and radii
    differs from cfjax's, which decides on their float32 copies; the port's
    plans are cfjax's."""
    _, _, Fj, Ft = builds("lattice")
    t = Fj.tree
    c64 = [np.asarray(c) for c in t.centers]
    r64 = [np.asarray(r) for r in t.radii]
    assert c64[1].dtype == np.float64 and t.centers_np[1].dtype == np.float32
    differ = 0
    for (_, gc, gr, _, _), pj, pt in zip(Fj.buckets, Fj.plans, Ft.plans):
        p64 = jbh.interaction_plan(np.asarray(gc), np.asarray(gr), c64, r64, Fj.theta, t.levels)
        differ += not _plans_equal(p64, pj)
        assert _plans_equal(pt, pj)
    assert differ > 0


@pytest.mark.parametrize("name,order", [("fused_d2", 1), ("fused_d2", 2), ("fused_d2", 3),
                                        ("fused_d2", 4), ("fused_d3", 1), ("fused_tiers", 1),
                                        ("generic_d5", 2), ("generic_xy", 1),
                                        ("generic_split", 1), ("lattice", 1)])
def test_planned_mvm_matches_reference(name, order, builds):
    """`_matvec` (through `bh_matvec_planned`) at the order and with fixed
    centers either way, against cfjax's, within 1e-10 relative."""
    _, _, Fj, Ft = builds(name, order)
    w = np.random.default_rng(order).standard_normal(Fj.shape[1])
    for fixed in (False, True):
        ref = Fj._matvec(jnp.asarray(w), fixed_centers=fixed)
        out = Ft._matvec(torch.tensor(w), fixed_centers=fixed)
        assert out.dtype == torch.float64 and out.shape == (Fj.shape[0],)
        assert _rel(out.numpy(), ref) <= REL
    np.testing.assert_allclose(Ft.matvec_linear(torch.tensor(w)).numpy(),
                               np.asarray(Fj.matvec_linear(jnp.asarray(w))), rtol=0,
                               atol=REL * np.linalg.norm(np.asarray(ref)))


@pytest.mark.parametrize("name,order", [("fused_d2", 1), ("fused_d2", 2), ("generic_xy", 1),
                                        ("generic_split", 1)])
def test_dynamic_mvm_matches_reference_and_planned(name, order, builds):
    """`bh_matvec`, the traversal at every call, against cfjax's on the same
    inputs and against the planned MVM of the same bucket, within 1e-10
    relative. Its criterion runs on the float32 mirrors, as the plans do."""
    _, _, Fj, Ft = builds(name, order)
    t = Ft.tree
    w = np.random.default_rng(7).standard_normal(Fj.shape[1])
    wp = Ft._permuted_weights(torch.tensor(w))
    wj = jnp.asarray(wp.numpy())
    cs = [c.astype(np.float64) for c in t.centers_np]
    rs = [r.astype(np.float64) for r in t.radii_np]
    for (xg, gc, gr, _, F), (flv, fidx, lidx) in zip(Ft.buckets, Ft.plans):
        xg, gc, gr = (torch.as_tensor(a) for a in (xg, gc, gr))
        for fixed in (False, True):
            out, over = bh_matvec(tk.EQ(), xg, gc, gr, t.points, [torch.tensor(c) for c in cs],
                                  [torch.tensor(r) for r in rs], wp, Ft.theta, t.levels,
                                  t.leafsize, F, order, fixed)
            ref, over_j = jbh.bh_matvec(jk.EQ(), jnp.asarray(xg.numpy()), jnp.asarray(gc.numpy()),
                                        jnp.asarray(gr.numpy()), jnp.asarray(t.points.numpy()),
                                        tuple(map(jnp.asarray, cs)), tuple(map(jnp.asarray, rs)),
                                        wj, Ft.theta, t.levels, t.leafsize, F, order, fixed)
            planned = tbh.bh_matvec_planned(tk.EQ(), xg, fidx, lidx, t.points, wp, flv,
                                            t.levels, t.leafsize, order, fixed)
            assert over <= 0 and int(over_j) <= 0
            assert _rel(out.numpy(), ref) <= REL
            assert _rel(out.numpy(), planned.numpy()) <= REL


@pytest.mark.parametrize("name", ["fused_d2", "generic_d5", "generic_xy"])
def test_theta_zero_is_the_dense_mvm(name, builds):
    """At theta = 0 no node is far: the MVM is the dense product (1e-12)."""
    x, y, _, _ = builds(name)
    _, _, kw = CASES[name]
    F = BarnesHutFactorization(tk.EQ(), torch.tensor(x), None if y is None else torch.tensor(y),
                               theta=0.0, group_size=kw["group_size"])
    src = x if y is None else y
    w = np.random.default_rng(3).standard_normal(src.shape[0])
    dense = np.asarray(pairwise(jk.EQ(), jnp.asarray(x), jnp.asarray(src))) @ w
    assert _rel(F @ torch.tensor(w), dense) <= 1e-12


def test_plan_partitions_the_sources(builds):
    """Per group, the leaves under its far nodes (across levels) and its
    open leaves cover every leaf exactly once (cfjax's invariant)."""
    _, _, _, F = builds("fused_d2")
    L = F.tree.levels
    for (_, gc, _, _, _), (flv, fidx, lidx) in zip(F.buckets, F.plans):
        for g in range(gc.shape[0]):
            covered = np.zeros(2**L, dtype=int)
            for l, idx in zip(flv, fidx):
                for node in idx[g][idx[g] >= 0]:
                    covered[node * 2 ** (L - l):(node + 1) * 2 ** (L - l)] += 1
            covered[lidx[g][lidx[g] >= 0]] += 1
            assert (covered == 1).all()


def test_matvec_linear_is_linear(builds):
    """Fixed centers make every moment linear in w (to rounding)."""
    _, _, _, F = builds("fused_d2", 4)
    r = np.random.default_rng(1)
    u, v = (torch.tensor(r.standard_normal(F.shape[1])) for _ in range(2))
    lhs = F.matvec_linear(2.0 * u - 3.0 * v)
    rhs = 2.0 * F.matvec_linear(u) - 3.0 * F.matvec_linear(v)
    assert _rel(lhs.numpy(), rhs.numpy()) <= 1e-12


@pytest.mark.parametrize("method", ["gmres", "minres"])
def test_solve_matches_reference(method):
    """`F.solve` through the linear MVM, against cfjax's (1e-8 of the
    largest entry): a short lengthscale on spread points keeps the
    approximate Gramian well conditioned, so both solves converge."""
    r = np.random.default_rng(5)
    x = r.uniform(0, 10, (512, 2))
    b = r.standard_normal(512)
    Fj = jbh.BarnesHutFactorization(jk.Lengthscale(jk.EQ(), 0.15), jnp.asarray(x), theta=0.5)
    Ft = BarnesHutFactorization(tk.Lengthscale(tk.EQ(), 0.15), torch.tensor(x), theta=0.5)
    ref = np.asarray(Fj.solve(jnp.asarray(b), tol=1e-10, maxiter=400, method=method))
    out = Ft.solve(torch.tensor(b), tol=1e-10, maxiter=400, method=method).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-8 * np.abs(ref).max())
    assert _rel(Ft.matvec_linear(torch.tensor(out)).numpy(), b) <= 1e-9


def test_non_isotropic_kernel_raises():
    with pytest.raises(ValueError, match="isotropic"):
        BarnesHutFactorization(tk.Dot(), torch.zeros((64, 2), dtype=torch.float64))
