"""Parity of the port's sparse layer (`cfjax_torch.operators.sparse_op`,
`tile_ell`, and K4's plain version) with cfjax on the CPU.

Inputs are float64 numpy arrays from a seed, fed to both packages (cfjax
in x64). Both packages compute distances by the same difference form in
the same order, so the sparsity patterns, nnz and ratios are equal
exactly, and the TileELL packed arrays (off, perm) equal element for
element; values and products agree to rtol / atol 1e-12 (one exp in
another library). cfjax's TileELL `todense` returns float32, so the
port's `todense` is held against cfjax's `S @ I`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfjax.kernels as jk
import cfjax_torch
import cfjax_torch.kernels as tk
from cfjax.operators import tile_ell as j_tile
from cfjax.operators.sparse_op import _width_tiers as j_width_tiers
from cfjax.operators.sparse_op import decay_radius as j_decay_radius
from cfjax.operators.sparse_op import sparse_gramian as j_sparse_gramian
from cfjax_torch.operators import tile_ell as t_tile
from cfjax_torch.operators.sparse_op import _width_tiers, decay_radius, sparse_gramian
from cfjax_torch.ops.tile_ell_mvm import rows_matvec, slab_matvec_plain

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """Input without a device goes to the CPU in this module's tests; the
    configured device is restored after them."""
    shipped = cfjax_torch.config.DEFAULT.device
    cfjax_torch.set_config(device="cpu")
    yield
    cfjax_torch.set_config(device=shipped)


TOL = dict(rtol=1e-12, atol=1e-12)

RADIUS_KERNELS = {
    "EQ": lambda: jk.EQ(), "Exp": lambda: jk.Exp(), "Cauchy": lambda: jk.Cauchy(),
    "MaternP2": lambda: jk.MaternP(2), "LengthscaleEQ": lambda: jk.Lengthscale(jk.EQ(), 2.0),
    "RQ": lambda: jk.RQ(1.5), "GammaExp": lambda: jk.GammaExp(1.5),
    "IMQ": lambda: jk.InverseMultiQuadratic(0.5), "Power": lambda: jk.EQ() ** 2,
    "SumScaled": lambda: 2.0 * jk.EQ() + 0.5 * jk.MaternP(1)}


@pytest.mark.parametrize("name", sorted(RADIUS_KERNELS))
def test_decay_radius_matches_reference(name):
    kj = RADIUS_KERNELS[name]()
    for tol in (1e-6, 1e-3):
        rj = j_decay_radius(kj, tol)
        rt = decay_radius(tk.from_reference(kj), tol)
        assert rj is not None and rt is not None
        np.testing.assert_allclose(rt, rj, rtol=1e-9)
    assert decay_radius(tk.from_reference(kj), 2.0) == 0.0


def test_no_decay_radius_raises():
    kt = tk.Dot() ** 2
    assert decay_radius(kt, 1e-6) is None and j_decay_radius(jk.Dot() ** 2, 1e-6) is None
    with pytest.raises(ValueError, match="decay radius"):
        sparse_gramian(kt, torch.ones((10, 2), dtype=torch.float64))


def _spatial(rng, cross):
    x = rng.uniform(0, 12, (1500, 2))
    y = rng.uniform(0, 12, (900, 2)) if cross else None
    return x, y


def _both(kj, x, y, **kw):
    Sj, rj = j_sparse_gramian(kj, jnp.asarray(x), None if y is None else jnp.asarray(y), **kw)
    St, rt = sparse_gramian(tk.from_reference(kj), torch.tensor(x),
                            None if y is None else torch.tensor(y), **kw)
    return Sj, rj, St, rt


@pytest.mark.parametrize("cross", [False, True], ids=["square", "cross"])
@pytest.mark.parametrize("method", ["scan", "tree", "auto"])
@pytest.mark.parametrize("fmt", ["tile", "ell", "bcoo", "lazy"])
def test_sparse_gramian_matches_reference(fmt, method, cross, rng):
    x, y = _spatial(rng, cross)
    kj = jk.Lengthscale(jk.EQ(), 0.3)
    Sj, rj, St, rt = _both(kj, x, y, tol=1e-8, block=128, format=fmt, method=method)
    assert rt == rj
    n, m = 1500, (900 if cross else 1500)
    if fmt == "bcoo":
        assert St.is_sparse and St.is_coalesced() and tuple(St.shape) == (n, m)
        assert St._nnz() == int(Sj.nse)
        np.testing.assert_allclose(St.to_dense().numpy(), np.asarray(Sj.todense()), **TOL)
        return
    assert type(St).__name__ == type(Sj).__name__
    assert St.nnz == Sj.nnz and St.shape == (n, m)
    assert St.is_symmetric == Sj.is_symmetric == (not cross)
    a = rng.standard_normal(m)
    np.testing.assert_allclose((St @ torch.tensor(a)).numpy(), np.asarray(Sj @ jnp.asarray(a)),
                               **TOL)
    v = rng.standard_normal(n)
    if fmt == "lazy" and cross:
        with pytest.raises(NotImplementedError):
            St.T @ torch.tensor(v)
    else:
        np.testing.assert_allclose((St.T @ torch.tensor(v)).numpy(),
                                   np.asarray(Sj.T @ jnp.asarray(v)), **TOL)
    if fmt != "lazy":   # the lazy todense is one MVM per column
        ref = np.asarray(Sj @ jnp.eye(m, dtype=jnp.float64)) if fmt == "tile" \
            else np.asarray(Sj.todense())
        np.testing.assert_allclose(St.todense().numpy(), ref, **TOL)


@pytest.mark.parametrize("method", ["scan", "tree"])
def test_tile_ell_arrays_match_reference(method, rng):
    """The packed TileELL arrays equal cfjax's element for element: the
    scan build is count-sorted and width-tiered (menu-quantized groups,
    cropped), the tree build packs padded ELL rows."""
    x, _ = _spatial(rng, False)
    Sj, _, St, _ = _both(jk.Lengthscale(jk.EQ(), 0.3), x, None, tol=1e-8, block=128,
                         format="tile", method=method)
    assert St.nt == Sj.nt and len(St.groups) == len(Sj.groups)
    np.testing.assert_array_equal(St.perm.numpy(), np.asarray(Sj.perm))
    for (r0, r1, off, val), (q0, q1, offj, valj) in zip(St.groups, Sj.groups):
        assert (r0, r1) == (q0, q1)
        assert off.dtype == torch.int32 and tuple(off.shape) == tuple(offj.shape)
        np.testing.assert_array_equal(off.numpy(), np.asarray(offj))
        np.testing.assert_allclose(val.numpy(), np.asarray(valj), rtol=1e-14, atol=0)


def test_tile_ell_width_tiers(rng):
    """Skewed neighbour counts (a dense cluster and a diffuse cloud) give
    several width tiers of the count-sorted build and several groups."""
    n, d = 4096, 3
    x = np.concatenate([rng.standard_normal((512, d)) * 0.05,
                        rng.standard_normal((n - 512, d)) * 4.0])
    Sj, rj, St, rt = _both(jk.Lengthscale(jk.EQ(), 0.3), x, None, tol=1e-8, block=256,
                           format="tile")
    counts = np.sort(np.count_nonzero(St.todense().numpy(), axis=1))[::-1]
    tiers = _width_tiers(counts, n, align=1024)
    assert tiers == j_width_tiers(counts, n, align=1024) and len(tiers) >= 2
    assert rt == rj and St.nnz == Sj.nnz == counts.sum()
    assert len(St.groups) == len(Sj.groups) >= 2
    a = rng.standard_normal(n)
    np.testing.assert_allclose((St @ torch.tensor(a)).numpy(), np.asarray(Sj @ jnp.asarray(a)),
                               **TOL)


def test_tile_ell_single_column_tile(rng):
    """m <= 128: one column tile (nt = 1), which K4 takes itself (cfjax
    sends it to XLA, since Mosaic rejects the (1, 128) gather)."""
    x, y = rng.standard_normal((200, 3)), rng.standard_normal((100, 3))
    Sj, _, St, _ = _both(jk.Lengthscale(jk.EQ(), 0.8), x, y, tol=1e-4, block=128,
                         format="tile")
    assert St.nt == 1 == Sj.nt
    a = rng.standard_normal(100)
    np.testing.assert_allclose((St @ torch.tensor(a)).numpy(), np.asarray(Sj @ jnp.asarray(a)),
                               **TOL)
    np.testing.assert_allclose((St @ torch.tensor(a)).numpy(), St.todense().numpy() @ a, **TOL)


def test_tile_ell_matrix_rhs(rng):
    x = rng.standard_normal((300, 3)) * 2
    Sj, _, St, _ = _both(jk.Lengthscale(jk.EQ(), 0.5), x, None, tol=1e-6, block=128,
                         format="tile")
    A = rng.standard_normal((300, 4))
    out = St @ torch.tensor(A)
    assert tuple(out.shape) == (300, 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(Sj @ jnp.asarray(A)), **TOL)


@pytest.mark.parametrize("B,K,nt", [(8, 1, 1), (8, 3, 2), (16, 2, 5), (8, 8, 1)])
def test_slab_matvec_plain_matches_xla(B, K, nt, rng):
    """K4's plain version against cfjax's `_slab_matvec_xla`, with ~70%
    zero values and offsets over the whole lane range."""
    a2 = rng.standard_normal((nt, 128))
    off = rng.integers(0, 128, (B, K, nt, 128)).astype(np.int32)
    val = rng.standard_normal((B, K, nt, 128)) * (rng.uniform(size=(B, K, nt, 128)) < 0.3)
    ref = np.asarray(j_tile._slab_matvec_xla(jnp.asarray(a2), jnp.asarray(off),
                                             jnp.asarray(val)))
    ta, to, tv = torch.tensor(a2), torch.tensor(off), torch.tensor(val)
    np.testing.assert_allclose(slab_matvec_plain(ta, to, tv).numpy(), ref, **TOL)
    # the group as an operator: its row slices give the same through K4's
    # wrapper, which takes the plain version on CPU tensors
    S = t_tile.TileEllOperator([(0, B * 128, to, tv)], torch.arange(B * 128), B * 128,
                               nt * 128, int(np.count_nonzero(val)))
    np.testing.assert_allclose(rows_matvec(S.rows, ta.reshape(-1)).numpy(), ref.reshape(-1),
                               **TOL)


def test_operator_from_reference_arrays(rng):
    """One cfjax-built operator fed to both MVMs: the port's operator over
    cfjax's packed arrays gives cfjax's S @ a and S.T @ v."""
    x, y = _spatial(rng, True)
    Sj, _ = j_sparse_gramian(jk.Lengthscale(jk.EQ(), 0.3), jnp.asarray(x), jnp.asarray(y),
                             tol=1e-8, block=128, format="tile", method="scan")
    groups = [(r0, r1, np.asarray(off), np.asarray(val)) for r0, r1, off, val in Sj.groups]
    St = t_tile.TileEllOperator.from_reference(groups, np.asarray(Sj.perm), *Sj.shape, Sj.nnz)
    assert St.dtype == torch.float64 and not St.is_symmetric
    a, v = rng.standard_normal(900), rng.standard_normal(1500)
    np.testing.assert_allclose((St @ torch.tensor(a)).numpy(), np.asarray(Sj @ jnp.asarray(a)),
                               **TOL)
    np.testing.assert_allclose((St.T @ torch.tensor(v)).numpy(),
                               np.asarray(Sj.T @ jnp.asarray(v)), **TOL)


def test_build_tile_ell_host_matches_reference(rng):
    """The host COO packer: float32 values (cfjax stores them in float32),
    so the arrays are equal exactly."""
    n, m, nnz = 700, 450, 6000
    rows = rng.integers(0, n, nnz)
    cols = rng.integers(0, m, nnz)
    keep = np.unique(rows * m + cols, return_index=True)[1]
    rows, cols = rows[keep], cols[keep]
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    Sj = j_tile.build_tile_ell(rows, cols, vals, n, m)
    St = t_tile.build_tile_ell(rows, cols, vals, n, m)
    np.testing.assert_array_equal(St.perm.numpy(), np.asarray(Sj.perm))
    for (r0, r1, off, val), (q0, q1, offj, valj) in zip(St.groups, Sj.groups, strict=True):
        assert (r0, r1) == (q0, q1)
        np.testing.assert_array_equal(off.numpy(), np.asarray(offj))
        np.testing.assert_array_equal(val.numpy(), np.asarray(valj))
    dense = np.zeros((n, m), np.float32)
    dense[rows, cols] = vals
    np.testing.assert_array_equal(St.todense().numpy(), dense)


def test_tree_on_high_d_data(rng):
    """In high d the leaf test prunes nothing: "auto" scans, "tree" raises."""
    x = rng.standard_normal((1024, 16))
    Sj, rj, St, rt = _both(jk.EQ(), x, None, tol=1e-3, method="auto", format="ell")
    assert rt == rj > 0
    with pytest.raises(ValueError, match="prunes nothing"):
        sparse_gramian(tk.EQ(), torch.tensor(x), tol=1e-3, method="tree", format="ell")
