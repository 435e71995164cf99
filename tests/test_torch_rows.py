"""The port's redesigned pieces on the CPU: K4's row-slice layout, K1's
profile families, and the configured device for input without one.

* Row slices (`operators/tile_ell.row_slices`, read by K4): from every
  build path (scan, tree, the host COO packer, cfjax's packed arrays) the
  layout's `S @ a` through `rows_matvec_plain` equals the TileELL slabs'
  product through `slab_matvec_plain` and cfjax's `S @ a`, in float64 to
  rtol / atol 1e-12 (the same products summed in another order). Edge
  cases: empty rows, n and m off multiples of 32 and 128, one column
  tile, dump rows, collision depth K > 1, float32 and float64.
* Families (`ProfileSpec.family`): the folded form that K1's specialised
  instances compute agrees with the interpreted program to rtol 1e-6 in
  float32 (exp2 of a prescaled argument against exp: about one rounding
  of an argument below 2^5) and to 1e-12 in float64 (the folding itself).
* Derivative families (`ProfileSpec.family` of a derivative spec): the
  closed-form f' and f'' that K3's family instances compute agree with
  the interpreted jet and with autodiff of `k.profile`.
* The device: input that carries no device resolves to the configured
  device, "cuda" by default; these tests read the resolution without
  allocating, then run with "cpu".
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfjax.kernels as jk
import cfjax_torch
import cfjax_torch.kernels as tk
from cfjax.operators import tile_ell as j_tile
from cfjax.operators.sparse_op import sparse_gramian as j_sparse_gramian
from cfjax_torch import config
from cfjax_torch.barneshut import tree as t_tree
from cfjax_torch.kernels.profile_spec import (FAMILY_CAUCHY, FAMILY_EQ, FAMILY_IMQ,
                                              FAMILY_MATERN, FAMILY_NONE, FAMILY_RQ, to_spec)
from cfjax_torch.operators import tile_ell as t_tile
from cfjax_torch.operators.sparse_op import sparse_gramian
from cfjax_torch.operators.toeplitz import CirculantOperator, ToeplitzOperator
from cfjax_torch.ops.tile_ell_mvm import SLICE, rows_matvec, rows_matvec_plain, \
    slab_matvec_plain, slice_warps
from cfjax_torch.utils.grids import LazyGrid, UniformGrid, as_points, point_device

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


def slab_product(S, a):
    """S @ a through the slabs: `slab_matvec_plain` per group, the sorted
    rows placed through perm (dump rows cropped)."""
    n, m = S.shape
    a2 = torch.nn.functional.pad(a, (0, S.nt * 128 - m)).reshape(S.nt, 128)
    outs = [slab_matvec_plain(a2, off[:(r1 - r0) // 128], val[:(r1 - r0) // 128]).reshape(-1)
            for r0, r1, off, val in S.groups]
    out = torch.zeros(S.perm.shape[0] + 1, dtype=a.dtype)
    out[S.perm] = torch.cat(outs)[:S.perm.shape[0]]
    return out[:n]


def check_layout(S):
    """The layout's invariants: one layout row per output row, slices
    padded to their own longest row, rows by descending count."""
    rs = S.rows
    n = S.shape[0]
    assert sorted(rs.out_row.tolist()) == list(range(n))
    width = torch.diff(rs.ptr) // SLICE
    assert bool((torch.diff(rs.ptr) % SLICE == 0).all())
    total = int(rs.ptr[-1])
    assert rs.col.shape == rs.val.shape == (total,)
    live = (rs.val != 0).reshape(-1)
    counts = torch.zeros(width.shape[0] * SLICE, dtype=torch.long)
    for s in range(width.shape[0]):
        block = live[int(rs.ptr[s]):int(rs.ptr[s + 1])].reshape(-1, SLICE)
        counts[s * SLICE:(s + 1) * SLICE] = block.sum(0)
        if block.shape[0]:
            assert int(block.sum(0).max()) == int(width[s])   # padded to its longest row
            # each row's entries first, then its pad slots
            assert bool((block[1:] <= block[:-1]).all())
    assert bool((counts[:-1] >= counts[1:]).all())
    assert int(counts.sum()) == int(live.sum()) <= S.nnz
    assert bool((rs.col[~live] == 0).all()) and bool((rs.col < max(S.shape[1], 1)).all())
    return total


def _spatial(rng, n=1500, m=None):
    x = rng.uniform(0, 12, (n, 2))
    y = None if m is None else rng.uniform(0, 12, (m, 2))
    return x, y


@pytest.mark.parametrize("cross", [False, True], ids=["square", "cross"])
@pytest.mark.parametrize("method", ["scan", "tree"])
def test_row_slices_match_slabs_and_reference(method, cross, rng):
    """Both device build paths: the layout's product equals the slabs' and
    cfjax's, and it holds about one slot per nonzero."""
    x, y = _spatial(rng, 1500, 900 if cross else None)
    kj = jk.Lengthscale(jk.EQ(), 0.3)
    Sj, _ = j_sparse_gramian(kj, jnp.asarray(x), None if y is None else jnp.asarray(y),
                             tol=1e-8, block=128, format="tile", method=method)
    St, _ = sparse_gramian(tk.from_reference(kj), torch.tensor(x),
                           None if y is None else torch.tensor(y), tol=1e-8, block=128,
                           format="tile", method=method)
    total = check_layout(St)
    assert total <= 1.15 * St.nnz
    a = torch.tensor(rng.standard_normal(St.shape[1]))
    out = rows_matvec_plain(St.rows, a)
    np.testing.assert_allclose(out.numpy(), slab_product(St, a).numpy(), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(Sj @ jnp.asarray(a.numpy())), **TOL)
    np.testing.assert_allclose((St @ a).numpy(), out.numpy(), rtol=0, atol=0)


def test_row_slices_from_reference_arrays(rng):
    """cfjax's packed arrays (menu-quantized groups with pad rows sent to
    the dump slot) through `from_reference`."""
    x, y = _spatial(rng, 1500, 900)
    Sj, _ = j_sparse_gramian(jk.Lengthscale(jk.EQ(), 0.3), jnp.asarray(x), jnp.asarray(y),
                             tol=1e-8, block=128, format="tile", method="scan")
    groups = [(r0, r1, np.asarray(off), np.asarray(val)) for r0, r1, off, val in Sj.groups]
    St = t_tile.TileEllOperator.from_reference(groups, np.asarray(Sj.perm), *Sj.shape, Sj.nnz)
    assert St.perm.shape[0] > St.shape[0]          # there are dump rows
    check_layout(St)
    a = torch.tensor(rng.standard_normal(900))
    out = rows_matvec_plain(St.rows, a)
    np.testing.assert_allclose(out.numpy(), slab_product(St, a).numpy(), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(Sj @ jnp.asarray(a.numpy())), **TOL)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n,m", [(700, 450), (33, 129), (1, 1), (64, 128), (300, 100)])
def test_row_slices_host_build(n, m, dtype, rng):
    """The host COO packer at sizes off the multiples of 32 and 128, with
    empty rows, rows that collide within a tile (K > 1), one column tile
    (m <= 128), and both value types (cfjax's packer keeps float32, so
    cfjax's product is the reference for float32 values only)."""
    nnz = max(1, n * m // 7)
    rows = rng.integers(0, max(1, n - n // 5), nnz)       # the last rows stay empty
    cols = rng.integers(0, m, nnz)
    keep = np.unique(rows * m + cols, return_index=True)[1]
    rows, cols = rows[keep], cols[keep]
    vals = rng.standard_normal(len(rows)).astype(dtype)
    Sj = j_tile.build_tile_ell(rows, cols, vals, n, m)
    St = t_tile.build_tile_ell(rows, cols, vals, n, m)
    assert St.rows.val.dtype == torch.from_numpy(vals).dtype
    assert St.nt == 1 or m > 128
    assert any(off.shape[1] > 1 for _, _, off, _ in St.groups) or nnz < 2 * n
    check_layout(St)
    a = torch.tensor(rng.standard_normal(m).astype(dtype))
    dense = np.zeros((n, m))
    dense[rows, cols] = vals
    out = rows_matvec_plain(St.rows, a)
    tol = TOL if dtype == np.float64 else dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), slab_product(St, a).numpy(), **tol)
    np.testing.assert_allclose(out.numpy(), dense @ a.numpy().astype(np.float64), **tol)
    if dtype == np.float32:    # cfjax's host packer stores its values in float32
        np.testing.assert_allclose(out.numpy(), np.asarray(Sj @ jnp.asarray(a.numpy())), **tol)


def test_row_slices_dump_rows_and_zero_values():
    """Pad rows of a group and slots whose value is 0 do not enter the
    layout; a perm that names too few output rows is refused."""
    B, K, nt = 8, 2, 2
    off = torch.zeros((B, K, nt, 128), dtype=torch.int32)
    val = torch.zeros((B, K, nt, 128), dtype=torch.float64)
    off[0, 0, 1, 5], val[0, 0, 1, 5] = 7, 2.0      # row 5, column 135
    off[0, 1, 1, 5], val[0, 1, 1, 5] = 9, 3.0      # row 5, column 137 (K = 2)
    off[0, 0, 0, 6], val[0, 0, 0, 6] = 3, 0.0      # a stored zero
    off[1, 0, 0, 2], val[1, 0, 0, 2] = 4, 5.0      # sorted row 130: a dump row
    n, m = 100, 200
    perm = torch.cat([torch.arange(n), torch.full((B * 128 - n,), n)])
    S = t_tile.TileEllOperator([(0, B * 128, off, val)], perm, n, m, 2)
    total = check_layout(S)
    assert total == 2 * SLICE and S.rows.m == m
    a = torch.arange(m, dtype=torch.float64)
    out = rows_matvec_plain(S.rows, a)
    assert out[5] == 2.0 * 135 + 3.0 * 137 and int(torch.count_nonzero(out)) == 1
    np.testing.assert_allclose(out.numpy(), slab_product(S, a).numpy(), **TOL)
    with pytest.raises(ValueError, match="output rows"):
        t_tile.row_slices([(0, B * 128, off, val)], perm, n + 1, m, torch.float64)


def test_row_slices_warps_follow_the_mean_row():
    """A dense operator's rows (2048 slots each) through the layout; the
    kernel's warps per slice fill an H100's 132 SMs (64 warps each) and
    stay within 1..8."""
    n, m = 64, 2048
    full = torch.ones((n, m), dtype=torch.float64)
    rows, cols = torch.nonzero(full).T
    S = t_tile.build_tile_ell(rows.numpy(), cols.numpy(), full[rows, cols].numpy(), n, m)
    assert S.rows.m == m and int(S.rows.ptr[-1]) == n * m
    a = torch.ones(m, dtype=torch.float64)
    np.testing.assert_allclose(rows_matvec(S.rows, a).numpy(), np.full(n, float(m)), **TOL)
    np.testing.assert_allclose(rows_matvec_plain(S.rows, a).numpy(), np.full(n, float(m)),
                               **TOL)
    assert [slice_warps(s, 132) for s in (1, 512, 1024, 1056, 2112, 4224, 8448, 10**6)] \
        == [8, 8, 8, 8, 4, 2, 1, 1]
    with pytest.raises(ValueError, match="operator takes"):
        rows_matvec(S.rows, a[:-1])


FAMILIES = {
    "EQ": (tk.EQ(), FAMILY_EQ, 0),
    "Exp": (tk.Exp(), FAMILY_MATERN, 0),
    "MaternP0": (tk.MaternP(0), FAMILY_MATERN, 0),
    "MaternP1": (tk.MaternP(1), FAMILY_MATERN, 1),
    "MaternP2": (tk.MaternP(2), FAMILY_MATERN, 2),
    "MaternP3": (tk.MaternP(3), FAMILY_MATERN, 3),
    "RQ": (tk.RQ(1.5), FAMILY_RQ, 0),
    "Cauchy": (tk.Cauchy(), FAMILY_CAUCHY, 0),
    "IMQ": (tk.InverseMultiQuadratic(0.7), FAMILY_IMQ, 0),
    "LengthscaleMaternP2": (tk.Lengthscale(tk.MaternP(2), 0.8), FAMILY_MATERN, 2),
    "LengthscaleLengthscaleEQ": (tk.Lengthscale(tk.Lengthscale(tk.EQ(), 1.3), 0.9),
                                 FAMILY_EQ, 0),
    "ScaledEQ": (2.0 * tk.EQ(), FAMILY_EQ, 0),
    "LengthscaleScaledRQ": (tk.Lengthscale(3.0 * tk.RQ(0.7), 1.2), FAMILY_RQ, 0),
    "ScaledLengthscaleCauchy": (2.0 * tk.Lengthscale(tk.Cauchy(), 0.8), FAMILY_CAUCHY, 0),
    "ScaledLengthscaleIMQ": (tk.Lengthscale(tk.InverseMultiQuadratic(1.3), 1.7) * 0.5,
                             FAMILY_IMQ, 0),
}


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_form_matches_program(name):
    k, family, p = FAMILIES[name]
    spec, why = to_spec(k)
    assert why is None and (spec.family, spec.family_p) == (family, p)
    s32 = torch.linspace(0, 4, 2049, dtype=torch.float32)
    torch.testing.assert_close(spec.evaluate(s32, family=True), spec.evaluate(s32),
                               rtol=1e-6, atol=0)
    s64 = torch.linspace(0, 30, 2049, dtype=torch.float64)
    torch.testing.assert_close(spec.evaluate(s64, family=True), spec.evaluate(s64),
                               rtol=1e-12, atol=0)
    torch.testing.assert_close(spec.evaluate(s64, family=True), k.profile_value(s64),
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("k", [2.0 * tk.EQ() + 0.5 * tk.MaternP(1), tk.EQ() ** 2,
                               tk.GammaExp(1.5), tk.MaternP(4), 2.0 * (3.0 * tk.EQ()),
                               tk.EQ() * tk.Cauchy()],
                         ids=["Sum", "Power", "GammaExp", "MaternP4", "TwoConstants",
                              "Product"])
def test_other_specs_stay_interpreted(k):
    spec, why = to_spec(k)
    assert why is None and spec.family == FAMILY_NONE
    with pytest.raises(ValueError, match="interpreted"):
        spec.evaluate(torch.zeros(3), family=True)
    # their derivative specs (where they have one) stay interpreted too
    dspec, _ = to_spec(k, derivative=True)
    assert dspec is None or dspec.family == FAMILY_NONE
    # a one-leaf derivative spec carries K3's jet family instead
    assert to_spec(tk.EQ(), derivative=True)[0].family == FAMILY_EQ


JET_FAMILIES = {
    "EQ": (tk.EQ(), FAMILY_EQ, 0),
    "MaternP1": (tk.MaternP(1), FAMILY_MATERN, 1),
    "MaternP2": (tk.MaternP(2), FAMILY_MATERN, 2),
    "ScaledLengthscaleMaternP3": (2.5 * tk.Lengthscale(tk.MaternP(3), 0.6), FAMILY_MATERN, 3),
    "LengthscaleEQTwice": (tk.Lengthscale(tk.Lengthscale(tk.EQ(), 2.0), 0.7) * 0.5,
                           FAMILY_EQ, 0),
    "RQ": (2.0 * tk.Lengthscale(tk.RQ(2.0), 1.3), FAMILY_RQ, 0),
    "Cauchy": (tk.Lengthscale(tk.Cauchy(), 0.6) * 1.5, FAMILY_CAUCHY, 0),
    "IMQ": (tk.Lengthscale(tk.InverseMultiQuadratic(1.3), 1.7) * 0.5, FAMILY_IMQ, 0),
}


@pytest.mark.parametrize("name", sorted(JET_FAMILIES))
def test_jet_family_form_matches_program(name):
    """K3's derivative families (`evaluate_jet_family`: f', f'' in closed
    form from the folded table) against the interpreted jet of the
    derivative program and autodiff of `k.profile`: 1e-12 in float64, and
    in float32 within 2e-6 of the largest value (the exp2 argument and the
    Matern Taylor bound move by a rounding)."""
    from cfjax_torch.kernels.derivatives import elementwise_derivatives

    k, family, p = JET_FAMILIES[name]
    spec, why = to_spec(k, derivative=True)
    assert why is None and spec.jet and (spec.family, spec.family_p) == (family, p)
    s64 = torch.linspace(0, 30, 4001, dtype=torch.float64)
    f1, f2 = spec.evaluate_jet_family(s64)
    _, g1, g2 = spec.evaluate_jet(s64)
    _, h1, h2 = elementwise_derivatives(k.profile, s64, 2)
    for a, b in ((f1, g1), (f2, g2), (f1, h1), (f2, h2)):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12 * float(b.abs().max()))
    s32 = torch.linspace(0, 4, 2049, dtype=torch.float32)
    f1, f2 = spec.evaluate_jet_family(s32)
    _, g1, g2 = spec.evaluate_jet(s32)
    for a, b in ((f1, g1), (f2, g2)):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-6 * float(b.abs().max()))
    with pytest.raises(ValueError, match="evaluate_jet_family"):
        spec.evaluate(s32, family=True)


@pytest.fixture
def default_device():
    """The configured device as shipped ("cuda") for the test's body."""
    before = config.DEFAULT.device
    config.set_config(device=config.Config.device)
    yield
    config.set_config(device=before)


def test_input_without_a_device_goes_to_the_card(default_device):
    assert config.Config.device == "cuda" and config.default_device() == torch.device("cuda")
    cuda = torch.device("cuda")
    assert point_device(np.zeros((4, 2))) == cuda
    assert point_device([[0.0, 1.0]]) == cuda
    assert point_device(UniformGrid(0.0, 0.1, 8)) == cuda
    assert point_device(LazyGrid((UniformGrid(0.0, 0.1, 8), np.arange(3.0)))) == cuda
    assert point_device(UniformGrid(0.0, 0.1, 8, device="cpu")) == torch.device("cpu")
    assert point_device(torch.zeros(3)) == torch.device("cpu")     # a tensor keeps its own
    col = ToeplitzOperator(lambda: torch.ones(8), num=8)
    circ = CirculantOperator(lambda: torch.ones(8), num=8)
    assert col.device == cuda and circ.device == cuda
    assert config.default_device("cpu") == torch.device("cpu")


def test_input_without_a_device_on_the_cpu_when_configured():
    assert config.DEFAULT.device == "cpu"
    assert as_points(np.zeros((4, 2))).device.type == "cpu"
    assert UniformGrid(0.0, 0.1, 8).points().device.type == "cpu"
    assert ToeplitzOperator(lambda: torch.ones(8), num=8).device.type == "cpu"
    tree = t_tree.build_tree(np.random.default_rng(0).standard_normal((300, 2)), 16)
    assert tree.points.device.type == "cpu"
    S = t_tile.build_tile_ell(np.array([0, 1]), np.array([1, 0]), np.array([1.0, 2.0]), 2, 2)
    assert S.perm.device.type == "cpu" and S.rows.col.device.type == "cpu"
