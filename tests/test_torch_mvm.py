"""Parity of the port's Gramian MVM layer with cfjax on the CPU.

The plain torch versions of the two CUDA kernels are held against the
Pallas kernels they replace, run in interpret mode as tests/test_pallas.py
runs them (float32, so rtol 2e-5 for the exact difference form and
rtol 2e-4 / atol 2e-5 for the cancelling expansion, cfjax's own
interpret tolerances), and against cfjax's blocked XLA MVM in float64
(rtol 1e-12). The operator layer (Gramian, dispatch, explain) is held
against cfjax on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfjax.kernels as jk
import cfjax_torch
import cfjax_torch.kernels as tk
from cfjax.operators.dispatch import explain as j_explain
from cfjax.operators.dispatch import gramian as j_gramian
from cfjax.operators.gramian import gramian_matvec as j_gramian_matvec
from cfjax.ops.pallas_mvm import pallas_gramian_matvec, pallas_gramian_matvec_direct
from cfjax_torch.operators import Gramian, kernel_decline_reason
from cfjax_torch.operators.dispatch import explain as t_explain
from cfjax_torch.operators.dispatch import gramian as t_gramian
from cfjax_torch.operators.gramian import gramian_matvec as t_gramian_matvec
from cfjax_torch.ops import gramian_mvm as mvm
from cfjax_torch.ops.tiles import inner_tile, matmul_p, sqdist_tile

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """Input without a device goes to the CPU in this module's tests; the
    configured device is restored after them."""
    shipped = cfjax_torch.config.DEFAULT.device
    cfjax_torch.set_config(device="cpu")
    yield
    cfjax_torch.set_config(device=shipped)


ISO = {"MaternP2": lambda: jk.MaternP(2), "EQ": lambda: jk.EQ(), "Exp": lambda: jk.Exp(),
       "RQ": lambda: jk.RQ(1.5),
       "SumScaled": lambda: 2.0 * jk.EQ() + 0.5 * jk.MaternP(1)}


def _data(rng, n, m, d, dtype, scale=1.0, positive=False):
    x = (scale * rng.standard_normal((n, d))).astype(dtype)
    y = (scale * rng.standard_normal((m, d))).astype(dtype)
    a = rng.standard_normal(m)
    return x, y, (np.abs(a) if positive else a).astype(dtype)


# The float32 comparisons with the interpret-mode Pallas kernels use
# positive weights: with signed weights some row sums cancel to near 0,
# and the two float32 summation orders then differ by more than any
# relative tolerance on those rows.


@pytest.mark.parametrize("d", [1, 3, 8])
@pytest.mark.parametrize("name", ["MaternP2", "EQ", "Exp"])
def test_direct_plain_matches_pallas_interpret(d, name, rng):
    kj = ISO[name]()
    x, y, a = _data(rng, 300, 270, d, np.float32, positive=True)
    ref = pallas_gramian_matvec_direct(kj, jnp.asarray(x), jnp.asarray(y), jnp.asarray(a),
                                       tm=128, tn=128, interpret=True)
    out = mvm.gramian_matvec_direct(tk.from_reference(kj), torch.tensor(x),
                                    torch.tensor(y), torch.tensor(a))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5)


@pytest.mark.parametrize("d", [2, 5, 16])
@pytest.mark.parametrize("name", sorted(ISO))
def test_direct_plain_matches_reference_f64(d, name, rng):
    kj = ISO[name]()
    x, y, a = _data(rng, 150, 130, d, np.float64)
    ref = j_gramian_matvec(kj, jnp.asarray(x), jnp.asarray(y), jnp.asarray(a), "iso", 64)
    out = mvm.gramian_matvec_direct_plain(tk.from_reference(kj), torch.tensor(x),
                                          torch.tensor(y), torch.tensor(a))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12)


@pytest.mark.parametrize("prec", ["default", "high", "highest"])
@pytest.mark.parametrize("mode", ["iso", "dot"])
def test_expand_plain_matches_pallas_interpret(mode, prec, rng):
    kj = jk.EQ() if mode == "iso" else jk.Dot() ** 2
    x, y, a = _data(rng, 300, 270, 40, np.float32, scale=40 ** -0.5, positive=True)
    ref = pallas_gramian_matvec(kj, jnp.asarray(x), jnp.asarray(y), jnp.asarray(a), mode,
                                tm=128, tn=128, interpret=True, precision=prec)
    out = mvm.gramian_matvec_expand(tk.from_reference(kj), torch.tensor(x), torch.tensor(y),
                                    torch.tensor(a), mode, precision=prec)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("kname,mode", [("EQ", "iso"), ("MaternP2", "iso"),
                                        ("ExponentialDot", "dot")])
def test_expand_plain_matches_reference_f64(kname, mode, rng):
    kj = {"EQ": jk.EQ(), "MaternP2": jk.MaternP(2), "ExponentialDot": jk.ExponentialDot()}[kname]
    x, y, a = _data(rng, 150, 130, 40, np.float64, scale=40 ** -0.5)
    ref = j_gramian_matvec(kj, jnp.asarray(x), jnp.asarray(y), jnp.asarray(a), mode, 64)
    out = mvm.gramian_matvec_expand_plain(tk.from_reference(kj), torch.tensor(x),
                                          torch.tensor(y), torch.tensor(a), mode)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12)


def test_wrappers_take_plain_version_on_cpu(rng):
    x, y, a = (torch.tensor(v) for v in _data(rng, 40, 30, 3, np.float32))
    before = dict(mvm.LAUNCHES)
    k = tk.MaternP(2)
    np.testing.assert_allclose(mvm.gramian_matvec_direct(k, x, y, a).numpy(),
                               mvm.gramian_matvec_direct_plain(k, x, y, a).numpy())
    np.testing.assert_allclose(mvm.gramian_matvec_expand(k, x, y, a).numpy(),
                               mvm.gramian_matvec_expand_plain(k, x, y, a).numpy())
    assert mvm.LAUNCHES == before


def test_tiles_forms_agree(rng):
    x, y, _ = (torch.tensor(v) for v in _data(rng, 20, 17, 5, np.float64))
    np.testing.assert_allclose(sqdist_tile(x, y, direct_max_d=0).numpy(),
                               sqdist_tile(x, y).numpy(), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(inner_tile(x, y).numpy(), (x @ y.T).numpy(), rtol=1e-14)
    np.testing.assert_allclose(matmul_p(x, y.T, "default").numpy(), (x @ y.T).numpy(),
                               rtol=1e-14)
    with pytest.raises(ValueError):
        matmul_p(x, y.T, "bf16")


@pytest.mark.parametrize("name", ["MaternP2", "Dot2", "Cosine", "NN"])
def test_gramian_matvec_matmat_dense_match_reference(name, rng):
    kj = {"MaternP2": jk.MaternP(2), "Dot2": jk.Dot() ** 2,
          "Cosine": jk.Cosine(np.array([0.3, 0.1, 0.2])), "NN": jk.NN(0.5)}[name]
    kt = tk.from_reference(kj)
    x, y, a = _data(rng, 70, 50, 3, np.float64)
    V = rng.standard_normal((50, 3))
    Gj = j_gramian(kj, jnp.asarray(x), jnp.asarray(y))
    Gt = t_gramian(kt, torch.tensor(x), torch.tensor(y))
    assert isinstance(Gt, Gramian) and Gt.mode == Gj.mode and Gt.shape == Gj.shape
    np.testing.assert_allclose((Gt @ torch.tensor(a)).numpy(),
                               np.asarray(Gj @ jnp.asarray(a)), rtol=1e-12)
    np.testing.assert_allclose((Gt @ torch.tensor(V)).numpy(),
                               np.asarray(Gj @ jnp.asarray(V)), rtol=1e-12)
    np.testing.assert_allclose(Gt.todense().numpy(), np.asarray(Gj.todense()), rtol=1e-12)
    Gs = t_gramian(kt, torch.tensor(x))
    np.testing.assert_allclose(Gs.diagonal().numpy(),
                               np.asarray(j_gramian(kj, jnp.asarray(x)).diagonal()), rtol=1e-12)


def test_gramian_rmatvec_matches_dense(rng):
    x, y, _ = _data(rng, 40, 25, 3, np.float64)
    G = t_gramian(tk.MaternP(1), torch.tensor(x), torch.tensor(y))
    v = torch.tensor(rng.standard_normal(40))
    np.testing.assert_allclose(G.T.matvec(v).numpy(), G.todense().numpy().T @ v.numpy(),
                               rtol=1e-12)


@pytest.mark.parametrize("case", ["constant", "delta_split", "vertical", "ard",
                                  "periodic", "finite_basis", "matrix"])
def test_dispatch_structure_matches_reference(case, rng):
    x = rng.standard_normal((30, 2))
    A = rng.standard_normal((6, 6))
    A = A @ A.T
    kernels = {
        "constant": (jk.Constant(2.0), tk.Constant(2.0), x),
        "delta_split": (jk.MaternP(2) + 0.1 * jk.Delta(), tk.MaternP(2) + 0.1 * tk.Delta(), x),
        "vertical": (jk.VerticalRescaling(jk.EQ(), lambda v: 1.0 + jnp.sum(v * v)),
                     tk.VerticalRescaling(tk.EQ(), lambda v: 1.0 + torch.sum(v * v)), x),
        "ard": (jk.ARD(jk.EQ(), np.array([0.5, 2.0])), None, x),
        "periodic": (jk.Periodic(jk.EQ()), None, x),
        "finite_basis": (jk.FiniteBasis((lambda v: v[0], lambda v: jnp.cos(v[1]))),
                         tk.FiniteBasis((lambda v: v[0], lambda v: torch.cos(v[1]))), x),
        "matrix": (jk.MatrixKernel(A, A.shape), None, np.array([0, 3, 5, 1, 1])),
    }
    kj, kt, pts = kernels[case]
    kt = tk.from_reference(kj) if kt is None else kt
    Kj = j_gramian(kj, jnp.asarray(pts))
    Kt = t_gramian(kt, torch.tensor(pts))
    assert type(Kt).__name__ == type(Kj).__name__
    np.testing.assert_allclose(np.asarray(Kt.todense(), dtype=float),
                               np.asarray(Kj.todense()), rtol=1e-12)
    assert t_explain(kt, torch.tensor(pts)).split(" | ")[0] == \
        j_explain(kj, jnp.asarray(pts)).split(" | ")[0]


def test_dispatch_raises_for_unported_structure(rng):
    """Steps 4 and 8 no longer raise: an evenly spaced 1-D tensor gives a
    Toeplitz operator and a SeparableProduct on a LazyGrid a Kronecker
    operator, each of cfjax's type and with cfjax's MVM."""
    from cfjax.utils.grids import LazyGrid as JLazyGrid
    from cfjax_torch.utils.grids import LazyGrid

    xs = np.linspace(0, 1, 50)
    axes = (np.linspace(0, 1, 4), np.linspace(0, 1, 3))
    cases = ((tk.EQ(), jk.EQ(), torch.tensor(xs), jnp.asarray(xs)),
             (tk.separable("*", tk.EQ(), tk.EQ()), jk.separable("*", jk.EQ(), jk.EQ()),
              LazyGrid(axes), JLazyGrid(axes)))
    for kt, kj, xt, xj in cases:
        Gt, Gj = t_gramian(kt, xt), j_gramian(kj, xj)
        assert type(Gt).__name__ == type(Gj).__name__
        assert type(Gt).__name__ in ("ToeplitzOperator", "KroneckerOperator")
        a = rng.standard_normal(Gt.shape[1])
        np.testing.assert_allclose((Gt @ torch.tensor(a)).numpy(),
                                   np.asarray(Gj @ jnp.asarray(a)), rtol=1e-10)


def test_kernel_selection_on_cpu_and_explain(rng):
    x = torch.tensor(rng.standard_normal((50, 3)))
    G = t_gramian(tk.MaternP(2), x)
    assert G.kernel is None and "CUDA device" in kernel_decline_reason(G)
    assert "cuda kernel declined" in t_explain(tk.MaternP(2), x)
    G = t_gramian(tk.NN(0.3), x)
    assert "trait mode" in kernel_decline_reason(G)


def test_blocked_matvec_gradient_with_checkpoint(rng):
    x, y, a = (torch.tensor(v) for v in _data(rng, 60, 45, 3, np.float64))
    k = tk.Lengthscale(tk.MaternP(2), 0.7)
    k.l.requires_grad_(True)
    out = t_gramian_matvec(k, x, y, a, "iso", block=16)
    (g_blocked,) = torch.autograd.grad(out.sum(), k.l)
    dense = k.profile_value(sqdist_tile(x, y)) @ a
    (g_dense,) = torch.autograd.grad(dense.sum(), k.l)
    np.testing.assert_allclose(g_blocked.numpy(), g_dense.numpy(), rtol=1e-12)


@pytest.mark.parametrize("prec", ["default", "high", "highest"])
@pytest.mark.parametrize("kname,mode", [("EQ", "iso"), ("ExponentialDot", "dot")])
def test_expand_plain_matches_reference_at_each_tier(kname, mode, prec, rng):
    """K2's plain version at each matmul tier against cfjax's blocked MVM
    under the same `matmul_precision` (exact on the CPU in both packages:
    rtol 1e-12)."""
    import cfjax

    kj = {"EQ": jk.EQ(), "ExponentialDot": jk.ExponentialDot()}[kname]
    x, y, a = _data(rng, 150, 130, 40, np.float64, scale=40 ** -0.5)
    cfjax.set_config(matmul_precision=prec)
    try:
        ref = j_gramian_matvec(kj, jnp.asarray(x), jnp.asarray(y), jnp.asarray(a), mode, 64)
    finally:
        cfjax.set_config(matmul_precision=cfjax.config.Config.matmul_precision)
    out = mvm.gramian_matvec_expand(tk.from_reference(kj), torch.tensor(x), torch.tensor(y),
                                    torch.tensor(a), mode, precision=prec)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12)


def test_tier_passes():
    """The tensor-core passes of each tier in K2 and K3, and of the
    configured tier."""
    import cfjax_torch
    from cfjax_torch.ops.tiles import TIER_PASSES, tier_passes

    assert {p: tier_passes(p) for p in ("default", "high", "highest")} == TIER_PASSES
    assert TIER_PASSES == {"default": 1, "high": 3, "highest": 3}
    cfjax_torch.set_config(matmul_precision="default")
    try:
        assert tier_passes() == 1
    finally:
        cfjax_torch.set_config(matmul_precision=cfjax_torch.config.Config.matmul_precision)
    assert tier_passes() == 3
    with pytest.raises(ValueError):
        tier_passes("bf16")
