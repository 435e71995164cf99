"""K1's families on the CPU: the tabulated real-nu Matern family, the
many-column product at each matmul tier, its least work, and the kernel's
hyperparameters moved to the points when an operator is formed.

* `Gramian._matmat` (and the many-column K1's plain version) of real-nu
  Matern and MaternP kernels against cfjax's blocked `gramian_matvec`,
  rtol 1e-12, at every tier (on the CPU every tier is exact in both
  packages).
* The real-nu Matern family's table (`utils/besselk.py` `matern_nu_knots`)
  and its interpolation rule (`ProfileSpec.evaluate(s, family=True)`, the
  kernels' arithmetic emulated in float32 on the CPU) against the float64
  reference `matern_nu_reference`: relative 1e-5 above 1e-30 for every nu
  of chip_smoke's phase 21a over s from 1e-12 to 1e6 (float32; the table
  alone, in float64, 1e-6).
* `work_direct`'s many-column count: the product's 2p flops an entry on
  the tensor cores at the tier's passes.
* `to_points`: a Gramian (and the derivative, sparse and Barnes-Hut
  operators) holds the kernel with its hyperparameters on the points'
  device and dtype, the user's kernel untouched; autograd reaches a leaf
  that requires grad through the move (the logML's gradient and a
  `fit_kernel` step on float32 points are those of the kernel cast by
  hand)."""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfjax
import cfjax.kernels as jk
import cfjax_torch
import cfjax_torch.kernels as tk
from cfjax.operators.gramian import gramian_matvec as j_gramian_matvec
from cfjax_torch.derivative import GradientKernel, HessianKernel
from cfjax_torch.gp import fit_kernel, log_marginal_likelihood
from cfjax_torch.kernels.parameters import leaves, to_points
from cfjax_torch.kernels.profile_spec import (FAMILY_MATERN_NU, FAMILY_NONE, MATERN_NU,
                                              to_spec)
from cfjax_torch.operators.dispatch import gramian
from cfjax_torch.ops import gramian_mvm as mvm
from cfjax_torch.utils.besselk import (MATERN_KNOTS, MATERN_STEPS, MATERN_TABLE_MAX_NU,
                                       matern_nu_knots, matern_nu_octave,
                                       matern_nu_reference, matern_nu_small)
from cfjax_torch.utils.roofline import Work

torch.set_num_threads(2)

# chip_smoke.py phase 21a's nus and bound
MATERN_NUS = (0.3, 0.5, 1.3, 2.3, 2.5, 3.7, 10.2, 25.0)
MATERN_BOUND = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """Input without a device goes to the CPU in this module's tests; the
    configured device is restored after them."""
    shipped = cfjax_torch.config.DEFAULT.device
    cfjax_torch.set_config(device="cpu")
    yield
    cfjax_torch.set_config(device=shipped)


@pytest.fixture
def tier(request):
    cfjax_torch.set_config(matmul_precision=request.param)
    yield request.param
    cfjax_torch.set_config(matmul_precision=cfjax_torch.config.Config.matmul_precision)


MATMAT_KERNELS = {
    "Matern2.3": lambda m: m.Lengthscale(m.Matern(2.3), 0.8),
    "Matern0.7": lambda m: m.Matern(0.7),
    "ScaledMatern1.3": lambda m: 3.0 * m.Lengthscale(m.Matern(1.3), 1.4),
    "MaternP2": lambda m: m.MaternP(2),
}


@pytest.mark.parametrize("tier", ["highest", "high", "default"], indirect=True)
@pytest.mark.parametrize("p", [1, 16, 17])
@pytest.mark.parametrize("name", list(MATMAT_KERNELS))
def test_matmat_matches_reference(rng, name, p, tier):
    """K A for A of shape (m, p) through Gramian._matmat and the
    many-column K1's plain version at the tier, against cfjax's blocked
    gramian_matvec: rtol 1e-12 (an entry that cancels to far below the
    others is held to 1e-12 of the largest: the two sum in other orders).
    The real-nu Materns carry the tabulated family: their spec is K1's in
    both products on the card."""
    kj, kt = MATMAT_KERNELS[name](jk), MATMAT_KERNELS[name](tk)
    assert (to_spec(kt)[0].family == FAMILY_MATERN_NU) == (name != "MaternP2")
    x, y = rng.standard_normal((150, 3)), rng.standard_normal((130, 3))
    A = rng.standard_normal((130, p))
    ref = np.asarray(j_gramian_matvec(kj, jnp.asarray(x), jnp.asarray(y), jnp.asarray(A),
                                      "iso", 64))
    tol = dict(rtol=1e-12, atol=1e-12 * np.abs(ref).max())
    G = gramian(kt, torch.tensor(x), torch.tensor(y))
    np.testing.assert_allclose((G @ torch.tensor(A)).numpy(), ref, **tol)
    np.testing.assert_allclose(mvm.gramian_matmat_direct(
        kt, torch.tensor(x), torch.tensor(y), torch.tensor(A), precision=tier).numpy(), ref,
        **tol)


@pytest.mark.parametrize("nu", MATERN_NUS)
def test_matern_table_holds_the_bound(nu):
    """The family's interpolation rule in float32 (the kernels' arithmetic,
    `_matern_nu_family`) against the float64 reference at every s whose
    value is above 1e-30, s from 1e-12 to 1e6 and 0: relative 1e-5
    (MATERN_BOUND); the same rule in float64 on the float64 table, 1e-6
    (the interpolation alone)."""
    spec, why = to_spec(tk.Matern(nu))
    assert why is None and spec.family == FAMILY_MATERN_NU and spec.ops[-1] == MATERN_NU
    s32 = torch.cat([torch.zeros(1), torch.logspace(-12, 6, 60001)]).float()
    for s, bound in ((s32, MATERN_BOUND), (s32.double(), 1e-6)):
        out = spec.evaluate(s, family=True).double()
        ref = matern_nu_reference(nu, s.double())[0]
        live = ref > 1e-30
        assert torch.isfinite(out).all() and float(out[0]) == 1.0
        err = float(((out - ref).abs() / ref)[live].max())
        assert err <= bound, f"nu={nu} {s.dtype}: max rel {err:.3e}"
        assert float(out[~live].abs().max()) <= 1e-29


def test_matern_table_knots_and_cubics():
    """Each interval holds f at its left knot, and its cubic reaches the
    next knot's value at q = 1 with the reference's slope at both ends; it
    starts an octave below the guard's x (nu > 1) or at 2^-24 (nu <= 1),
    is zero once f leaves float32, and is cached by nu."""
    for nu in (0.3, 2.3, 25.0):
        tab = matern_nu_knots(nu)
        assert tab.shape == (MATERN_KNOTS, 4) and tab.dtype == torch.float64
        assert matern_nu_knots(nu) is tab
        e_lo = matern_nu_octave(nu)
        k = torch.arange(MATERN_KNOTS + 1, dtype=torch.float64)
        xk = torch.exp2(e_lo + torch.div(k, MATERN_STEPS, rounding_mode="floor")) \
            * (1 + k.remainder(MATERN_STEPS) / MATERN_STEPS)
        f = matern_nu_reference(nu, xk * xk / (2 * nu))[0]
        live = (tab[:, 0] > 0).nonzero()[:, 0]
        torch.testing.assert_close(tab[live, 0], f[live], rtol=1e-12, atol=0)
        end = tab[live, 0] * torch.exp2(tab[live, 1:].sum(dim=1))
        torch.testing.assert_close(end, f[live + 1], rtol=1e-10, atol=0)
        assert not bool(tab[live[-1] + 1:].any())
        assert float(f[live[-1] + 1]) >= 2.0 ** -126 > float(f[live[-1] + 2])
    assert matern_nu_octave(0.5) == -24 and matern_nu_octave(1.3) == -12
    assert matern_nu_octave(2.3) == -6
    assert matern_nu_small(1.3) == 0.0
    assert matern_nu_small(0.5) == pytest.approx(0.5 * math.gamma(0.5) / math.gamma(1.5))


def test_matern_family_folds_lengthscale_constant_and_small_x():
    """3 Lengthscale(Matern(nu), 0.8): the lengthscale folded into x's
    constant and the guard, the constant a factor; below the table
    1 - a x^(2 nu) for nu < 1 and the Taylor polynomial above 1 (s near
    the guard's bound); nu above MATERN_TABLE_MAX_NU keeps the
    interpreter."""
    for nu in (0.3, 2.3):
        k = 3.0 * tk.Lengthscale(tk.Matern(nu), 0.8)
        spec = to_spec(k)[0]
        assert spec.family == FAMILY_MATERN_NU and spec.family_scale == 3.0
        s = torch.cat([torch.zeros(1), torch.logspace(-30, 3, 20001)]).float()
        out = spec.evaluate(s, family=True).double()
        ref = 3.0 * matern_nu_reference(nu, s.double() / 0.64)[0]
        live = ref > 1e-30
        err = float(((out - ref).abs() / ref)[live].max())
        assert err <= MATERN_BOUND, f"nu={nu}: {err:.3e}"
    spec = to_spec(tk.Matern(MATERN_TABLE_MAX_NU + 1))[0]
    assert spec is not None and spec.family == FAMILY_NONE


def test_work_direct_counts_the_product_on_the_tensor_cores():
    """B = K A: 2d + the profile on the CUDA cores and the SFU, 2p flops an
    entry on the tensor cores at the tier's passes. MaternP(2) at n = 2^17,
    p = 16: the SFU sets 8.217 ms, the single-column K1's bound, where the
    count of p FFMAs an entry set 14.38 ms (fp32). The tabulated Matern
    family: 19 fp32 and 2 SFU an entry."""
    prof = mvm.profile_ops(to_spec(tk.MaternP(2))[0])
    n = 131072
    w = mvm.work_direct(n, n, 3, prof, p=16)
    assert (w.fp32, w.sfu, w.tc_flops, w.tc_passes) == (n * n * 12.0, n * n * 2.0,
                                                        n * n * 32.0, 3)
    assert w.bound() == "SFU"
    assert w.roofline_seconds() * 1e3 == pytest.approx(8.217, rel=5e-4)
    assert w.roofline_seconds() == mvm.work_direct(n, n, 3, prof).roofline_seconds()
    old = Work(fp32=n * n * (2 * 3 + 6 + 16.0))
    assert old.roofline_seconds() * 1e3 == pytest.approx(14.38, rel=5e-4)
    one = mvm.work_direct(n, n, 3, prof, p=16, passes=1)
    assert one.tc_passes == 1 and one.seconds()["tensor cores"] == w.seconds()["tensor cores"] / 3
    assert mvm.profile_ops(to_spec(tk.Lengthscale(tk.Matern(2.3), 1.0))[0]) == (19, 2)


def _all_on(k, dtype):
    return all(l.dtype == dtype and l.device.type == "cpu" for l in leaves(k))


def test_operators_hold_hyperparameters_on_the_points(rng):
    """Formed on float32 points, a Gramian, a gradient gramian (the pair
    composite, and an iso kernel), a Hessian gramian, a sparse lazy
    operator and a Barnes-Hut operator hold the kernel with float32
    hyperparameters; the user's kernel keeps its float64 ones; on float64
    points nothing is copied. The float32 products equal those of the
    kernel cast by hand."""
    from cfjax_torch.barneshut import BarnesHutFactorization
    from cfjax_torch.operators.sparse_op import sparse_gramian

    x = torch.tensor(rng.standard_normal((64, 3)), dtype=torch.float32)
    k = tk.Lengthscale(tk.MaternP(2), 0.7)
    G = gramian(k, x)
    assert _all_on(G.k, torch.float32) and _all_on(k, torch.float64)
    assert gramian(k, x.double()).k is k
    a = torch.tensor(rng.standard_normal(64), dtype=torch.float32)
    cast = tk.Lengthscale(tk.MaternP(2), torch.tensor(0.7, dtype=torch.float32))
    assert torch.equal(G @ a, gramian(cast, x) @ a)
    composite = tk.MaternP(2) + tk.Line(1.0) ** 2 + tk.NN(0.1)
    for mk in (GradientKernel(composite), GradientKernel(k), HessianKernel(tk.EQ())):
        Gd = gramian(mk, x[:8])
        assert _all_on(Gd.k, torch.float32) and _all_on(mk.k, torch.float64)
    Gc = gramian(GradientKernel(composite), x[:8])
    v = torch.tensor(rng.standard_normal(24), dtype=torch.float32)
    ref = gramian(GradientKernel(composite), x[:8].double()) @ v.double()
    assert float(torch.linalg.norm((Gc @ v).double() - ref) / torch.linalg.norm(ref)) <= 1e-5
    xs = torch.tensor(rng.uniform(-20, 20, (1024, 2)), dtype=torch.float32)
    S, _ = sparse_gramian(tk.Lengthscale(tk.EQ(), 0.3), xs, tol=1e-4, format="lazy")
    assert _all_on(S.k, torch.float32)
    F = BarnesHutFactorization(k, x, theta=0.5, group_size=16)
    assert _all_on(F.k, torch.float32)
    assert to_points(k, x.double()) is k and to_points(k, torch.arange(3)) is k


@pytest.fixture
def small_cholesky_size():
    cfjax_torch.set_config(max_cholesky_size=32)
    yield
    cfjax_torch.set_config(max_cholesky_size=cfjax_torch.config.Config.max_cholesky_size)


@pytest.mark.parametrize("method", ["cholesky", "slq"])
def test_moved_leaves_keep_the_logml_gradient(rng, method, small_cholesky_size, monkeypatch):
    """The logML on float32 points with a float64 lengthscale that requires
    grad: value and gradient equal, bit for bit, those of a Gramian that
    leaves its hyperparameters where they are (`hp` then casts them at
    every evaluation): the move is the same `.to`, made once when the
    Gramian is formed, and autograd reaches the leaf through it, the slq
    branch's pull-back through the rebuilt product."""
    gramian_mod = importlib.import_module("cfjax_torch.operators.gramian")

    x = torch.tensor(rng.standard_normal((48, 2)), dtype=torch.float32)
    y = torch.sin(x[:, 0]) + 0.01 * torch.tensor(rng.standard_normal(48), dtype=torch.float32)

    def run():
        l = torch.tensor(0.9, dtype=torch.float64, requires_grad=True)
        v = log_marginal_likelihood(tk.Lengthscale(tk.MaternP(2), l), x, y, noise=1e-2,
                                    method=method, generator=torch.Generator().manual_seed(3))
        (g,) = torch.autograd.grad(v, l)
        return v.detach(), g

    v0, g0 = run()
    monkeypatch.setattr(gramian_mod, "to_points", lambda k, points: k)
    v1, g1 = run()
    assert torch.equal(v0, v1) and torch.equal(g0, g1) and g0.dtype == torch.float64
    assert bool(torch.isfinite(g0)) and float(g0) != 0.0


def test_fit_kernel_on_float32_points(rng, monkeypatch):
    """fit_kernel on float32 points: each step's Gramian holds float32
    hyperparameters; its history and fitted kernel equal, bit for bit,
    those of Gramians that leave the hyperparameters where they are; the
    fit's negative logML falls and its kernel comes back with the user's
    float64 leaves."""
    gramian_mod = importlib.import_module("cfjax_torch.operators.gramian")

    x = torch.tensor(rng.standard_normal((40, 2)), dtype=torch.float32)
    y = torch.sin(x[:, 0]) + 0.01 * torch.tensor(rng.standard_normal(40), dtype=torch.float32)
    fit = lambda: fit_kernel(tk.Lengthscale(tk.MaternP(2), 2.0), x, y, noise=1e-2, steps=3,
                             lr=0.05)
    k, hist = fit()
    monkeypatch.setattr(gramian_mod, "to_points", lambda k, points: k)
    k1, hist1 = fit()
    assert torch.equal(hist, hist1) and torch.equal(k.l, k1.l)
    assert hist.shape == (3,) and bool(torch.all(hist[1:] < hist[:-1]))
    assert _all_on(k, torch.float64)
