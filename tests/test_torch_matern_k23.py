"""Real-nu Matern on K2 and K3, and config 5's Nystrom build, on the CPU.

* The jet family's tables (`utils/besselk.py` `matern_nu_jet_knots`: -f'
  and f'' of Matern(nu)'s profile) against the float64 reference
  `matern_nu_reference`, as tests/test_torch_k1_families.py holds the
  value table: each knot's value at rtol 1e-12 above the Taylor bound, each
  cubic's end at the next knot at 1e-10; the family's plain version
  (`ProfileSpec.evaluate_jet_family`, the kernel's arithmetic emulated in
  float32) within MATERN_BOUND (1e-5) of the reference wherever f' and f''
  are normal floats, float64 within 1e-6 (the interpolation alone), and the
  reference's Taylor branch and limits at s = 0.
* `to_spec(Matern(nu), derivative=True)` carries the family for 1 < nu <=
  MATERN_TABLE_MAX_NU and declines nu <= 1; K2's and K3's route functions
  pick the family's instance (no launch: there is no card here).
* Gramian MVMs of Lengthscale(Matern(1.3), 4) and GradientKernel(Matern(2.7))
  in float64 against cfjax's on the same numpy inputs (both plain on the
  CPU, the same quadrature): rtol 1e-10.
* Config 5's Nystrom build on float32 points: the port builds the panel and
  its Gram in float64 (PERF.md: the float32 build stalled config 5's PCG
  on an H100), so its apply agrees with cfjax's build on the same points
  in float64 within 5e-5, where cfjax's float32 build is about 1e-3 off;
  PCG in float64 takes cfjax's iterations within 1. The real-nu Matern panel
  through the family's plain version against `pairwise_xy`'s (cfjax's
  quadrature): 1e-5 in float64. "highest" holds float32 products at full
  fp32 whatever torch's global setting.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfjax.kernels as jk
import cfjax_torch
import cfjax_torch.kernels as tk
from cfjax.derivative import GradientKernel as JGradientKernel
from cfjax.operators import cg as j_cg
from cfjax.operators import nystrom_preconditioner as j_nystrom
from cfjax.operators.dispatch import gramian as j_gramian
from cfjax_torch.derivative import GradientKernel
from cfjax_torch.kernels.profile_spec import FAMILY_EQ, FAMILY_MATERN_NU, FAMILY_NONE, to_spec
from cfjax_torch.operators import cg
from cfjax_torch.operators import preconditioner as pre
from cfjax_torch.operators.dispatch import gramian
from cfjax_torch.ops import grad_mvm, tiles
from cfjax_torch.ops import gramian_mvm as mvm
from cfjax_torch.utils.testing import pairwise_xy
from cfjax_torch.utils.besselk import (MATERN_JET_KNOTS, MATERN_JET_OCTAVES, MATERN_STEPS,
                                       MATERN_TABLE_MAX_NU, matern_nu_jet_knots,
                                       matern_nu_jet_octave, matern_nu_jet_taylor,
                                       matern_nu_reference)

torch.set_num_threads(2)

JET_NUS = (1.2, 1.5, 2.3, 2.7, 3.5, 7.2, 25.0)
MATERN_BOUND = 1e-5
TINY = 2.0 ** -126   # float32's smallest normal


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """Input without a device goes to the CPU in this module's tests; the
    configured device is restored after them."""
    shipped = cfjax_torch.config.DEFAULT.device
    cfjax_torch.set_config(device="cpu")
    yield
    cfjax_torch.set_config(device=shipped)


def _knots(nu):
    k = torch.arange(MATERN_JET_KNOTS + 1, dtype=torch.float64)
    return torch.exp2(matern_nu_jet_octave(nu) + torch.div(k, MATERN_STEPS, rounding_mode="floor")) \
        * (1 + k.remainder(MATERN_STEPS) / MATERN_STEPS)


@pytest.mark.parametrize("nu", JET_NUS)
def test_jet_table_knots_and_cubics(nu):
    """Each interval of both tables holds -f' (f'') at its left knot and its
    cubic reaches the next knot's value at q = 1, above the reference's
    Taylor bound; an interval is kept while its left knot's value is a
    normal float32 and is zero after; the tables start an octave below x
    at the bound and are cached by nu."""
    t1, t2 = matern_nu_jet_knots(nu)
    assert t1.shape == t2.shape == (MATERN_JET_KNOTS, 4) and t1.dtype == torch.float64
    assert matern_nu_jet_knots(nu)[0] is t1
    xk = _knots(nu)
    s = xk * xk / (2 * nu)
    _, f1, f2 = matern_nu_reference(nu, s)
    bound = matern_nu_jet_taylor(nu)[2]
    assert float(s[MATERN_STEPS]) <= bound < float(s[2 * MATERN_STEPS])
    for tab, f in ((t1, -f1), (t2, f2)):
        live = ((tab[:, 0] > 0) & (s[:-1] >= bound)).nonzero()[:, 0]
        torch.testing.assert_close(tab[live, 0], f[live], rtol=1e-12, atol=0)
        end = tab[live, 0] * torch.exp2(tab[live, 1:].sum(dim=1))
        torch.testing.assert_close(end, f[live + 1], rtol=1e-10, atol=0)
        last = int((tab[:, 0] > 0).nonzero()[-1, 0])
        assert not bool(tab[last + 1:].any()) and last + 1 < MATERN_JET_KNOTS
        assert float(f[last]) >= TINY > float(f[last + 1])


@pytest.mark.parametrize("nu", JET_NUS)
def test_jet_family_holds_the_bound(nu):
    """f', f'' of the jet family (`evaluate_jet_family`) against the float64
    reference at s = 0 and log-spaced s from 1e-24 to 1e6 (the Taylor
    branch below the bound included): float32 within MATERN_BOUND wherever
    both are normal floats, float64 within 1e-6; at s = 0 the reference's
    limits t1 and 2 t2."""
    spec, why = to_spec(tk.Matern(nu), derivative=True)
    assert why is None and spec.family == FAMILY_MATERN_NU
    s = torch.cat([torch.zeros(1, dtype=torch.float64), torch.logspace(-24, 6, 60001,
                                                                       dtype=torch.float64)])
    t1, t2, _ = matern_nu_jet_taylor(nu)
    for dt, limit in ((torch.float32, MATERN_BOUND), (torch.float64, 1e-6)):
        sd = s.to(dt)
        got = spec.evaluate_jet_family(sd)
        ref = matern_nu_reference(nu, sd.double())[1:]
        for g, r in zip(got, ref):
            g = g.double()
            assert torch.isfinite(g).all()
            live = r.abs() >= 4 * TINY   # a normal float32 with room for the rounding
            err = float(((g - r).abs() / r.abs())[live].max())
            assert err <= limit, f"nu={nu} {dt}: max rel {err:.3e}"
        assert float(got[0][0]) == pytest.approx(t1, rel=1e-7)
        assert float(got[1][0]) == pytest.approx(2 * t2, rel=1e-7, abs=0)


@pytest.mark.parametrize("nu,family", [(1.0001, FAMILY_MATERN_NU), (2.7, FAMILY_MATERN_NU),
                                       (MATERN_TABLE_MAX_NU, FAMILY_MATERN_NU),
                                       (MATERN_TABLE_MAX_NU + 1, FAMILY_NONE),
                                       (1.0, None), (0.5, None)])
def test_derivative_spec_takes_the_family(nu, family):
    """to_spec(Matern(nu), derivative=True): the tabulated jet family for
    1 < nu <= MATERN_TABLE_MAX_NU, the interpreter above it, a decline at
    nu <= 1 (no finite f' at s = 0)."""
    spec, why = to_spec(tk.Matern(nu), derivative=True)
    if family is None:
        assert spec is None and "nu <= 1" in why
        return
    assert why is None and spec.jet and spec.family == family
    if family == FAMILY_MATERN_NU:
        assert spec.family_consts[-1] == nu and grad_mvm.grad_route(spec) == "grad_matern"
        assert grad_mvm.jet_ops(spec) == (26, 3)


def test_jet_family_folds_lengthscale_and_constant():
    """2.5 Lengthscale(Matern(2.7), 0.6): sigma = 1/0.36 folded into x's
    constant, the bound and the factors, the Constant into the factors."""
    k = 2.5 * tk.Lengthscale(tk.Matern(2.7), 0.6)
    spec = to_spec(k, derivative=True)[0]
    assert spec.family == FAMILY_MATERN_NU and spec.family_scale == 1.0
    sigma = 1 / 0.36
    s = torch.cat([torch.zeros(1), torch.logspace(-12, 3, 20001)])
    f1, f2 = spec.evaluate_jet_family(s)
    _, r1, r2 = matern_nu_reference(2.7, s.double() * sigma)
    # the tables hold the unscaled profile's derivatives: live where those
    # are normal floats
    for g, r, c in ((f1, r1, 2.5 * sigma), (f2, r2, 2.5 * sigma ** 2)):
        live = r.abs() >= 4 * TINY
        assert float(((g.double() - c * r).abs() / (c * r).abs())[live].max()) <= MATERN_BOUND


def test_routes_pick_the_families():
    """K2's and K3's instances for a spec, by their route functions (the
    LAUNCHES key each counts under), and the tables the wrappers pass."""
    vspec = to_spec(tk.Lengthscale(tk.Matern(1.3), 4.0))[0]
    assert vspec.family == FAMILY_MATERN_NU and mvm.expand_route(vspec) == "expand_matern"
    assert tuple(mvm.family_table(vspec, torch.device("cpu")).shape) == (1024, 4)
    assert mvm.expand_route(to_spec(tk.EQ())[0]) == "expand"
    assert mvm.expand_route(to_spec(2.0 * tk.Matern(1.3) + tk.EQ())[0]) == "expand"
    dspec = to_spec(tk.Matern(2.7), derivative=True)[0]
    assert grad_mvm.grad_route(dspec) == "grad_matern"
    tab = grad_mvm.jet_table(dspec, torch.device("cpu"))
    assert tab.dtype == torch.float32 and tuple(tab.shape) == (2 * MATERN_JET_KNOTS, 4)
    assert MATERN_JET_KNOTS == 32 * MATERN_JET_OCTAVES
    eq = to_spec(tk.EQ(), derivative=True)[0]
    assert eq.family == FAMILY_EQ and grad_mvm.grad_route(eq) == "grad"
    assert grad_mvm.jet_table(eq, torch.device("cpu")) is None


@pytest.mark.parametrize("n,d", [(30, 3), (24, 8)])
@pytest.mark.parametrize("case", ["value", "gradient"])
def test_gramian_mvms_match_reference(case, n, d, rng):
    """Lengthscale(Matern(1.3), 4) (K2's kernel) and GradientKernel(Matern
    (2.7)) (K3's) gramian MVMs against cfjax's, float64 on the CPU."""
    x = rng.standard_normal((n, d))
    if case == "value":
        kj, kt = jk.Lengthscale(jk.Matern(1.3), 4.0), tk.Lengthscale(tk.Matern(1.3), 4.0)
    else:
        kj, kt = JGradientKernel(jk.Matern(2.7)), GradientKernel(tk.Matern(2.7))
    Gj, Gt = j_gramian(kj, jnp.asarray(x)), gramian(kt, torch.tensor(x))
    v = rng.standard_normal(Gt.shape[1])
    ref = np.asarray(Gj @ jnp.asarray(v))
    np.testing.assert_allclose((Gt @ torch.tensor(v)).numpy(), ref, rtol=1e-10,
                               atol=1e-12 * np.abs(ref).max())


# config 5's regime at n = 4096: sigma^2 / lambda_max = 3.4e-7, about 3
# float32 eps, and lambda_(r+1) ~ 3e-4 at rank 24
N5, BOX5, S2, RANK5 = 4096, 1.5, 1e-3, 24


@pytest.fixture(scope="module")
def box_points():
    rng = np.random.default_rng(0)
    x = rng.uniform(-BOX5 / 2, BOX5 / 2, (N5, 2)).astype(np.float32)
    y = (np.sin(x[:, 0]) + 0.1 * rng.uniform(0, 1, N5)).astype(np.float32)
    return x, y


def test_nystrom_float32_points_match_float64_build(box_points):
    """The port's preconditioner on float32 points against cfjax's built on
    the same points in float64: within 5e-5 relative on y (the float32
    apply's rounding on the modes near sigma^2 / lambda_max); cfjax's
    float32 build is over 1e-4 off: the rounding the float64 build removes.
    PCG in float64 takes cfjax's float64 iterations within 1; in float32 it
    converges."""
    x, y = box_points
    kj, kt = jk.Lengthscale(jk.EQ(), 1.0), tk.Lengthscale(tk.EQ(), 1.0)
    xt, yt = torch.tensor(x), torch.tensor(y)
    ref = np.asarray(j_nystrom(kj, jnp.asarray(x, jnp.float64), S2, rank=RANK5)(
        jnp.asarray(y, jnp.float64)))
    rel = lambda u: np.linalg.norm(u - ref) / np.linalg.norm(ref)
    M = pre.nystrom_preconditioner(kt, xt, S2, rank=RANK5)
    assert rel(M(yt).double().numpy()) <= 5e-5
    Mj32 = j_nystrom(kj, jnp.asarray(x), S2, rank=RANK5)
    assert rel(np.asarray(Mj32(jnp.asarray(y)), dtype=np.float64)) > 1e-4
    x64, y64 = jnp.asarray(x, jnp.float64), jnp.asarray(y, jnp.float64)
    Gj = j_gramian(kj, x64)
    _, (it_j, _) = j_cg(lambda v: Gj._matvec(v) + S2 * v, y64, tol=1e-4, maxiter=60,
                        M=j_nystrom(kj, x64, S2, rank=RANK5))
    G64 = gramian(kt, xt.double())
    _, (it64, _) = cg(lambda v: G64._matvec(v) + S2 * v, yt.double(), tol=1e-4, maxiter=60,
                      M=pre.nystrom_preconditioner(kt, xt.double(), S2, rank=RANK5))
    assert abs(it64 - int(it_j)) <= 1
    G = gramian(kt, xt)
    hist = []
    _, (it, res) = cg(lambda v: G._matvec(v) + S2 * v, yt, tol=1e-4, maxiter=60, M=M,
                      callback=lambda i, xa, r: hist.append(float(torch.linalg.norm(r))))
    assert len(hist) == it < 60 and float(res) <= 1e-4 * float(torch.linalg.norm(yt))


def test_matern_nystrom_panel_matches_quadrature(rng, monkeypatch):
    """Lengthscale(Matern(2.3), 0.9): M's apply with the build's entries
    through the tabulated family's plain version (`gramian.build_tile`)
    against the entries through `pairwise_xy` (cfjax's quadrature),
    float64: 1e-5 relative."""
    x = torch.tensor(rng.standard_normal((600, 3)))
    v = torch.tensor(rng.standard_normal(600))
    k = tk.Lengthscale(tk.Matern(2.3), 0.9)
    out = pre.nystrom_preconditioner(k, x, 1e-2, rank=96)(v)
    monkeypatch.setattr(pre, "build_tile",
                        lambda g: lambda a, b: pairwise_xy(g.k_given, a, b))
    ref = pre.nystrom_preconditioner(k, x, 1e-2, rank=96)(v)
    assert float(torch.linalg.norm(out - ref) / torch.linalg.norm(ref)) <= 1e-5


def test_highest_ignores_the_global_tf32_setting(monkeypatch):
    """matmul_p at "highest" (and the tf32 tiers' emulation) multiply with
    torch's CUDA float32 matmul precision held at full fp32 ("ieee")
    whatever it is set to, and restore the caller's setting: on the card
    "tf32" would let cuBLAS round the inputs. The CPU can check the switch,
    not its effect."""
    m = torch.backends.cuda.matmul
    seen = []
    real = torch.Tensor.__matmul__

    def spy(a, b):
        seen.append(m.fp32_precision)
        return real(a, b)

    monkeypatch.setattr(torch.Tensor, "__matmul__", spy)
    saved = m.fp32_precision
    try:
        m.fp32_precision = "tf32"
        a = torch.ones((3, 4))
        tiles.matmul_p(a, a.T, precision="highest")
        with tiles.full_fp32():
            assert m.fp32_precision == "ieee"
        assert m.fp32_precision == "tf32"
    finally:
        m.fp32_precision = saved
    assert seen == ["ieee"]
