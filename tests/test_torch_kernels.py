"""Parity of the port's kernel zoo (cfjax_torch.kernels) with cfjax.

The same numpy inputs go to both packages: cfjax in x64 on the CPU
(tests/conftest.py), the port in float64. Kernel entries, profiles and
profile specs agree to rtol 1e-12 — both evaluate the same float64
formulas, so only the last bits of exp/pow/rsqrt may differ."""

import functools
import operator

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfjax.kernels as jk
import cfjax_torch
import cfjax_torch.kernels as tk
from cfjax.utils.testing import pairwise as j_pairwise
from cfjax_torch.kernels.profile_spec import to_spec
from cfjax_torch.utils.testing import pairwise as t_pairwise

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """Input without a device goes to the CPU in this module's tests; the
    configured device is restored after them."""
    shipped = cfjax_torch.config.DEFAULT.device
    cfjax_torch.set_config(device="cpu")
    yield
    cfjax_torch.set_config(device=shipped)


RTOL = 1e-12


def _x(rng, n, d, scale=1.0):
    return scale * rng.standard_normal((n, d))


# cfjax kernels whose port is built by from_reference
REFERENCE_KERNELS = {
    "EQ": lambda: jk.EQ(),
    "RQ": lambda: jk.RQ(1.5),
    "Exp": lambda: jk.Exp(),
    "GammaExp": lambda: jk.GammaExp(1.3),
    "MaternP0": lambda: jk.MaternP(0),
    "MaternP1": lambda: jk.MaternP(1),
    "MaternP2": lambda: jk.MaternP(2),
    "MaternP3": lambda: jk.MaternP(3),
    "Cauchy": lambda: jk.Cauchy(),
    "IMQ": lambda: jk.IMQ(0.7),
    "Constant": lambda: jk.Constant(2.0),
    "Cosine": lambda: jk.Cosine(np.array([0.1, 0.2, 0.3])),
    "Dot": lambda: jk.Dot(),
    "ExponentialDot": lambda: jk.ExponentialDot(),
    "Line": lambda: jk.Line(0.5),
    "Poly": lambda: jk.Poly(3, 0.5),
    "NN": lambda: jk.NN(0.3),
    "Lengthscale": lambda: jk.Lengthscale(jk.MaternP(2), 0.5),
    "SumScaled": lambda: 2.0 * jk.EQ() + 0.5 * jk.MaternP(1),
    "Product": lambda: jk.EQ() * jk.RQ(2.0),
    "Power": lambda: jk.Dot() ** 2,
    "ARD": lambda: jk.ARD(jk.EQ(), np.array([0.5, 1.0, 2.0])),
    "Energetic": lambda: jk.Energetic(jk.EQ(), np.array([[2.0, 0.3, 0.0],
                                                          [0.3, 1.0, 0.1],
                                                          [0.0, 0.1, 0.5]])),
    "Periodic": lambda: jk.Periodic(jk.EQ()),
    "ScaledInput": lambda: jk.ScaledInputKernel(jk.MaternP(1), np.array([[1.0, 0.5, 0.0],
                                                                         [0.0, 1.0, 0.2],
                                                                         [0.1, 0.0, 1.0]])),
    "Symmetric": lambda: jk.SymmetricKernel(jk.EQ(), 0.3),
    "PseudoVoigt": lambda: jk.PseudoVoigt(0.3),
    "Spectral": lambda: jk.Spectral(0.7, np.array([0.1, 0.2, 0.0]), np.array([1.0, 2.0, 0.5])),
    "SeparableProduct": lambda: jk.separable("*", jk.EQ(), jk.MaternP(1), jk.Exp()),
    "SeparableSum": lambda: jk.separable("+", jk.EQ(), jk.Cauchy(), jk.RQ(0.5)),
}


@pytest.mark.parametrize("name", sorted(REFERENCE_KERNELS))
def test_kernel_entries_match_reference(name, rng):
    kj = REFERENCE_KERNELS[name]()
    kt = tk.from_reference(kj)
    x, y = _x(rng, 9, 3), _x(rng, 7, 3)
    ref = np.asarray(j_pairwise(kj, jnp.asarray(x), jnp.asarray(y)))
    out = t_pairwise(kt, torch.tensor(x), torch.tensor(y)).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL)
    assert kt.trait.value == kj.trait.value
    assert kt.is_mercer == kj.is_mercer


def test_callable_kernels_match_reference(rng):
    """Kernels with static callables get the same function written for
    each framework."""
    x, y = _x(rng, 6, 2), _x(rng, 5, 2)
    pairs = [
        (jk.Normed(jk.EQ(), lambda t: jnp.sum(jnp.abs(t)) ** 2),
         tk.Normed(tk.EQ(), lambda t: torch.sum(torch.abs(t)) ** 2)),
        (jk.Warped(jk.MaternP(1), lambda v: jnp.tanh(v)),
         tk.Warped(tk.MaternP(1), lambda v: torch.tanh(v))),
        (jk.Chained(lambda v: jnp.exp(v), jk.EQ()),
         tk.Chained(lambda v: torch.exp(v), tk.EQ())),
        (jk.VerticalRescaling(jk.EQ(), lambda v: 1.0 + jnp.sum(v * v)),
         tk.VerticalRescaling(tk.EQ(), lambda v: 1.0 + torch.sum(v * v))),
        (jk.normalize(jk.NN(0.5)), tk.normalize(tk.NN(0.5))),
        (jk.FiniteBasis((lambda v: v[0], lambda v: jnp.sin(v[1]))),
         tk.FiniteBasis((lambda v: v[0], lambda v: torch.sin(v[1])))),
    ]
    for kj, kt in pairs:
        ref = np.asarray(j_pairwise(kj, jnp.asarray(x), jnp.asarray(y)))
        out = t_pairwise(kt, torch.tensor(x), torch.tensor(y)).numpy()
        np.testing.assert_allclose(out, ref, rtol=RTOL)


def test_delta_and_brownian_match_reference(rng):
    x = _x(rng, 6, 2)
    xd = np.concatenate([x, x[:2]])
    for kj, kt, pts in [(jk.Delta(), tk.Delta(), xd),
                        (jk.Brownian(), tk.Brownian(), np.abs(_x(rng, 6, 1)))]:
        ref = np.asarray(j_pairwise(kj, jnp.asarray(pts)))
        out = t_pairwise(kt, torch.tensor(pts)).numpy()
        np.testing.assert_allclose(out, ref, rtol=RTOL)


PROFILE_KERNELS = ["EQ", "RQ", "Exp", "GammaExp", "MaternP0", "MaternP1", "MaternP2",
                   "MaternP3", "Cauchy", "IMQ", "Constant", "Dot", "ExponentialDot",
                   "Line", "Poly", "Lengthscale", "SumScaled", "Product", "Power",
                   "PseudoVoigt"]


def _profile_args(rng):
    # 0, the Taylor-guard neighbourhood, and ordinary squared distances
    return np.concatenate([[0.0, 1e-300, 1e-17, 1e-9, 1e-5],
                           np.abs(rng.standard_normal(20)) * 4.0])


@pytest.mark.parametrize("name", PROFILE_KERNELS)
def test_profile_and_spec_match_reference(name, rng):
    kj = REFERENCE_KERNELS[name]()
    kt = tk.from_reference(kj)
    s = _profile_args(rng)
    ref_p = np.asarray(kj.profile(jnp.asarray(s)))
    ref_v = np.asarray(kj.profile_value(jnp.asarray(s)))
    np.testing.assert_allclose(kt.profile(torch.tensor(s)).numpy(), ref_p, rtol=RTOL)
    np.testing.assert_allclose(kt.profile_value(torch.tensor(s)).numpy(), ref_v, rtol=RTOL)
    spec, why = to_spec(kt)
    assert why is None and spec is not None
    np.testing.assert_allclose(spec.evaluate(torch.tensor(s)).numpy(), ref_v, rtol=RTOL)


def test_spec_declines_with_reason():
    for k in (tk.NN(0.3), tk.Cosine(1.0), tk.Chained(torch.exp, tk.EQ()), tk.Delta(),
              tk.ARD(tk.EQ(), np.array([1.0, 2.0]))):
        spec, why = to_spec(k)
        assert spec is None and isinstance(why, str) and why


def test_spec_covers_nested_lengthscales_and_powers(rng):
    k = tk.Lengthscale(tk.Lengthscale(tk.EQ() + 0.5 * tk.MaternP(3), 2.0), 0.5) ** 3
    spec, _ = to_spec(k)
    s = torch.tensor(_profile_args(rng))
    np.testing.assert_allclose(spec.evaluate(s).numpy(), k.profile_value(s).numpy(), rtol=RTOL)
    assert spec.mode == "iso" and to_spec(tk.ExponentialDot() * 2.0)[0].mode == "dot"


@pytest.mark.parametrize("name", ["SumScaled", "Lengthscale", "Spectral", "Energetic", "Poly"])
def test_parameters_and_similar_round_trip(name, rng):
    kj = REFERENCE_KERNELS[name]()
    kt = tk.from_reference(kj)
    pj = np.asarray(jk.parameters(kj))
    np.testing.assert_array_equal(tk.parameters(kt).numpy(), pj)
    assert tk.nparameters(kt) == jk.nparameters(kj) == pj.size
    theta = pj * 1.5 + 0.1
    kj2, kt2 = jk.similar(kj, jnp.asarray(theta)), tk.similar(kt, torch.tensor(theta))
    np.testing.assert_array_equal(tk.parameters(kt2).numpy(), np.asarray(jk.parameters(kj2)))
    np.testing.assert_array_equal(tk.parameters(kt).numpy(), pj)  # original untouched
    x = _x(rng, 5, 3)
    np.testing.assert_allclose(t_pairwise(kt2, torch.tensor(x)).numpy(),
                               np.asarray(j_pairwise(kj2, jnp.asarray(x))), rtol=RTOL)
    with pytest.raises(ValueError):
        tk.similar(kt, torch.zeros(pj.size + 1))


def test_constructor_validation_and_matern():
    with pytest.raises(ValueError):
        tk.RQ(-1.0)
    with pytest.raises(ValueError):
        tk.Constant(-2.0)
    with pytest.raises(ValueError):
        tk.MaternP(-1)
    with pytest.raises(ValueError):
        tk.Matern(-1.0)
    assert tk.MaternP(3)._derivs == jk.MaternP(3)._derivs
    assert tk.MaternP(3)._poly == jk.MaternP(3)._poly


def test_kernels_follow_input_device_and_dtype():
    k = tk.Lengthscale(tk.RQ(1.5), 0.5)
    s = torch.linspace(0, 3, 7, dtype=torch.float32)
    assert k.profile_value(s).dtype == torch.float32
    np.testing.assert_allclose(k.profile_value(s).numpy(),
                               k.profile_value(s.double()).numpy(), rtol=1e-6)


def test_config_and_grids_match_reference():
    import dataclasses

    import cfjax.config as jc
    import cfjax_torch.config as tc
    from cfjax.utils import grids as jg
    from cfjax_torch.utils import grids as tg

    jf = {f.name for f in dataclasses.fields(jc.Config)}
    tf = {f.name for f in dataclasses.fields(tc.Config)}
    # the port adds where input without a device goes (JAX has a default device)
    assert jf - tf == {"cg_chunk_iters", "cg_chunk_min_n"} and tf - jf == {"device"}
    x = np.linspace(-1.0, 2.0, 33).astype(np.float32)
    # the port's grid also carries the tensor's device and dtype
    got = tg.detect_uniform_grid(torch.tensor(x))
    assert (got.start, got.step, got.num) == dataclasses.astuple(jg.detect_uniform_grid(x))
    assert (got.device, got.dtype) == (torch.device("cpu"), torch.float32)
    assert tg.detect_uniform_grid(np.sort(np.random.default_rng(0).random(20))) is None
    lg_j = jg.LazyGrid((jg.UniformGrid(0.0, 0.5, 3), np.array([1.0, 2.0])))
    lg_t = tg.LazyGrid((tg.UniformGrid(0.0, 0.5, 3), np.array([1.0, 2.0])))
    np.testing.assert_allclose(lg_t.points().numpy(), np.asarray(lg_j.points()))
    assert tuple(tg.as_points(torch.ones(4)).shape) == (4, 1)


# --------------------------------------------------------------------------
# real-nu Matern: the profile (cfjax's quadrature), its jet, its specs
# --------------------------------------------------------------------------

MATERN_NUS = [0.7, 1.5, 2.3, 2.5, 3.7]


def _matern_args(nu, rng, dtype=np.float64):
    """0, either side of the Taylor guard's bound in `dtype`, the region
    where the quadrature is accurate, and ordinary squared distances."""
    eps = float(np.finfo(dtype).eps)
    bound = np.sqrt(eps) if nu > 2 else eps if nu > 1 else 1e-6
    return np.concatenate([[0.0, bound * (1 - 1e-6), bound * (1 + 1e-6), 1e-3, 0.1],
                           np.abs(rng.standard_normal(20)) * 4.0]).astype(dtype)


@pytest.mark.parametrize("nu", MATERN_NUS)
def test_matern_profile_matches_reference(nu, rng):
    """Matern(nu).profile against cfjax's in float64 and float32, and the
    value spec's plain evaluator against the profile. At s = 0 and nu <= 1
    cfjax's quadrature takes log 0 and returns 0; the port returns the
    limit 1, as the guard does for nu > 1."""
    for dtype, rtol in ((np.float64, RTOL), (np.float32, 1e-5)):
        s = _matern_args(nu, rng, dtype)
        ref = np.asarray(jk.Matern(nu).profile(jnp.asarray(s)))
        out = tk.Matern(nu).profile(torch.tensor(s)).numpy()
        assert out.dtype == dtype
        assert out[0] == 1.0 and ref[0] == (0.0 if nu <= 1 else 1.0)
        np.testing.assert_allclose(out[1:], ref[1:], rtol=rtol)
    spec, why = to_spec(tk.Matern(nu))
    assert why is None
    np.testing.assert_allclose(spec.evaluate(torch.tensor(s)).numpy(), out, rtol=RTOL)


@pytest.mark.parametrize("nu", [1.5, 2.3, 2.5, 3.7])
def test_matern_jet_matches_reference(nu, rng):
    """The derivative spec's plain jet against cfjax's profile through
    jax.jvp twice: the Taylor branch below the bound (f'' = 0 for
    1 < nu <= 2, as cfjax's), the closed form above it."""
    import jax

    kj = jk.Matern(nu)
    eps = np.finfo(np.float64).eps
    bound = np.sqrt(eps) if nu > 2 else eps
    s = np.concatenate([[0.0, 0.5 * bound, 1e-3, 0.1], np.abs(rng.standard_normal(10)) * 4.0])

    def jet(t):
        d1 = lambda u: jax.jvp(kj.profile, (u,), (1.0,))[1]
        return kj.profile(t), d1(t), jax.jvp(d1, (t,), (1.0,))[1]

    ref = [np.asarray(jax.vmap(lambda t, i=i: jet(t)[i])(jnp.asarray(s))) for i in range(3)]
    spec, why = to_spec(tk.Matern(nu), derivative=True)
    assert why is None and spec.jet
    out = [v.numpy() for v in spec.evaluate_jet(torch.tensor(s))]
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o, r, rtol=1e-8, atol=1e-12)
    if nu <= 2:
        assert out[2][0] == 0.0


@pytest.mark.parametrize("p", [0, 1, 2, 3])
def test_matern_half_integer_is_maternp(p):
    """Matern(p + 1/2) is MaternP(p): the quadrature from s = 1e-3 (below,
    it loses accuracy: tests/test_torch_besselk.py), the kernels' method
    (`matern_nu_reference`) from 0."""
    from cfjax_torch.utils.besselk import matern_nu_reference

    s = torch.tensor(np.concatenate([np.logspace(-3, 1.5, 40)]))
    np.testing.assert_allclose(tk.Matern(p + 0.5).profile(s).numpy(),
                               tk.MaternP(p).profile(s).numpy(), rtol=1e-9)
    s0 = torch.tensor(np.concatenate([[0.0, 1e-14, 1e-9], np.logspace(-6, 2, 40)]))
    np.testing.assert_allclose(matern_nu_reference(p + 0.5, s0)[0].numpy(),
                               tk.MaternP(p).profile(s0).numpy(), rtol=1e-12)


def test_matern_specs_and_decline():
    from cfjax_torch.kernels import profile_spec as ps
    from cfjax_torch.utils.besselk import matern_nu_table

    k = tk.Lengthscale(tk.Matern(2.3), 0.8)
    spec, _ = to_spec(k)
    # the program for K2, K3 and composites, and K1's tabulated family
    assert spec.ops[-1] == ps.MATERN_NU and spec.family == ps.FAMILY_MATERN_NU
    off = spec.args[-1]
    assert spec.consts[off:off + 16] == matern_nu_table(2.3, False)
    dspec, _ = to_spec(k, derivative=True)
    assert dspec.ops[-1] == ps.MATERN_NU_JET and dspec.jet
    assert dspec.consts[dspec.args[-1]:] == matern_nu_table(2.3, True)
    for nu in (0.5, 1.0):
        spec, why = to_spec(tk.Matern(nu), derivative=True)
        assert spec is None and "nu <= 1" in why
        assert to_spec(tk.Matern(nu))[0] is not None
    # four Materns fit the constant table; a fifth does not
    matern_sum = lambda m: functools.reduce(operator.add, [tk.Matern(1.3 + i) for i in range(m)])
    assert to_spec(matern_sum(4))[0] is not None
    assert "too long" in to_spec(matern_sum(5))[1]


def test_matern_parameters_similar_and_reference(rng):
    kj = jk.Lengthscale(jk.Matern(2.3), 0.8)
    kt = tk.from_reference(kj)
    np.testing.assert_array_equal(tk.parameters(kt).numpy(), np.asarray(jk.parameters(kj)))
    kt2 = tk.similar(kt, torch.tensor([3.7, 1.2], dtype=torch.float64))
    assert float(kt2.k.nu) == 3.7 and float(kt2.l) == 1.2
    x, y = _x(rng, 6, 3), _x(rng, 5, 3)
    ref = np.asarray(j_pairwise(jk.similar(kj, jnp.asarray([3.7, 1.2])), jnp.asarray(x),
                                jnp.asarray(y)))
    np.testing.assert_allclose(t_pairwise(kt2, torch.tensor(x), torch.tensor(y)).numpy(), ref,
                               rtol=RTOL)


def test_matern_gramian_mvms_match_reference(rng):
    """gramian(Lengthscale(Matern(2.3), 0.8), x) @ a and the gradient
    gramian's MVM (GradientKernel) against cfjax: both plain on the CPU,
    the same quadrature in float64."""
    from cfjax.derivative import GradientKernel as JGrad
    from cfjax.operators.dispatch import gramian as j_gramian
    from cfjax_torch.derivative import GradientKernel as TGrad
    from cfjax_torch.operators.dispatch import gramian as t_gramian

    x = _x(rng, 40, 3)
    a, A = rng.standard_normal(40), rng.standard_normal(40 * 3)
    kj, kt = jk.Lengthscale(jk.Matern(2.3), 0.8), tk.Lengthscale(tk.Matern(2.3), 0.8)
    np.testing.assert_allclose((t_gramian(kt, torch.tensor(x)) @ torch.tensor(a)).numpy(),
                               np.asarray(j_gramian(kj, jnp.asarray(x)) @ jnp.asarray(a)),
                               rtol=1e-11)
    for nu in (2.7, 1.5):
        gj = j_gramian(JGrad(jk.Matern(nu)), jnp.asarray(x))
        gt = t_gramian(TGrad(tk.Matern(nu)), torch.tensor(x))
        np.testing.assert_allclose((gt @ torch.tensor(A)).numpy(), np.asarray(gj @ jnp.asarray(A)),
                                   rtol=1e-10)


def test_matern_log_marginal_likelihood_and_gradient(rng):
    """The Cholesky logML of Lengthscale(Matern(nu), l) and its gradient in
    (l, nu) against jax.grad."""
    import jax

    from cfjax.gp import log_marginal_likelihood as j_lml
    from cfjax_torch.gp import log_marginal_likelihood as t_lml

    x = _x(rng, 30, 2)
    y = np.sin(x[:, 0]) + 0.1 * rng.standard_normal(30)

    def lj(th):
        return j_lml(jk.Lengthscale(jk.Matern(th[1]), th[0]), jnp.asarray(x), jnp.asarray(y),
                     noise=1e-2)

    th0 = np.array([0.9, 2.3])
    vj, gj = jax.value_and_grad(lj)(jnp.asarray(th0))
    th = torch.tensor(th0, requires_grad=True)
    vt = t_lml(tk.Lengthscale(tk.Matern(th[1]), th[0]), torch.tensor(x), torch.tensor(y),
               noise=1e-2)
    (gt,) = torch.autograd.grad(vt, th)
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-11)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-8)


def test_property_probes_match_reference():
    """The four probes, on the kernels cfjax's tests probe, and on Matern."""
    from cfjax.utils import testing as jt
    from cfjax_torch.utils import testing as tt

    cases = [(jk.EQ(), tk.EQ()), (jk.Cosine(jnp.ones(3)), tk.Cosine(np.ones(3))),
             (jk.Cosine(jnp.asarray([1.0, 2.0, 0.5])), tk.Cosine(np.array([1.0, 2.0, 0.5]))),
             (jk.Dot(), tk.Dot()), (jk.Matern(2.3), tk.Matern(2.3))]
    for kj, kt in cases:
        assert tt.isstationary_probe(kt) == jt.isstationary_probe(kj)
        assert tt.isisotropic_probe(kt) == jt.isisotropic_probe(kj)
    assert [tt.isstationary_probe(kt) for _, kt in cases] == [True, True, True, False, True]
    assert [tt.isisotropic_probe(kt) for _, kt in cases] == [True, False, False, False, True]
    x = np.random.default_rng(3).standard_normal((12, 2))
    K = t_pairwise(tk.Matern(0.7), torch.tensor(x))
    assert tt.iscov(K) == jt.iscov(np.asarray(j_pairwise(jk.EQ(), jnp.asarray(x)))) is True
    assert tt.ispsd(K.numpy()) and not tt.ispsd(-K) and not tt.iscov(K + torch.triu(K, 1))
