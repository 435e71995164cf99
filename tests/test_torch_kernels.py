"""Parity of the port's kernel zoo (cfjax_torch.kernels) with cfjax.

The same numpy inputs go to both packages: cfjax in x64 on the CPU
(tests/conftest.py), the port in float64. Kernel entries, profiles and
profile specs agree to rtol 1e-12 — both evaluate the same float64
formulas, so only the last bits of exp/pow/rsqrt may differ."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfjax.kernels as jk
import cfjax_torch.kernels as tk
from cfjax.utils.testing import pairwise as j_pairwise
from cfjax_torch.kernels.profile_spec import to_spec
from cfjax_torch.utils.testing import pairwise as t_pairwise

torch.set_num_threads(2)

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
    with pytest.raises(NotImplementedError, match="besselk"):
        tk.Matern(1.5)
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
    assert jf - tf == {"cg_chunk_iters", "cg_chunk_min_n"} and tf <= jf
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
