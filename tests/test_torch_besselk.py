"""Parity of the port's modified Bessel K (`cfjax_torch/utils/besselk.py`)
with cfjax's on the CPU (x64, float64 in both packages), and the
kernels' method for K_nu in float64 (`matern_nu_reference`: Temme's
series, Steed's continued fraction and the order recurrence, the code of
`csrc/profile_spec.cuh` `matern_nu`) against scipy.

The quadrature is cfjax's algorithm, so the two packages agree to
rounding (1e-10); both agree with scipy to cfjax's own test tolerance
(rtol 1e-8, `tests/test_kernels.py`) on x in [0.01, 30]."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

from cfjax.utils.besselk import besselk as j_besselk
from cfjax.utils.besselk import besselkxv as j_besselkxv
from cfjax_torch.utils.besselk import besselk, besselkxv, matern_nu_reference, matern_nu_table

F64 = torch.float64
NUS = [0.3, 1.0, 1.5, 2.7, 5.5]


def _matern_jet_scipy(nu, s):
    """(f, f', f'') of the Matern profile at s > 0 from scipy.special.kv."""
    r = np.sqrt(2 * nu * s)
    c = math.exp((1 - nu) * math.log(2) - scipy.special.gammaln(nu))
    return (c * r ** nu * scipy.special.kv(nu, r),
            -c * nu * r ** (nu - 1) * scipy.special.kv(nu - 1, r),
            c * nu ** 2 * r ** (nu - 2) * scipy.special.kv(abs(nu - 2), r))


@pytest.mark.parametrize("nu", NUS)
def test_besselk_matches_cfjax_and_scipy(rng, nu):
    x = rng.uniform(0.01, 30.0, 40)
    ours = besselk(nu, torch.tensor(x)).numpy()
    np.testing.assert_allclose(ours, np.asarray(j_besselk(nu, jnp.asarray(x))), rtol=1e-10)
    np.testing.assert_allclose(ours, scipy.special.kv(nu, x), rtol=1e-8)
    np.testing.assert_allclose(besselkxv(nu, torch.tensor(x)).numpy(),
                               np.asarray(j_besselkxv(nu, jnp.asarray(x))), rtol=1e-10)


@pytest.mark.parametrize("nu, x", [(0.3, 0.05), (1.3, 2.0), (2.7, 7.5), (10.2, 15.0)])
def test_besselkxv_gradients_match_jax(nu, x):
    gj = jax.grad(lambda n, z: j_besselkxv(n, z), argnums=(0, 1))(nu, x)
    n = torch.tensor(nu, dtype=F64, requires_grad=True)
    z = torch.tensor(x, dtype=F64, requires_grad=True)
    gt = torch.autograd.grad(besselkxv(n, z), (n, z))
    np.testing.assert_allclose([float(g) for g in gt], [float(g) for g in gj], rtol=1e-8)


def test_besselkxv_dtype_and_broadcast():
    x32 = torch.linspace(0.5, 4.0, 5)
    assert besselkxv(1.3, x32).dtype == torch.float32
    out = besselkxv(torch.tensor([[0.5], [2.5]], dtype=F64), torch.tensor([1.0, 2.0], dtype=F64))
    assert out.shape == (2, 2)
    np.testing.assert_allclose(out.numpy()[1, 0], scipy.special.kv(2.5, 1.0), rtol=1e-8)


@pytest.mark.parametrize("nu", [0.3, 0.5, 0.7, 1.0, 1.3, 1.5, 2.0, 2.3, 2.5, 2.7, 3.7, 10.2, 25.0])
def test_kernels_method_matches_scipy(nu):
    """matern_nu_reference (the kernels' method in float64) against scipy
    from s = 1e-12 to the point where the profile leaves float64's range:
    the value, and the jet's f' and f'' for nu > 1 above the Taylor
    guard's bound (below it both follow the guard's polynomial)."""
    s = np.logspace(-12, 4, 300)
    f, f1, f2 = (t.numpy() for t in matern_nu_reference(nu, torch.tensor(s)))
    with np.errstate(all="ignore"):
        ref = _matern_jet_scipy(nu, s)
    live = np.isfinite(ref[2]) & (ref[0] > 1e-280)
    bound = math.sqrt(np.finfo(np.float64).eps) if nu > 2 else np.finfo(np.float64).eps
    np.testing.assert_allclose(f[live], ref[0][live], rtol=1e-12)
    if nu > 1:
        closed = live & (s >= bound)
        np.testing.assert_allclose(f1[closed], ref[1][closed], rtol=1e-12)
        np.testing.assert_allclose(f2[closed], ref[2][closed], rtol=1e-12)


@pytest.mark.parametrize("nu", [0.3, 0.7, 1.0])
def test_kernels_method_is_one_at_zero(nu):
    f = matern_nu_reference(nu, torch.tensor([0.0, 1e-300], dtype=F64))[0].numpy()
    np.testing.assert_allclose(f, 1.0, rtol=1e-14)


def test_quadrature_loses_accuracy_at_small_x():
    """cfjax's quadrature, kept as it is in the port: against scipy it
    misses by more than 1e-7 below x ~ 1e-3 at nu = 0.5, and by more than
    10% at nu = 25, x = 1e-3, where the kernels' method holds 1e-12."""
    x = np.array([1e-6, 1e-3])
    for nu, worst in ((0.5, 1e-7), (25.0, 0.1)):
        ours = besselkxv(nu, torch.tensor(x)).numpy()
        ref = x ** nu * scipy.special.kv(nu, x)
        assert np.abs(ours / ref - 1).max() > worst
        s = torch.tensor(x * x / (2 * nu))
        c = math.exp((1 - nu) * math.log(2) - scipy.special.gammaln(nu))
        np.testing.assert_allclose(matern_nu_reference(nu, s)[0].numpy(), c * ref, rtol=1e-12)


@pytest.mark.parametrize("nu, jet, l, flip, n", [
    (0.3, False, 0.3, 0.0, 0.0), (0.7, False, -0.3, 0.0, 1.0), (1.3, False, 0.3, 0.0, 1.0),
    (1.3, True, -0.3, 1.0, 1.0), (1.5, True, -0.5, 0.0, 2.0), (2.5, True, -0.5, 0.0, 3.0),
    (25.0, False, 0.0, 0.0, 25.0)])
def test_matern_nu_table(nu, jet, l, flip, n):
    t = matern_nu_table(nu, jet)
    assert len(t) == 16
    assert (t[0], t[8], t[9]) == (nu, flip, n)
    assert t[7] == pytest.approx(l, abs=1e-14)
    assert t[1] + t[15] == pytest.approx(math.sqrt(2 * nu), rel=1e-15)
    assert t[1] == float(np.float32(t[1]))
    c = 2.0 ** (1 - nu) / math.gamma(nu)
    assert 0.5 <= t[2] < 1 and t[2] * 2.0 ** t[3] == pytest.approx(c, rel=1e-13)
    gp, gm = 1 / math.gamma(1 + t[7]), 1 / math.gamma(1 - t[7])
    assert (t[12], t[13]) == pytest.approx((gp, gm), rel=1e-15)
    assert t[11] == pytest.approx((gp + gm) / 2, rel=1e-15)
    assert t[10] == pytest.approx(-0.5772156649015329 if t[7] == 0 else (gm - gp) / (2 * t[7]),
                                  rel=1e-9)


def test_kv_terms_follow_the_series_and_the_fraction():
    """The terms the kernels' K_nu routine runs: Temme's series needs more
    as x grows to 2, Steed's fraction fewer as x grows past it."""
    from cfjax_torch.utils.besselk import kv_terms

    x = torch.tensor([1e-6, 0.1, 1.0, 2.0, 2.5, 10.0, 100.0], dtype=F64)
    terms, temme = kv_terms(2.3, x)
    assert temme.tolist() == [True, True, True, True, False, False, False]
    t = terms.tolist()
    assert all(v == int(v) and 1 <= v < 40 for v in t)
    assert t[0] <= t[1] <= t[2] <= t[3] and t[4] >= t[5] >= t[6]
