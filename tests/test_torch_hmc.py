"""Parity of the port's samplers (`cfjax_torch/gp/hmc.py`) with cfjax's on
the CPU (x64, float64 in both packages).

The two packages draw from different generators. `hmc_sample` and
`nuts_sample` draw through one helper per kind of draw (`_normal`,
`_uniform`, `_direction`), which the tests replace with cfjax's own draws,
derived from its key as cfjax derives them: the chains then agree sample
for sample. `nuts_sample_host` draws from `np.random.default_rng(seed)`;
given the seed cfjax derives from its key, its stream is cfjax's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfjax.kernels as jk
import cfjax_torch
import cfjax_torch.kernels as tk
from cfjax.gp import hmc as j_hmc
from cfjax.gp import log_marginal_likelihood as j_lml
from cfjax.utils.testing import pairwise as j_pairwise
from cfjax_torch.gp import hmc as t_hmc
from cfjax_torch.gp import log_marginal_likelihood as t_lml

torch.set_num_threads(2)
COV = np.array([[1.0, 0.8], [0.8, 2.0]])
PREC = np.linalg.inv(COV)


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """Input without a device goes to the CPU in this module's tests; the
    configured device is restored after them."""
    shipped = cfjax_torch.config.DEFAULT.device
    cfjax_torch.set_config(device="cpu")
    yield
    cfjax_torch.set_config(device=shipped)


def _gaussian():
    P = torch.tensor(PREC)
    return (lambda th: -0.5 * th @ (jnp.asarray(PREC) @ th),
            lambda th: -0.5 * th @ (P @ th))


def _logml_target(rng):
    """cfjax's test_nuts_through_logml target: EQ with lengthscale exp(theta),
    n = 48, a Cholesky logML and a standard normal prior."""
    n = 48
    x = rng.standard_normal((n, 2))
    K = np.asarray(j_pairwise(jk.Lengthscale(jk.EQ(), 0.7), jnp.asarray(x),
                              jnp.asarray(x))) + 0.01 * np.eye(n)
    y = np.linalg.cholesky(K) @ rng.standard_normal(n)
    xj, yj, xt, yt = jnp.asarray(x), jnp.asarray(y), torch.tensor(x), torch.tensor(y)

    def lj(th):
        k = jk.Lengthscale(jk.EQ(), jnp.exp(th[0]))
        return j_lml(k, xj, yj, noise=0.01) - 0.5 * th[0] ** 2

    def lt(th):
        k = tk.Lengthscale(tk.EQ(), torch.exp(th[0]))
        return t_lml(k, xt, yt, noise=0.01) - 0.5 * th[0] ** 2

    return lj, lt


class CfjaxDraws:
    """cfjax's draws, from its key, handed out in the order the port asks
    for them: per transition a momentum (the key's first half); per
    doubling the direction bit and, from the doubling's split, one Gumbel
    uniform per leaf (on [1e-12, 1)) and the progressive-sampling uniform
    (on [1e-38, 1)); HMC's uniform from the step key's second half."""

    def __init__(self, key, total):
        self.keys = list(jax.random.split(key, total))
        self.step = -1

    def install(self, monkeypatch):
        monkeypatch.setattr(t_hmc, "_normal", self.normal)
        monkeypatch.setattr(t_hmc, "_uniform", self.uniform)
        monkeypatch.setattr(t_hmc, "_direction", self.direction)

    def normal(self, generator, dim):
        self.step += 1
        kp, self.kt = jax.random.split(self.keys[self.step])
        return torch.tensor(np.asarray(jax.random.normal(kp, (dim,))))

    def direction(self, generator):
        self.kt, kd, self.ks, self.kc = jax.random.split(self.kt, 4)
        return bool(jax.random.bernoulli(kd))

    def uniform(self, generator, low=0.0):
        if low == 0.0:   # HMC's accept draw
            return float(jax.random.uniform(self.kt))
        if low == 1e-12:
            self.ks, ku = jax.random.split(self.ks)
            return float(jax.random.uniform(ku, (), minval=1e-12, maxval=1.0))
        return float(jax.random.uniform(self.kc, (), minval=1e-38))


def test_hmc_matches_reference_draw_for_draw(monkeypatch):
    lj, lt = _gaussian()
    key, ns, nw = jax.random.PRNGKey(0), 15, 15
    sj, aj = j_hmc.hmc_sample(lj, jnp.zeros(2), key, num_samples=ns, num_warmup=nw,
                              num_leapfrog=8)
    CfjaxDraws(key, ns + nw).install(monkeypatch)
    st, at = t_hmc.hmc_sample(lt, torch.zeros(2), None, num_samples=ns, num_warmup=nw,
                              num_leapfrog=8)
    assert st.dtype == torch.float64 and st.shape == (ns, 2)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=1e-10)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-10)


def test_hmc_gaussian_moments(monkeypatch):
    """cfjax's test_hmc_smoke, its sizes, tolerances and draws (PRNGKey(0)):
    plain HMC's fixed trajectory length mixes well at some step sizes and
    poorly at others, so its moments depend on the draws more than NUTS's."""
    cov = torch.tensor([[1.0, 0.5], [0.5, 2.0]], dtype=torch.float64)
    prec = torch.linalg.inv(cov)
    CfjaxDraws(jax.random.PRNGKey(0), 3500).install(monkeypatch)
    s, acc = t_hmc.hmc_sample(lambda th: -0.5 * th @ (prec @ th), torch.zeros(2), None,
                              num_samples=3000, num_warmup=500, num_leapfrog=16)
    assert float(acc) > 0.5
    s = s.numpy()
    assert np.all(np.abs(s.mean(0)) < 0.3)
    np.testing.assert_allclose(np.diag(np.cov(s.T)), np.diag(cov.numpy()), rtol=0.4)


@pytest.mark.parametrize("target", ["gaussian", "logml"])
def test_nuts_matches_reference_draw_for_draw(monkeypatch, rng, target):
    lj, lt = _gaussian() if target == "gaussian" else _logml_target(rng)
    dim = 2 if target == "gaussian" else 1
    key, ns, nw = jax.random.PRNGKey(3), 12, 12
    sj, aj = j_hmc.nuts_sample(lj, jnp.zeros(dim), key, num_samples=ns, num_warmup=nw,
                               max_tree_depth=5)
    CfjaxDraws(key, ns + nw).install(monkeypatch)
    st, at = t_hmc.nuts_sample(lt, torch.zeros(dim), None, num_samples=ns, num_warmup=nw,
                               max_tree_depth=5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=1e-10)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-10)


def test_nuts_gaussian_moments():
    """cfjax's test_nuts_gaussian, at its sizes and tolerances, on the
    port's own generator."""
    _, lt = _gaussian()
    s, astat = t_hmc.nuts_sample(lt, torch.zeros(2), torch.Generator().manual_seed(3),
                                 num_samples=4000, num_warmup=600, max_tree_depth=8)
    assert 0.5 < float(astat) <= 1.0
    s = s.numpy()
    assert np.all(np.abs(s.mean(0)) < 0.25)
    np.testing.assert_allclose(np.cov(s.T), COV, rtol=0.35, atol=0.15)


@pytest.mark.parametrize("target", ["gaussian", "logml"])
def test_nuts_host_matches_reference_sample_for_sample(rng, target):
    lj, lt = _gaussian() if target == "gaussian" else _logml_target(rng)
    dim = 2 if target == "gaussian" else 1
    key = jax.random.PRNGKey(0)
    ns, nw = (60, 40) if target == "gaussian" else (12, 8)
    sj, aj = j_hmc.nuts_sample_host(lj, jnp.zeros(dim), key, num_samples=ns,
                                    num_warmup=nw, max_tree_depth=6)
    seed = int(jax.random.randint(key, (), 0, 2 ** 31 - 1))
    st, at = t_hmc.nuts_sample_host(lt, torch.zeros(dim), seed, num_samples=ns,
                                    num_warmup=nw, max_tree_depth=6)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=1e-10)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-10)


def test_samplers_are_exported():
    import cfjax_torch.gp as gp

    assert gp.hmc_sample is t_hmc.hmc_sample and gp.nuts_sample is t_hmc.nuts_sample
    assert callable(t_hmc.nuts_sample_host)
