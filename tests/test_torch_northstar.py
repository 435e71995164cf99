"""The port's north-star demo (`cfjax_torch/examples/northstar_demo.py`)
against cfjax's (`examples/northstar_demo.py`) on the CPU, float64.

cfjax's demo is one function, so its stages are written out here as it
runs them (its lines 57-70 and 157-199) on the same numpy draws. At fixed
(l, v), the "weights" carried from the chain to the solve:
  * `synthesize` draws x, the noise, the subset and the probe rows bit for
    bit as cfjax does; y differs only by the two libraries' sin and cos
    (<= 2 ulp);
  * `solve` (rank-1024 Nystrom PCG) agrees with cfjax's
    `nystrom_preconditioner` + `cg` to 1e-6 relative, and both meet CG's
    tolerance (1e-4) against the dense system and agree with its solution
    to 1e-5;
  * on the same alpha, `posterior_mean` (Barnes-Hut, theta 1/2, fixed
    centers) agrees with cfjax's `matvec_linear` to 1e-10, `exact_mean`
    with cfjax's Gramian MVM to 1e-10, and the RMSEs to 1e-8; each
    pipeline on its own alpha gives the same RMSEs to 1e-5 (the alphas
    agree to 1e-6 and K alpha cancels thousands of times);
  * through Barnes-Hut both miss the true field by more than the noise,
    where the exact mean does not: alpha cancels in K alpha (the demo's
    docstring).
`main(512, quick=True, device="cpu")` runs the whole pipeline (its chain
included) to an RMSE below the noise, and `full_n_checks` runs the slq
path at a lowered max_cholesky_size."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfjax_torch
from cfjax.barneshut import BarnesHutFactorization as JBarnesHut
from cfjax.kernels import EQ as JEQ
from cfjax.kernels import Lengthscale as JLengthscale
from cfjax.operators import cg as j_cg
from cfjax.operators import gramian as j_gramian
from cfjax.operators import nystrom_preconditioner as j_nystrom
from cfjax_torch.examples import northstar_demo as demo

torch.set_num_threads(2)
F64 = torch.float64
N = 4096
L_HAT, V_HAT = 2.0, 0.8


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """Input without a device goes to the CPU in this module's tests; the
    configured device is restored after them."""
    shipped = cfjax_torch.config.DEFAULT.device
    cfjax_torch.set_config(device="cpu")
    yield
    cfjax_torch.set_config(device=shipped)


def cfjax_draws(n):
    """cfjax's demo data (examples/northstar_demo.py:57-70 and :194), in
    float64: x, y, the subset and the probe rows."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.uniform(-10, 10, (n, 2)), dtype=jnp.float64)
    f_true = lambda p: jnp.sin(p[:, 0]) * jnp.cos(0.5 * p[:, 1])
    y = f_true(x) + 0.1 * jnp.asarray(rng.standard_normal(n), dtype=jnp.float64)
    m = 4096 if n >= 4096 else n
    sub = rng.choice(n, m, replace=False)
    probe = rng.choice(n, 4096, replace=False)
    return x, y, sub, probe


@pytest.fixture(scope="module")
def pipelines():
    """Both packages' solve and Barnes-Hut mean at n = 4096, fixed (l, v)."""
    x, y, sub, probe = demo.synthesize(N, dtype=F64)
    sol = demo.solve(x, y, L_HAT, V_HAT)
    pm = demo.posterior_mean(sol["k"], x, sol["alpha"], V_HAT)
    exact, _ = demo.exact_mean(sol["G"], sol["alpha"], V_HAT)

    xj, yj, _, probe_j = cfjax_draws(N)
    k = JLengthscale(JEQ(), L_HAT)
    G = j_gramian(k, xj)
    M = j_nystrom(k, xj, 0.01 / V_HAT, rank=1024)
    alpha, (iters, _) = j_cg(lambda v: V_HAT * G._matvec(v) + 0.01 * v, yj, tol=1e-4,
                             maxiter=100, M=lambda v: M(v) / V_HAT)
    F = JBarnesHut(k, xj, theta=0.5)
    f_true = lambda p: jnp.sin(p[:, 0]) * jnp.cos(0.5 * p[:, 1])
    rmse = lambda m: float(jnp.sqrt(jnp.mean((m[probe_j] - f_true(xj)[probe_j]) ** 2)))
    means = {}
    for which, a in (("own", alpha), ("same", jnp.asarray(sol["alpha"].numpy()))):
        bh, ex = V_HAT * F.matvec_linear(a), V_HAT * G._matvec(a)
        means[which] = dict(bh=np.asarray(bh), exact=np.asarray(ex), rmse_bh=rmse(bh),
                            rmse_exact=rmse(ex))
    return dict(port=dict(x=x, y=y, probe=probe, sol=sol, bh=pm["mean"], exact=exact),
                cfjax=dict(alpha=np.asarray(alpha), iters=int(iters), K=np.asarray(G.todense()),
                           **means))


@pytest.mark.parametrize("n", [512, 5000])
def test_synthesize_draws_cfjax_data(n):
    x, y, sub, probe = demo.synthesize(n, dtype=F64)
    rng = np.random.default_rng(0)
    xs, eps = rng.uniform(-10, 10, (n, 2)), rng.standard_normal(n)
    assert np.array_equal(x.numpy(), xs)
    assert np.array_equal(sub.numpy(), rng.choice(n, min(4096, n), replace=False))
    assert np.array_equal(probe.numpy(), rng.choice(n, min(4096, n), replace=False))
    if n >= 4096:
        xj, yj, sub_j, probe_j = cfjax_draws(n)
        assert np.array_equal(x.numpy(), np.asarray(xj))
        assert np.array_equal(sub.numpy(), sub_j) and np.array_equal(probe.numpy(), probe_j)
        np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=0, atol=4.5e-16)
    x32, y32, _, _ = demo.synthesize(n)
    assert x32.dtype == torch.float32 and np.array_equal(x32.numpy(), xs.astype(np.float32))
    assert y32.dtype == torch.float32


def test_solve_matches_cfjax_and_the_dense_system(pipelines):
    port, ref = pipelines["port"], pipelines["cfjax"]
    a, aj = port["sol"]["alpha"].numpy(), ref["alpha"]
    assert port["sol"]["iters"] == ref["iters"]
    assert np.linalg.norm(a - aj) / np.linalg.norm(aj) <= 1e-6
    A = V_HAT * ref["K"] + 0.01 * np.eye(N)
    y = port["y"].numpy()
    dense = np.linalg.solve(A, y)
    for sol in (a, aj):
        assert np.linalg.norm(A @ sol - y) / np.linalg.norm(y) <= 1e-4
        assert np.linalg.norm(sol - dense) / np.linalg.norm(dense) <= 1e-5


@pytest.mark.parametrize("which,tol", [("same", 1e-8), ("own", 1e-5)])
def test_posterior_mean_and_rmse_match_cfjax(pipelines, which, tol):
    """On the same alpha: the means to 1e-10, the RMSEs to 1e-8. On each
    package's own alpha: the RMSEs to 1e-5."""
    port, ref = pipelines["port"], pipelines["cfjax"][which]
    if which == "same":
        for key in ("bh", "exact"):
            assert np.linalg.norm(port[key].numpy() - ref[key]) \
                / np.linalg.norm(ref[key]) <= 1e-10
    x, probe = port["x"], port["probe"]
    assert demo.rmse(port["bh"], x, probe) == pytest.approx(ref["rmse_bh"], rel=tol)
    assert demo.rmse(port["exact"], x, probe) == pytest.approx(ref["rmse_exact"], rel=tol)


def test_barnes_hut_mean_misses_where_the_exact_mean_does_not(pipelines):
    """alpha cancels in K alpha: the treecode's error, small against
    K |alpha|, is several times the noise against the mean, in both
    packages; the exact mean is within a fraction of the noise."""
    port, ref = pipelines["port"], pipelines["cfjax"]
    K, alpha = ref["K"], port["sol"]["alpha"].numpy()
    mag = V_HAT * K @ np.abs(alpha)
    exact = port["exact"].numpy()
    assert np.linalg.norm(mag) > 1000 * np.linalg.norm(exact)
    assert np.linalg.norm(port["bh"].numpy() - exact) <= 1e-2 * np.linalg.norm(mag)
    own = ref["own"]
    assert min(own["rmse_bh"], demo.rmse(port["bh"], port["x"], port["probe"])) > demo.NOISE
    assert max(own["rmse_exact"], demo.rmse(port["exact"], port["x"], port["probe"])) \
        < 0.5 * demo.NOISE


def test_main_quick_runs_end_to_end_on_the_cpu():
    rmse, walls, parts = demo.main(512, quick=True, device="cpu")
    assert rmse < demo.NOISE and np.isfinite(parts["rmse_bh"])
    assert set(walls) == {"setup_s", "chain_s", "nystrom_s", "pcg_s", "bh_build_s",
                          "bh_plan_s", "bh_mvm_s", "exact_mvm_s"}
    assert all(t > 0 for t in walls.values())
    chain = parts["chain"]
    assert chain["samples"].shape == (24, 2) and 0.5 <= chain["astat"] <= 1.0
    assert parts["full"] is None and parts["mean"].device.type == "cpu"


def test_full_n_checks_run_the_slq_path():
    """At n = 256 above a lowered max_cholesky_size the full-n checks take
    the slq logML: a finite value and gradient, then 8 finite samples of the
    host chain drawn from cfjax's seed."""
    x, y, _, _ = demo.synthesize(256, dtype=F64)
    cfjax_torch.set_config(max_cholesky_size=64)
    try:
        out = demo.full_n_checks(x, y, L_HAT, V_HAT)
    finally:
        cfjax_torch.set_config(max_cholesky_size=cfjax_torch.config.Config.max_cholesky_size)
    assert np.isfinite(out["value"]) and bool(torch.isfinite(out["grad"]).all())
    assert out["samples"].shape == (8, 2) and bool(torch.isfinite(out["samples"]).all())
    assert 0.0 <= out["astat"] <= 1.0


def test_host_seed_is_the_one_cfjax_derives_from_its_key():
    """cfjax's nuts_sample_host draws from the seed it derives from
    PRNGKey(3) (int32, as with 64-bit mode off)."""
    key = jax.random.PRNGKey(3)
    assert demo.HOST_SEED == int(jax.random.randint(key, (), 0, 2 ** 31 - 1, dtype=jnp.int32))
