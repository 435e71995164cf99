"""Parity of the port's solvers and GP conditioning with cfjax on the CPU
(float64 in both packages, n = 500, d = 3).

Cholesky regime: the two packages run the same dense factorization, so
alpha and the posterior mean agree to rtol 1e-9 and the log marginal
likelihood to rtol 1e-10. Nystrom-PCG regime (max_cholesky_size = 128 in
both configs): the preconditioners agree only to the float32 rounding of
their r x r factors, so alpha and the mean agree to 1e-6 and the CG
iteration counts to +-1."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfjax
import cfjax.kernels as jk
import cfjax_torch
import cfjax_torch.kernels as tk
from cfjax.gp import gp_condition as j_condition
from cfjax.gp import log_marginal_likelihood as j_lml
from cfjax.operators.dispatch import explain as j_explain
from cfjax.operators.dispatch import gramian as j_gramian
from cfjax.operators.preconditioner import nystrom_preconditioner as j_nystrom
from cfjax.operators.solvers import cg as j_cg
from cfjax.operators.solvers import factorize as j_factorize
from cfjax_torch.gp import gp_condition as t_condition
from cfjax_torch.gp import log_marginal_likelihood as t_lml
from cfjax_torch.operators import (CholeskyFactorization, LowRankFactorization, cg,
                                   factorize, solve, solve_with_info)
from cfjax_torch.operators import preconditioner as pre
from cfjax_torch.operators.dispatch import explain as t_explain
from cfjax_torch.operators.dispatch import gramian as t_gramian
from cfjax_torch.operators.preconditioner import nystrom_preconditioner as t_nystrom
from cfjax_torch.utils import trace

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """Input without a device goes to the CPU in this module's tests; the
    configured device is restored after them."""
    shipped = cfjax_torch.config.DEFAULT.device
    cfjax_torch.set_config(device="cpu")
    yield
    cfjax_torch.set_config(device=shipped)


N, D, NOISE = 500, 3, 1e-2


@pytest.fixture
def problem(rng):
    x = rng.standard_normal((N, D))
    y = np.sin(x[:, 0]) + 0.1 * rng.standard_normal(N)
    xt = rng.standard_normal((40, D))
    return x, y, xt


@pytest.fixture
def small_cholesky_size():
    cfjax.set_config(max_cholesky_size=128)
    cfjax_torch.set_config(max_cholesky_size=128)
    yield
    cfjax.set_config(max_cholesky_size=cfjax.config.Config.max_cholesky_size)
    cfjax_torch.set_config(max_cholesky_size=cfjax_torch.config.Config.max_cholesky_size)


KERNELS = {"MaternP2": lambda: jk.MaternP(2),
           "LengthscaleEQ": lambda: jk.Lengthscale(jk.EQ(), 0.8),
           "SumWithDelta": lambda: jk.MaternP(1) + 0.5 * jk.RQ(2.0)}


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_gp_condition_cholesky_regime(name, problem):
    x, y, xt = problem
    kj = KERNELS[name]()
    kt = tk.from_reference(kj)
    pj = j_condition(kj, jnp.asarray(x), jnp.asarray(y), noise=NOISE)
    pt = t_condition(kt, torch.tensor(x), torch.tensor(y), noise=NOISE)
    np.testing.assert_allclose(pt.alpha.numpy(), np.asarray(pj.alpha), rtol=1e-9)
    np.testing.assert_allclose(pt.mean(torch.tensor(xt)).numpy(),
                               np.asarray(pj.mean(jnp.asarray(xt))), rtol=1e-9)
    np.testing.assert_allclose(float(t_lml(kt, torch.tensor(x), torch.tensor(y), NOISE)),
                               float(j_lml(kj, jnp.asarray(x), jnp.asarray(y), NOISE)),
                               rtol=1e-10)
    assert t_explain(kt, torch.tensor(x)).split(" | ")[0] == \
        j_explain(kj, jnp.asarray(x)).split(" | ")[0]


def test_lml_gradient_matches_reference(problem):
    x, y, _ = problem
    g_ref = jax.grad(lambda l: j_lml(jk.Lengthscale(jk.MaternP(2), l), jnp.asarray(x),
                                     jnp.asarray(y), NOISE))(0.9)
    k = tk.Lengthscale(tk.MaternP(2), 0.9)
    k.l.requires_grad_(True)
    (g,) = torch.autograd.grad(t_lml(k, torch.tensor(x), torch.tensor(y), NOISE), k.l)
    np.testing.assert_allclose(float(g), float(g_ref), rtol=1e-8)


@pytest.mark.parametrize("name", ["MaternP2", "LengthscaleEQ"])
def test_gp_condition_nystrom_pcg_regime(name, problem, small_cholesky_size):
    x, y, xt = problem
    kj = KERNELS[name]()
    kt = tk.from_reference(kj)
    pj = j_condition(kj, jnp.asarray(x), jnp.asarray(y), noise=NOISE, precond_rank=64, tol=1e-8)
    pt = t_condition(kt, torch.tensor(x), torch.tensor(y), noise=NOISE, precond_rank=64,
                     tol=1e-8)
    np.testing.assert_allclose(pt.alpha.numpy(), np.asarray(pj.alpha), atol=1e-6)
    np.testing.assert_allclose(pt.mean(torch.tensor(xt)).numpy(),
                               np.asarray(pj.mean(jnp.asarray(xt))), atol=1e-6)
    # cfjax's gp_condition does not return CG info: rerun its PCG
    Kj = j_gramian(kj, jnp.asarray(x)).add_diagonal(NOISE)
    _, (it_j, _) = j_cg(Kj._matvec, jnp.asarray(y), tol=1e-8,
                        M=j_nystrom(kj, jnp.asarray(x), NOISE, rank=64))
    assert abs(pt.solve_info[0] - int(it_j)) <= 1


def test_nystrom_apply_matches_reference(problem):
    x, y, _ = problem
    kj = jk.MaternP(2)
    Mj = j_nystrom(kj, jnp.asarray(x), NOISE, rank=64)
    Mt = t_nystrom(tk.from_reference(kj), torch.tensor(x), NOISE, rank=64)
    np.testing.assert_allclose(Mt(torch.tensor(y)).numpy(), np.asarray(Mj(jnp.asarray(y))),
                               rtol=1e-6)


BUILD_CASES = {"MaternP2_d3": (lambda l: tk.MaternP(2), 3),
               "LengthscaleMatern2.3": (lambda l: tk.Lengthscale(tk.Matern(2.3), 0.9), 3),
               "c*ARD_MaternP2_d90": (lambda l: 6.67 * tk.ARDKernel(tk.MaternP(2), l), 90),
               "ARD_Polynomial2_dot": (lambda l: tk.ARDKernel(tk.Polynomial(2, 1.0), l), 5)}


@pytest.mark.parametrize("name", sorted(BUILD_CASES))
def test_nystrom_build_reads_the_gramian(name, rng, small_cholesky_size, monkeypatch):
    """gp_condition builds its preconditioner from the operator it solves
    with: its factors are those of the public wrapper's build, bit for bit;
    U, E and denom are float32 on float32 points; and the points are
    divided by an ARD kernel's l once a solve (one `gramian.prescale` span
    under `gp.condition`, none without an ARD)."""
    make, d = BUILD_CASES[name]
    n = 300
    x = torch.tensor(rng.standard_normal((n, d)), dtype=torch.float32)
    y = torch.sin(x[:, 0])
    k = make(torch.tensor(rng.uniform(0.5, 2.0, d), dtype=torch.float32))
    built = []
    monkeypatch.setattr(pre, "nystrom_factors",
                        lambda *a, f=pre.nystrom_factors, **kw: built.append(f(*a, **kw))
                        or built[-1])
    trace.clear()
    with trace.recording():
        t_condition(k, x, y, noise=NOISE, tol=1e-4, maxiter=20)
    sp = trace.spans()
    trace.clear()
    (cond,) = [s for s in sp if s["name"] == "gp.condition"]
    prescales = [s for s in sp if s["name"] == "gramian.prescale"]
    assert len(prescales) == ("ARD" in name)
    assert all(s["root"] == cond["id"] and s["attrs"]["rows"] == n for s in prescales)
    t_nystrom(k, x, NOISE, rank=n // 2)
    (U, E, denom), want = built
    assert U.shape == (n, n // 2)
    assert U.dtype == E.dtype == denom.dtype == torch.float32
    assert all(torch.equal(a, b) for a, b in zip((U, E, denom), want))


def test_cg_and_solve_methods(problem):
    x, y, _ = problem
    K = t_gramian(tk.MaternP(2), torch.tensor(x)).add_diagonal(NOISE)
    dense = K.todense().numpy()
    ref = np.linalg.solve(dense, y)
    xs, (it, res) = cg(K._matvec, torch.tensor(y), tol=1e-10, maxiter=2000)
    assert it < 2000 and float(res) <= 1e-10 * np.linalg.norm(y)
    np.testing.assert_allclose(xs.numpy(), ref, rtol=1e-6, atol=1e-8)
    for method in ("auto", "cholesky"):
        np.testing.assert_allclose(solve(K, torch.tensor(y), method=method).numpy(), ref,
                                   rtol=1e-9)
    Y = torch.tensor(np.stack([y, 2 * y], axis=1))
    np.testing.assert_allclose(solve(K, Y, method="cg", tol=1e-10, maxiter=2000).numpy(),
                               np.stack([ref, 2 * ref], axis=1), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(solve(K, torch.tensor(y), method="minres", tol=1e-12,
                                     maxiter=2000).numpy(), ref, rtol=1e-6, atol=1e-8)
    # "refined": float32 inner CG, residuals from the float64 operator
    # (cfjax's semantics). The reported residual is the true one, and it
    # bounds the error: ||x - ref|| <= ||r|| / lambda_min <= ||r|| / NOISE
    xr, (outer, res) = solve_with_info(K, torch.tensor(y), method="refined")
    assert xr.dtype == torch.float64 and 1 <= outer <= 4
    np.testing.assert_allclose(float(res), np.linalg.norm(y - dense @ xr.numpy()), rtol=1e-6)
    assert float(res) < 1e-3 * np.linalg.norm(y)
    assert np.linalg.norm(xr.numpy() - ref) <= float(res) / NOISE


def test_factorize_rank_revealing_matches_reference(rng):
    x = rng.standard_normal((60, 2))
    x = np.concatenate([x, x[:20]])          # duplicated points: rank-deficient
    Fj = j_factorize(j_gramian(jk.EQ(), jnp.asarray(x)))
    Ft = factorize(t_gramian(tk.EQ(), torch.tensor(x)))
    assert isinstance(Ft, LowRankFactorization) and type(Fj).__name__ == "LowRankFactorization"
    assert Ft.rank == Fj.rank
    np.testing.assert_allclose(float(Ft.logdet()), float(Fj.logdet()), rtol=1e-9)
    b = rng.standard_normal(80)
    np.testing.assert_allclose(Ft.solve(torch.tensor(b)).numpy(),
                               np.asarray(Fj.solve(jnp.asarray(b))), rtol=1e-6, atol=1e-9)
    full = factorize(t_gramian(tk.EQ(), torch.tensor(x[:60])).add_diagonal(NOISE))
    assert isinstance(full, CholeskyFactorization)
    np.testing.assert_allclose(float(full.logdet()),
                               float(j_factorize(j_gramian(jk.EQ(), jnp.asarray(x[:60]))
                                                 .add_diagonal(NOISE)).logdet()), rtol=1e-10)


def test_cholesky_jitter_on_semidefinite_matrix(rng):
    x = rng.standard_normal((30, 2))
    x = np.concatenate([x, x[:5]])
    F = CholeskyFactorization(t_gramian(tk.EQ(), torch.tensor(x)))
    assert torch.isfinite(F.L).all()


def test_lml_other_methods_not_ported(problem, monkeypatch):
    """Every logML method of cfjax is ported: method="slq" (the stochastic
    Lanczos branch) runs and, on cfjax's own default probes, agrees with
    cfjax's estimate; an unknown method still raises."""
    from cfjax.operators import slq as j_slq
    from cfjax_torch.operators import slq as t_slq

    x, y, _ = problem
    Z = np.asarray(j_slq._rademacher(jax.random.PRNGKey(0), N, 16, jnp.float64))
    monkeypatch.setattr(t_slq, "_rademacher", lambda gen, n, p, dtype, device: torch.tensor(
        Z, dtype=dtype, device=device))
    out = t_lml(tk.EQ(), torch.tensor(x), torch.tensor(y), NOISE, method="slq")
    ref = j_lml(jk.EQ(), jnp.asarray(x), jnp.asarray(y), NOISE, method="slq")
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-6)
    with pytest.raises(ValueError):
        t_lml(tk.EQ(), torch.tensor(x), torch.tensor(y), NOISE, method="lanczos")


def _rel_err(out, ref):
    return float(np.linalg.norm(out - ref) / np.linalg.norm(ref))


def test_gp_condition_float32_points_float64_observations(rng, small_cholesky_size):
    """float32 points with numpy's float64 observations, through the
    Nystrom-PCG regime: the port casts y to the points' dtype as cfjax's
    `jnp.asarray` does under JAX's default, so the solve stays in float32
    (before, the float32 Nystrom apply met a float64 vector and raised).
    cfjax here runs with x64 on, in float64: the float32 alpha agrees with
    it to 1e-4 relative (float32 PCG at tol 1e-7, the condition number of
    K + 1e-2 I)."""
    x = rng.standard_normal((300, 3)).astype(np.float32)
    y = rng.standard_normal(300)
    kj = jk.MaternP(2)
    pj = j_condition(kj, jnp.asarray(x), jnp.asarray(y), noise=NOISE, tol=1e-10)
    pt = t_condition(tk.from_reference(kj), torch.tensor(x), y, noise=NOISE, tol=1e-7,
                     maxiter=2000)
    assert pt.alpha.dtype == torch.float32
    assert _rel_err(pt.alpha.double().numpy(), np.asarray(pj.alpha)) <= 1e-4
    # precondition="never" keeps float32 too (plain CG on the Gramian)
    pn = t_condition(tk.from_reference(kj), torch.tensor(x), y, noise=NOISE,
                     precondition="never", tol=1e-7, maxiter=2000)
    assert pn.alpha.dtype == torch.float32
    assert _rel_err(pn.alpha.double().numpy(), np.asarray(pj.alpha)) <= 1e-4


def test_gradient_gp_float32_points_float64_observations(rng, small_cholesky_size):
    """GradientKernel(EQ()) on float32 points (40, 4) with a float64 y of
    160 gradient entries (CG regime: 160 > 128): float32 alpha, within 1e-4
    relative of cfjax's float64 alpha."""
    from cfjax.derivative import GradientKernel as JGradientKernel
    from cfjax_torch.derivative import GradientKernel

    x = rng.standard_normal((40, 4)).astype(np.float32)
    y = rng.standard_normal(160)
    pj = j_condition(JGradientKernel(jk.EQ()), jnp.asarray(x), jnp.asarray(y), noise=NOISE,
                     tol=1e-10)
    pt = t_condition(GradientKernel(tk.EQ()), torch.tensor(x), y, noise=NOISE, tol=1e-7,
                     maxiter=2000)
    assert pt.alpha.dtype == torch.float32
    assert _rel_err(pt.alpha.double().numpy(), np.asarray(pj.alpha)) <= 1e-4


def test_lml_float32_points_float64_observations(rng):
    """log_marginal_likelihood casts y the same way (Cholesky branch)."""
    x = rng.standard_normal((100, 3)).astype(np.float32)
    y = rng.standard_normal(100)
    kj = jk.MaternP(2)
    ref = float(j_lml(kj, jnp.asarray(x), jnp.asarray(y), NOISE))
    out = t_lml(tk.from_reference(kj), torch.tensor(x), y, NOISE)
    assert out.dtype == torch.float32
    assert abs(float(out) - ref) <= 1e-4 * abs(ref)
