"""Parity of the port's lazy log-likelihood and hyperparameter fit with
cfjax on the CPU (x64, float64 in both packages): stochastic Lanczos
quadrature (`operators/slq.py`), the CG quadratic form, the slq branch of
`log_marginal_likelihood`, `fit_kernel`, the many-column product K A (the
plain version of K1's many-column variant and `Gramian._matmat`), and the
kernels' decline under autograd, decided at each call.

The Rademacher probes of the two packages come from different generators,
so the port's `_rademacher` is patched to return cfjax's own probes. Same
probes, same float64 arithmetic: Lanczos agrees to rounding (rtol 1e-10),
the solves to their tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfjax
import cfjax.kernels as jk
import cfjax_torch
import cfjax_torch.kernels as tk
from cfjax.gp import fit_kernel as j_fit
from cfjax.gp import log_marginal_likelihood as j_lml
from cfjax.operators import slq as j_slq
from cfjax.operators.dispatch import gramian as j_gramian
from cfjax.operators.gramian import gramian_matvec as j_gramian_matvec
from cfjax.utils.testing import pairwise as j_pairwise
from cfjax_torch.gp import fit_kernel as t_fit
from cfjax_torch.gp import log_marginal_likelihood as t_lml
from cfjax_torch.operators import slq as t_slq
from cfjax_torch.operators.dispatch import explain as t_explain
from cfjax_torch.operators.dispatch import gramian as t_gramian
from cfjax_torch.operators.gramian import GRAD_REASON, kernel_decline_reason
from cfjax_torch.ops import gramian_mvm as mvm

torch.set_num_threads(2)
F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """Input without a device goes to the CPU in this module's tests; the
    configured device is restored after them."""
    shipped = cfjax_torch.config.DEFAULT.device
    cfjax_torch.set_config(device="cpu")
    yield
    cfjax_torch.set_config(device=shipped)


@pytest.fixture
def small_cholesky_size():
    cfjax.set_config(max_cholesky_size=32)
    cfjax_torch.set_config(max_cholesky_size=32)
    yield
    cfjax.set_config(max_cholesky_size=cfjax.config.Config.max_cholesky_size)
    cfjax_torch.set_config(max_cholesky_size=cfjax_torch.config.Config.max_cholesky_size)


def _probes(key, n, probes):
    """cfjax's probes for `key` as a float64 numpy array."""
    return np.asarray(j_slq._rademacher(key, n, probes, jnp.float64))


@pytest.fixture
def solver_iters(monkeypatch):
    """The iteration counts of the solves slq runs, in call order, under
    the solver's name ("cg_columns", "cg")."""
    seen = {"cg_columns": [], "cg": []}

    def wrap(name):
        inner = getattr(t_slq, name)

        def solve(*a, **kw):
            out, info = inner(*a, **kw)
            seen[name].append(info if name == "cg_columns" else info[0])
            return out, info
        monkeypatch.setattr(t_slq, name, solve)

    wrap("cg_columns")
    wrap("cg")
    return seen


@pytest.fixture
def patch_probes(monkeypatch):
    """Make the port draw cfjax's probes for `key` (PRNGKey(0) by default,
    cfjax's own default) in its next slq calls."""
    def patch(key=None):
        key = jax.random.PRNGKey(0) if key is None else key
        monkeypatch.setattr(t_slq, "_rademacher", lambda gen, n, p, dtype, device: torch.tensor(
            _probes(key, n, p), dtype=dtype, device=device))
    return patch


N, NOISE = 200, 1e-2


@pytest.fixture
def points(rng):
    x = rng.standard_normal((N, 2))
    y = np.sin(x[:, 0]) + 0.1 * rng.standard_normal(N)
    return x, y


def _mvs(x, l=0.9):
    """The matvec_fn(params, V) of K + noise I over (l, noise), for
    Lengthscale(EQ, l), in both packages."""
    xj, xt = jnp.asarray(x), torch.tensor(x)

    def mv_j(params, V):
        ll, nz = params
        return j_gramian(jk.Lengthscale(jk.EQ(), ll), xj).matvec(V) + nz * V

    def mv_t(params, V):
        ll, nz = params
        return t_gramian(tk.Lengthscale(tk.EQ(), ll), xt).matvec(V) + nz * V

    return mv_j, mv_t


def _leaf(v):
    return torch.tensor(v, dtype=F64, requires_grad=True)


def test_lanczos_batch_matches_reference(points):
    x, _ = points
    mv_j, mv_t = _mvs(x)
    Z = _probes(jax.random.PRNGKey(1), N, 4)
    aj, bj, nj = j_slq._lanczos_batch(lambda V: mv_j((0.9, NOISE), V), jnp.asarray(Z), 20)
    at, bt, nt = t_slq._lanczos_batch(lambda V: mv_t((0.9, NOISE), V), torch.tensor(Z), 20)
    assert at.shape == (20, 4) and bt.shape == (19, 4)
    for out, ref in ((at, aj), (bt, bj), (nt, nj)):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-10)


def test_quad_logdet_matches_reference(points):
    x, _ = points
    mv_j, _ = _mvs(x)
    Z = _probes(jax.random.PRNGKey(1), N, 4)
    aj, bj, nj = j_slq._lanczos_batch(lambda V: mv_j((0.9, NOISE), V), jnp.asarray(Z), 20)
    ref = j_slq._quad_logdet(aj, bj, nj ** 2, N)
    out = t_slq._quad_logdet(torch.tensor(np.asarray(aj)), torch.tensor(np.asarray(bj)),
                             torch.tensor(np.asarray(nj)) ** 2, N)
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-12)


@pytest.mark.parametrize("probes,iters", [(8, 24), (16, 30)])
def test_slq_logdet_value_matches_reference(points, patch_probes, probes, iters):
    x, _ = points
    mv_j, mv_t = _mvs(x)
    key = jax.random.PRNGKey(5)
    patch_probes(key)
    ref = j_slq.slq_logdet(mv_j, N, probes, iters, 1e-6, 200, (0.9, NOISE), key)
    out = t_slq.slq_logdet(mv_t, N, probes, iters, 1e-6, 200,
                           (torch.tensor(0.9, dtype=F64), torch.tensor(NOISE, dtype=F64)),
                           dtype=F64)
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-10)


def test_slq_probe_chunking_matches_full(rng, monkeypatch):
    """Chunked Lanczos sweeps (probes run in sequence so that the
    reorthogonalization basis stays bounded) give the same estimate as
    one full-batch sweep over the same probes (cfjax's test, ported)."""
    n = 256
    x = rng.standard_normal((n, 2))
    K = torch.tensor(np.asarray(j_pairwise(jk.Lengthscale(jk.EQ(), 0.8), jnp.asarray(x),
                                           jnp.asarray(x)))) + 0.1 * torch.eye(n, dtype=F64)
    mv = lambda params, V: K @ V

    def est():
        return float(t_slq.slq_logdet(mv, n, 8, 24, 1e-6, 200, (),
                                      torch.Generator().manual_seed(7), dtype=F64,
                                      device="cpu"))

    full = est()
    monkeypatch.setattr(t_slq, "_probe_chunk", lambda n_, p_, it_: 2)   # four chunks
    chunked = est()
    np.testing.assert_allclose(chunked, full, rtol=1e-10)
    ref = float(torch.linalg.slogdet(K)[1])
    assert abs(full - ref) / abs(ref) < 0.05


def test_probe_chunk_caps_the_basis():
    assert t_slq._probe_chunk(1000, 16, 48) == j_slq._probe_chunk(1000, 16, 48) == 16
    for n in (1 << 17, 1 << 20, 10 ** 6):
        assert t_slq._probe_chunk(n, 16, 48) == j_slq._probe_chunk(n, 16, 48)


def test_slq_logdet_probes_follow_params_then_the_configured_device(monkeypatch):
    """Without a device, the probes go to the device of the first tensor
    among the parameters, else to the configured default, never to a fixed
    CPU (a "meta" default stands in for the card here)."""
    seen = []
    real = t_slq._rademacher

    def spy(generator, n, probes, dtype, device):
        seen.append(torch.device(device))
        return real(generator, n, probes, dtype, torch.device("cpu"))

    monkeypatch.setattr(t_slq, "_rademacher", spy)
    K = 2.0 * torch.eye(8, dtype=F64)
    mv = lambda params, V: K @ V
    shipped = cfjax_torch.config.DEFAULT.device
    try:
        cfjax_torch.set_config(device="meta")
        for params in ((), (torch.tensor(1.0, dtype=F64),)):
            est = t_slq.slq_logdet(mv, 8, 2, 4, 1e-6, 50, params,
                                   torch.Generator().manual_seed(0), dtype=F64)
            np.testing.assert_allclose(float(est), 8 * np.log(2.0), rtol=1e-12)
    finally:
        cfjax_torch.set_config(device=shipped)
    assert seen == [torch.device("meta"), torch.device("cpu")]


def test_rademacher_draws_signs_from_the_generator():
    g = lambda: torch.Generator().manual_seed(3)
    Z = t_slq._rademacher(g(), 500, 4, F64, torch.device("cpu"))
    assert Z.shape == (500, 4) and Z.dtype == F64
    assert set(Z.unique().tolist()) == {-1.0, 1.0}
    assert torch.equal(Z.float(), t_slq._rademacher(g(), 500, 4, torch.float32,
                                                     torch.device("cpu")))


def test_slq_gradient_matches_jax_grad(points, patch_probes, solver_iters):
    """The Hutchinson gradient over the lengthscale and the noise against
    jax.grad of cfjax's estimator, at solve_tol 1e-10."""
    x, _ = points
    mv_j, mv_t = _mvs(x)
    key = jax.random.PRNGKey(2)
    patch_probes(key)
    gj = jax.grad(lambda p: j_slq.slq_logdet(mv_j, N, 16, 30, 1e-10, 1000, p, key))(
        (jnp.asarray(0.9), jnp.asarray(NOISE)))
    l, nz = _leaf(0.9), _leaf(NOISE)
    est = t_slq.slq_logdet(mv_t, N, 16, 30, 1e-10, 1000, (l, nz), dtype=F64, device="cpu")
    gt = torch.autograd.grad(est, (l, nz))
    for out, ref in zip(gt, gj):
        np.testing.assert_allclose(float(out), float(ref), rtol=1e-6)
    assert len(solver_iters["cg_columns"]) == 1 and 0 < solver_iters["cg_columns"][0] < 1000


def test_cg_quadform_value_and_gradients_match_reference(points, solver_iters):
    x, y = points
    mv_j, mv_t = _mvs(x)
    params = (jnp.asarray(0.9), jnp.asarray(NOISE))
    qj = j_slq.cg_quadform(lambda p, v: mv_j(p, v), 1e-12, 1000, params, jnp.asarray(y))
    gj = jax.grad(lambda p, yy: j_slq.cg_quadform(lambda q, v: mv_j(q, v), 1e-12, 1000, p, yy),
                  argnums=(0, 1))(params, jnp.asarray(y))
    l, nz, yt = _leaf(0.9), _leaf(NOISE), torch.tensor(y, requires_grad=True)
    qt = t_slq.cg_quadform(mv_t, 1e-12, 1000, (l, nz), yt)
    gl, gn, gy = torch.autograd.grad(qt, (l, nz, yt))
    np.testing.assert_allclose(float(qt.detach()), float(qj), rtol=1e-8)
    np.testing.assert_allclose([float(gl), float(gn)], [float(g) for g in gj[0]], rtol=1e-8)
    np.testing.assert_allclose(gy.numpy(), np.asarray(gj[1]), rtol=1e-8)
    assert len(solver_iters["cg"]) == 1 and 0 < solver_iters["cg"][0] < 1000


def _lml_both(x, y, l, method, **kw):
    """(port value, port d/dl, d/dnoise; cfjax value, d/dl, d/dnoise)."""
    lj, gj = jax.value_and_grad(
        lambda ll, nz: j_lml(jk.Lengthscale(jk.EQ(), ll), jnp.asarray(x), jnp.asarray(y),
                             noise=nz, method=method, **kw), argnums=(0, 1))(l, NOISE)
    lt, nz = _leaf(l), _leaf(NOISE)
    vt = t_lml(tk.Lengthscale(tk.EQ(), lt), torch.tensor(x), torch.tensor(y), noise=nz,
               method=method, **kw)
    gt = torch.autograd.grad(vt, (lt, nz))
    return (float(vt.detach()), *map(float, gt)), (float(lj), *map(float, gj))


@pytest.mark.parametrize("method", ["slq", "auto"])
def test_logml_slq_matches_reference(points, patch_probes, small_cholesky_size, method):
    """log_marginal_likelihood through the slq branch (forced, or chosen by
    the auto route above max_cholesky_size = 32 in both packages) on
    cfjax's default probes: value and gradient in l and the noise."""
    x, y = points
    patch_probes()
    out, ref = _lml_both(x, y, 0.9, method)
    np.testing.assert_allclose(out, ref, rtol=1e-6)


def test_logml_slq_lazy_regime(rng):
    """cfjax's test, ported: the SLQ + CG logML on a lazy gramian is within
    2% of the Cholesky value, and its Hutchinson gradient in log l within
    0.15 max(1, |g|) of the exact one."""
    n = 300
    x = torch.tensor(rng.standard_normal((n, 2)))
    y = torch.sin(x[:, 0]) + 0.1 * torch.tensor(rng.standard_normal(n))
    k = tk.Lengthscale(tk.EQ(), 0.9)
    exact = t_lml(k, x, y, noise=1e-2, method="cholesky")
    est = t_lml(k, x, y, noise=1e-2, method="slq", probes=32, lanczos_iters=40,
                generator=torch.Generator().manual_seed(3))
    assert abs(float(est) - float(exact)) / abs(float(exact)) < 0.02

    def nll_grad(method, **kw):
        log_l = torch.tensor(0.0, dtype=F64, requires_grad=True)
        v = -t_lml(tk.Lengthscale(tk.EQ(), torch.exp(log_l)), x, y, noise=1e-2, method=method,
                   **kw)
        return float(torch.autograd.grad(v, log_l)[0])

    g = nll_grad("slq", probes=16, lanczos_iters=30, generator=torch.Generator().manual_seed(0))
    g_exact = nll_grad("cholesky")
    assert np.isfinite(g)
    assert abs(g - g_exact) < 0.15 * max(1.0, abs(g_exact))


def test_logml_slq_default_generator_is_seeded(points):
    """Without a generator the probes come from one seeded with 0: two
    calls give the same estimate."""
    x, y = points
    k = tk.Lengthscale(tk.EQ(), 0.9)
    a = t_lml(k, torch.tensor(x), torch.tensor(y), noise=NOISE, method="slq")
    b = t_lml(k, torch.tensor(x), torch.tensor(y), noise=NOISE, method="slq",
              generator=torch.Generator().manual_seed(0))
    assert float(a) == float(b)


def _fit_data(rng, n=64, true_l=0.6, noise=1e-2):
    x = rng.uniform(-2, 2, (n, 1))
    K = np.asarray(j_pairwise(jk.Lengthscale(jk.EQ(), true_l), jnp.asarray(x),
                              jnp.asarray(x))) + noise * np.eye(n)
    return x, np.linalg.cholesky(K) @ rng.standard_normal(n)


def test_fit_kernel_optax(rng):
    """cfjax's test, ported: the Adam fit of the logML recovers the
    lengthscale (the Flux counterpart of reference test/optimization.jl)."""
    x, y = _fit_data(rng)
    k_fit, hist = t_fit(tk.Lengthscale(tk.EQ(), 1.5), torch.tensor(x), torch.tensor(y),
                        noise=1e-2, steps=120, lr=0.05)
    assert hist.shape == (120,) and hist.dtype == F64
    assert hist[-1] < hist[0]
    assert abs(float(k_fit.l) - 0.6) < 0.3, float(k_fit.l)
    assert not k_fit.l.requires_grad


def test_fit_kernel_history_matches_reference(rng):
    """The history of 20 steps (Cholesky branch) equals cfjax's optax run."""
    x, y = _fit_data(rng)
    _, hj = j_fit(jk.Lengthscale(jk.EQ(), 1.5), jnp.asarray(x), jnp.asarray(y), noise=1e-2,
                  steps=20, lr=0.05)
    kt, ht = t_fit(tk.Lengthscale(tk.EQ(), 1.5), torch.tensor(x), torch.tensor(y), noise=1e-2,
                   steps=20, lr=0.05)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=1e-6)


def test_fit_kernel_through_slq_matches_reference(rng, patch_probes, small_cholesky_size):
    """Three steps through the slq branch (n = 64 above max_cholesky_size =
    32 in both packages) on cfjax's default probes: the history agrees to
    the solves' tolerance."""
    x, y = _fit_data(rng)
    patch_probes()
    _, hj = j_fit(jk.Lengthscale(jk.EQ(), 1.5), jnp.asarray(x), jnp.asarray(y), noise=1e-2,
                  steps=3, lr=0.05)
    kt, ht = t_fit(tk.Lengthscale(tk.EQ(), 1.5), torch.tensor(x), torch.tensor(y), noise=1e-2,
                   steps=3, lr=0.05)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=1e-5)
    assert float(kt.l) != 1.5


def test_fit_kernel_sum_kernel_and_linear_space(rng):
    """Two leaves (a constant and a lengthscale), in log space and in
    linear space, against cfjax's history."""
    x, y = _fit_data(rng, n=40)
    for log_space in (True, False):
        _, hj = j_fit(2.0 * jk.Lengthscale(jk.EQ(), 1.2), jnp.asarray(x), jnp.asarray(y),
                      noise=1e-2, steps=5, lr=0.02, log_space=log_space)
        _, ht = t_fit(2.0 * tk.Lengthscale(tk.EQ(), 1.2), torch.tensor(x), torch.tensor(y),
                      noise=1e-2, steps=5, lr=0.02, log_space=log_space)
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=1e-6)


@pytest.mark.parametrize("p", [1, 3, 16, 17])
@pytest.mark.parametrize("name", ["MaternP2", "LengthscaleEQ", "SumScaled"])
def test_matmat_matches_reference(rng, name, p):
    """K A for A of shape (m, p): the many-column K1's plain version and
    Gramian._matmat against cfjax's blocked gramian_matvec, rtol 1e-12 (an
    entry that cancels to far below the others is held to 1e-12 of the
    largest: the two sum in other orders)."""
    kj = {"MaternP2": jk.MaternP(2), "LengthscaleEQ": jk.Lengthscale(jk.EQ(), 0.7),
          "SumScaled": 2.0 * jk.EQ() + 0.5 * jk.MaternP(1)}[name]
    kt = tk.from_reference(kj)
    x, y = rng.standard_normal((150, 3)), rng.standard_normal((130, 3))
    A = rng.standard_normal((130, p))
    ref = np.asarray(j_gramian_matvec(kj, jnp.asarray(x), jnp.asarray(y), jnp.asarray(A),
                                      "iso", 64))
    tol = dict(rtol=1e-12, atol=1e-12 * np.abs(ref).max())
    out = mvm.gramian_matmat_direct(kt, torch.tensor(x), torch.tensor(y), torch.tensor(A))
    assert out.shape == (150, p)
    np.testing.assert_allclose(out.numpy(), ref, **tol)
    np.testing.assert_allclose(mvm.gramian_matmat_direct_plain(
        kt, torch.tensor(x), torch.tensor(y), torch.tensor(A), block=32).numpy(), ref, **tol)
    G = t_gramian(kt, torch.tensor(x), torch.tensor(y))
    np.testing.assert_allclose((G @ torch.tensor(A)).numpy(), ref, **tol)


def test_kernel_decline_under_autograd_is_decided_at_each_call(rng):
    """A Gramian the kernels take (device, dtype and spec as on the card:
    the build-time reason cleared here) declines K1 only where autograd
    would record: under torch.no_grad() a kernel whose leaves require grad
    runs the kernel; with grad enabled it still declines, and explain()
    says so only then."""
    x = torch.tensor(rng.standard_normal((40, 3)))
    k = tk.Lengthscale(tk.MaternP(2), 0.7)
    k.l.requires_grad_(True)
    G = t_gramian(k, x)
    G.kernel, G.kernel_reason = "direct", None
    v, V = torch.ones(40, dtype=F64), torch.ones((40, 3), dtype=F64)
    assert kernel_decline_reason(G) == GRAD_REASON
    assert kernel_decline_reason(G, v) == kernel_decline_reason(G, V) == GRAD_REASON
    with torch.no_grad():
        assert kernel_decline_reason(G) is None and kernel_decline_reason(G, V) is None
    k.l.requires_grad_(False)
    assert kernel_decline_reason(G) is None
    assert kernel_decline_reason(G, v.clone().requires_grad_(True)) == GRAD_REASON
    # on the CPU the build-time reason stands in both modes
    k.l.requires_grad_(True)
    how = t_explain(k, x)
    assert "tensors on cpu" in how and "autograd" not in how
    with torch.no_grad():
        assert "tensors on cpu" in t_explain(k, x)
