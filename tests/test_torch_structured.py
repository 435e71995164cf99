"""Parity of the port's structured fast paths with cfjax on the CPU:
grids with a device and dtype, the Toeplitz / circulant operators and
their direct solvers, the Kronecker operator, the dispatch branches that
return them, `cg_columns`, GP conditioning, posterior variance and the
structured log marginal likelihood on grids, and the linalg helpers.

The same numpy inputs go to cfjax (x64, tests/conftest.py) and to the
port (float64). Tolerances, per kind of result:
  * FFT MVMs, dense forms, exact spectral solves, logdets: rtol 1e-10
    (two FFT libraries, the same products);
  * Levinson / Durbin / Trench: rtol 1e-10, atol 1e-14 (the same
    recurrence in the same order);
  * Kronecker Cholesky solves: rtol 1e-8 (explicit factor inverses of
    moderately conditioned factors);
  * CG-based results (Strang PCG, cg_columns, gp_condition in the CG
    regime, posterior variance): both packages stop at tol 1e-10 or
    1e-12, so atol 1e-7 on O(1) results;
  * log marginal likelihoods: rtol 1e-10; their gradients against
    jax.grad: rtol 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfjax
import cfjax.kernels as jk
import cfjax_torch
import cfjax_torch.kernels as tk
from cfjax.derivative import SeparableKernel as JSeparableKernel
from cfjax.gp import gp_condition as j_condition
from cfjax.gp import log_marginal_likelihood as j_lml
from cfjax.operators import toeplitz as jtoe
from cfjax.operators.dispatch import explain as j_explain
from cfjax.operators.dispatch import gramian as j_gramian
from cfjax.operators.solvers import cg_columns as j_cg_columns
from cfjax.utils import linalg as jlinalg
from cfjax.utils.grids import LazyGrid as JLazyGrid
from cfjax.utils.grids import UniformGrid as JUniformGrid
from cfjax_torch.derivative import SeparableKernel
from cfjax_torch.gp import gp_condition as t_condition
from cfjax_torch.gp import log_marginal_likelihood as t_lml
from cfjax_torch.operators import (CirculantOperator, KroneckerCholesky, KroneckerOperator,
                                   ToeplitzOperator, cg_columns, circulant_matvec, durbin,
                                   levinson, solve, toeplitz_matvec, trench)
from cfjax_torch.operators import dispatch as t_dispatch
from cfjax_torch.operators.dispatch import explain as t_explain
from cfjax_torch.operators.dispatch import gramian as t_gramian
from cfjax_torch.utils import linalg as tlinalg
from cfjax_torch.utils.grids import LazyGrid, UniformGrid, as_points, detect_uniform_grid
from cfjax_torch.utils.testing import pairwise

torch.set_num_threads(2)

F64 = torch.float64


def _t(a):
    return torch.tensor(np.asarray(a))


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _grids(start, step, num):
    """The same uniform grid in both packages (the port's in float64)."""
    return JUniformGrid(start, step, num), UniformGrid(start, step, num, dtype=F64)


def _lazy_grids(*specs):
    return (JLazyGrid(tuple(JUniformGrid(*s) for s in specs)),
            LazyGrid(tuple(UniformGrid(*s) for s in specs), dtype=F64))


@pytest.fixture
def small_cholesky_size():
    cfjax.set_config(max_cholesky_size=16)
    cfjax_torch.set_config(max_cholesky_size=16)
    yield
    cfjax.set_config(max_cholesky_size=cfjax.config.Config.max_cholesky_size)
    cfjax_torch.set_config(max_cholesky_size=cfjax_torch.config.Config.max_cholesky_size)


# -------------------- grids --------------------


def test_grid_device_and_dtype():
    g = UniformGrid(0.5, 0.25, 6)          # positional, as cfjax's
    assert g.points().dtype == torch.get_default_dtype() and g.points().device.type == "cpu"
    g64 = UniformGrid(0.5, 0.25, 6, device="cpu", dtype=F64)
    np.testing.assert_allclose(g64.points().numpy(), np.asarray(JUniformGrid(0.5, 0.25, 6).points()),
                               rtol=1e-15)
    lg = LazyGrid((UniformGrid(0.0, 1.0, 3), np.linspace(0, 1, 4)), dtype=F64)
    assert all(a.dtype == F64 for a in (lg.axes[0], lg.axes[1]))
    assert lg.axis_points(0).dtype == F64 and lg.points().dtype == F64
    assert as_points(lg).shape == (12, 2)
    np.testing.assert_allclose(
        lg.points().numpy(),
        np.asarray(JLazyGrid((JUniformGrid(0.0, 1.0, 3), np.linspace(0, 1, 4))).points()))
    d = detect_uniform_grid(torch.linspace(0, 1, 50, dtype=F64))
    assert d.dtype == F64 and d.device == torch.device("cpu") and d.num == 50


def test_float32_grid_dispatches_toeplitz_and_keeps_dtype(rng):
    """float32 uniform grids (diffs wobble in the 7th digit) still take
    the Toeplitz path, and the detected grid keeps float32 (cfjax's
    operator is float64 here, the port's float32)."""
    n = 512
    pts = (0.3 + 0.01 * np.arange(n, dtype=np.float64)).astype(np.float32)
    g = detect_uniform_grid(torch.tensor(pts))
    assert g is not None and g.dtype == torch.float32
    op = t_gramian(tk.EQ(), torch.tensor(pts))
    assert isinstance(op, ToeplitzOperator) and op.dtype == torch.float32
    assert type(j_gramian(jk.EQ(), jnp.asarray(pts))).__name__ == "ToeplitzOperator"
    a = torch.tensor(rng.standard_normal(n), dtype=torch.float32)
    out = op @ a
    assert out.dtype == torch.float32
    K = pairwise(tk.EQ(), torch.tensor(pts)[:, None])
    np.testing.assert_allclose(out.numpy(), (K @ a).numpy(), rtol=2e-4, atol=2e-4)


# -------------------- Toeplitz / circulant --------------------


def test_periodic_embedding_matches(rng):
    x = rng.uniform(0, 3, 17)
    a = rng.standard_normal(17)
    Gt = t_gramian(tk.Periodic(tk.EQ()), _t(x))
    Gj = j_gramian(jk.Periodic(jk.EQ()), jnp.asarray(x))
    assert type(Gt).__name__ == type(Gj).__name__ == "Gramian"
    np.testing.assert_allclose((Gt @ _t(a)).numpy(), np.asarray(Gj @ jnp.asarray(a)), rtol=1e-10)


def test_toeplitz_mvm_and_dense(rng):
    gj, gt = _grids(0.0, 0.05, 40)
    Tj, Tt = j_gramian(jk.Exp(), gj), t_gramian(tk.Exp(), gt)
    assert isinstance(Tt, ToeplitzOperator) and Tt.is_symmetric
    np.testing.assert_allclose(Tt.todense().numpy(), np.asarray(Tj.todense()), rtol=1e-10,
                               atol=1e-14)
    K = pairwise(tk.Exp(), gt.points()[:, None]).numpy()
    np.testing.assert_allclose(Tt.todense().numpy(), K, rtol=1e-10, atol=1e-14)
    a = rng.standard_normal(40)
    A = rng.standard_normal((40, 3))
    np.testing.assert_allclose((Tt @ _t(a)).numpy(), np.asarray(Tj @ jnp.asarray(a)), rtol=1e-10)
    np.testing.assert_allclose((Tt @ _t(A)).numpy(), np.asarray(Tj @ jnp.asarray(A)), rtol=1e-10)
    np.testing.assert_allclose(Tt.diagonal().numpy(), np.asarray(Tj.diagonal()), rtol=1e-15)


def test_nonsymmetric_toeplitz(rng):
    gxj, gxt = _grids(0.0, 0.1, 24)
    gyj, gyt = _grids(0.5, 0.1, 24)
    Tj, Tt = j_gramian(jk.Exp(), gxj, gyj), t_gramian(tk.Exp(), gxt, gyt)
    assert isinstance(Tt, ToeplitzOperator) and not Tt.is_symmetric
    a = rng.standard_normal(24)
    np.testing.assert_allclose((Tt @ _t(a)).numpy(), np.asarray(Tj @ jnp.asarray(a)), rtol=1e-10)
    np.testing.assert_allclose(Tt.T.matvec(_t(a)).numpy(), np.asarray(Tj.T @ jnp.asarray(a)),
                               rtol=1e-10)
    K = pairwise(tk.Exp(), gxt.points()[:, None], gyt.points()[:, None]).numpy()
    np.testing.assert_allclose(Tt.todense().numpy(), K, rtol=1e-10)


def test_fft_matvecs_match_reference(rng):
    n = 33
    col, row, c = rng.standard_normal(n), rng.standard_normal(n), rng.standard_normal(n)
    row[0] = col[0]
    for v in (rng.standard_normal(n), rng.standard_normal((n, 4))):
        np.testing.assert_allclose(
            toeplitz_matvec(_t(col), _t(row), _t(v)).numpy(),
            np.asarray(jtoe.toeplitz_matvec(jnp.asarray(col), jnp.asarray(row), jnp.asarray(v))),
            rtol=1e-10, atol=1e-13)
        np.testing.assert_allclose(
            circulant_matvec(_t(c), _t(v)).numpy(),
            np.asarray(jtoe.circulant_matvec(jnp.asarray(c), jnp.asarray(v))),
            rtol=1e-10, atol=1e-13)
    vc = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    np.testing.assert_allclose(
        circulant_matvec(_t(c), _t(vc)).numpy(),
        np.asarray(jtoe.circulant_matvec(jnp.asarray(c), jnp.asarray(vc))), rtol=1e-10,
        atol=1e-13)


def _dd_toeplitz_col(n):
    """A diagonally dominant SPD Toeplitz first column."""
    return np.exp(-np.arange(n) * 0.8)


def test_levinson_durbin_trench(rng):
    n = 30
    col = _dd_toeplitz_col(n)
    b = rng.standard_normal(n)
    r = col[1:] / col[0]
    pairs = ((levinson(_t(col), _t(b)), jtoe.levinson(jnp.asarray(col), jnp.asarray(b))),
             (durbin(_t(r)), jtoe.durbin(jnp.asarray(r))),
             (trench(_t(col)), jtoe.trench(jnp.asarray(col))))
    for out, ref in pairs:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-14)
    i, j = np.arange(n)[:, None], np.arange(n)[None, :]
    T = col[np.abs(i - j)]
    np.testing.assert_allclose(pairs[0][0].numpy(), np.linalg.solve(T, b), rtol=1e-9)
    np.testing.assert_allclose(pairs[2][0].numpy(), np.linalg.inv(T), rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("method", ["auto", "levinson", "cg"])
def test_toeplitz_solve_methods(method, rng):
    n = 64
    col = _dd_toeplitz_col(n)
    b = rng.standard_normal((n, 2))
    Tt, Tj = ToeplitzOperator(_t(col)), jtoe.ToeplitzOperator(jnp.asarray(col))
    out = Tt.solve(_t(b), method=method, tol=1e-12)
    ref = Tj.solve(jnp.asarray(b), method=method, tol=1e-12)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(out[:, 0].numpy(), Tt.solve(_t(b[:, 0]), method=method,
                                                           tol=1e-12).numpy(), rtol=1e-12)


def test_strang_preconditioner_matches_reference(rng):
    n = 50
    col = np.exp(-np.arange(n) / 7.0)
    v = rng.standard_normal(n)
    Mt = ToeplitzOperator(_t(col)).strang_preconditioner()
    Mj = jtoe.ToeplitzOperator(jnp.asarray(col)).strang_preconditioner()
    np.testing.assert_allclose(Mt(_t(v)).numpy(), np.asarray(Mj(jnp.asarray(v))), rtol=1e-10)


def test_toeplitz_auto_solve_above_levinson_threshold(rng):
    n = 8200    # auto takes Strang-PCG above n = 8192
    g = UniformGrid(0.0, 1.0 / n, n, dtype=F64)
    T = t_gramian(tk.Exp(), g)
    Tn = ToeplitzOperator(T.col + 1.0 * (torch.arange(n) == 0))
    b = torch.tensor(rng.standard_normal(n))
    x = Tn.solve(b, tol=1e-10, maxiter=500)
    assert float(torch.linalg.norm(Tn @ x - b) / torch.linalg.norm(b)) <= 1e-9


def test_circulant(rng):
    c = np.r_[2.0, 0.5, 0.1, 0.05, 0.1, 0.5]
    Ct, Cj = CirculantOperator(_t(c)), jtoe.CirculantOperator(jnp.asarray(c))
    a = rng.standard_normal(6)
    A = rng.standard_normal((6, 2))
    K = np.asarray(Cj.todense())
    np.testing.assert_allclose(Ct.todense().numpy(), K, rtol=1e-15)
    np.testing.assert_allclose((Ct @ _t(a)).numpy(), np.asarray(Cj @ jnp.asarray(a)), rtol=1e-10)
    np.testing.assert_allclose(Ct.solve(_t(a)).numpy(), np.asarray(Cj.solve(jnp.asarray(a))),
                               rtol=1e-10)
    np.testing.assert_allclose(Ct.solve(_t(A)).numpy(), np.linalg.solve(K, A), rtol=1e-10)
    np.testing.assert_allclose(float(Ct.logdet()), float(Cj.logdet()), rtol=1e-10)
    np.testing.assert_allclose(float(Ct.logdet()), np.linalg.slogdet(K)[1], rtol=1e-10)
    np.testing.assert_allclose(Ct.eigenvalues().numpy(), np.asarray(Cj.eigenvalues()), rtol=1e-10,
                               atol=1e-14)
    np.testing.assert_allclose(Ct.diagonal().numpy(), np.asarray(Cj.diagonal()))
    assert (Ct.is_symmetric, Ct.is_psd) == (Cj.is_symmetric, Cj.is_psd) == (True, True)
    skew = CirculantOperator(_t(np.r_[2.0, 0.5, 0.1, 0.3, 0.2]))
    assert not skew.is_symmetric
    with pytest.raises(ValueError, match="num"):
        CirculantOperator(lambda: _t(c))


def test_indefinite_toeplitz_routes_to_minres(rng):
    n = 64
    col = np.zeros(n)
    col[1] = 1.0   # zero diagonal, unit off-diagonals: eigenvalues 2 cos(k pi / (n + 1))
    T = ToeplitzOperator(_t(col))
    assert T.is_symmetric and not T.is_psd
    assert not jtoe.ToeplitzOperator(jnp.asarray(col)).is_psd
    b = T @ _t(rng.standard_normal(n))
    x = solve(T, b, tol=1e-12, maxiter=2000, method="auto")
    np.testing.assert_allclose((T @ x).numpy(), b.numpy(), atol=1e-7)


def test_psd_toeplitz_symbol_check():
    t = np.linspace(0, 3, 32)
    col = np.exp(-0.5 * t**2)
    assert ToeplitzOperator(_t(col)).is_psd
    assert jtoe.ToeplitzOperator(jnp.asarray(col)).is_psd


def test_psd_symbol_check_resolves_float32_rounding():
    """Exp on a 65536-point grid: the embedding's symbol is positive in
    float64 (cfjax: PSD, so CG); the float32 column's rounding takes it to
    about -1e-3, inside the dtype-aware tolerance. An indefinite float32
    Toeplitz still says no."""
    n = 65536
    assert j_gramian(jk.Exp(), JUniformGrid(0.0, 1.0 / n, n)).is_psd
    for dtype in (torch.float32, F64):
        assert t_gramian(tk.Exp(), UniformGrid(0.0, 1.0 / n, n, dtype=dtype)).is_psd
    col = torch.zeros(64, dtype=torch.float32)
    col[1] = 1.0
    assert not ToeplitzOperator(col).is_psd


def test_nonsymmetric_toeplitz_solve_roundtrip(rng):
    n = 128
    col = 0.5 ** np.arange(n) + 1e-3 * rng.standard_normal(n)
    row = 0.3 ** np.arange(n) + 1e-3 * rng.standard_normal(n)
    row[0] = col[0]
    col[0] += 2.0
    row[0] += 2.0
    T = ToeplitzOperator(_t(col), _t(row))
    assert not T.is_symmetric and not T.is_psd
    b = T @ _t(rng.standard_normal(n))
    got = T.solve(b, tol=1e-12, maxiter=2000)
    ref = jtoe.ToeplitzOperator(jnp.asarray(col), jnp.asarray(row)).solve(
        jnp.asarray(b.numpy()), tol=1e-12, maxiter=2000)
    np.testing.assert_allclose((T @ got).numpy(), b.numpy(), atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    with pytest.raises(ValueError, match="square"):
        ToeplitzOperator(_t(col), _t(row[:-1]))


def test_grid_gramian_construction_is_lazy(rng, monkeypatch):
    """gramian() on uniform grids and lazy grids evaluates no kernel
    column at construction; the first MVM evaluates exactly one, and later
    MVMs reuse it."""
    calls = []
    real = t_dispatch._grid_col
    monkeypatch.setattr(t_dispatch, "_grid_col",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    T = t_gramian(tk.Exp(), UniformGrid(0.0, 1.0 / 256, 256, dtype=F64))
    assert isinstance(T, ToeplitzOperator) and T.shape == (256, 256) and T.dtype == F64
    K = t_gramian(tk.separable("^", tk.EQ(), d=3),
                  LazyGrid(tuple(UniformGrid(0.0, 1.0 / 16, 16) for _ in range(3)), dtype=F64))
    assert isinstance(K, KroneckerOperator) and K.shape == (4096, 4096)
    C = t_gramian(tk.Periodic(tk.EQ()), UniformGrid(0.0, 1.0 / 64, 64, dtype=F64))
    assert isinstance(C, CirculantOperator)
    assert calls == []
    a = torch.tensor(rng.standard_normal(256))
    T @ a
    assert len(calls) == 1
    T @ a
    assert len(calls) == 1


def test_lazy_column_with_grad_is_rebuilt_per_use(rng):
    """A column that carries an autograd graph is not cached: two
    backward passes through two MVMs both see the kernel's parameter."""
    l = torch.tensor(0.7, dtype=F64, requires_grad=True)
    T = t_gramian(tk.Lengthscale(tk.EQ(), l), UniformGrid(0.0, 0.1, 20, dtype=F64))
    a = torch.tensor(rng.standard_normal(20))
    K = pairwise(tk.Lengthscale(tk.EQ(), l), torch.arange(20, dtype=F64)[:, None] * 0.1)
    (g_ref,) = torch.autograd.grad((K @ a).sum(), l)
    for _ in range(2):
        (g,) = torch.autograd.grad((T @ a).sum(), l)
        np.testing.assert_allclose(float(g), float(g_ref), rtol=1e-10)


# -------------------- Kronecker --------------------


def test_kronecker_mvm_solve(rng):
    axes = (np.linspace(0, 3, 5), np.linspace(0, 3, 4), np.linspace(0, 3, 3))
    kj, kt = jk.SeparableProduct((jk.EQ(),) * 3), tk.SeparableProduct((tk.EQ(),) * 3)
    Kj, Kt = j_gramian(kj, JLazyGrid(axes)), t_gramian(kt, LazyGrid(axes))
    assert isinstance(Kt, KroneckerOperator) and Kt.shape == Kj.shape == (60, 60)
    assert [type(f).__name__ for f in Kt.factors] == [type(f).__name__ for f in Kj.factors]
    Kd = Kt.todense().numpy()
    np.testing.assert_allclose(Kd, np.asarray(Kj.todense()), rtol=1e-12, atol=1e-15)
    P = LazyGrid(axes).points()
    np.testing.assert_allclose(Kd, pairwise(kt, P, P).numpy(), rtol=1e-10, atol=1e-14)
    a = rng.standard_normal(60)
    A = rng.standard_normal((60, 3))
    np.testing.assert_allclose((Kt @ _t(a)).numpy(), np.asarray(Kj @ jnp.asarray(a)), rtol=1e-10)
    np.testing.assert_allclose((Kt @ _t(A)).numpy(), Kd @ A, rtol=1e-10)
    np.testing.assert_allclose(Kt._apply_modes(_t(A), Kt.factors).numpy(), Kd @ A, rtol=1e-10)
    np.testing.assert_allclose(Kt.diagonal().numpy(), np.asarray(Kj.diagonal()), rtol=1e-14)
    x = Kt.solve(_t(a))
    np.testing.assert_allclose(x.numpy(), np.asarray(Kj.solve(jnp.asarray(a))), rtol=1e-8)
    np.testing.assert_allclose(Kd @ x.numpy(), a, rtol=1e-6, atol=1e-8)
    F = Kt.cholesky()
    assert isinstance(F, KroneckerCholesky)
    np.testing.assert_allclose(float(F.logdet()), float(Kj.cholesky().logdet()), rtol=1e-10)
    np.testing.assert_allclose(float(F.logdet()), np.linalg.slogdet(Kd)[1], rtol=1e-6)
    np.testing.assert_allclose(float(Kt.logdet()), float(Kj.logdet()), rtol=1e-10)
    np.testing.assert_allclose(F.solve(_t(A)).numpy(),
                               np.asarray(Kj.cholesky().solve(jnp.asarray(A))), rtol=1e-8)


def test_kronecker_cg_solve_above_cholesky_size(rng, small_cholesky_size):
    gj, gt = _lazy_grids((0.0, 0.5, 20), (0.0, 0.7, 18))
    Kj = j_gramian(jk.SeparableProduct((jk.MaternP(1), jk.Exp())), gj)
    Kt = t_gramian(tk.SeparableProduct((tk.MaternP(1), tk.Exp())), gt)
    b = rng.standard_normal(360)
    x = Kt.solve(_t(b), tol=1e-12, maxiter=2000)
    np.testing.assert_allclose(x.numpy(), np.asarray(Kj.solve(jnp.asarray(b), tol=1e-12,
                                                              maxiter=2000)), atol=1e-7)
    np.testing.assert_allclose((Kt @ x).numpy(), b, atol=1e-8)


def test_kronecker_of_large_and_lazy_factors_uses_apply_modes(rng):
    """A factor wider than 2048 is not densified: the MVM runs mode by
    mode through each factor's own matmat."""
    big = ToeplitzOperator(_t(np.exp(-np.arange(2100) / 50.0)))
    small = np.array([[2.0, 0.5], [0.5, 1.0]])
    K = KroneckerOperator((big, _t(small)))
    assert K._dense_mats() is None
    v = rng.standard_normal((4200, 2))
    Y = (big @ _t(v.reshape(2100, 4))).numpy().reshape(2100, 2, 2)   # big along axis 0
    ref = np.einsum("ab,ibr->iar", small, Y).reshape(4200, 2)         # small along axis 1
    np.testing.assert_allclose((K @ _t(v)).numpy(), ref, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose((K @ _t(v[:, 0])).numpy(), ref[:, 0], rtol=1e-10, atol=1e-12)


def test_separable_kernel(rng):
    B = np.array([[2.0, 0.5], [0.5, 1.0]])
    x = rng.standard_normal((6, 3))
    Gt = t_gramian(SeparableKernel(tk.EQ(), B), _t(x))
    Gj = j_gramian(JSeparableKernel(jk.EQ(), jnp.asarray(B)), jnp.asarray(x))
    assert isinstance(Gt, KroneckerOperator) and type(Gj).__name__ == "KroneckerOperator"
    K = np.kron(pairwise(tk.EQ(), _t(x)).numpy(), B)
    v = rng.standard_normal(12)
    np.testing.assert_allclose((Gt @ _t(v)).numpy(), K @ v, rtol=1e-10)
    np.testing.assert_allclose((Gt @ _t(v)).numpy(), np.asarray(Gj @ jnp.asarray(v)), rtol=1e-10)


# -------------------- dispatch --------------------


def _branch_inputs(rng):
    """(cfjax kernel, port kernel, cfjax x, port x, cfjax y, port y) of
    every dispatch branch this module adds."""
    g1j, g1t = _grids(0.0, 0.1, 24)
    g2j, g2t = _grids(0.55, 0.1, 24)
    lgj, lgt = _lazy_grids((0.0, 0.3, 4), (0.0, 0.5, 3))
    tgj, tgt = _lazy_grids((0.1, 0.2, 2), (0.2, 0.25, 5))
    xs = np.linspace(-1.0, 1.0, 33)
    x3 = rng.standard_normal((5, 3))
    B = np.array([[1.0, 0.3], [0.3, 2.0]])
    sep_j, sep_t = jk.separable("*", jk.EQ(), jk.MaternP(1)), tk.separable("*", tk.EQ(),
                                                                           tk.MaternP(1))
    return {
        "toeplitz": (jk.Exp(), tk.Exp(), g1j, g1t, None, None),
        "toeplitz_nonsym": (jk.Exp(), tk.Exp(), g1j, g1t, g2j, g2t),
        "toeplitz_tensor": (jk.MaternP(2), tk.MaternP(2), jnp.asarray(xs), _t(xs), None, None),
        "toeplitz_cosine": (jk.Cosine(np.array([2.0])), tk.Cosine(np.array([2.0])), g1j, g1t,
                            None, None),
        "circulant": (jk.Periodic(jk.EQ()), tk.Periodic(tk.EQ()), *_grids(0.0, 0.125, 8),
                      None, None),
        "kronecker": (sep_j, sep_t, lgj, lgt, None, None),
        "kronecker_rect": (sep_j, sep_t, tgj, tgt, lgj, lgt),
        "separable_kernel": (JSeparableKernel(jk.EQ(), jnp.asarray(B)),
                             SeparableKernel(tk.EQ(), B), jnp.asarray(x3), _t(x3), None, None),
    }


@pytest.mark.parametrize("case", ["toeplitz", "toeplitz_nonsym", "toeplitz_tensor",
                                  "toeplitz_cosine", "circulant", "kronecker",
                                  "kronecker_rect", "separable_kernel"])
def test_dispatch_type_matches_reference(case, rng):
    kj, kt, xj, xt, yj, yt = _branch_inputs(rng)[case]
    Gj, Gt = j_gramian(kj, xj, yj), t_gramian(kt, xt, yt)
    assert type(Gt).__name__ == type(Gj).__name__
    assert Gt.shape == Gj.shape
    np.testing.assert_allclose(Gt.todense().numpy(), np.asarray(Gj.todense()), rtol=1e-10,
                               atol=1e-14)
    v = rng.standard_normal(Gt.shape[1])
    np.testing.assert_allclose((Gt @ _t(v)).numpy(), np.asarray(Gj @ jnp.asarray(v)),
                               rtol=1e-10, atol=1e-13)
    if case != "separable_kernel":
        assert t_explain(kt, xt, yt) == j_explain(kj, xj, yj)


def test_test_points_on_the_grid_dispatch_toeplitz():
    """post.mean at uniform 1-D test points of the training grid's num and
    step dispatches Toeplitz (step 8 with y), as in cfjax."""
    gj, gt = _grids(0.0, 0.1, 24)
    xs = 0.05 + 0.1 * np.arange(24)
    assert isinstance(t_gramian(tk.EQ(), _t(xs), gt), ToeplitzOperator)
    assert type(j_gramian(jk.EQ(), jnp.asarray(xs), gj)).__name__ == "ToeplitzOperator"


def test_from_reference_converts_structured_kernels():
    for kj in (jk.Periodic(jk.Lengthscale(jk.EQ(), 0.4)),
               jk.separable("*", jk.EQ(), jk.Lengthscale(jk.MaternP(2), 0.3)),
               jk.separable("^", jk.Exp(), d=3)):
        kt = tk.from_reference(kj)
        assert type(kt).__name__ == type(kj).__name__
        np.testing.assert_allclose(tk.parameters(kt).numpy(), np.asarray(jk.parameters(kj)))
    kt = tk.from_reference(JSeparableKernel(jk.EQ(), np.eye(2)))
    assert isinstance(kt, SeparableKernel) and type(kt.k).__name__ == "EQ"


# -------------------- solvers and GP --------------------


def test_cg_columns_matches_reference(rng):
    n, p = 40, 5
    M = rng.standard_normal((n, n))
    A = M @ M.T + n * np.eye(n)
    B = rng.standard_normal((n, p))
    B[:, 2] *= 1e-3                      # columns converge at different iterations
    Xt, it_t = cg_columns(lambda V: _t(A) @ V, _t(B), tol=1e-12)
    Xj, it_j = j_cg_columns(lambda V: jnp.asarray(A) @ V, jnp.asarray(B), tol=1e-12)
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(Xt.numpy(), np.linalg.solve(A, B), rtol=1e-8, atol=1e-12)
    assert it_t == int(it_j)
    X32, _ = cg_columns(lambda V: _t(A).float() @ V, _t(B).float(), tol=1e-6)
    assert X32.dtype == torch.float32


GRID_KERNELS = {"Exp": (jk.Exp, tk.Exp), "MaternP2": (lambda: jk.MaternP(2), lambda: tk.MaternP(2))}


@pytest.mark.parametrize("regime", ["cholesky", "cg"])
@pytest.mark.parametrize("name", sorted(GRID_KERNELS))
def test_gp_on_uniform_grid_matches_reference(name, regime, rng, request):
    if regime == "cg":
        request.getfixturevalue("small_cholesky_size")
    kj, kt = (f() for f in GRID_KERNELS[name])
    gj, gt = _grids(0.0, 0.05, 60)
    y = np.sin(3 * gt.points().numpy()) + 0.1 * rng.standard_normal(60)
    xt = rng.uniform(0, 3, 9)
    pj = j_condition(kj, gj, jnp.asarray(y), noise=1e-2, tol=1e-12, maxiter=2000)
    pt = t_condition(kt, gt, _t(y), noise=1e-2, tol=1e-12, maxiter=2000)
    tol = dict(rtol=1e-9) if regime == "cholesky" else dict(atol=1e-7)
    np.testing.assert_allclose(pt.alpha.numpy(), np.asarray(pj.alpha), **tol)
    np.testing.assert_allclose(pt.mean(_t(xt)).numpy(), np.asarray(pj.mean(jnp.asarray(xt))),
                               **tol)
    var_t = pt.variance(_t(xt), tol=1e-12, maxiter=500)
    var_j = pj.variance(jnp.asarray(xt), tol=1e-12, maxiter=500)
    np.testing.assert_allclose(var_t.numpy(), np.asarray(var_j), atol=1e-7)
    assert (var_t > 0).all()


def test_gp_on_lazy_grid_matches_reference(rng):
    gj, gt = _lazy_grids((0.0, 0.4, 5), (0.0, 0.5, 4), (0.0, 0.6, 3))
    tgj, tgt = _lazy_grids((0.1, 0.7, 3), (0.2, 0.45, 4), (0.0, 0.5, 2))
    kj = jk.separable("*", jk.EQ(), jk.MaternP(2), jk.Exp())
    kt = tk.separable("*", tk.EQ(), tk.MaternP(2), tk.Exp())
    P = gt.points().numpy()
    y = np.sin(P.sum(1)) + 0.1 * rng.standard_normal(len(P))
    pj = j_condition(kj, gj, jnp.asarray(y), noise=1e-2)
    pt = t_condition(kt, gt, _t(y), noise=1e-2)
    np.testing.assert_allclose(pt.alpha.numpy(), np.asarray(pj.alpha), rtol=1e-9)
    Ms = t_gramian(kt, tgt, gt)
    assert isinstance(Ms, KroneckerOperator) and Ms.shape == (24, 60)
    np.testing.assert_allclose(pt.mean(tgt).numpy(), np.asarray(pj.mean(tgj)), rtol=1e-9)
    xt = rng.uniform(0, 1.5, (6, 3))
    np.testing.assert_allclose(pt.mean(_t(xt)).numpy(), np.asarray(pj.mean(jnp.asarray(xt))),
                               rtol=1e-9)
    np.testing.assert_allclose(pt.variance(_t(xt), tol=1e-12, maxiter=500).numpy(),
                               np.asarray(pj.variance(jnp.asarray(xt), tol=1e-12, maxiter=500)),
                               atol=1e-7)


def test_logml_kronecker_structure_aware(rng):
    gj, gt = _lazy_grids(*[(0.0, 0.37, 16)] * 3)
    kj, kt = jk.separable("*", jk.EQ(), jk.EQ(), jk.EQ()), tk.separable("*", tk.EQ(), tk.EQ(),
                                                                       tk.EQ())
    y = rng.standard_normal(16**3)
    lm = t_lml(kt, gt, _t(y), noise=1e-2)
    np.testing.assert_allclose(float(lm), float(j_lml(kj, gj, jnp.asarray(y), noise=1e-2)),
                               rtol=1e-10)
    A = t_gramian(kt, gt).todense().numpy() + 1e-2 * np.eye(16**3)
    L = np.linalg.cholesky(A)
    z = np.linalg.solve(L, y)
    ref = -0.5 * (z @ z + 2 * np.log(np.diag(L)).sum() + 16**3 * np.log(2 * np.pi))
    np.testing.assert_allclose(float(lm), ref, rtol=1e-8)


def test_logml_circulant_structure_aware(rng):
    n = 256
    gj, gt = _grids(0.0, 1.0 / n, n)
    assert isinstance(t_gramian(tk.Periodic(tk.EQ()), gt), CirculantOperator)
    y = rng.standard_normal(n)
    lm = t_lml(tk.Periodic(tk.EQ()), gt, _t(y), noise=1e-3)
    np.testing.assert_allclose(float(lm), float(j_lml(jk.Periodic(jk.EQ()), gj, jnp.asarray(y),
                                                      noise=1e-3)), rtol=1e-10)
    A = t_gramian(tk.Periodic(tk.EQ()), gt).todense().numpy() + 1e-3 * np.eye(n)
    L = np.linalg.cholesky(A)
    z = np.linalg.solve(L, y)
    ref = -0.5 * (z @ z + 2 * np.log(np.diag(L)).sum() + n * np.log(2 * np.pi))
    np.testing.assert_allclose(float(lm), ref, rtol=1e-8)
    np.testing.assert_allclose(float(t_lml(tk.Periodic(tk.EQ()), gt, _t(y), noise=1e-3,
                                           method="cholesky")), ref, rtol=1e-8)


def _lml_grads(kernel_j, kernel_t, xj, xt, y, l0, noise0):
    """(d/dl, d/dnoise) of the logML in both packages."""
    gj = jax.grad(lambda l, s: j_lml(kernel_j(l), xj, jnp.asarray(y), noise=s),
                  argnums=(0, 1))(l0, noise0)
    l = torch.tensor(l0, dtype=F64, requires_grad=True)
    s = torch.tensor(noise0, dtype=F64, requires_grad=True)
    gt = torch.autograd.grad(t_lml(kernel_t(l), xt, _t(y), noise=s), (l, s))
    return [float(g) for g in gt], [float(g) for g in gj]


def test_logml_kronecker_gradient_matches_jax_grad(rng):
    """On a small grid whose factor eigenvalues are distinct
    (torch.linalg.eigh's backward needs them so)."""
    gj, gt = _lazy_grids((0.0, 0.37, 6), (0.1, 0.5, 5), (0.0, 0.3, 4))
    y = rng.standard_normal(120)
    kj = lambda l: jk.separable("*", jk.Lengthscale(jk.EQ(), l), jk.MaternP(2), jk.Exp())
    kt = lambda l: tk.separable("*", tk.Lengthscale(tk.EQ(), l), tk.MaternP(2), tk.Exp())
    for f in t_gramian(kt(0.8), gt).factors:
        w = torch.linalg.eigvalsh(f.todense())
        assert float(torch.diff(w).min()) > 1e-6
    got, ref = _lml_grads(kj, kt, gj, gt, y, 0.8, 0.05)
    np.testing.assert_allclose(got, ref, rtol=1e-8)


def test_logml_circulant_gradient_matches_jax_grad(rng):
    n = 64
    gj, gt = _grids(0.0, 1.0 / n, n)
    y = rng.standard_normal(n)
    got, ref = _lml_grads(lambda l: jk.Periodic(jk.Lengthscale(jk.EQ(), l)),
                          lambda l: tk.Periodic(tk.Lengthscale(tk.EQ(), l)), gj, gt, y, 0.6, 0.02)
    np.testing.assert_allclose(got, ref, rtol=1e-8)


# -------------------- linalg --------------------


def test_perfect_shuffle(rng):
    X = rng.standard_normal((3, 5))
    out = tlinalg.perfect_shuffle(_t(X.reshape(-1)), 3, 5)
    np.testing.assert_allclose(out.numpy(), X.T.reshape(-1))
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jlinalg.perfect_shuffle(jnp.asarray(X.reshape(-1)), 3, 5)))
    p = tlinalg.perfect_shuffle_indices(3, 5)
    np.testing.assert_array_equal(p, jlinalg.perfect_shuffle_indices(3, 5))
    np.testing.assert_allclose(X.reshape(-1)[p], X.T.reshape(-1))
    np.testing.assert_array_equal(tlinalg.perfect_shuffle_indices(4),
                                  jlinalg.perfect_shuffle_indices(4))


def test_exchange_and_loo(rng):
    J = tlinalg.exchange_matrix(4, dtype=F64).numpy()
    np.testing.assert_allclose(J, np.asarray(jlinalg.exchange_matrix(4)))
    v = rng.standard_normal(4)
    np.testing.assert_allclose(J @ v, v[::-1])
    x = rng.uniform(0.5, 2, 6)
    loo = tlinalg.leave_one_out_products(_t(x)).numpy()
    np.testing.assert_allclose(loo, [np.prod(np.delete(x, i)) for i in range(6)], rtol=1e-12)
    np.testing.assert_allclose(loo, np.asarray(jlinalg.leave_one_out_products(jnp.asarray(x))),
                               rtol=1e-14)


def test_givens_differentiable():
    c, s, r = tlinalg.givens_rotation(3.0, 4.0)
    np.testing.assert_allclose([float(c), float(s), float(r)], [0.6, 0.8, 5.0], rtol=1e-15)
    assert abs(float(-s * 3.0 + c * 4.0)) < 1e-12
    assert [float(v) for v in tlinalg.givens_rotation(0.0, 0.0)] == \
        [float(v) for v in jlinalg.givens_rotation(0.0, 0.0)] == [1.0, 0.0, 0.0]
    f = torch.tensor(3.0, dtype=F64, requires_grad=True)
    (g,) = torch.autograd.grad(tlinalg.givens_rotation(f, 4.0)[2], f)
    np.testing.assert_allclose(float(g), float(jax.grad(lambda f: jlinalg.givens_rotation(f, 4.0)[2])(3.0)),
                               rtol=1e-12)


def test_nth_and_jet_derivatives():
    x = 0.7
    expect = [np.sin(x), np.cos(x), -np.sin(x), -np.cos(x), np.sin(x)]
    xt = torch.tensor(x, dtype=F64)
    for fn in (tlinalg.nth_derivatives, tlinalg.jet_derivatives):
        np.testing.assert_allclose([float(v) for v in fn(torch.sin, xt, 4)], expect, rtol=1e-10)
    ref = jlinalg.jet_derivatives(lambda v: jnp.exp(-v * v), 0.3, 3)
    got = tlinalg.jet_derivatives(lambda v: torch.exp(-v * v), torch.tensor(0.3, dtype=F64), 3)
    np.testing.assert_allclose([float(v) for v in got], [float(v) for v in ref], rtol=1e-12)
