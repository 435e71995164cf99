"""Parity of the port's refinement solvers (`refined_solve`,
`approx_refined_solve`, `solve(method="refined")`) with cfjax's.

The operators are the same numpy matrices in both packages (cfjax's
`test_refined_solve_beats_f32_cg` and `test_approx_refined_solve_inexact_inner`
inputs), and the preconditioner is cfjax's Nystrom apply written out as a
dense float32 matrix, so both solvers see identical products. Their float32
inner solves still round differently: the port's CG accumulates its iterate
in float64, and its GMRES solves the small least-squares problem in float64.
So the outer iteration counts are identical and the solutions agree to what
the float64 outer loop leaves of that difference (tolerances beside each
check)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfjax.kernels as jk
import cfjax_torch
import cfjax_torch.kernels as tk
from cfjax.operators import gramian as j_gramian
from cfjax.operators import nystrom_preconditioner as j_nystrom
from cfjax.operators.solvers import approx_refined_solve as j_approx
from cfjax.operators.solvers import refined_solve as j_refined
from cfjax.operators.solvers import solve as j_solve
from cfjax.utils.testing import pairwise
from cfjax_torch.operators import (approx_refined_solve, cg, gramian, refined_solve,
                                   solve, solve_with_info)

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    shipped = cfjax_torch.config.DEFAULT.device
    cfjax_torch.set_config(device="cpu")
    yield
    cfjax_torch.set_config(device=shipped)


def _dense_apply(M, n):
    """cfjax's preconditioner apply as a dense float32 matrix."""
    return np.asarray(jax.vmap(M, in_axes=1, out_axes=1)(jnp.eye(n, dtype=jnp.float32)))


def _both(A):
    """v -> A v in each package, on the same numpy matrix."""
    Aj, At = jnp.asarray(A), torch.tensor(A)
    return (lambda v: Aj @ v), (lambda v: At @ v)


def test_refined_solve_matches_reference(rng):
    """cfjax's test_refined_solve_beats_f32_cg system (n = 1024, sigma^2 =
    1e-3, kappa ~ 1e6): the same number of refinements, x within 1e-8 of
    the largest entry of cfjax's (measured 4.5e-9), a float64 residual
    below 1e-9 and 100x below plain float32 PCG's true one."""
    n = 1024
    x = rng.uniform(-5, 5, (n, 2))
    k = jk.Lengthscale(jk.EQ(), 1.5)
    s2 = 1e-3
    K64 = np.asarray(pairwise(k, jnp.asarray(x), jnp.asarray(x))) + s2 * np.eye(n)
    b = K64 @ rng.standard_normal(n)
    Mmat = _dense_apply(j_nystrom(k, jnp.asarray(x, jnp.float32), s2, rank=256), n)
    (hi_j, hi_t), (lo_j, lo_t), (M_j, M_t) = _both(K64), _both(K64.astype(np.float32)), _both(Mmat)
    opts = dict(tol=1e-9, inner_tol=1e-3, inner_maxiter=100, refinements=8)
    xj, (oj, _) = j_refined(hi_j, lo_j, jnp.asarray(b), M=M_j, **opts)
    xt, (ot, res) = refined_solve(hi_t, lo_t, torch.tensor(b), M=M_t, **opts)
    assert xt.dtype == torch.float64
    assert ot == int(oj)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0,
                               atol=1e-8 * np.abs(np.asarray(xj)).max())
    bn = np.linalg.norm(b)
    rel = float(res) / bn
    assert rel < 1e-9
    # the reported residual is the true float64 one
    assert abs(np.linalg.norm(b - K64 @ xt.numpy()) / bn - rel) <= 1e-3 * rel
    x32, _ = cg(lo_t, torch.tensor(b, dtype=torch.float32), tol=1e-10, maxiter=500, M=M_t)
    rel32 = np.linalg.norm(b - K64 @ x32.double().numpy()) / bn
    assert rel < rel32 / 100, (rel, rel32)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_approx_refined_solve_matches_reference(dtype, rng):
    """cfjax's test_approx_refined_solve_inexact_inner system (n = 768, a
    non-symmetric perturbation at 0.2 sigma^2 spectral norm): the same
    outer count and cfjax's bounds on the residual; x within 1e-8 of
    cfjax's in float64 (measured 8e-13), within 1e-3 in float32, where the
    two GMRES solves round differently and each stops at relres 1e-4
    (measured 7.8e-5)."""
    n = 768
    x = rng.uniform(-5, 5, (n, 2)).astype(np.float32)
    k = jk.Lengthscale(jk.EQ(), 1.0)
    s2 = 1e-2
    K = np.asarray(pairwise(k, jnp.asarray(x), jnp.asarray(x))).astype(np.float32)
    A = K + s2 * np.eye(n, dtype=np.float32)
    E = rng.standard_normal((n, n)).astype(np.float32)
    Aap = A + (0.2 * s2 / float(np.linalg.norm(E, 2))) * E
    b = A @ rng.standard_normal(n).astype(np.float32)
    Mmat = _dense_apply(j_nystrom(k, jnp.asarray(x), s2, rank=128), n)
    A, Aap, b, Mmat = (a.astype(dtype) for a in (A, Aap, b, Mmat))
    (ex_j, ex_t), (ap_j, ap_t), (M_j, M_t) = _both(A), _both(Aap), _both(Mmat)
    opts = dict(tol=1e-4, inner_tol=3e-2, inner_maxiter=30, refinements=8)
    xj, (oj, _) = j_approx(ex_j, ap_j, jnp.asarray(b), M=M_j, **opts)
    xt, (ot, res) = approx_refined_solve(ex_t, ap_t, torch.tensor(b), M=M_t, **opts)
    assert xt.dtype == torch.from_numpy(b).dtype
    assert ot == int(oj) and ot <= 6
    rel = float(res) / float(np.linalg.norm(b))
    assert rel < 1e-4
    true_rel = np.linalg.norm(b.astype(np.float64) - A.astype(np.float64) @ xt.double().numpy())
    assert true_rel / np.linalg.norm(b.astype(np.float64)) < 1.5e-4
    tol = 1e-8 if dtype == np.float64 else 1e-3
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0,
                               atol=tol * np.abs(np.asarray(xj)).max())


def _gp_operators(dtype, rng):
    n = 300
    x = rng.uniform(-5, 5, (n, 2)).astype(dtype)
    y = np.sin(x[:, 0].astype(np.float64))
    Kj = j_gramian(jk.EQ(), jnp.asarray(x)).add_diagonal(1.0)
    Kt = gramian(tk.EQ(), torch.tensor(x)).add_diagonal(1.0)
    return Kj, Kt, y


@pytest.mark.parametrize("tol", [None, 1e-6])
def test_solve_refined_on_a_float64_operator_matches_reference(tol, rng):
    """solve(method="refined") on a float64 Gramian + I: both products from
    the operator's own MVM; the same refinements, x within 1e-8 of
    cfjax's (measured 1e-9), the reported residual below tol."""
    Kj, Kt, y = _gp_operators(np.float64, rng)
    xj = np.asarray(j_solve(Kj, jnp.asarray(y), method="refined", tol=tol))
    xt, (it, res) = solve_with_info(Kt, torch.tensor(y), method="refined", tol=tol)
    assert xt.dtype == torch.float64
    np.testing.assert_allclose(xt.numpy(), xj, rtol=0, atol=1e-8 * np.abs(xj).max())
    assert float(res) <= (1e-8 if tol is None else tol) * np.linalg.norm(y)
    np.testing.assert_array_equal(solve(Kt, torch.tensor(y), method="refined", tol=tol), xt)


def test_solve_refined_on_a_float32_operator_keeps_the_reference_floor(rng):
    """On a float32 operator cfjax's "float64" residual is the float32 MVM
    cast up, so the refinement stops at float32's floor above 1e-8 after
    its 4 refinements; the port mirrors it (x within 1e-5 of cfjax's:
    float32 products; measured 4.2e-7)."""
    Kj, Kt, y = _gp_operators(np.float32, rng)
    xj = np.asarray(j_solve(Kj, jnp.asarray(y), method="refined"))
    xt, (it, res) = solve_with_info(Kt, torch.tensor(y), method="refined")
    assert it == 4 and float(res) > 1e-8 * np.linalg.norm(y)
    np.testing.assert_allclose(xt.numpy(), xj, rtol=0, atol=1e-5 * np.abs(xj).max())


def test_refined_solve_needs_a_float64_matvec_hi():
    A = torch.eye(8, dtype=torch.float64) * 2.0
    with pytest.raises(TypeError, match="float64"):
        refined_solve(lambda v: (A @ v).float(), lambda v: A.float() @ v, torch.ones(8))
    x, (it, res) = refined_solve(lambda v: A @ v, lambda v: A.float() @ v, torch.ones(8))
    assert it == 1 and float(res) == 0.0 and torch.equal(x, torch.full((8,), 0.5,
                                                                        dtype=torch.float64))
