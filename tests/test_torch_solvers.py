"""Parity of the port's MINRES, GMRES and `solve` policy with cfjax.

Both packages run the same recurrences in float64 on the same numpy
inputs; the port's loops test convergence on the host, cfjax's inside a
`lax.while_loop`, so the iteration counts may differ by one where a
residual sits at the tolerance. Solutions agree within 1e-8."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfjax.kernels as jk
import cfjax_torch
import cfjax_torch.kernels as tk
from cfjax.operators.solvers import gmres as j_gmres
from cfjax.operators.solvers import minres as j_minres
from cfjax.operators.solvers import solve as j_solve
from cfjax.operators.sparse_op import sparse_gramian as j_sparse_gramian
from cfjax_torch.operators import cg, gmres, minres, solve, solve_with_info
from cfjax_torch.operators.sparse_op import sparse_gramian

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """Input without a device goes to the CPU in this module's tests; the
    configured device is restored after them."""
    shipped = cfjax_torch.config.DEFAULT.device
    cfjax_torch.set_config(device="cpu")
    yield
    cfjax_torch.set_config(device=shipped)


def _indefinite(rng, n, neg):
    """Symmetric, with eigenvalues spread over [-10, -1] (a share `neg` of
    them) and [1, 10]: indefinite, and far enough from singular that the
    two float64 recurrences do not drift apart through lost orthogonality."""
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    k = int(neg * n)
    lam = np.concatenate([-rng.uniform(1, 10, k), rng.uniform(1, 10, n - k)])
    return (Q * lam) @ Q.T


@pytest.mark.parametrize("n,neg", [(60, 0.5), (120, 0.2), (200, 0.7)])
def test_minres_matches_reference(n, neg, rng):
    A, b = _indefinite(rng, n, neg), rng.standard_normal(n)
    xj, (ij, _) = j_minres(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), tol=1e-10, maxiter=2000)
    xt, (it, res) = minres(lambda v: torch.tensor(A) @ v, torch.tensor(b), tol=1e-10,
                           maxiter=2000)
    assert abs(it - int(ij)) <= 1 and it < 2000
    assert float(res) <= 1e-10 * np.linalg.norm(b)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=1e-8)
    np.testing.assert_allclose(A @ xt.numpy(), b, rtol=0, atol=1e-8 * np.linalg.norm(b))


def test_minres_float32_keeps_dtype(rng):
    A, b = _indefinite(rng, 80, 0.3), rng.standard_normal(80)
    x, (it, _) = minres(lambda v: torch.tensor(A, dtype=torch.float32) @ v,
                        torch.tensor(b, dtype=torch.float32), tol=1e-5, maxiter=500)
    assert x.dtype == torch.float32 and it < 500
    assert np.linalg.norm(A @ x.double().numpy() - b) <= 1e-4 * np.linalg.norm(b)


@pytest.mark.parametrize("restart", [8, 32])
def test_gmres_matches_reference(restart, rng):
    n = 90
    B = rng.standard_normal((n, n)) + 12.0 * np.eye(n)
    b = rng.standard_normal(n)
    xj, (ij, rj) = j_gmres(lambda v: jnp.asarray(B) @ v, jnp.asarray(b), tol=1e-10, maxiter=400,
                           restart=restart)
    xt, (it, rt) = gmres(lambda v: torch.tensor(B) @ v, torch.tensor(b), tol=1e-10,
                         maxiter=400, restart=restart)
    assert it == int(ij) and rt <= 1e-10 * np.linalg.norm(b)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=1e-8)


def test_gmres_preconditioned_true_residual(rng):
    """With a left preconditioner the stopping test is on ||b - A x||."""
    n = 120
    A = rng.standard_normal((n, n)) + np.diag(np.linspace(1, 100, n))
    b = rng.standard_normal(n)
    d = torch.tensor(np.diag(A))
    xt, (it, rt) = gmres(lambda v: torch.tensor(A) @ v, torch.tensor(b), tol=1e-8, maxiter=400,
                         M=lambda v: v / d)
    assert rt <= 1e-8 * np.linalg.norm(b)
    assert np.linalg.norm(A @ xt.numpy() - b) <= 1e-8 * np.linalg.norm(b)


def _sparse_pair(rng, cross, fmt="tile"):
    x = rng.standard_normal((600, 2))
    y = rng.standard_normal((400, 2)) if cross else None
    kj = jk.Lengthscale(jk.EQ(), 0.3)
    Sj, _ = j_sparse_gramian(kj, jnp.asarray(x), None if y is None else jnp.asarray(y),
                             tol=1e-8, format=fmt, method="scan")
    St, _ = sparse_gramian(tk.from_reference(kj), torch.tensor(x),
                           None if y is None else torch.tensor(y), tol=1e-8, format=fmt,
                           method="scan")
    return Sj, St


@pytest.mark.parametrize("fmt", ["tile", "ell"])
def test_solve_routes_sparse_shift_to_minres(fmt, rng):
    """A sparsified Gramian is symmetric but not known PSD: `solve` picks
    MINRES, as cfjax's does."""
    Sj, St = _sparse_pair(rng, False, fmt)
    a = rng.standard_normal(600)
    op_t = St.add_diagonal(0.5)
    b = op_t @ torch.tensor(a)
    x, info = solve_with_info(op_t, b, tol=1e-10, maxiter=500)
    assert info is not None and 0 < info[0] < 500
    xm, _ = minres(op_t._matvec, b, tol=1e-10, maxiter=500)
    assert torch.equal(x, xm)
    np.testing.assert_allclose(x.numpy(), a, atol=1e-8)
    xj = j_solve(Sj.add_diagonal(0.5), jnp.asarray(b.numpy()), tol=1e-10, maxiter=500)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0, atol=1e-8)
    # a matrix right-hand side is solved column by column
    X = solve(op_t, torch.stack([b, 2 * b], dim=1), tol=1e-10, maxiter=500)
    np.testing.assert_allclose(X.numpy(), np.stack([a, 2 * a], axis=1), atol=1e-8)


def test_solve_rectangular_takes_cgnr(rng):
    """A rectangular operator goes to CGNR (CG on A^T A x = A^T b): on a
    cross sparse Gramian through its transpose MVM, and on a
    well-conditioned dense one to cfjax's answer and the least-squares
    solution."""
    _, St = _sparse_pair(rng, True)
    assert not St.is_symmetric and St.shape == (600, 400)
    b = torch.tensor(rng.standard_normal(600))
    x, info = solve_with_info(St, b, tol=1e-6, maxiter=50)
    xc, _ = cg(lambda v: St._rmatvec(St._matvec(v)), St._rmatvec(b), tol=1e-6, maxiter=50)
    assert torch.equal(x, xc) and info[0] <= 50

    from cfjax.operators import LowRankOperator as JLowRank
    from cfjax_torch.operators import LowRankOperator

    A = rng.standard_normal((200, 80)) + 3.0 * np.eye(200, 80)
    c = rng.standard_normal(200)
    x = solve(LowRankOperator(torch.tensor(A), torch.eye(80, dtype=torch.float64)),
              torch.tensor(c), tol=1e-12, maxiter=500)
    xj = j_solve(JLowRank(jnp.asarray(A), jnp.eye(80)), jnp.asarray(c), tol=1e-12, maxiter=500)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0, atol=1e-8)
    np.testing.assert_allclose(x.numpy(), np.linalg.lstsq(A, c, rcond=None)[0], rtol=0,
                               atol=1e-8)


def test_solve_explicit_methods(rng):
    n = 70
    A = _indefinite(rng, n, 0.4)
    from cfjax_torch.operators import DenseOperator

    op = DenseOperator(torch.tensor(A), symmetric=True)
    b = torch.tensor(rng.standard_normal(n))
    ref = np.linalg.solve(A, b.numpy())
    for method in ("minres", "gmres", "cgnr"):
        np.testing.assert_allclose(solve(op, b, tol=1e-12, maxiter=1000, method=method).numpy(),
                                   ref, atol=1e-8)
    with pytest.raises(NotImplementedError, match="refined"):
        solve(op, b, method="refined")
