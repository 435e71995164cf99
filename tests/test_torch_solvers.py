"""Parity of the port's MINRES, GMRES and `solve` policy with cfjax, and
the blocks of CG's predicated step.

Both packages run the same recurrences in float64 on the same numpy
inputs; the port's loops test convergence on the host, cfjax's inside a
`lax.while_loop`, so the iteration counts may differ by one where a
residual sits at the tolerance. Solutions agree within 1e-8. CG reads its
residual once a block of steps: whatever the block, it returns what it
returns reading after every step."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfjax.kernels as jk
import cfjax_torch
import cfjax_torch.kernels as tk
from cfjax_torch.operators import solvers
from cfjax.operators.solvers import gmres as j_gmres
from cfjax.operators.solvers import minres as j_minres
from cfjax.operators.solvers import solve as j_solve
from cfjax.operators.sparse_op import sparse_gramian as j_sparse_gramian
from cfjax_torch.operators import cg, gmres, minres, solve, solve_with_info
from cfjax_torch.operators.sparse_op import sparse_gramian
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
    with pytest.raises(ValueError, match="unknown solve method"):
        solve(op, b, method="refine")


def _spd_system(dtype, precondition, decades=3.0):
    """A 96 x 96 SPD system Q diag(lambda) Q^T with eigenvalues spread over
    `decades` decades (a badly scaled diagonal on top where decades > 1),
    its right-hand side, and the Jacobi preconditioner (or none)."""
    g = torch.Generator().manual_seed(5)
    Q, _ = torch.linalg.qr(torch.randn(96, 96, generator=g, dtype=torch.float64))
    D = torch.diag(torch.logspace(0, float(decades > 1), 96, dtype=torch.float64))
    lam = torch.logspace(-decades / 2, decades / 2, 96, dtype=torch.float64)
    A = (D @ (Q * lam) @ Q.T @ D).to(dtype)
    b = torch.randn(96, generator=g, dtype=torch.float64).to(dtype)
    d = torch.diagonal(A)
    return (lambda v: A @ v), b, ((lambda v: v / d) if precondition else None)


def _blocked_cg(k, monkeypatch, *args, **kw):
    """cg with every block k steps long; (x, iterations, residual, span)."""
    monkeypatch.setattr(solvers, "FIRST_BLOCK", k)
    monkeypatch.setattr(solvers, "_next_block", lambda *a: k)
    trace.clear()
    with trace.recording():
        x, (its, res) = cg(*args, **kw)
    (sp,) = [s for s in trace.spans() if s["name"] == "solvers.cg"]
    trace.clear()
    return x, its, res, sp["attrs"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("precondition", [False, True])
@pytest.mark.parametrize("k", [1, 3, 8, 32])
def test_cg_blocks_return_the_stepwise_answer(k, precondition, dtype, monkeypatch):
    """Blocks of k predicated steps against reading after every step
    (k = 1): the same x, iterations and residual, bit for bit; the steps of
    a block after convergence are frozen and counted; a solve that cannot
    converge stops at exactly maxiter; x0 is honoured."""
    mv, b, M = _spd_system(dtype, precondition)
    tol = 1e-5 if dtype == torch.float32 else 1e-10

    one = _blocked_cg(1, monkeypatch, mv, b, tol=tol, maxiter=500, M=M)
    x, its, res, at = _blocked_cg(k, monkeypatch, mv, b, tol=tol, maxiter=500, M=M)
    assert 8 < its == one[1] < 500 and torch.equal(x, one[0]) and torch.equal(res, one[2])
    assert x.dtype == dtype and res <= tol * torch.linalg.norm(b)
    assert one[3]["frozen"] == 0 and at["frozen"] == (-its) % k
    assert at["reads"] == 1 + -(-its // k) and at["host_syncs"] == at["reads"]
    assert at["captured"] == at["replays"] == 0 and at["iters"] == its

    # maxiter cuts a block short: 13 iterations, none frozen
    x, cut, res, at = _blocked_cg(k, monkeypatch, mv, b, tol=0.0, maxiter=13, M=M)
    one = _blocked_cg(1, monkeypatch, mv, b, tol=0.0, maxiter=13, M=M)
    assert cut == one[1] == 13 and at["frozen"] == 0 and torch.equal(x, one[0])

    # a start near the answer (the solve to a 100 times looser tolerance):
    # fewer iterations, the same tolerance met
    x0 = _blocked_cg(1, monkeypatch, mv, b, tol=100 * tol, maxiter=500, M=M)[0]
    x, its0, res, at = _blocked_cg(k, monkeypatch, mv, b, x0=x0, tol=tol, maxiter=500, M=M)
    one = _blocked_cg(1, monkeypatch, mv, b, x0=x0, tol=tol, maxiter=500, M=M)
    assert its0 == one[1] < its and torch.equal(x, one[0]) and res <= tol * torch.linalg.norm(b)
    assert at["frozen"] == (-its0) % k


def test_cg_block_converged_inside_is_frozen(monkeypatch):
    """A solve that converges inside its one block of 32: the steps after
    convergence change neither x nor the residual."""
    mv, b, M = _spd_system(torch.float64, True, decades=1.0)
    x, its, res, at = _blocked_cg(32, monkeypatch, mv, b, tol=1e-6, maxiter=500, M=M)
    one = _blocked_cg(1, monkeypatch, mv, b, tol=1e-6, maxiter=500, M=M)
    assert 0 < its < 32 and at["frozen"] == 32 - its and at["reads"] == 2
    assert torch.equal(x, one[0]) and torch.equal(res, one[2])


def test_cg_starts_converged(monkeypatch):
    """b = 0, or x0 the answer already: no step is run, one read."""
    mv, b, M = _spd_system(torch.float64, False)
    for bb, x0 in ((torch.zeros_like(b), None), (b, torch.linalg.solve(
            torch.stack([mv(e) for e in torch.eye(96, dtype=torch.float64)]).T, b))):
        x, its, res, at = _blocked_cg(8, monkeypatch, mv, bb, x0=x0, tol=1e-6, maxiter=50)
        assert its == 0 and at["reads"] == 1 and at["frozen"] == 0
        assert torch.equal(x, torch.zeros_like(b) if x0 is None else x0)


@pytest.mark.parametrize("least,its,want", [
    (1e4, 8, 2),          # 4 decades in 8 iterations, 4 left: a third of 8
    (1e2, 8, 1),          # 6 in 8, 2 left: a third of 2.7
    (1e7, 8, 18),         # 1 in 8, 7 left: a third of 56
    (1e7, 40, 32),        # 1 in 40, 7 left: a third of 280 above the largest block
    (1e4, 60, 20),        # 4 in 60, 4 left: a third of 60
    (1.0000001, 300, 1),  # all but converged: one step
    (1e8, 8, 32),         # no decrease: the largest block
])
def test_next_block(least, its, want):
    """A third of the iterations left at the mean decrease so far, from the
    least residual read (rr0 = 1e8, atol2 = 1), in [1, MAX_BLOCK]."""
    assert solvers._next_block(least, 1.0, 1e8, its) == want
    assert solvers._next_block(least, 0.0, 1e8, its) == solvers.MAX_BLOCK


def test_cg_callback_sees_every_iteration(monkeypatch):
    """With a callback, cg reads after every step and calls it once an
    iteration, with the count, the float64 iterate and the residual."""
    mv, b, M = _spd_system(torch.float32, True)
    seen = []
    trace.clear()
    with trace.recording():
        x, (its, res) = cg(mv, b, tol=1e-5, maxiter=500, M=M,
                           callback=lambda i, xa, r: seen.append((i, xa.dtype, float(r @ r))))
    (sp,) = trace.spans()
    trace.clear()
    assert [s[0] for s in seen] == list(range(1, its + 1)) and seen[0][1] == torch.float64
    assert sp["attrs"]["reads"] == its + 1 and sp["attrs"]["frozen"] == 0
    assert torch.equal(x, _blocked_cg(8, monkeypatch, mv, b, tol=1e-5, maxiter=500, M=M)[0])


def test_cg_under_autograd():
    """A solve autograd records takes the same steps out of place: its
    gradient through the iterations matches the one of A^-1 b."""
    g = torch.Generator().manual_seed(7)
    B = torch.randn(24, 24, generator=g, dtype=torch.float64)
    A = B @ B.T + 24 * torch.eye(24, dtype=torch.float64)
    b = torch.randn(24, generator=g, dtype=torch.float64, requires_grad=True)
    x, (its, _) = cg(lambda v: A @ v, b, tol=1e-12, maxiter=200)
    (gx,) = torch.autograd.grad(x.sum(), b)
    assert its > 0 and x.grad_fn is not None
    torch.testing.assert_close(gx, torch.linalg.solve(A, torch.ones(24, dtype=torch.float64)),
                               rtol=1e-8, atol=1e-10)
