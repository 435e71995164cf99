"""Solvers: CG, MINRES, GMRES, the Cholesky policy and factorize
(counterpart of `cfjax.operators.solvers`, reference src/gramian.jl:193-238,
src/lazy_linear_algebra.jl:135-144 and src/barneshut.jl:64-72).

CG runs its iterations in blocks between convergence reads (cfjax's is a
`lax.while_loop`): each iteration is one predicated step on device
tensors, which changes nothing once the residual has met the tolerance, so
the host reads the residual and the iteration count once a block, and
sizes the next block from the residual's decrease. On a CUDA device the
step is captured once a solve into a CUDA graph and each block is that
many replays: the host launches one graph an iteration instead of some
twenty kernels. MINRES and GMRES are Python loops with one host sync per
residual check. Every read to the host here is counted in `utils.trace`'s
`host_syncs`; `cg` and `cg_columns` are spans (`solvers.cg`,
`solvers.cg_columns`) with their iterations and the host's wait in their
reads. `torch.linalg.cholesky` raises on a
matrix that is not positive definite where `jnp.linalg.cholesky` returns
NaN, so the rank-revealing tests use `torch.linalg.cholesky_ex` and its
`info`. The refinement solvers run their outer loops on the host, as
cfjax's do: one residual norm read a refinement.
"""

from __future__ import annotations

import math
import threading

import torch

from .. import config as _config
from ..utils import trace
from .linop import LinearOperator, LowRankOperator


# CG's first block of iterations between two convergence reads, and the
# largest block
FIRST_BLOCK, MAX_BLOCK = 8, 32


class _Captures(threading.local):
    def __init__(self):
        # this thread's device index -> [the stream CG's step is captured
        # on, the memory pool the captures share, the last graph captured]
        self.held = {}


_CAPTURES = _Captures()


def cg(matvec, b, x0=None, tol: float = None, maxiter: int = None, M=None,
       callback=None):
    """Preconditioned conjugate gradients for SPD operators.

    matvec: callable v -> A v. M: callable v -> M^-1 v. Returns (x, info)
    with info = (iterations, final residual norm). `callback(i, x, r)`,
    if given, sees each iteration's iterate (in its accumulation dtype)
    and recursive residual.

    A float32 solve accumulates its iterate x in float64 (and returns it
    in float32): the rounding of a float32 x after every update, times
    A's spread of eigenvalues, otherwise caps the true residual far above
    the recursive one (measured on an H100 at n = 2^17: 7.3e-4 true vs
    1e-5 recursive after 316 PCG iterations). The operator and every
    other vector stay in b's dtype.

    The iterations run in blocks (`_next_block`) of one predicated step
    on device tensors: a step taken after the residual met the tolerance
    is frozen (alpha and beta 0: x, the residual and gamma kept, the count
    not advanced), so x, the residual and the count are those of the first
    converged iteration whatever the block. The host reads the residual
    and the count before the first block and after each, and with a
    callback after every step. On a CUDA device, with no callback and no
    autograd graph, the first step runs eagerly (caches fill) and the
    step is then captured into a CUDA graph that each block replays; a
    step that cannot be captured (one that reads to the host) runs
    eagerly. The span `solvers.cg` carries `iters`, `captured` (1: the
    graph), `replays` (the steps replayed from it), `reads` (the host's
    reads) and `frozen` (steps run after convergence). Its `launch.*`
    deltas count the kernels the host launched: a captured step's once,
    however often it is replayed."""
    tol = _config.DEFAULT.cg_tol if tol is None else tol
    maxiter = _config.DEFAULT.cg_maxiter if maxiter is None else maxiter
    b = torch.as_tensor(b)
    x = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0)
    acc = torch.float64 if b.dtype == torch.float32 else b.dtype
    Minv = (lambda v: v) if M is None else M

    sp = trace.begin("solvers.cg")
    its = steps = reads = replays = 0
    graph = None
    try:
        r = b - matvec(x)
        z = Minv(r)
        # in place unless autograd records the solve
        inplace = not (torch.is_grad_enabled()
                       and any(t.requires_grad for t in (b, x, r, z)))
        atol2 = (tol * torch.linalg.norm(b)).to(torch.float64) ** 2
        state = [x.to(acc, copy=True), r, z.clone(), torch.dot(r, z), torch.dot(r, r),
                 torch.zeros((), dtype=torch.int64, device=b.device)]
        zero = torch.zeros((), dtype=b.dtype, device=b.device)

        def step():
            # once the residual met the tolerance, alpha is 0: x and r stay,
            # z, gamma and the residual's norm come out as before, and p
            # becomes z, which no longer reaches x
            xa, r, p, gamma, rr, i = state
            out = (lambda t: t) if inplace else (lambda t: None)
            live = rr > atol2
            Ap = matvec(p)
            alpha = torch.where(live, gamma / torch.dot(p, Ap), zero)
            xa = torch.addcmul(xa, alpha, p, out=out(xa))   # float32 products exact in float64
            r = torch.sub(r, alpha * Ap, out=out(r))
            z = Minv(r)
            gamma_new = torch.dot(r, z)
            beta = torch.where(live, gamma_new / gamma, zero)
            p = torch.add(z, beta * p, out=out(p))
            gamma = torch.where(live, gamma_new, gamma, out=out(gamma))
            state[:] = [xa, r, p, gamma, torch.dot(r, r, out=out(rr)),
                        torch.add(i, live, out=out(i))]

        def read(*ts):
            nonlocal reads
            reads += 1
            return trace.cpu(torch.stack([t.to(torch.float64) for t in ts]), sp).tolist()

        rr0, atol2_h = read(state[4], atol2)
        capture = b.is_cuda and callback is None and inplace
        least = rr0
        k = 0 if rr0 <= atol2_h else min(1 if callback is not None else FIRST_BLOCK, maxiter)
        while k > 0:
            run = k
            if capture and graph is None:
                step()                  # the warm-up: caches fill, nothing is captured
                steps, run = steps + 1, run - 1
                if run:
                    graph = _capture(step, b.device)
                    capture = graph is not None
            if graph is not None:
                for _ in range(run):
                    graph.replay()
                replays += run
            else:
                for _ in range(run):
                    step()
            steps += run
            rr, i = read(state[4], state[5])
            i = int(i)
            if callback is not None and i > its:
                callback(i, state[0], state[1])
            its = i
            if rr <= atol2_h or its >= maxiter:
                break
            least = min(least, rr)
            k = 1 if callback is not None else _next_block(least, atol2_h, rr0, its)
            k = max(1, min(k, maxiter - its))
    finally:
        trace.end(sp, iters=its, captured=int(graph is not None), replays=replays,
                  reads=reads, frozen=steps - its)
    xa, r = state[0], state[1]
    return xa.to(b.dtype), (its, torch.linalg.norm(r))


def _next_block(least, atol2, rr0, its):
    """The steps to run before the next convergence read, in [1, MAX_BLOCK]:
    a third of the iterations left, at the mean log decrease of the squared
    residual over the `its` iterations so far (from `rr0` to `least`, the
    least one read), from `least` down to `atol2`. CG's residual is not
    monotone: on config 4's gradient system it swings by half a decade from
    one iteration to the next near the end, where blocks of the whole
    estimate from the last block's decrease ran 11-14 steps a solve past
    convergence, and this rule 0.4 (PERF.md). A residual that has not
    decreased, or a tolerance of 0, asks for the largest block."""
    k = MAX_BLOCK
    if atol2 > 0 and 0 < least < rr0:
        k = min(k, its * math.log(least / atol2) / (3 * math.log(rr0 / least)))
    return max(1, int(k))


def _capture(step, device):
    """A CUDA graph of `step()`, or None where the current stream is already
    capturing or capturing raises, as a step that reads to the host does.
    The capture checks this thread's calls alone (`thread_local`): another
    thread's work that is not capture-safe neither fails nor spoils it. The
    captures of one thread on one device share a side stream and a memory
    pool, so a solve's capture reuses the memory of the last one, which is
    never replayed again; the last graph is kept until the next capture,
    since a pool that no graph holds is freed, so between solves the pool
    holds one step's temporaries. `torch.cuda.graph` would synchronize the
    device and empty the allocator's cache at every capture. A failed
    capture leaves the allocator recording to its pool, which no later
    capture may then begin: that pool is closed and retired with its
    stream."""
    if torch.cuda.is_current_stream_capturing():
        return None
    idx = device.index if device.index is not None else torch.cuda.current_device()
    held = _CAPTURES.held
    if idx not in held:
        with torch.cuda.device(idx):
            held[idx] = [torch.cuda.Stream(), torch.cuda.graph_pool_handle(), None]
    side, pool, _ = held[idx]
    graph = torch.cuda.CUDAGraph()
    here = torch.cuda.current_stream(idx)
    side.wait_stream(here)
    try:
        with torch.cuda.stream(side):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                step()
            finally:
                graph.capture_end()
        held[idx][2] = graph
    except RuntimeError:        # torch's CUDA errors included
        graph = None
        del held[idx]
        try:
            torch._C._cuda_endAllocateToPool(idx, pool)
        except (AttributeError, RuntimeError):
            pass
    here.wait_stream(side)
    return graph


def cg_columns(matvec, B, tol: float = None, maxiter: int = None):
    """Multi-RHS CG: solve A X = B for every column of B in ONE batched
    recurrence (per-column alpha and beta; converged columns frozen by
    masking), so the operator sees (n, p) matmats: the batched equivalent
    of one `cg` per column. Returns (X, iterations). As in `cg`, a float32
    solve accumulates X in float64."""
    tol = _config.DEFAULT.cg_tol if tol is None else tol
    maxiter = _config.DEFAULT.cg_maxiter if maxiter is None else maxiter
    B = torch.as_tensor(B)
    acc = torch.float64 if B.dtype == torch.float32 else B.dtype
    atol2 = (tol * torch.linalg.norm(B, dim=0)) ** 2    # (p,)
    X = torch.zeros_like(B, dtype=acc)
    R, P = B, B
    g = torch.sum(R * R, dim=0)
    sp = trace.begin("solvers.cg_columns")
    i = 0
    try:
        live = g > atol2
        while i < maxiter and trace.item(live.any(), sp):
            AP = matvec(P)
            pAp = torch.sum(P * AP, dim=0)
            alpha = torch.where(live, g / torch.where(pAp != 0, pAp, 1.0), 0.0)
            X = X + alpha.to(acc)[None, :] * P.to(acc)
            R = R - alpha[None, :] * AP
            g_new = torch.sum(R * R, dim=0)
            beta = torch.where(live, g_new / torch.where(g != 0, g, 1.0), 0.0)
            P = torch.where(live[None, :], R + beta[None, :] * P, P)
            g = torch.where(live, g_new, g)
            live = g > atol2
            i += 1
    finally:
        trace.end(sp, iters=i)
    return X.to(B.dtype), i


def minres(matvec, b, x0=None, tol: float = None, maxiter: int = None):
    """MINRES for symmetric (possibly indefinite) operators: the Lanczos
    recurrence with Givens QR (Paige & Saunders), as cfjax's. Returns
    (x, info) with info = (iterations, |eta|), |eta| being the recursive
    residual norm.

    A float32 solve accumulates its iterate x in float64 (and returns it in
    float32), as `cg` does; the operator and every other vector stay in
    b's dtype."""
    tol = _config.DEFAULT.cg_tol if tol is None else tol
    maxiter = _config.DEFAULT.cg_maxiter if maxiter is None else maxiter
    b = torch.as_tensor(b)
    x0 = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0)
    acc = torch.float64 if b.dtype == torch.float32 else b.dtype
    xa = x0.to(acc)

    r0 = b - matvec(x0)
    beta1 = torch.linalg.norm(r0)
    bnorm = trace.item(torch.linalg.norm(b))
    atol = tol * (bnorm if bnorm > 0 else 1.0)
    tiny = torch.finfo(b.dtype).tiny
    safe = lambda t: torch.where(t > tiny, t, torch.ones_like(t))

    v_prev = torch.zeros_like(b)
    v = r0 / torch.where(beta1 > 0, beta1, torch.ones_like(beta1))
    w0 = torch.zeros_like(b)
    w_m1 = torch.zeros_like(b)
    beta = beta1
    one = torch.ones((), dtype=b.dtype, device=b.device)
    g0, g1, s0, s1 = one, one, 0 * one, 0 * one
    eta = beta1
    i = 0
    while i < maxiter and trace.item(torch.abs(eta)) > atol:
        Av = matvec(v)
        alpha = torch.dot(v, Av)
        v_next = Av - alpha * v - beta * v_prev
        beta_next = torch.linalg.norm(v_next)
        v_next = v_next / safe(beta_next)

        delta = g1 * alpha - g0 * s1 * beta
        rho1 = torch.sqrt(delta**2 + beta_next**2)
        rho2 = s1 * alpha + g0 * g1 * beta
        rho3 = s0 * beta
        gamma_new = delta / safe(rho1)
        sigma_new = beta_next / safe(rho1)

        w_new = (v - rho3 * w_m1 - rho2 * w0) / safe(rho1)
        xa = xa + (gamma_new * eta).to(acc) * w_new.to(acc)
        eta = -sigma_new * eta

        v_prev, v, w_m1, w0, beta = v, v_next, w0, w_new, beta_next
        g0, g1, s0, s1 = g1, gamma_new, s1, sigma_new
        i += 1
    return xa.to(b.dtype), (i, torch.abs(eta))


def gmres(matvec, b, x0=None, tol: float = None, maxiter: int = None, restart: int = 32,
          M=None):
    """Restarted GMRES(m) for non-symmetric operators, as cfjax's: each
    cycle runs `restart` Arnoldi steps (modified Gram-Schmidt), solves the
    small least-squares problem, and tests the true residual ||b - A x||.
    M: callable v -> M^-1 v (left preconditioner). Returns (x, (matvecs,
    final residual norm))."""
    tol = _config.DEFAULT.cg_tol if tol is None else tol
    maxiter = _config.DEFAULT.cg_maxiter if maxiter is None else maxiter
    b = torch.as_tensor(b)
    n = b.shape[0]
    x = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0)
    Minv = (lambda v: v) if M is None else M
    m = int(min(restart, maxiter))
    bnorm = trace.item(torch.linalg.norm(b))
    atol = tol * (bnorm if bnorm > 0 else 1.0)
    eps = torch.finfo(b.dtype).eps
    safe = lambda t, lo: torch.where(t > lo, t, torch.ones_like(t))

    def arnoldi_cycle(x):
        r = Minv(b - matvec(x))
        beta = torch.linalg.norm(r)
        V = torch.zeros((m + 1, n), dtype=b.dtype, device=b.device)
        V[0] = r / safe(beta, 0)
        H = torch.zeros((m + 1, m), dtype=b.dtype, device=b.device)
        for j in range(m):
            w = Minv(matvec(V[j]))
            for i in range(j + 1):
                H[i, j] = torch.dot(V[i], w)
                w = w - H[i, j] * V[i]
            H[j + 1, j] = torch.linalg.norm(w)
            V[j + 1] = w / safe(H[j + 1, j], eps)
        e1 = torch.zeros((m + 1, 1), dtype=torch.float64)
        e1[0, 0] = trace.cpu(beta.double())
        # minimum-norm least squares (SVD-based, as jnp.linalg.lstsq), on
        # the host: the problem is (restart + 1) x restart
        y = torch.linalg.lstsq(trace.cpu(H.double()), e1, driver="gelsd").solution[:, 0]
        return x + V[:m].T @ trace.to_device(y, b.device, b.dtype)

    res = trace.item(torch.linalg.norm(b - matvec(x)))
    it = 0
    while it < maxiter and res > atol:
        x = arnoldi_cycle(x)
        # stopping test on the true residual (one extra matvec per cycle):
        # with M the Arnoldi residual lives in preconditioned space
        res = trace.item(torch.linalg.norm(b - matvec(x)))
        it += m + 1
    return x, (it, res)


def refined_solve(matvec_hi, matvec_lo, b, M=None, tol: float = 1e-8,
                  inner_tol: float = 1e-3, inner_maxiter: int = 60,
                  refinements: int = 4):
    """Mixed-precision iterative refinement: inner PCG in float32,
    residuals recomputed in float64.

    At n ~ 10^5-10^6 the condition number of a GP system crosses
    1/eps_f32 and plain float32 PCG stalls; one float64 MVM per
    refinement restores float64-quality solutions while the Krylov work
    stays in float32.

    matvec_hi: v -> A v in float64 (float64 in and out; anything else
    raises TypeError: a float32 residual would make the refinement a no-op).
    matvec_lo: v -> A v in float32. M: callable v -> M^-1 v for the inner
    PCG. Returns (x, (outer_iters, final float64 residual norm))."""
    b = torch.as_tensor(b).to(torch.float64)

    def residual(x):
        Ax = matvec_hi(x)
        if Ax.dtype != torch.float64:
            raise TypeError(f"refined_solve needs a float64 matvec_hi, got {Ax.dtype}: the "
                            "refinement cannot improve on plain float32 CG without it")
        return b - Ax

    x = torch.zeros_like(b)
    bnorm = trace.item(torch.linalg.norm(b))
    it = 0
    for it in range(1, refinements + 1):
        r = residual(x)
        res = torch.linalg.norm(r)
        if trace.item(res) <= tol * bnorm:
            return x, (it - 1, res)
        d, _ = cg(matvec_lo, r.to(torch.float32), tol=inner_tol, maxiter=inner_maxiter, M=M)
        x = x + d.to(torch.float64)
    return x, (it, torch.linalg.norm(residual(x)))


def approx_refined_solve(matvec_exact, matvec_approx, b, M=None,
                         tol: float = 1e-4, inner_tol: float = 3e-2,
                         inner_maxiter: int = 20, refinements: int = 8):
    """Inexact inner, exact outer: GMRES against a cheap approximate
    operator (Barnes-Hut, sparsified, low-rank) corrected by residuals of
    the exact one, so the returned residual is the true system's. Per outer
    step the error contracts by about max(inner_tol, ||A^-1 E||), E the
    approximation's error: the steps converge only where E's spectral norm
    sits below the smallest eigenvalue of A (the noise variance of a GP).

    Runs in b's dtype. The inner solver is GMRES (restart = inner_maxiter):
    the approximation is usually not symmetric, which breaks CG's
    recurrence. Returns (x, (outer_iters, final exact-residual norm))."""
    b = torch.as_tensor(b)
    x = torch.zeros_like(b)
    bnorm = trace.item(torch.linalg.norm(b))
    r = b
    it = 0
    for it in range(1, refinements + 1):
        res = torch.linalg.norm(r)
        if trace.item(res) <= tol * bnorm:
            return x, (it - 1, res)
        d, _ = gmres(matvec_approx, r, tol=inner_tol, maxiter=inner_maxiter,
                     restart=inner_maxiter, M=M)
        x = x + d
        r = b - matvec_exact(x)
    return x, (it, torch.linalg.norm(r))


def _tri_solve(L, b, upper=False, left_transpose=False):
    A = L.mT if left_transpose else L
    B = b[:, None] if b.ndim == 1 else b
    out = torch.linalg.solve_triangular(A, B, upper=upper)
    return out[:, 0] if b.ndim == 1 else out


def _dense(op):
    return op.todense() if isinstance(op, LinearOperator) else torch.as_tensor(op)


class CholeskyFactorization:
    """Dense Cholesky of a lazy operator (reference `cholesky`/`factorize`
    small-n branch, src/gramian.jl:193-213). A tol-scaled jitter is added
    only when the clean factorization fails."""

    def __init__(self, op, jitter: float = None, _L0=None):
        A = _dense(op)
        n = A.shape[0]
        jitter = _config.DEFAULT.default_tol if jitter is None else jitter
        if _L0 is None:
            _L0, info = torch.linalg.cholesky_ex(A)
            if trace.item(info) != 0:
                scale = torch.mean(torch.diagonal(A))
                shift = (jitter * scale) * torch.eye(n, dtype=A.dtype, device=A.device)
                _L0 = torch.linalg.cholesky(A + shift)
        self.L = _L0
        self.shape = tuple(A.shape)

    def solve(self, b):
        z = _tri_solve(self.L, b, upper=False)
        return _tri_solve(self.L, z, upper=True, left_transpose=True)

    def logdet(self):
        return 2 * torch.sum(torch.log(torch.diagonal(self.L)))


class LowRankFactorization:
    """Rank-revealing factorization of a numerically rank-deficient PSD
    operator: the semantics of the reference's pivoted Cholesky with
    tolerance (src/gramian.jl:193-199), through one eigendecomposition,
    keeping the eigenpairs above tol * lambda_max. solve() is the
    minimum-norm pseudo-inverse solve; logdet() the pseudo-determinant."""

    def __init__(self, op, tol: float = None):
        tol = _config.DEFAULT.default_tol if tol is None else tol
        if (isinstance(op, LowRankOperator) and op.is_psd
                and op.U.shape[1] < op.shape[0]):
            # already a factor A = U0 U0^T: eigendecompose the r x r Gram
            # matrix instead of densifying — O(n r^2)
            U0 = op.U
            s, W = torch.linalg.eigh(U0.T @ U0)
            smax = torch.clamp(s[-1], min=torch.finfo(U0.dtype).tiny)
            r = max(1, trace.item(torch.sum(s > tol * smax)))
            w = s[-r:]
            Q = U0 @ (W[:, -r:] / torch.sqrt(w)[None, :])
            self.shape = op.shape
        else:
            A = _dense(op)
            w, Q = torch.linalg.eigh(A)
            wmax = torch.clamp(w[-1], min=torch.finfo(A.dtype).tiny)
            r = max(1, trace.item(torch.sum(w > tol * wmax)))
            w = w[-r:]
            Q = Q[:, -r:]
            self.shape = tuple(A.shape)
        self.rank = r
        self.U = Q * torch.sqrt(w)[None, :]   # A ~= U U^T, (n, r)
        self._w = w
        self._Q = Q

    def solve(self, b):
        t = self._Q.T @ b
        return self._Q @ (t / (self._w if b.ndim == 1 else self._w[:, None]))

    def logdet(self):
        return torch.sum(torch.log(self._w))


def factorize(op, max_cholesky_size: int = None, rank_tol: float = None):
    """Policy: dense factorization below the size threshold, else the lazy
    operator itself (solved iteratively) — src/gramian.jl:201-213. A
    failed clean Cholesky (numerically rank-deficient matrix) re-factors
    as a rank-revealing `LowRankFactorization` at `rank_tol`."""
    mcs = _config.DEFAULT.max_cholesky_size if max_cholesky_size is None else max_cholesky_size
    n = op.shape[0]
    sym = op.is_symmetric if isinstance(op, LinearOperator) else True
    if n <= mcs and sym:
        if isinstance(op, LowRankOperator) and op.U.shape[1] < n:
            return LowRankFactorization(op, tol=rank_tol)
        A = _dense(op)
        L0, info = torch.linalg.cholesky_ex(A)
        if trace.item(info) != 0:
            return LowRankFactorization(A, tol=rank_tol)
        return CholeskyFactorization(A, _L0=L0)
    return op


def solve(op, b, tol: float = None, maxiter: int = None, method: str = "auto"):
    """A \\ b for any operator: Cholesky (small symmetric PSD, the
    reference policy up to max_cholesky_size, src/gramian.jl:201-213), CG
    (PSD), MINRES (symmetric indefinite), GMRES (general,
    method="gmres"), mixed-precision refinement (method="refined", see
    `solve_with_info`), CGNR normal equations (non-symmetric / rectangular
    least squares, src/lazy_linear_algebra.jl:135-144)."""
    return solve_with_info(op, b, tol, maxiter, method)[0]


def solve_with_info(op, b, tol: float = None, maxiter: int = None, method: str = "auto"):
    """`solve`, returning (x, info): info is the iterative solver's
    (iterations, final residual norm) on the CG, MINRES, GMRES and CGNR
    branches (a list of them for a 2-D b), and refined_solve's (outer
    iterations, float64 residual norm) on the "refined" branch, else None.

    method="refined" is `refined_solve` with both products from the
    operator's own MVM in its dtype, cast to float64 and float32 (tol
    default 1e-8), as cfjax's: on a float32 operator its "float64"
    residual carries float32 error, so the refinement cannot beat float32
    there. For float64 residuals pass a float64 `matvec_hi` to
    `refined_solve`."""
    if isinstance(op, (CholeskyFactorization, LowRankFactorization)):
        return op.solve(b), None
    b = b if isinstance(b, torch.Tensor) else torch.as_tensor(b, device=getattr(op, "device",
                                                                                  None))
    if method == "refined":
        mv, dt = op._matvec, op.dtype
        return refined_solve(lambda v: mv(v.to(dt)).to(torch.float64),
                             lambda v: mv(v.to(dt)).to(torch.float32), b,
                             tol=1e-8 if tol is None else tol)
    if method == "auto":
        if op.is_symmetric and op.is_psd:
            method = "cholesky" if op.shape[0] <= _config.DEFAULT.max_cholesky_size else "cg"
        elif op.is_symmetric:
            method = "minres"
        else:
            method = "cgnr"
    if method == "cholesky":
        return CholeskyFactorization(op).solve(b), None
    mv = op._matvec
    if method == "cgnr":
        # normal equations A^T A x = A^T b, solved by CG: the least-squares
        # solution for rectangular / non-symmetric operators
        rmv = op._rmatvec
        f = lambda bb: cg(lambda v: rmv(mv(v)), rmv(bb), tol=tol, maxiter=maxiter)
    elif method in ("cg", "minres", "gmres"):
        it = {"cg": cg, "minres": minres, "gmres": gmres}[method]
        f = lambda bb: it(mv, bb, tol=tol, maxiter=maxiter)
    else:
        raise ValueError(f"unknown solve method {method!r}")
    if b.ndim == 1:
        return f(b)
    cols = [f(b[:, j]) for j in range(b.shape[1])]
    return torch.stack([c[0] for c in cols], dim=1), [c[1] for c in cols]
