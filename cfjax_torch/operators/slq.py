"""Stochastic Lanczos quadrature (SLQ) logdet and the CG quadratic form for
lazy operators (counterpart of `cfjax.operators.slq`).

logdet(K) is estimated by Lanczos quadrature over Rademacher probes
(Ubaru-Chen-Saad), all probes batched through the operator's matmat, so a
Gramian on the card evaluates each kernel entry once per Lanczos step for
the whole batch (K1's many-column variant). The gradient
d logdet(K)/dtheta = tr(K^-1 dK/dtheta) is Hutchinson's estimate with the
same probes: W = K^-1 Z by `cg_columns`, then (1/p) sum_i w_i^T (dK) z_i
as one autograd pull-back of the product K(theta) Z. The quadratic form
y^T K^-1 y is a CG solve whose backward uses the implicit identities
dq/dtheta = -alpha^T dK alpha and dq/dy = 2 alpha.

Both are `torch.autograd.Function`s over a matvec_fn(params, V) and the
tensors `params` (kernel hyperparameters, noise). Their forwards run with
grad disabled, so every forward product, and the solves of the backwards,
go to the CUDA kernels even when the parameters require grad; only the
pull-back rebuilds the product under autograd, on the checkpointed plain
path.

Under tracing (`utils.trace`) the stages are device spans: `slq.lanczos`
(one a probe chunk), `slq.quadform` (the CG of the quadratic form) and, in
the backwards, `slq.cg_columns` and `slq.pull_back`, children of the span
that was open when the forward ran.
"""

from __future__ import annotations

import torch

from .. import config as _config
from ..utils import trace
from .solvers import cg, cg_columns


def _lanczos_batch(matvec, Z, iters: int):
    """Batched Lanczos: Z (n, p) start vectors -> per-probe tridiagonal
    coefficients alphas (iters, p), betas (iters - 1, p), and the start
    norms (p,). Full reorthogonalization against the stored basis, a
    preallocated (iters, n, p) tensor (memory iters * n * p): two rounds of
    classical Gram-Schmidt a step, over the rows written so far, as cfjax's
    masked sweep."""
    n, p = Z.shape
    sp = trace.begin("slq.lanczos", Z.device)
    nrm = torch.linalg.norm(Z, dim=0)
    q = Z / nrm
    V = torch.zeros((iters, n, p), dtype=Z.dtype, device=Z.device)
    V[0] = q
    q_prev = torch.zeros_like(q)
    beta = torch.zeros((p,), dtype=Z.dtype, device=Z.device)
    alphas, betas = [], []
    for i in range(iters):
        w = matvec(q)
        alpha = torch.sum(q * w, dim=0)
        w = w - alpha * q - beta * q_prev
        Vi = V[:i + 1]   # row i is still zero past the first step, as in cfjax
        for _ in range(2):
            coeffs = torch.einsum("knp,np->kp", Vi, w)
            w = w - torch.einsum("knp,kp->np", Vi, coeffs)
        beta = torch.linalg.norm(w, dim=0)
        q_next = w / torch.where(beta > 0, beta, torch.ones_like(beta))
        V[i] = q
        q_prev, q = q, q_next
        alphas.append(alpha)
        betas.append(beta)
    trace.end(sp, iters=iters)
    return torch.stack(alphas), torch.stack(betas[:-1]), nrm


def _quad_logdet(alphas, betas, nrm2, n):
    """Per-probe Gauss quadrature of log through `eigh` of each probe's
    tridiagonal; the mean over probes of nrm2 * quadrature."""
    T = (torch.diag_embed(alphas.T) + torch.diag_embed(betas.T, 1)
         + torch.diag_embed(betas.T, -1))
    evals, evecs = torch.linalg.eigh(T)
    evals = torch.clamp(evals, min=torch.finfo(alphas.dtype).tiny)
    quads = torch.sum(evecs[:, 0, :] ** 2 * torch.log(evals), dim=1)   # (p,)
    return torch.mean(nrm2 * quads)


def _rademacher(generator, n, probes, dtype, device):
    """(n, probes) entries +-1 drawn from `generator` (on `device`)."""
    bits = torch.randint(0, 2, (n, probes), generator=generator, device=device)
    return (2 * bits - 1).to(dtype)


def _probe_chunk(n, probes, iters):
    """Probes per Lanczos sweep: full reorthogonalization stores the whole
    basis (iters * n * chunk floats), capped at ~1 GB, the probe chunks run
    one after the other."""
    cap = int((1 << 30) // (4 * iters * max(n, 1)))
    chunk = max(1, min(probes, cap))
    while probes % chunk:
        chunk -= 1
    return chunk


def _slq_estimate(mv, Z, iters):
    """The SLQ logdet estimate of the operator `mv` over the probes Z, in
    probe chunks of `_probe_chunk` (the mean of the chunks' estimates)."""
    n, probes = Z.shape
    chunk = _probe_chunk(n, probes, iters)
    ests = []
    for c in range(0, probes, chunk):
        alphas, betas, nrm = _lanczos_batch(mv, Z[:, c:c + chunk], iters)
        ests.append(_quad_logdet(alphas, betas, nrm ** 2, n))
    return ests[0] if len(ests) == 1 else torch.mean(torch.stack(ests))


def _pull_back(matvec_fn, params, V, cot):
    """The vector-Jacobian product of params -> matvec_fn(params, V) at the
    cotangent `cot`: one product under autograd (the checkpointed plain
    path of a Gramian); None for the parameters that need no gradient."""
    want = [p.requires_grad for p in params]
    with torch.enable_grad():
        ps = [p.detach().requires_grad_(w) for p, w in zip(params, want)]
        out = matvec_fn(ps, V)
        leaves = [p for p in ps if p.requires_grad]
        grads = iter(torch.autograd.grad(out, leaves, grad_outputs=cot, allow_unused=True)
                     if leaves else ())
    return tuple(next(grads) if w else None for w in want)


class _SLQLogdet(torch.autograd.Function):
    @staticmethod
    def forward(ctx, matvec_fn, n, probes, iters, solve_tol, solve_maxiter, generator,
                dtype, device, *params):
        Z = _rademacher(generator, n, probes, dtype, device)
        est = _slq_estimate(lambda V: matvec_fn(params, V), Z, iters)
        ctx.matvec_fn, ctx.probes = matvec_fn, probes
        ctx.solve = (solve_tol, solve_maxiter)
        ctx.span = trace.current()
        ctx.save_for_backward(Z, *params)
        return est

    @staticmethod
    def backward(ctx, gbar):
        Z, *params = ctx.saved_tensors
        tol, maxiter = ctx.solve
        plain = [p.detach() for p in params]
        sp = trace.begin("slq.cg_columns", Z.device, ctx.span)
        W, its = cg_columns(lambda V: ctx.matvec_fn(plain, V), Z, tol=tol, maxiter=maxiter)
        trace.end(sp, iters=its)
        # (1/p) sum_i w_i^T dK z_i: the pull-back of params -> K(params) Z at W / p
        sp = trace.begin("slq.pull_back", Z.device, ctx.span)
        grads = _pull_back(ctx.matvec_fn, params, Z, W * (gbar / ctx.probes))
        trace.end(sp)
        return (None,) * 9 + grads


def slq_logdet(matvec_fn, n, probes, iters, solve_tol, solve_maxiter, params, generator=None,
               dtype=None, device=None):
    """Estimate logdet(K(params)) for the SPD operator defined by
    matvec_fn(params, V) acting columnwise on (n, p) blocks. `params` is a
    sequence of tensors (kernel hyperparameters, noise, ...); the
    estimate is differentiable in them through the Hutchinson / CG
    backward. The probes are drawn from `generator` (default: a generator
    seeded with 0 on `device`), in `dtype` (default torch's), on `device`:
    when it is not given, the device of the first tensor among `params`,
    else the configured default (`config.default_device()`), as cfjax
    puts them on its default device."""
    dtype = torch.get_default_dtype() if dtype is None else dtype
    if device is None:
        device = next((p.device for p in params if isinstance(p, torch.Tensor)),
                      _config.default_device())
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return _SLQLogdet.apply(matvec_fn, n, probes, iters, solve_tol, solve_maxiter,
                            generator, dtype, device, *params)


class _CGQuadform(torch.autograd.Function):
    @staticmethod
    def forward(ctx, matvec_fn, solve_tol, solve_maxiter, y, *params):
        sp = trace.begin("slq.quadform", y.device)
        alpha, (its, _) = cg(lambda v: matvec_fn(params, v), y, tol=solve_tol,
                             maxiter=solve_maxiter)
        trace.end(sp, iters=its)
        ctx.matvec_fn, ctx.span = matvec_fn, trace.current()
        ctx.save_for_backward(alpha, *params)
        return torch.dot(y, alpha)

    @staticmethod
    def backward(ctx, gbar):
        alpha, *params = ctx.saved_tensors
        sp = trace.begin("slq.pull_back", alpha.device, ctx.span)
        grads = _pull_back(ctx.matvec_fn, params, alpha, alpha * (-gbar))
        trace.end(sp)
        return (None, None, None, 2.0 * gbar * alpha) + grads


def cg_quadform(matvec_fn, solve_tol, solve_maxiter, params, y):
    """q = y^T K(params)^-1 y with K SPD, solved by CG; differentiable in
    `params` (a sequence of tensors) and y through the implicit
    identities dq/dtheta = -alpha^T dK alpha and dq/dy = 2 alpha."""
    return _CGQuadform.apply(matvec_fn, solve_tol, solve_maxiter, y, *params)
