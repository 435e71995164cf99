"""GP regression on top of the lazy operator layer (counterpart of
`cfjax.gp.regression`): posterior conditioning through the
structure-dispatched `gramian` + solve (dense Cholesky up to
max_cholesky_size, Nystrom-preconditioned CG above it for a plain
Gramian, plain CG for other operators such as the gradient gramian of
`GradientKernel` observations), the posterior mean and variance, and the
log marginal likelihood: exact and structured on circulant and Kronecker
gramians, a dense Cholesky otherwise.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch.func import vmap

from ..operators.dispatch import gramian
from ..operators.kronecker import KroneckerOperator
from ..operators.solvers import cg, cg_columns, solve_with_info
from ..operators.toeplitz import CirculantOperator
from ..utils.grids import as_points, point_device


def _observations(y, x, K):
    """y as a tensor on the device of x's points, in the floating dtype of
    the operator K built on them: cfjax's `jnp.asarray(y)` makes numpy's
    float64 observations float32 under JAX's default, so a float32 GP keeps
    float32 vectors (and its MVMs stay on the CUDA kernels, which take
    float32). Integer points (index kernels) leave y's dtype alone."""
    y = torch.as_tensor(y, device=point_device(x))
    integer_points = isinstance(x, (torch.Tensor, np.ndarray)) and not (
        torch.is_floating_point(x) if isinstance(x, torch.Tensor)
        else np.issubdtype(x.dtype, np.floating))
    if (not integer_points and y.is_floating_point() and K.dtype is not None
            and K.dtype.is_floating_point):
        y = y.to(K.dtype)
    return y


@dataclasses.dataclass
class GPPosterior:
    kernel: object
    x_train: torch.Tensor
    alpha: torch.Tensor  # (K + noise I)^{-1} y
    noise: float
    # (CG iterations, final residual norm) on the CG branches; None after
    # a dense factorization
    solve_info: tuple = None

    def mean(self, x_test):
        Ks = gramian(self.kernel, x_test, self.x_train)
        return Ks @ self.alpha

    def variance(self, x_test, tol: float = 1e-6, maxiter: int = 200):
        """Posterior variance diag(K_ss) - diag(K_s K^-1 K_s^T), exact: one
        batched CG (`cg_columns`) over the rows of the dense test x train
        block, so use few test points or small n."""
        xt = as_points(x_test)
        K = gramian(self.kernel, self.x_train).add_diagonal(self.noise)
        Ksd = gramian(self.kernel, xt, self.x_train).todense()
        V, _ = cg_columns(K._matmat, Ksd.T, tol=tol, maxiter=maxiter)
        quad = torch.sum(Ksd.T * V, dim=0)
        prior = vmap(lambda xi: self.kernel(xi, xi))(xt)
        return prior - quad


def gp_condition(kernel, x, y, noise: float = 1e-6,
                 precondition: str = "auto", precond_rank: int = 512,
                 seed: int = 0, **solve_opts) -> GPPosterior:
    """Condition a GP prior on observations y at points x (y may be
    values, or stacked gradient blocks when kernel is a derivative kernel
    such as `GradientKernel`, point-major: y[i*d + l] = d f / dx_l at x_i).

    precondition: "auto" builds a rank-`precond_rank` Nystrom
    preconditioner (landmarks drawn from `seed`) for the lazy-CG regime
    (n > max_cholesky_size, a plain Gramian operator and a scalar noise)
    and solves with PCG; "never" disables it. Below the threshold the
    solve is a dense Cholesky."""
    from .. import config as _config
    from ..operators.gramian import Gramian

    K0 = gramian(kernel, x)
    K = K0.add_diagonal(noise)
    n = K.shape[0]
    y = _observations(y, x, K0)
    if (precondition == "auto" and isinstance(K0, Gramian)
            and torch.as_tensor(noise).ndim == 0
            and n > _config.DEFAULT.max_cholesky_size):
        from ..operators.preconditioner import nystrom_preconditioner

        extra = set(solve_opts) - {"tol", "maxiter", "x0"}
        if extra:
            raise TypeError(
                f"unsupported solve_opts for the preconditioned CG path: {sorted(extra)}")
        M = nystrom_preconditioner(kernel, x, noise, rank=min(precond_rank, n // 2),
                                   seed=seed)
        alpha, info = cg(K._matvec, y, M=M, x0=solve_opts.get("x0"),
                         tol=solve_opts.get("tol"), maxiter=solve_opts.get("maxiter"))
        return GPPosterior(kernel, x, alpha, noise, info)
    alpha, info = solve_with_info(K, y, **solve_opts)
    return GPPosterior(kernel, x, alpha, noise, info)


def log_marginal_likelihood(kernel, x, y, noise: float = 1e-6, method: str = "auto"):
    """log p(y | x, theta), routed through the structure dispatcher:

      * Circulant gramian (periodic kernel on a uniform grid): exact
        O(n log n) spectral logdet and quadratic form;
      * Kronecker gramian (separable product on a lazy grid): exact
        per-factor eigendecompositions, O(sum n_i^3) for n = prod n_i;
      * n <= max_cholesky_size: dense Cholesky.

    cfjax's stochastic Lanczos branch ("slq", the lazy regime above
    max_cholesky_size) is not ported yet (ROADMAP.md, queue 1, item 8).
    Differentiable in the kernel's hyperparameters and `noise` by
    autograd (the Kronecker branch through `torch.linalg.eigh`, whose
    backward needs distinct factor eigenvalues)."""
    from .. import config as _config

    K = gramian(kernel, x)
    y = _observations(y, x, K)
    n = y.shape[0]
    mcs = _config.DEFAULT.max_cholesky_size
    if method == "auto":
        if isinstance(K, CirculantOperator):
            method = "circulant"
        elif isinstance(K, KroneckerOperator) and all(f.shape[0] <= mcs for f in K.factors):
            method = "kronecker"
        else:
            method = "cholesky" if n <= mcs else "slq"
    if method == "circulant":
        lam = K.eigenvalues().real + noise
        quad = torch.sum(torch.abs(torch.fft.fft(y)) ** 2 / lam) / n
        logdet = torch.sum(torch.log(lam))
    elif method == "kronecker":
        ws, Qs = zip(*(torch.linalg.eigh(f.todense()) for f in K.factors))
        lam = ws[0]
        for w in ws[1:]:
            lam = (lam[:, None] * w[None, :]).reshape(-1)
        lam = lam + noise
        z = K._apply_modes(y, [Q.T for Q in Qs], in_dims=[Q.shape[0] for Q in Qs])
        quad = torch.sum(z * z / lam)
        logdet = torch.sum(torch.log(lam))
    elif method == "cholesky":
        A = K.todense() + noise * torch.eye(n, dtype=K.dtype, device=y.device)
        L = torch.linalg.cholesky(A)
        z = torch.linalg.solve_triangular(L, y[:, None], upper=False)[:, 0]
        quad = torch.sum(z * z)
        logdet = 2 * torch.sum(torch.log(torch.diagonal(L)))
    elif method == "slq":
        raise NotImplementedError(
            "log_marginal_likelihood method 'slq' is not ported yet (ROADMAP.md, queue 1, item 8)")
    else:
        raise ValueError(f"unknown logML method {method!r}")
    return -0.5 * (quad + logdet + n * math.log(2 * math.pi))
