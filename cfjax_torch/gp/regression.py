"""GP regression on top of the lazy operator layer (counterpart of
`cfjax.gp.regression`): posterior conditioning through the
structure-dispatched `gramian` + solve (dense Cholesky up to
max_cholesky_size, Nystrom-preconditioned CG above it for a plain
Gramian, plain CG for other operators such as the gradient gramian of
`GradientKernel` observations), and the Cholesky log marginal likelihood.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..operators.dispatch import gramian
from ..operators.solvers import cg, solve_with_info


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
    y = torch.as_tensor(y)
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
    """log p(y | x, theta) through a dense Cholesky (n <= max_cholesky_size).
    The circulant, Kronecker and SLQ branches of cfjax are not ported yet
    (ROADMAP.md, queue 1, items 8 and 10). Differentiable in the kernel's
    hyperparameters and `noise` by autograd."""
    from .. import config as _config

    y = torch.as_tensor(y)
    n = y.shape[0]
    if method == "auto":
        method = "cholesky" if n <= _config.DEFAULT.max_cholesky_size else "slq"
    if method != "cholesky":
        raise NotImplementedError(
            f"log_marginal_likelihood method {method!r} is not ported yet "
            "(ROADMAP.md, queue 1, items 8 and 10)")
    K = gramian(kernel, x)
    A = K.todense() + noise * torch.eye(n, dtype=K.dtype, device=y.device)
    L = torch.linalg.cholesky(A)
    z = torch.linalg.solve_triangular(L, y[:, None], upper=False)[:, 0]
    quad = torch.sum(z * z)
    logdet = 2 * torch.sum(torch.log(torch.diagonal(L)))
    return -0.5 * (quad + logdet + n * math.log(2 * math.pi))
