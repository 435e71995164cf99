"""Hyperparameter optimization: maximize the log marginal likelihood
(counterpart of `cfjax.gp.fit`).

The reference demonstrates this with Flux over `parameters`/`similar`
(test/optimization.jl); cfjax runs optax's Adam over the kernel pytree's
leaves. Here the flat parameter vector of `kernels.parameters` is the
optimizer's one tensor, the kernel is rebuilt from it with `similar`, and
`torch.optim.Adam` takes the steps (its update is optax's adam: eps added
to the square root of the bias-corrected second moment).
"""

from __future__ import annotations

import torch

from ..kernels.parameters import parameters, similar
from .regression import log_marginal_likelihood


def fit_kernel(kernel, x, y, noise: float = 1e-4, steps: int = 100, lr: float = 0.05,
               log_space: bool = True):
    """Gradient ascent on log p(y | x, theta). Returns (kernel, history),
    history the negative logML before each step (float64).

    log_space=True optimizes the logs of the hyperparameters (all positive);
    set False for kernels with sign-free parameters."""
    theta0 = parameters(kernel).detach().to(torch.float64)
    if theta0.numel() == 0:
        return kernel, torch.zeros((0,), dtype=torch.float64)
    theta = (torch.log(theta0) if log_space else theta0.clone()).requires_grad_(True)

    def rebuild(t):
        return similar(kernel, torch.exp(t) if log_space else t)

    opt = torch.optim.Adam([theta], lr=lr)
    hist = []
    for _ in range(steps):
        opt.zero_grad()
        loss = -log_marginal_likelihood(rebuild(theta), x, y, noise=noise)
        loss.backward()
        opt.step()
        hist.append(float(loss.detach()))
    with torch.no_grad():
        return rebuild(theta.detach()), torch.tensor(hist, dtype=torch.float64)
