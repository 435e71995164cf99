"""The ARD Matern-5/2 kernel with an outputscale, in plain torch: GPyTorch's
`ScaleKernel(MaternKernel(nu=2.5, ard_num_dims=d))`,

    k(x, y) = s (1 + sqrt(5) r + 5 r^2 / 3) exp(-sqrt(5) r),
    r = ||(x - y) / l||,

with the outputscale s = sigma_f^2 and one lengthscale l_i a feature. Every
distance is taken from the difference form in float64, one block of rows
at a time; TF32 is held off for the products. From it: K v, the solve
(K + sigma^2 I)^-1 y by a dense Cholesky (small n only) and the posterior
mean K(x*, x) alpha. Nothing here comes from `cfjax_torch` or from JAX.
"""

from __future__ import annotations

import contextlib
import math

import torch

# rows of a block: the (rows, m, d) difference tensor stays near 2^24 values
BLOCK_VALUES = 1 << 24


@contextlib.contextmanager
def no_tf32():
    """Float32 products at full precision inside the block (a float64 product
    never runs in TF32; the flags are set for any float32 caller)."""
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = m.allow_tf32, c.allow_tf32
    m.allow_tf32 = c.allow_tf32 = False
    try:
        yield
    finally:
        m.allow_tf32, c.allow_tf32 = saved


def _f64(*ts):
    return [torch.as_tensor(t).to(torch.float64) for t in ts]


def kernel_matrix(x, y, ell, outputscale):
    """K(x, y) in float64, (n, m), block by block of rows of x."""
    x, y, ell = _f64(x, y, ell)
    s = float(outputscale)
    rows = max(1, BLOCK_VALUES // max(1, y.shape[0] * x.shape[1]))
    out = []
    for i in range(0, x.shape[0], rows):
        diff = (x[i:i + rows, None, :] - y[None, :, :]) / ell
        r = torch.sqrt(torch.sum(diff * diff, dim=-1))
        out.append(s * (1 + math.sqrt(5) * r + 5 * r * r / 3) * torch.exp(-math.sqrt(5) * r))
    return torch.cat(out)


def matvec(x, y, ell, outputscale, v):
    """K(x, y) v in float64."""
    with no_tf32():
        return kernel_matrix(x, y, ell, outputscale) @ torch.as_tensor(v).to(torch.float64)


def solve(x, obs, ell, outputscale, noise):
    """alpha = (K + noise I)^-1 obs by a dense Cholesky in float64."""
    (obs,) = _f64(obs)
    A = kernel_matrix(x, x, ell, outputscale)
    A.diagonal().add_(float(noise))
    L = torch.linalg.cholesky(A)
    return torch.cholesky_solve(obs[:, None], L)[:, 0]


def posterior_mean(xt, x, alpha, ell, outputscale):
    """K(x*, x) alpha in float64."""
    return matvec(xt, x, ell, outputscale, alpha)
