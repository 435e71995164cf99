"""Float64 kernel-matrix products and the log marginal likelihood, in plain
torch, block by block so that they fit beside nothing else on the card.

- `products(kernel, xq, x, A)`: K(xq, x) @ A for columns A (m, J).
- `grad_products(kernel, xq, x, A)`: the gradient kernel's blocks
  B_ij = -2 f' I - 4 f'' r r^T (r = xq_i - x_j) applied to J stacked
  vectors A (J, m, d), point-major as the observations are.
- `logml(kernel, x, y, noise, theta)`: log p(y | x) of k(||x - y|| / e^theta)
  plus noise I, by a dense Cholesky, and its derivative in theta.
"""

from __future__ import annotations

import math

import torch

from . import kernels

# elements of one (rows, m) tile: 2^27 float64 values are 1 GiB
TILE_ELEMENTS = 1 << 27


def _rows(m: int, budget: int = TILE_ELEMENTS) -> int:
    return max(1, budget // max(1, m))


def products(kernel: dict, xq, x, A, ell: float = 1.0):
    """K(xq, x) @ A in float64, (nq, J) for A (m, J)."""
    xq, x, A = xq.double(), x.double(), A.double()
    b = _rows(x.shape[0])
    return torch.cat([kernels.profile(kernel, kernels.dist(xq[i:i + b], x) / ell) @ A
                      for i in range(0, xq.shape[0], b)])


def grad_products(kernel: dict, xq, x, A, jobs_per_block: int = 8):
    """out[c, i] = sum_j B(xq_i, x_j) A[c, j] in float64, (J, nq, d) for A
    (J, m, d): -2 F1 @ A - 4 (rowsum(W) xq - W @ x), W = F2 * <xq_i - x_j, A_j>."""
    xq, x, A = xq.double(), x.double(), A.double()
    rows = _rows(x.shape[0] * jobs_per_block)
    out = torch.empty((A.shape[0], xq.shape[0], x.shape[1]), dtype=torch.float64,
                      device=A.device)
    t = torch.einsum("jmd,md->jm", A, x)          # <x_j, A_j>
    for i in range(0, xq.shape[0], rows):
        xb = xq[i:i + rows]
        f1, f2 = kernels.jet(kernel, kernels.sqdist(xb, x))
        for c in range(0, A.shape[0], jobs_per_block):
            Ac = A[c:c + jobs_per_block]
            W = f2 * (torch.einsum("bd,jmd->jbm", xb, Ac) - t[c:c + jobs_per_block, None, :])
            out[c:c + jobs_per_block, i:i + rows] = (
                -2.0 * torch.einsum("bm,jmd->jbd", f1, Ac)
                - 4.0 * (W.sum(dim=2)[..., None] * xb - W @ x))
    return out


def logml(kernel: dict, x, y, noise: float, theta: float):
    """(log p(y | x, theta), d/dtheta of it) in float64 for the kernel
    k(||x - y|| / e^theta) plus noise I: a dense Cholesky, the gradient by
    autograd through it."""
    x, y = x.double(), y.double()
    n = x.shape[0]
    th = torch.tensor(float(theta), dtype=torch.float64, device=x.device, requires_grad=True)
    D = kernels.dist(x, x)
    A = kernels.profile(kernel, D * torch.exp(-th))
    del D
    A.diagonal().add_(noise)
    L = torch.linalg.cholesky(A)
    del A
    z = torch.linalg.solve_triangular(L, y[:, None], upper=False)[:, 0]
    value = -0.5 * (z @ z + 2 * torch.log(torch.diagonal(L)).sum() + n * math.log(2 * math.pi))
    (g,) = torch.autograd.grad(value, th)
    return float(value.detach()), float(g)
