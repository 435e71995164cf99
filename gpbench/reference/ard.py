"""Float64 products of the ARD kernel with an outputscale, in plain torch,
block by block: K(xq, x) @ A with k(x, y) = s f(||(x - y) / l||), f the
configuration's profile (`kernels.profile`) and s the outputscale. The
distances come from the difference form (`torch.cdist` without the matmul
expansion: no cancellation). Nothing here comes from the program under
test."""

from __future__ import annotations

import torch

from . import kernels

# elements of one (rows, m) tile: 2^27 float64 values are 1 GiB
TILE_ELEMENTS = 1 << 27


def products(kernel: dict, outputscale: float, ell, xq, x, A):
    """K(xq, x) @ A in float64, (nq, J) for A (m, J)."""
    ell = ell.to(device=x.device, dtype=torch.float64)
    xq, x, A = xq.double() / ell, x.double() / ell, A.double()
    rows = max(1, TILE_ELEMENTS // max(1, x.shape[0]))
    out = []
    for i in range(0, xq.shape[0], rows):
        rho = torch.cdist(xq[i:i + rows], x, compute_mode="donot_use_mm_for_euclid_dist")
        out.append((float(outputscale) * kernels.profile(kernel, rho)) @ A)
    return torch.cat(out)
