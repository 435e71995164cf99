"""Gradient-kernel fast paths for per-dimension separable kernels
(counterpart of `cfjax.derivative.separable_grad`, reference
src/gradient_algebra.jl:93-145):

SeparableSum K(x,y) = sum_d k_d(x_d, y_d): the gradient block is
diagonal, Block_ij = diag_d( d2/dx dy k_d(x_id, y_jd) ), so the MVM is d
independent (n x m) 1-D derivative-matrix products.

SeparableProduct K(x,y) = prod_d k_d(x_d, y_d): with P = prod_d v_d and
ratios h~ = h/v, g~ = g/v the action is
    b_id = sum_j P_ij [ h~_d A_jd + g~x_d ( s_ij - g~y_d A_jd ) ],
    s_ij = sum_e g~y_e(ij) A_je
— all (B, m) elementwise tiles + row reductions. Ratios follow the
reference's division by k_i(x_i, y_i) (gradient_algebra.jl:119-122), so
kernels must be nonzero at the evaluated pairs (true for EQ/RQ/Matern...).
"""

from __future__ import annotations

import torch
from torch.func import grad, vmap

from ..ops.tiles import map_rows


def _dim_fns(kd):
    """Scalar 1-D functions (value, dk/dx, dk/dy, d2k/dxdy) for one
    per-dimension kernel."""
    f = lambda xi, yj: kd(xi, yj)
    gx = grad(f, argnums=0)
    return f, gx, grad(f, argnums=1), grad(gx, argnums=1)


def _pair(fn, xc, yc):
    return vmap(lambda xi: vmap(lambda yj: fn(xi, yj))(yc))(xc)


def grad_matvec_separable_sum(k, x, y, A, block=256):
    """Gradient-gramian MVM of a SeparableSum kernel."""

    def body(xb):
        return torch.stack([_pair(_dim_fns(kd)[3], xb[:, i], y[:, i]) @ A[:, i]
                            for i, kd in enumerate(k.args)], dim=1)

    return map_rows(body, x, block, x.shape[1])


def grad_matvec_separable_prod(k, x, y, A, block=256):
    """Gradient-gramian MVM of a SeparableProduct kernel."""
    d = x.shape[1]

    def body(xb):
        V, Gx, Gy, H = [], [], [], []
        for i, kd in enumerate(k.args):
            f, gx, gy, h = _dim_fns(kd)
            for out, fn in ((V, f), (Gx, gx), (Gy, gy), (H, h)):
                out.append(_pair(fn, xb[:, i], y[:, i]))
        P = V[0]
        for v in V[1:]:
            P = P * v
        gty = [Gy[i] / V[i] for i in range(d)]
        s = sum(gty[i] * A[:, i][None, :] for i in range(d))  # sum_e g~y_e(ij) A_je
        outs = []
        for i in range(d):
            gtx = Gx[i] / V[i]
            term = (P * (H[i] / V[i])) @ A[:, i]
            term = term + torch.sum(P * gtx * s, dim=1)
            outs.append(term - (P * gtx * gty[i]) @ A[:, i])
        return torch.stack(outs, dim=1)

    return map_rows(body, x, block, x.shape[1])
