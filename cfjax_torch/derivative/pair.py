"""The pair-family fast path: kernels as F(s, nx, ny) (counterpart of
`cfjax.derivative.pair`).

With s = <x, y>, nx = |x|^2, ny = |y|^2, every isotropic kernel is
F = f(nx + ny - 2 s), every dot-product kernel is F = f(s), the
neural-network kernel is F(s, nx, ny) directly — and any
Sum/Product/Power/Chained combination of such kernels is again a scalar
function of (s, nx, ny), differentiable by `torch.func.grad`.

The gradient-kernel block then has the universal closed form
    Block(a) = F_s a + (F_ss <p,a> + 2 F_sny <z,a>) z
                     + (2 F_snx <p,a> + 4 F_nxny <z,a>) p
(p = row point, z = column point), so the full block MVM is 3 products
plus elementwise derivative tiles — one code path replacing the
reference's per-combinator Woodbury rules (src/gradient_algebra.jl:47-128)
and its hand-derived NN-kernel block (src/gradient.jl:173-211).

Cross-covariances for value+gradient observations:
    grad_x k = F_s z + 2 F_nx p,    grad_y k = F_s p + 2 F_ny z.
"""

from __future__ import annotations

import math

import torch
from torch.func import grad, vmap

from ..kernels.algebra import Power, Product, Sum
from ..kernels.base import InputTrait, hp, input_trait
from ..kernels.mercer import NeuralNetwork
from ..kernels.stationary import Constant
from ..kernels.transforms import Chained
from ..ops.tiles import inner_tile, map_rows, matmul_p


def pair_family_available(k) -> bool:
    """Can k be written as a smooth scalar F(s, nx, ny)?"""
    if isinstance(k, (Constant, NeuralNetwork)):
        return True
    if isinstance(k, (Sum, Product)):
        return all(pair_family_available(a) for a in k.args)
    if isinstance(k, (Power, Chained)):
        return pair_family_available(k.k)
    return input_trait(k) in (InputTrait.ISOTROPIC, InputTrait.DOT)


def pair_profile(k, s, nx, ny):
    """Scalar F(s, nx, ny) for kernel k (recursive over combinators)."""
    if isinstance(k, Constant):
        return hp(k.c, s) * torch.ones_like(s)
    if isinstance(k, NeuralNetwork):
        sig = hp(k.sigma, s)
        u = (s + sig) / torch.sqrt((1 + nx + sig) * (1 + ny + sig))
        return 2 / math.pi * torch.asin(u)
    if isinstance(k, Sum):
        return sum(pair_profile(a, s, nx, ny) for a in k.args)
    if isinstance(k, Product):
        out = None
        for a in k.args:
            v = pair_profile(a, s, nx, ny)
            out = v if out is None else out * v
        return out
    if isinstance(k, Power):
        return pair_profile(k.k, s, nx, ny) ** k.p
    if isinstance(k, Chained):
        return k.f(pair_profile(k.k, s, nx, ny))
    t = input_trait(k)
    if t == InputTrait.ISOTROPIC:
        # NO clamp to 0 here: a clamp or maximum ties at r^2 = 0 on the
        # diagonal, and its tie gradient halves every diagonal-block
        # derivative. Profiles used with derivative kernels are smooth at
        # (and just below) 0 by construction (Taylor guards), so the raw
        # value is both correct and exact under autograd.
        return k.profile(nx + ny - 2 * s)
    if t == InputTrait.DOT:
        return k.profile(s)
    raise ValueError(f"{type(k).__name__} is not in the pair family")


def _partials(k):
    """Scalar partial-derivative functions of F needed by the gradient
    block: (F, F_s, F_ss, F_snx, F_sny, F_nxny, F_nx, F_ny)."""
    F = lambda s, nx, ny: pair_profile(k, s, nx, ny)
    Fs = grad(F, argnums=0)
    Fnx = grad(F, argnums=1)
    return (F, Fs, grad(Fs, argnums=0), grad(Fs, argnums=1), grad(Fs, argnums=2),
            grad(Fnx, argnums=2), Fnx, grad(F, argnums=2))


def _tile_eval(fns, S, nx, ny):
    """Evaluate scalar fns elementwise on the (B, m) tile."""
    B, m = S.shape
    sf = S.reshape(-1)
    nxf = nx[:, None].expand(B, m).reshape(-1)
    nyf = ny[None, :].expand(B, m).reshape(-1)
    return [vmap(f)(sf, nxf, nyf).reshape(B, m) for f in fns]


def grad_matvec_pair(k, x, y, A, block=128):
    """(n d) x (m d) gradient-gramian MVM via the universal pair form."""
    _, Fs, Fss, Fsnx, Fsny, Fnxny, _, _ = _partials(k)
    ny_ = torch.sum(y * y, dim=1)
    T = torch.sum(y * A, dim=1)  # <z_j, A_j>

    def body(xb):
        fs, fss, fsnx, fsny, fnxny = _tile_eval(
            [Fs, Fss, Fsnx, Fsny, Fnxny], inner_tile(xb, y), torch.sum(xb * xb, dim=1), ny_)
        P = inner_tile(xb, A)
        Wz = fss * P + 2 * fsny * T[None, :]
        Wp = 2 * fsnx * P + 4 * fnxny * T[None, :]
        return matmul_p(fs, A) + matmul_p(Wz, y) + torch.sum(Wp, dim=1)[:, None] * xb

    return map_rows(body, x, block, x.shape[1])


def valgrad_matvec_pair(k, x, y, a0, A, block=128):
    """(1+d)-block MVM via the universal pair form."""
    fns = _partials(k)
    ny_ = torch.sum(y * y, dim=1)
    T = torch.sum(y * A, dim=1)

    def body(xb):
        f, fs, fss, fsnx, fsny, fnxny, fnx, fny = _tile_eval(
            fns, inner_tile(xb, y), torch.sum(xb * xb, dim=1), ny_)
        P = inner_tile(xb, A)
        # b0 = sum_j [ F a0 + <grad_y k, A_j> ],  grad_y k = F_s p + 2 F_ny z
        b0 = matmul_p(f, a0) + torch.sum(fs * P, dim=1) + 2 * torch.sum(fny * T[None, :], dim=1)
        # B1 = sum_j [ grad_x k a0_j + Block A_j ], grad_x k = F_s z + 2 F_nx p
        Wz = fs * a0[None, :] + fss * P + 2 * fsny * T[None, :]
        Wp_sum = torch.sum(2 * fnx * a0[None, :] + 2 * fsnx * P + 4 * fnxny * T[None, :], dim=1)
        B1 = matmul_p(fs, A) + matmul_p(Wz, y) + Wp_sum[:, None] * xb
        return torch.cat([b0[:, None], B1], dim=1)

    return map_rows(body, x, block, 1 + x.shape[1])
