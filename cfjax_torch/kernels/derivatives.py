"""Scalar derivative engine for kernel profiles (counterpart of
`cfjax.kernels.derivatives`, reference src/derivatives.jl and
src/gradient.jl:584-600).

All derivative stacks of a profile f at s are built by composing
`torch.func.grad` and evaluated elementwise with `torch.func.vmap`. The
profiles are written (Taylor-guarded `where`s) so that the derivatives
are finite at r^2 = 0.
"""

from __future__ import annotations

import torch
from torch.func import grad, vmap


def derivative_fns(profile, order: int):
    """[f, f', f'', ..., f^(order)] as scalar functions."""
    fns = [profile]
    for _ in range(order):
        fns.append(grad(fns[-1]))
    return fns


def elementwise_derivatives(profile, s, order: int):
    """(f(s), f'(s), ..., f^(order)(s)) elementwise on tensor s, each of
    the shape of s."""
    s = torch.as_tensor(s)
    flat = s.reshape(-1)
    return tuple(vmap(fn)(flat).reshape(s.shape) for fn in derivative_fns(profile, order))


def value_derivative(profile, s):
    """(f, f') — reference `value_derivative` (src/gradient.jl:584-588)."""
    return elementwise_derivatives(profile, s, 1)


def derivative_laplacian(profile, s):
    """(f', f'') — reference `derivative_laplacian` (src/gradient.jl:589-600)."""
    _, d1, d2 = elementwise_derivatives(profile, s, 2)
    return d1, d2
