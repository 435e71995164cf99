"""Small linear-algebra utilities (counterpart of `cfjax.utils.linalg`,
reference src/util.jl, src/givens.jl and src/derivatives.jl)."""

from __future__ import annotations

import numpy as np
import torch
from torch.func import grad, jvp


def perfect_shuffle_indices(d: int, m: int = None) -> np.ndarray:
    """Permutation p with vec(X)[p] == vec(X^T) for X (d, m) row-major: the
    reference's lazy PerfectShuffle S vec(X) = vec(X') (src/util.jl:155-192)
    as an index vector (a gather, no matrix ever built)."""
    m = d if m is None else m
    return np.arange(d * m).reshape(d, m).T.reshape(-1).copy()


def perfect_shuffle(v, d: int, m: int = None):
    """Apply the perfect shuffle to a flat vector: returns vec(X^T)."""
    m = d if m is None else m
    return torch.as_tensor(v).reshape(d, m).T.reshape(-1)


def exchange_matrix(n: int, dtype=None):
    """Anti-diagonal exchange matrix J (src/util.jl:195-201). Prefer
    torch.flip over multiplying by this."""
    return torch.flip(torch.eye(n, dtype=dtype), (0,))


def leave_one_out_products(x):
    """p_i = prod_{j != i} x_j without division (src/util.jl:209-221):
    exclusive prefix times exclusive suffix cumulative products."""
    x = torch.as_tensor(x)
    ones = torch.ones_like(x[:1])
    prefix = torch.cat([ones, torch.cumprod(x, 0)[:-1]])
    suffix = torch.cat([torch.flip(torch.cumprod(torch.flip(x, (0,)), 0)[:-1], (0,)), ones])
    return prefix * suffix


def _float(v):
    if isinstance(v, (int, float)):
        return torch.tensor(float(v), dtype=torch.float64)
    v = torch.as_tensor(v)
    return v if v.is_floating_point() else v.to(torch.float64)


def givens_rotation(f, g):
    """Differentiable Givens rotation: (c, s, r) with [c s; -s c] [f; g] =
    [r; 0]. The reference patches LinearAlgebra.givensAlgorithm for
    ForwardDiff duals (src/givens.jl:1-67); the smooth branch formulas
    below differentiate under autograd as they are. Python numbers are
    taken as float64."""
    f, g = _float(f), _float(g)
    r = torch.hypot(f, g)
    safe = torch.where(r > 0, r, torch.ones_like(r))
    c = torch.where(r > 0, f / safe, torch.ones_like(r))
    s = torch.where(r > 0, g / safe, torch.zeros_like(r))
    return c, s, r


def nth_derivatives(f, x, m: int):
    """All derivatives of scalar f at x up to order m (reference
    `derivatives`, src/derivatives.jl:9-29): repeated `torch.func.grad`,
    returning (f(x), f'(x), ..., f^(m)(x))."""
    fns = [f]
    for _ in range(m):
        fns.append(grad(fns[-1]))
    x = torch.as_tensor(x)
    if not x.is_floating_point():
        x = x.to(torch.get_default_dtype())
    return tuple(fn(x) for fn in fns)


def jet_derivatives(f, x, m: int):
    """The same derivatives by nested forward mode (`torch.func.jvp` with a
    unit tangent, m levels deep), cfjax's `jax.experimental.jet`
    counterpart."""
    fns = [f]
    for _ in range(m):
        fns.append(lambda t, h=fns[-1]: jvp(h, (t,), (torch.ones_like(t),))[1])
    x = torch.as_tensor(x)
    if not x.is_floating_point():
        x = x.to(torch.get_default_dtype())
    return tuple(fn(x) for fn in fns)
