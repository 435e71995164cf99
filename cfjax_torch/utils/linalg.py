"""Small linear-algebra utilities (counterpart of `cfjax.utils.linalg`).
Only `nth_derivatives`, which the chained gradient path needs, is ported
so far; the rest of the module comes with the structured fast paths
(ROADMAP.md, queue 1, item 10)."""

from __future__ import annotations

import torch
from torch.func import grad


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
