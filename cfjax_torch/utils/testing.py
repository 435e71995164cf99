"""Test oracles (counterpart of `cfjax.utils.testing`).

`pairwise` evaluates the kernel matrix pair by pair through nested
`torch.func.vmap` over the kernel's own `__call__` — the generic path,
independent of the trait-specialized tiles. The Nystrom build uses
`pairwise_xy` for its landmark panels."""

from __future__ import annotations

import torch
from torch.func import vmap


def pairwise_xy(k, x, y):
    return vmap(lambda xi: vmap(lambda yj: k(xi, yj))(y))(x)


def pairwise(k, x, y=None):
    """Dense kernel matrix by direct per-pair evaluation (oracle; O(n m)
    memory — test use only)."""
    x = torch.as_tensor(x)
    y = x if y is None else torch.as_tensor(y)
    return pairwise_xy(k, x, y)
