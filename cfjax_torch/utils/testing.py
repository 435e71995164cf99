"""Test oracles and property probes (counterpart of `cfjax.utils.testing`,
reference src/util.jl:91-149).

`pairwise` evaluates the kernel matrix pair by pair through nested
`torch.func.vmap` over the kernel's own `__call__` — the generic path,
independent of the trait-specialized tiles. The Nystrom build uses
`pairwise_xy` for its landmark panels. `ispsd` and `iscov` test a matrix;
`isstationary_probe` and `isisotropic_probe` test a kernel on numpy draws
from the same seeds as cfjax's, on the CPU in float64."""

from __future__ import annotations

import numpy as np
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


def _numpy(A):
    return A.detach().cpu().numpy() if isinstance(A, torch.Tensor) else np.asarray(A)


def ispsd(A, tol: float = 1e-8) -> bool:
    ev = np.linalg.eigvalsh(_numpy(A))
    return bool(ev.min() > -tol)


def iscov(A, tol: float = 1e-8) -> bool:
    A = _numpy(A)
    return bool(np.allclose(A, A.T, atol=tol)) and ispsd(A, tol)


def _probe_matrices(k, x, y, transform):
    a = pairwise_xy(k, torch.from_numpy(x), torch.from_numpy(y))
    b = pairwise_xy(k, torch.from_numpy(transform(x)), torch.from_numpy(transform(y)))
    return _numpy(a), _numpy(b)


def isstationary_probe(k, d: int = 3, n: int = 16, seed: int = 0, tol=1e-8) -> bool:
    """Randomized check that k(x + s, y + s) == k(x, y) (src/util.jl:103-126)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d))
    y = rng.standard_normal((n, d))
    s = rng.standard_normal((1, d))
    a, b = _probe_matrices(k, x, y, lambda z: z + s)
    return bool(np.allclose(a, b, atol=tol))


def isisotropic_probe(k, d: int = 3, n: int = 16, seed: int = 0, tol=1e-8) -> bool:
    """Randomized check of rotation invariance (src/util.jl:128-149)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d))
    y = rng.standard_normal((n, d))
    Q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    a, b = _probe_matrices(k, x, y, lambda z: z @ Q.T)
    return isstationary_probe(k, d, n, seed, tol) and bool(np.allclose(a, b, atol=tol))
