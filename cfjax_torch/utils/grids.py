"""Structured input descriptors (counterpart of `cfjax.utils.grids`).

`UniformGrid` and `LazyGrid` describe uniform 1-D ranges and Cartesian
products without materializing them; `detect_uniform_grid` classifies a
1-D array numerically; `as_points` normalizes any input container to an
(n, d) tensor. Tensors keep their device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class UniformGrid:
    """1-D uniform grid: start + step * arange(num). O(1) storage."""

    start: float
    step: float
    num: int

    def points(self):
        return self.start + self.step * torch.arange(self.num, dtype=torch.get_default_dtype())

    def __len__(self):
        return self.num


@dataclasses.dataclass(frozen=True)
class LazyGrid:
    """Lazy Cartesian product of per-dimension 1-D point sets
    (reference src/lazy_grid.jl), last axis fastest. `axes` entries are
    UniformGrid or 1-D arrays; `points()` materializes the product."""

    axes: tuple

    def __len__(self):
        n = 1
        for a in self.axes:
            n *= len(a)
        return n

    @property
    def ndim(self):
        return len(self.axes)

    def axis_points(self, i):
        a = self.axes[i]
        if isinstance(a, UniformGrid):
            return a.points()
        return torch.as_tensor(a)

    def points(self):
        """Materialize the (prod n_i, d) point matrix, last axis fastest."""
        pts = [self.axis_points(i) for i in range(self.ndim)]
        dtype = pts[0].dtype
        for p in pts[1:]:
            dtype = torch.promote_types(dtype, p.dtype)
        mesh = torch.meshgrid(*[p.to(dtype) for p in pts], indexing="ij")
        return torch.stack([m.reshape(-1) for m in mesh], dim=-1)


def detect_uniform_grid(x, rtol: float = None):
    """Classify a 1-D array as a uniform grid; returns a UniformGrid or
    None. The tolerance is dtype-aware: float32 grid positions carry
    rounding ~eps*|x[i]|, an absolute (not step-relative) error."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x).squeeze()
    if x.ndim != 1 or x.size < 2:
        return None
    d = np.diff(x)
    step = float(np.median(d))
    if step == 0:
        return None
    eps = np.finfo(x.dtype).eps if np.issubdtype(x.dtype, np.floating) else 0.0
    if rtol is None:
        rtol = max(1e-10, 4 * eps)
    atol = 8 * eps * float(np.max(np.abs(x))) + abs(step) * rtol
    if np.all(np.abs(d - step) <= atol):
        return UniformGrid(float(x[0]), float(step), int(x.size))
    return None


def as_points(x):
    """Normalize any input container to an (n, d) point tensor."""
    if isinstance(x, UniformGrid):
        return x.points()[:, None]
    if isinstance(x, LazyGrid):
        return x.points()
    x = torch.as_tensor(x)
    if x.ndim == 1:
        return x[:, None]
    return x
