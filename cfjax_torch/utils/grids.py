"""Structured input descriptors (counterpart of `cfjax.utils.grids`).

`UniformGrid` and `LazyGrid` describe uniform 1-D ranges and Cartesian
products without materializing them; `detect_uniform_grid` classifies a
1-D array numerically; `as_points` normalizes any input container to an
(n, d) tensor. Tensors keep their device.

A grid descriptor carries an optional `device` and `dtype` (defaults: the
CPU and `torch.get_default_dtype()`): its points, and the lazy Toeplitz,
circulant and Kronecker columns built from it, are made there. JAX places
arrays on its default device, so cfjax's grids need neither field.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import default_device


@dataclasses.dataclass(frozen=True)
class UniformGrid:
    """1-D uniform grid: start + step * arange(num). O(1) storage."""

    start: float
    step: float
    num: int
    device: object = None
    dtype: object = None

    def points(self):
        dtype = torch.get_default_dtype() if self.dtype is None else self.dtype
        return self.start + self.step * torch.arange(self.num, dtype=dtype,
                                                     device=default_device(self.device))

    def __len__(self):
        return self.num


@dataclasses.dataclass(frozen=True)
class LazyGrid:
    """Lazy Cartesian product of per-dimension 1-D point sets
    (reference src/lazy_grid.jl), last axis fastest. `axes` entries are
    UniformGrid or 1-D arrays; `points()` materializes the product. A
    `device` or `dtype` given here is passed on to every axis."""

    axes: tuple
    device: object = None
    dtype: object = None

    def __post_init__(self):
        if self.device is None and self.dtype is None:
            return
        place = {k: v for k, v in (("device", self.device), ("dtype", self.dtype))
                 if v is not None}
        axes = tuple(dataclasses.replace(a, **place) if isinstance(a, UniformGrid)
                     else torch.as_tensor(a).to(**place) for a in self.axes)
        object.__setattr__(self, "axes", axes)

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
        return a if isinstance(a, torch.Tensor) else torch.as_tensor(
            a, device=default_device(self.device))

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
    None. The grid carries x's device (the configured one for input that
    carries none) and floating dtype. The tolerance is dtype-aware:
    float32 grid positions carry rounding ~eps*|x[i]|, an absolute (not
    step-relative) error."""
    device = point_device(x)
    t = torch.as_tensor(x)
    x = t.detach().cpu().numpy().squeeze()
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
        return UniformGrid(float(x[0]), float(step), int(x.size), device=device,
                           dtype=t.dtype if t.is_floating_point() else None)
    return None


def point_device(x) -> torch.device:
    """The device of x's points, without making them: a tensor's own, a
    grid's, else the configured device."""
    if isinstance(x, torch.Tensor):
        return x.device
    if isinstance(x, UniformGrid):
        return default_device(x.device)
    if isinstance(x, LazyGrid):
        return point_device(x.axes[0]) if x.device is None and x.axes else \
            default_device(x.device)
    return default_device()


def as_points(x):
    """Normalize any input container to an (n, d) point tensor. A tensor
    keeps its device; other input goes to the configured device."""
    if isinstance(x, UniformGrid):
        return x.points()[:, None]
    if isinstance(x, LazyGrid):
        return x.points()
    x = torch.as_tensor(x, device=point_device(x))
    if x.ndim == 1:
        return x[:, None]
    return x
