"""Hyperparameter plumbing (counterpart of `cfjax.kernels.parameters`,
reference src/parameters.jl).

The flat hyperparameter vector walks each kernel's fields in cfjax's
dataclass field order, skipping static fields and None, and recursing into
sub-kernels — the order of cfjax's pytree leaves, so the flat vectors of
the two packages are equal. `from_reference` converts a cfjax kernel
object into the port's kernel without importing jax.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from .base import Kernel


def _leaf_slots(k):
    """(module, field name) of every hyperparameter tensor, in order."""
    for name, _ in k.FIELDS:
        if name in k.STATIC:
            continue
        v = getattr(k, name)
        if isinstance(v, Kernel):
            yield from _leaf_slots(v)
        elif isinstance(v, torch.nn.ModuleList):
            for a in v:
                yield from _leaf_slots(a)
        elif isinstance(v, torch.Tensor):
            yield k, name


def leaves(k) -> list:
    """The hyperparameter tensors of kernel k, in `parameters` order."""
    return [getattr(m, n) for m, n in _leaf_slots(k)]


def parameters(k) -> torch.Tensor:
    """Flat vector of all hyperparameters of kernel k."""
    ls = leaves(k)
    if not ls:
        return torch.zeros((0,), dtype=torch.float64)
    return torch.cat([l.reshape(-1) for l in ls])


def nparameters(k) -> int:
    return int(sum(getattr(m, n).numel() for m, n in _leaf_slots(k)))


def similar(k, theta):
    """Rebuild a kernel of the same structure from a flat parameter vector
    (reference `Base.similar(k, θ)`, src/parameters.jl:21-37)."""
    theta = torch.as_tensor(theta)
    old = leaves(k)
    need = sum(l.numel() for l in old)
    if theta.numel() != need:
        raise ValueError(
            f"parameter vector has {theta.numel()} entries, kernel needs {need}")
    parts, i = [], 0
    for l in old:
        parts.append(theta[i:i + l.numel()].reshape(l.shape))
        i += l.numel()
    return with_leaves(k, parts)


def with_leaves(k, leaves):
    """A kernel of k's structure whose hyperparameter tensors are `leaves`
    (in `parameters` order), used as they are, so that autograd sees
    through them. k's own hyperparameters are not copied: they may be
    results of autograd (which `copy.deepcopy` refuses)."""
    slots = list(_leaf_slots(k))
    if len(leaves) != len(slots):
        raise ValueError(f"{len(leaves)} leaves, kernel has {len(slots)}")
    memo = {id(getattr(m, n)): None for m, n in slots}
    new = copy.deepcopy(k, memo)
    for (m, n), leaf in zip(slots, leaves):
        setattr(memo[id(m)], n, leaf)   # m's copy in `new`
    return new


def _is_reference_kernel(v) -> bool:
    return dataclasses.is_dataclass(v) and type(v).__module__.startswith("cfjax.")


_MULTI_KERNELS = ("GradientKernel", "ValueGradientKernel", "HessianKernel",
                  "ValueGradientHessianKernel", "SeparableKernel", "DerivativeKernel",
                  "ValueDerivativeKernel")


def from_reference(k):
    """The port's counterpart of a cfjax kernel object: the class of the
    same name, with every field converted (sub-kernels recursively, array
    leaves through `np.asarray`, static fields as they are). cfjax's
    derivative multi-kernels convert their inner kernel."""
    from .. import kernels as _kernels

    name = type(k).__name__
    if name in _MULTI_KERNELS and type(k).__module__.startswith("cfjax."):
        from .. import derivative as _derivative

        cls = getattr(_derivative, name)
        if name == "SeparableKernel":
            return cls(from_reference(k.k), np.asarray(k.B))
        inner = k.k.k if name in ("DerivativeKernel", "ValueDerivativeKernel") else k.k
        return cls(from_reference(inner))
    cls = getattr(_kernels, name, None)
    if cls is None:  # LambdaKernel, _EmbeddedPeriodic
        from ..operators import dispatch as _dispatch

        cls = getattr(_dispatch, name, None)
    if cls is None or not (isinstance(cls, type) and issubclass(cls, Kernel)):
        raise TypeError(f"no counterpart for cfjax kernel {name}")

    def conv(field, v):
        if _is_reference_kernel(v):
            return from_reference(v)
        if isinstance(v, tuple) and v and all(_is_reference_kernel(a) for a in v):
            return tuple(from_reference(a) for a in v)
        if field in cls.STATIC or v is None:
            return v
        return np.asarray(v)

    return cls(**{f.name: conv(f.name, getattr(k, f.name))
                  for f in dataclasses.fields(k)})
