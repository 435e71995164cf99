"""Kernel base types and input traits (counterpart of `cfjax.kernels.base`).

Every kernel is a small `torch.nn.Module`. Its hyperparameters are tensor
buffers and its sub-kernels are submodules; structure (integer orders,
callables, precomputed tables) is plain static attributes. Each class
lists its fields in cfjax's dataclass field order (`FIELDS`) and names
the static ones (`STATIC`), so the flat hyperparameter vector of
`parameters.parameters` has the same order in both packages.

Evaluation conventions (reference src/stationary.jl:8-10, src/mercer.jl:2-3):
  - isotropic   : k(x, y) = profile(||x - y||^2)
  - dot-product : k(x, y) = profile(<x, y>)
  - stationary  : k(x, y) = tau_call(x - y)
  - stationary linear functional (Cosine): k(x, y) = profile(<c, x - y>)
  - generic     : k(x, y) arbitrary
`forward(x, y)` takes scalars or 1-D tensors; batching is the operator
layer's job (`torch.func.vmap` or tiles), never the kernel's.
"""

from __future__ import annotations

import enum

import numpy as np
import torch
from torch import nn


class InputTrait(enum.Enum):
    """What scalar summary of (x, y) the kernel depends on
    (reference src/properties.jl:31-37)."""

    GENERIC = "generic"
    ISOTROPIC = "isotropic"                  # depends on ||x-y||^2
    DOT = "dot"                              # depends on <x, y>
    STATIONARY = "stationary"                # depends on x - y
    STATIONARY_LINEAR_FUNCTIONAL = "slf"     # depends on <c, x - y>
    PERIODIC = "periodic"                    # 1-D periodic warp


def _as_param(v):
    """A hyperparameter value as a tensor buffer: Python and numpy
    numbers become float64, floating tensors keep their dtype."""
    t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
    if not t.is_floating_point():
        t = t.to(torch.float64)
    return t


def hp(t, like):
    """Hyperparameter `t` on the device and in the float dtype of `like`
    (the device always comes from the input tensors)."""
    if isinstance(like, torch.Tensor) and like.is_floating_point():
        return t.to(device=like.device, dtype=like.dtype)
    return t


def check(cond_fn, value, msg: str):
    """Validate a hyperparameter at user-construction time. Tensors that
    require grad (an optimizer's iterates) are never rejected."""
    if isinstance(value, torch.Tensor):
        if value.requires_grad:
            return
        value = value.detach().cpu().numpy()
    v = np.asarray(value)
    if v.dtype == object:
        return
    if not bool(cond_fn(v)):
        raise ValueError(f"{msg}: got {value}")


def sqdist(x, y):
    """Squared euclidean distance of two points (reference `euclidean2`,
    src/util.jl:40-47)."""
    d = torch.as_tensor(x) - torch.as_tensor(y)
    return torch.sum(d * d)


class Kernel(nn.Module):
    """Base class for all scalar-valued kernels."""

    # (name, default) in cfjax's dataclass field order
    FIELDS: tuple = ()
    # fields that are structure (pytree metadata in cfjax), not parameters
    STATIC: tuple = ()

    def __init__(self, *args, **kwargs):
        super().__init__()
        names = [n for n, _ in self.FIELDS]
        if len(args) > len(names):
            raise TypeError(f"{type(self).__name__} takes at most {len(names)} "
                            f"arguments, got {len(args)}")
        vals = dict(self.FIELDS)
        vals.update(zip(names, args))
        for n, v in kwargs.items():
            if n not in vals:
                raise TypeError(f"{type(self).__name__} has no field {n!r}")
            vals[n] = v
        for n in names:
            self._set_field(n, vals[n])
        self.__post_init__()

    def _set_field(self, name, v):
        if name in self.STATIC or v is None or isinstance(v, Kernel):
            setattr(self, name, v)
        elif isinstance(v, (tuple, list, nn.ModuleList)) and all(
                isinstance(a, Kernel) for a in v):
            setattr(self, name, nn.ModuleList(v))
        else:
            self.register_buffer(name, _as_param(v))

    def __post_init__(self):
        pass

    def extra_repr(self):
        parts = []
        for n, _ in self.FIELDS:
            v = getattr(self, n)
            if isinstance(v, torch.Tensor):
                parts.append(f"{n}={v.tolist()}")
            elif n in self.STATIC and not n.startswith("_"):
                parts.append(f"{n}={v!r}")
        return ", ".join(parts)

    # --- structure metadata -------------------------------------------------
    @property
    def trait(self) -> InputTrait:
        return InputTrait.GENERIC

    @property
    def is_mercer(self) -> bool:
        """Provably positive semi-definite? Defaults False (reference
        src/properties.jl:2); the zoo base classes and combinators
        override or propagate it."""
        return False

    @property
    def is_stationary(self) -> bool:
        return self.trait in (
            InputTrait.ISOTROPIC,
            InputTrait.STATIONARY,
            InputTrait.STATIONARY_LINEAR_FUNCTIONAL,
            InputTrait.PERIODIC,
        )

    @property
    def is_isotropic(self) -> bool:
        return self.trait == InputTrait.ISOTROPIC

    @property
    def is_dot(self) -> bool:
        return self.trait == InputTrait.DOT

    # --- evaluation ---------------------------------------------------------
    def profile(self, s):
        """Canonical scalar profile: f(r^2), f(<x,y>), or f(<c,tau>) per trait."""
        raise NotImplementedError(
            f"{type(self).__name__} does not define a scalar profile"
        )

    def profile_value(self, s):
        """Value-only profile for the MVM hot loops.

        Contract: identical values to `profile` everywhere (including
        s = 0), but its derivative in s may be clamped to 0 in an
        eps-neighbourhood of 0 (where `profile` carries a Taylor guard so
        autograd is exact). Only derivative-free evaluation paths (value
        MVMs, the CUDA kernels through `profile_spec`) may use it;
        anything that differentiates the profile in s must use
        `profile`. Hyperparameter gradients through value MVMs stay
        correct: at s = 0 every ds/dtheta factor is itself 0."""
        return self.profile(s)

    def tau_call(self, tau):
        """Stationary evaluation on the difference tau = x - y."""
        raise NotImplementedError

    def forward(self, x, y):
        t = self.trait
        if t == InputTrait.ISOTROPIC:
            return self.profile(sqdist(x, y))
        if t == InputTrait.DOT:
            return self.profile(torch.sum(torch.as_tensor(x) * torch.as_tensor(y)))
        if t in (InputTrait.STATIONARY, InputTrait.STATIONARY_LINEAR_FUNCTIONAL):
            return self.tau_call(torch.as_tensor(x) - torch.as_tensor(y))
        raise NotImplementedError(
            f"{type(self).__name__} must implement forward for generic inputs"
        )

    # --- algebra (defined in algebra.py) ------------------------------------
    def __add__(self, other):
        from . import algebra

        return algebra.add(self, other)

    __radd__ = __add__

    def __mul__(self, other):
        from . import algebra

        return algebra.mul(self, other)

    __rmul__ = __mul__

    def __pow__(self, p):
        from . import algebra

        return algebra.Power(self, int(p))


class MercerKernel(Kernel):
    """Base for provably PSD kernels (reference MercerKernel,
    src/CovarianceFunctions.jl:32-35)."""

    @property
    def is_mercer(self) -> bool:
        return True


class IsotropicKernel(MercerKernel):
    @property
    def trait(self) -> InputTrait:
        return InputTrait.ISOTROPIC

    def tau_call(self, tau):
        tau = torch.as_tensor(tau)
        return self.profile(torch.sum(tau * tau))


class StationaryKernel(MercerKernel):
    @property
    def trait(self) -> InputTrait:
        return InputTrait.STATIONARY


class DotProductKernel(MercerKernel):
    @property
    def trait(self) -> InputTrait:
        return InputTrait.DOT


class MultiKernel:
    """Base for matrix-valued kernels (reference MultiKernel,
    src/CovarianceFunctions.jl:40-42)."""

    def block_shape(self, d: int) -> tuple:
        raise NotImplementedError

    def __call__(self, x, y):
        raise NotImplementedError


def input_trait(k) -> InputTrait:
    """Explicit replacement for the reference's `input_trait` dispatch
    (src/properties.jl:39-45)."""
    if isinstance(k, Kernel):
        return k.trait
    return InputTrait.GENERIC
