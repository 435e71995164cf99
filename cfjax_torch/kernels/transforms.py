"""Kernel input/output transformations (counterpart of
`cfjax.kernels.transforms`, reference src/transformation.jl):
lengthscales, ARD, custom norms, periodic (MacKay) warping, linear input
scaling, generic warping, symmetrization, scalar chaining and vertical
rescaling. Callables (`n2`, `u`, `f`) are static and take torch tensors.
"""

from __future__ import annotations

import math

import torch

from .base import (
    InputTrait,
    IsotropicKernel,
    Kernel,
    check,
    hp,
    input_trait,
)


class Lengthscale(IsotropicKernel):
    """k(r^2 / l^2) (reference src/transformation.jl:6-19)."""

    FIELDS = (("k", None), ("l", 1.0))

    def __post_init__(self):
        check(lambda v: (v > 0).all(), self.l, "lengthscale must be positive")

    def profile(self, s):
        s = torch.as_tensor(s)
        l = hp(self.l, s)
        return self.k.profile(s / (l * l))

    def profile_value(self, s):
        s = torch.as_tensor(s)
        l = hp(self.l, s)
        return self.k.profile_value(s / (l * l))

    @property
    def is_mercer(self) -> bool:
        return getattr(self.k, "is_mercer", False)


class Normed(Kernel):
    """Stationary kernel with a custom squared norm on tau = x - y
    (src/transformation.jl:25-39). `n2` is a static callable tau -> scalar."""

    FIELDS = (("k", None), ("n2", None))
    STATIC = ("n2",)

    @property
    def trait(self) -> InputTrait:
        return InputTrait.STATIONARY

    def tau_call(self, tau):
        return self.k.profile(self.n2(torch.as_tensor(tau)))

    @property
    def is_mercer(self) -> bool:
        return getattr(self.k, "is_mercer", False)

    def forward(self, x, y):
        return self.tau_call(torch.as_tensor(x) - torch.as_tensor(y))


class ARDKernel(Kernel):
    """Automatic relevance determination: per-dimension lengthscales l
    (src/transformation.jl:42-46)."""

    FIELDS = (("k", None), ("l", None))

    @property
    def trait(self) -> InputTrait:
        return InputTrait.STATIONARY

    def tau_call(self, tau):
        tau = torch.as_tensor(tau)
        t = tau / hp(self.l, tau)
        return self.k.profile(torch.sum(t * t))

    @property
    def is_mercer(self) -> bool:
        return getattr(self.k, "is_mercer", False)

    def forward(self, x, y):
        return self.tau_call(torch.as_tensor(x) - torch.as_tensor(y))


def ARD(k, l):
    """ARD(k, vector l) or Lengthscale(k, scalar l) (src/transformation.jl:42-46)."""
    arr = torch.as_tensor(l)
    if arr.ndim == 0:
        return Lengthscale(k, l)
    return ARDKernel(k, arr)


class Energetic(Kernel):
    """Energetic norm kernel: k(tau' A tau) (src/transformation.jl:47-50)."""

    FIELDS = (("k", None), ("A", None))

    @property
    def trait(self) -> InputTrait:
        return InputTrait.STATIONARY

    def tau_call(self, tau):
        t = torch.atleast_1d(torch.as_tensor(tau))
        return self.k.profile(t @ (hp(self.A, t) @ t))

    @property
    def is_mercer(self) -> bool:
        return getattr(self.k, "is_mercer", False)

    def forward(self, x, y):
        return self.tau_call(torch.as_tensor(x) - torch.as_tensor(y))


class Periodic(Kernel):
    """MacKay periodic warp of an isotropic kernel
    (src/transformation.jl:54-64): per coordinate,
    tau^2 -> (2 sin(pi tau))^2 (1-periodic)."""

    FIELDS = (("k", None),)

    @property
    def trait(self) -> InputTrait:
        return InputTrait.PERIODIC

    def warped_sqdist(self, tau):
        t = torch.atleast_1d(torch.as_tensor(tau))
        w = 2 * torch.sin(math.pi * t)
        return torch.sum(w * w)

    def tau_call(self, tau):
        return self.k.profile(self.warped_sqdist(tau))

    @property
    def is_mercer(self) -> bool:
        return getattr(self.k, "is_mercer", False)

    def forward(self, x, y):
        return self.tau_call(torch.as_tensor(x) - torch.as_tensor(y))


class ScaledInputKernel(Kernel):
    """k(U x, U y) (src/transformation.jl:71-95)."""

    FIELDS = (("k", None), ("U", None))

    def forward(self, x, y):
        x = torch.atleast_1d(torch.as_tensor(x))
        U = hp(self.U, x)
        return self.k(U @ x, U @ torch.atleast_1d(torch.as_tensor(y)))

    @property
    def is_mercer(self) -> bool:
        return getattr(self.k, "is_mercer", False)


class Warped(Kernel):
    """k(u(x), u(y)) for a static callable u (src/transformation.jl:98-121)."""

    FIELDS = (("k", None), ("u", None))
    STATIC = ("u",)

    def forward(self, x, y):
        return self.k(self.u(torch.as_tensor(x)), self.u(torch.as_tensor(y)))

    @property
    def is_mercer(self) -> bool:
        return getattr(self.k, "is_mercer", False)


class SymmetricKernel(Kernel):
    """Symmetrized kernel about center z (src/transformation.jl:126-137)."""

    FIELDS = (("k", None), ("z", 0.0))

    def forward(self, x, y):
        x = torch.as_tensor(x)
        z = hp(self.z, x)
        x = x - z
        y = torch.as_tensor(y) - z
        return (self.k(x, y) + self.k(-x, y)) / 2


class Chained(Kernel):
    """f(k(x, y)) for a static scalar function f (src/transformation.jl:141-150).
    Keeps the input trait of k; is_mercer stays False (f(k) is generally
    not PSD)."""

    FIELDS = (("f", None), ("k", None))
    STATIC = ("f",)

    @property
    def trait(self) -> InputTrait:
        return input_trait(self.k)

    def profile(self, s):
        return self.f(self.k.profile(s))

    def profile_value(self, s):
        return self.f(self.k.profile_value(s))

    def tau_call(self, tau):
        return self.f(self.k.tau_call(tau))

    def forward(self, x, y):
        return self.f(self.k(x, y))


class VerticalRescaling(Kernel):
    """f(x) k(x, y) f(y) (src/transformation.jl:156-171)."""

    FIELDS = (("k", None), ("f", None))
    STATIC = ("f",)

    def forward(self, x, y):
        return self.f(torch.as_tensor(x)) * self.k(x, y) * self.f(torch.as_tensor(y))

    @property
    def is_mercer(self) -> bool:
        return getattr(self.k, "is_mercer", False)


def normalize(k: Kernel) -> Kernel:
    """Rescale so k(x, x) = 1 (src/transformation.jl:174)."""
    return VerticalRescaling(k, lambda x: 1.0 / torch.sqrt(k(x, x)))
