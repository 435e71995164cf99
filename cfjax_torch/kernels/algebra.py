"""Kernel algebra: sums, products, powers, separable combinations
(counterpart of `cfjax.kernels.algebra`, reference src/algebra.jl).

Combined input traits follow the reference's
`sum_and_product_input_trait` (src/properties.jl:47-63): Constants are
trait-transparent, heterogeneous traits collapse to GENERIC.
"""

from __future__ import annotations

import torch

from .base import InputTrait, Kernel, input_trait


def _combined(args) -> InputTrait:
    from .stationary import Constant

    non_const = [k for k in args if not isinstance(k, Constant)]
    if not non_const:
        return InputTrait.ISOTROPIC
    t = input_trait(non_const[0])
    for k in non_const[1:]:
        if input_trait(k) != t:
            return InputTrait.GENERIC
    if t == InputTrait.STATIONARY_LINEAR_FUNCTIONAL and len(non_const) > 1:
        # different linear functionals c don't share a scalar profile
        return InputTrait.GENERIC
    return t


def _flatten(cls, args):
    out = []
    for a in args:
        if isinstance(a, cls):
            out.extend(a.args)
        else:
            out.append(a)
    return tuple(out)


def _prod(vals):
    out = None
    for p in vals:
        out = p if out is None else out * p
    return out


class Sum(Kernel):
    """Pointwise sum of kernels (reference src/algebra.jl:28-47)."""

    FIELDS = (("args", ()),)

    def __post_init__(self):
        self.args = torch.nn.ModuleList(_flatten(Sum, self.args))

    @property
    def trait(self) -> InputTrait:
        return _combined(self.args)

    @property
    def is_mercer(self) -> bool:
        return all(getattr(k, "is_mercer", False) for k in self.args)

    def profile(self, s):
        return sum(k.profile(s) for k in self.args)

    def profile_value(self, s):
        return sum(k.profile_value(s) for k in self.args)

    def tau_call(self, tau):
        return sum(k.tau_call(tau) for k in self.args)

    def forward(self, x, y):
        return sum(k(x, y) for k in self.args)


class Product(Kernel):
    """Pointwise product of kernels (src/algebra.jl:5-25)."""

    FIELDS = (("args", ()),)

    def __post_init__(self):
        self.args = torch.nn.ModuleList(_flatten(Product, self.args))

    @property
    def trait(self) -> InputTrait:
        return _combined(self.args)

    @property
    def is_mercer(self) -> bool:
        # Schur product theorem (reference src/properties.jl:19)
        return all(getattr(k, "is_mercer", False) for k in self.args)

    def profile(self, s):
        return _prod(k.profile(s) for k in self.args)

    def profile_value(self, s):
        return _prod(k.profile_value(s) for k in self.args)

    def tau_call(self, tau):
        return _prod(k.tau_call(tau) for k in self.args)

    def forward(self, x, y):
        return _prod(k(x, y) for k in self.args)


class Power(Kernel):
    """k^p with static integer exponent (src/algebra.jl:50-63)."""

    FIELDS = (("k", None), ("p", 1))
    STATIC = ("p",)

    @property
    def trait(self) -> InputTrait:
        return input_trait(self.k)

    @property
    def is_mercer(self) -> bool:
        return getattr(self.k, "is_mercer", False) and self.p >= 1

    def profile(self, s):
        return self.k.profile(s) ** self.p

    def profile_value(self, s):
        return self.k.profile_value(s) ** self.p

    def tau_call(self, tau):
        return self.k.tau_call(tau) ** self.p

    def forward(self, x, y):
        return self.k(x, y) ** self.p


class SeparableProduct(Kernel):
    """prod_i k_i(x_i, y_i) — per-dimension product (src/algebra.jl:68-95)."""

    FIELDS = (("args", ()),)

    @property
    def is_mercer(self) -> bool:
        return all(getattr(k, "is_mercer", False) for k in self.args)

    def forward(self, x, y):
        x = torch.atleast_1d(torch.as_tensor(x))
        y = torch.atleast_1d(torch.as_tensor(y))
        return _prod(k(x[i], y[i]) for i, k in enumerate(self.args))


class SeparableSum(Kernel):
    """sum_i k_i(x_i, y_i) — additive per-dimension kernel
    (src/algebra.jl:105-123)."""

    FIELDS = (("args", ()),)

    @property
    def is_mercer(self) -> bool:
        return all(getattr(k, "is_mercer", False) for k in self.args)

    def forward(self, x, y):
        x = torch.atleast_1d(torch.as_tensor(x))
        y = torch.atleast_1d(torch.as_tensor(y))
        return sum(k(x[i], y[i]) for i, k in enumerate(self.args))


def separable(op, *kernels, d: int = None) -> Kernel:
    """separable('*', k1, k2, ...) / separable('+', ...) /
    separable('^', k, d=3) for a d-fold separable power
    (src/algebra.jl:140-143)."""
    if op in ("*", "prod"):
        return SeparableProduct(tuple(kernels))
    if op in ("+", "sum"):
        return SeparableSum(tuple(kernels))
    if op in ("^", "pow"):
        (k,) = kernels
        if d is None:
            raise ValueError("separable('^', k, d=...) needs d")
        return SeparableProduct(tuple(k for _ in range(d)))
    raise ValueError(f"unknown separable op {op!r}")


def _to_kernel(v):
    from .stationary import Constant

    if isinstance(v, Kernel):
        return v
    return Constant(v)


def add(a, b) -> Kernel:
    return Sum((_to_kernel(a), _to_kernel(b)))


def mul(a, b) -> Kernel:
    return Product((_to_kernel(a), _to_kernel(b)))
