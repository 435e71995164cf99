"""Non-stationary (Mercer) kernels (counterpart of `cfjax.kernels.mercer`,
reference src/mercer.jl): dot-product kernels, Brownian motion,
finite-basis (low-rank) kernels and the MacKay arcsine network kernel.
"""

from __future__ import annotations

import math

import torch

from .base import DotProductKernel, Kernel, hp


class Dot(DotProductKernel):
    """k(x, y) = <x, y> (reference src/mercer.jl:6-9)."""

    def profile(self, s):
        return torch.as_tensor(s)


class ExponentialDot(DotProductKernel):
    """k(x, y) = exp(<x, y>) (src/mercer.jl:19-22)."""

    def profile(self, s):
        return torch.exp(torch.as_tensor(s))


def Line(sigma=0.0) -> Kernel:
    """Dot + sigma (src/mercer.jl:12)."""
    return Dot() + sigma


def Polynomial(d: int, sigma=0.0) -> Kernel:
    """(Dot + sigma)^d (src/mercer.jl:13-14)."""
    return Line(sigma) ** d


Poly = Polynomial


class Brownian(Kernel):
    """k(x, y) = min(x, y) for scalar inputs (src/mercer.jl:33-37)."""

    @property
    def is_mercer(self) -> bool:
        return True

    def forward(self, x, y):
        return torch.minimum(torch.as_tensor(x).squeeze(), torch.as_tensor(y).squeeze())


class MatrixKernel(Kernel):
    """Discrete-input kernel k(i, j) = A[i, j] (src/mercer.jl:26-30)."""

    FIELDS = (("A", None), ("A_shape", None))
    STATIC = ("A_shape",)

    @property
    def is_mercer(self) -> bool:
        return True

    def forward(self, i, j):
        i = torch.as_tensor(i).to(torch.long).reshape(())
        j = torch.as_tensor(j).to(torch.long).reshape(())
        return self.A[i, j]


class FiniteBasis(Kernel):
    """Finite-basis (linear regression) kernel, k(x,y) = sum_b b(x) b(y)
    (src/mercer.jl:41-70). `basis` is a static tuple of callables."""

    FIELDS = (("basis", ()),)
    STATIC = ("basis",)

    def __post_init__(self):
        if len(self.basis) < 1:
            raise ValueError("basis is empty")

    @property
    def is_mercer(self) -> bool:
        return True

    @property
    def rank(self) -> int:
        return len(self.basis)

    def features(self, x):
        """Feature vector [b_1(x), ..., b_r(x)] for one point."""
        return torch.stack([torch.as_tensor(b(x)).reshape(()) for b in self.basis])

    def forward(self, x, y):
        return torch.sum(self.features(x) * self.features(y))


class NeuralNetwork(Kernel):
    """MacKay's arcsine neural-network kernel (src/mercer.jl:73-85):
        k(x,y) = 2/pi * asin( l(x,y) / sqrt((1 + l(x,x)) (1 + l(y,y))) )
    with l(x,y) = <x, y> + sigma."""

    FIELDS = (("sigma", 0.0),)

    @property
    def is_mercer(self) -> bool:
        return True

    def forward(self, x, y):
        x = torch.as_tensor(x)
        y = torch.as_tensor(y)
        s = hp(self.sigma, x)
        lxy = torch.sum(x * y) + s
        lxx = torch.sum(x * x) + s
        lyy = torch.sum(y * y) + s
        return 2 / math.pi * torch.asin(lxy / torch.sqrt((1 + lxx) * (1 + lyy)))


NN = NeuralNetwork
