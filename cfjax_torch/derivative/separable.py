"""Separable multi-output kernel: K(x, y) = B * k(x, y) (counterpart of
`cfjax.derivative.separable`, reference src/separable.jl).

Its gramian is gramian(k, x, y) ⊗ B (src/separable.jl:29-42), a lazy
KroneckerOperator whose scalar factor keeps its own fast path."""

from __future__ import annotations

import dataclasses

import torch

from ..kernels.base import Kernel, MultiKernel


@dataclasses.dataclass(frozen=True)
class SeparableKernel(MultiKernel):
    k: Kernel
    B: object  # (p, p) output covariance

    def block_shape(self, d):
        p = torch.as_tensor(self.B).shape[0]
        return (p, p)

    def __call__(self, x, y):
        return torch.as_tensor(self.B) * self.k(x, y)

    def gramian(self, x, y=None, **opts):
        from ..operators.dispatch import gramian as scalar_gramian
        from ..operators.kronecker import KroneckerOperator
        from ..operators.linop import DenseOperator

        G = scalar_gramian(self.k, x, y, **opts)
        B = torch.as_tensor(self.B).to(dtype=G.dtype, device=G.device)
        return KroneckerOperator((G, DenseOperator(B, symmetric=True, psd=True)))
