"""Separable multi-output kernel: K(x, y) = B * k(x, y) (counterpart of
`cfjax.derivative.separable`, reference src/separable.jl).

Its gramian is gramian(k, x, y) ⊗ B (src/separable.jl:29-42), a lazy
Kronecker operator in cfjax; the port's KroneckerOperator comes with the
structured fast paths, so `gramian` raises until then."""

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
        raise NotImplementedError(
            "the gramian of a SeparableKernel is a KroneckerOperator, which is not "
            "ported yet (ROADMAP.md, queue 1, item 10)")
