"""Woodbury (low-rank correction) operator A + U C V (counterpart of
`cfjax.operators.woodbury`, the reference's WoodburyFactorizations.jl
capability: gradient kernel blocks, src/gradient.jl:95-105, and
gradient-algebra corrections, src/gradient_algebra.jl:47-89): explicit
(A, U, C, V) with a fused MVM and the Woodbury-identity solve.

Arrays without a device (numpy, lists) go to A's device, or to the
configured default device when A is an array too.
"""

from __future__ import annotations

import torch

from ..config import default_device
from .linop import DiagonalOperator, LinearOperator


class WoodburyOperator(LinearOperator):
    def __init__(self, A, U, C, V=None, symmetric=None):
        if isinstance(A, LinearOperator):
            device = getattr(A, "device", None)
        else:
            device = A.device if isinstance(A, torch.Tensor) else default_device()
            A = DiagonalOperator(torch.as_tensor(A, device=device))
        as_t = lambda v: v if isinstance(v, torch.Tensor) else torch.as_tensor(v, device=device)
        self.A = A
        self.U = as_t(U)
        self.C = as_t(C)
        self.V = self.U.T if V is None else as_t(V)
        self.shape = self.A.shape
        self.dtype = self.U.dtype
        self.device = self.U.device
        self._sym = (V is None) if symmetric is None else symmetric

    @property
    def is_symmetric(self):
        return self._sym and self.A.is_symmetric

    @property
    def rank(self):
        return self.U.shape[1]

    def _matvec(self, v):
        return self.A._matvec(v) + self.U @ (self.C @ (self.V @ v))

    def _matmat(self, Vm):
        return self.A._matmat(Vm) + self.U @ (self.C @ (self.V @ Vm))

    def todense(self):
        return self.A.todense() + self.U @ self.C @ self.V

    def diagonal(self):
        n = self.shape[0]
        return self.A.diagonal() + torch.sum((self.U @ self.C) * self.V.T[:n], dim=1)

    def solve(self, b, **kw):
        """Woodbury identity: A and C must be invertible (A typically
        diagonal for the gradient blocks)."""
        Ainv_b = self.A.solve(b)
        Ainv_U = self.A.solve(self.U)
        S = torch.linalg.inv(self.C) + self.V @ Ainv_U   # the r x r capacitance
        t = torch.linalg.solve(S, self.V @ Ainv_b)
        return Ainv_b - Ainv_U @ t
