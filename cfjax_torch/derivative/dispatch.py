"""Dispatch for matrix-valued (multi-output) kernel gramians (counterpart
of `cfjax.derivative.dispatch`), wired from step 1 of
`operators.dispatch.gramian`."""

from __future__ import annotations


def gramian_multikernel(k, x, y=None, **opts):
    from .gradient import GradientKernel, ValueGradientKernel
    from .hessian import HessianKernel, ValueGradientHessianKernel
    from .separable import SeparableKernel

    if isinstance(k, (SeparableKernel, GradientKernel, ValueGradientKernel,
                      HessianKernel, ValueGradientHessianKernel)):
        return k.gramian(x, y, **opts)
    raise NotImplementedError(f"no gramian plan for {type(k).__name__}")
