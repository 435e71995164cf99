"""The solve job on an ARD kernel with an outputscale: `jobs/solve.py`'s job
(condition on the next observations of a seeded pool at fixed points, then
predict at the test points) with the kernel `outputscale * ARDKernel(k, l)`,
built by the program's own classes as a GPyTorch user writes
`ScaleKernel(MaternKernel(nu=2.5, ard_num_dims=d))`, and checked against the
benchmark's ARD reference (`reference/ard.py`).

The lengthscales l are drawn once, from the configuration's `ard` law and
its own `base_seed` (the same for every seed), on the host in float64, and
handed to the program and the reference rounded to the points' dtype.

The cell measures the route that evaluates this kernel through its
isotropic profile. A program that would evaluate it pairwise (the Gramian's
`generic` mode, minutes a job at the cell's size) is refused when the job is
made, before any work: the run ends at once with exit code 1."""

from __future__ import annotations

import math

import torch

from gpbench.harness import spec
from gpbench.reference import ard as ref

_solve = spec.job_module("solve")


def lengthscales(cfg: dict) -> torch.Tensor:
    """The configuration's d lengthscales (float64, host). The law
    "dim_scaled_lognormal" is LogNormal(sqrt(2) + ln(d) / 2, sqrt(3))."""
    law, d = cfg["ard"], int(cfg["d"])
    if law["law"] != "dim_scaled_lognormal":
        raise ValueError(f"unknown law of lengthscales {law['law']!r}")
    g = torch.Generator().manual_seed(int(law["base_seed"]))
    z = torch.randn(d, generator=g, dtype=torch.float64)
    return torch.exp(math.sqrt(2) + 0.5 * math.log(d) + math.sqrt(3) * z)


def pairwise_route(kernel, x) -> str | None:
    """Why the program would evaluate `kernel` on `x` pair by pair (its
    Gramian in the `generic` mode), or None."""
    from cfjax_torch.operators.dispatch import gramian

    mode = getattr(gramian(kernel, x[:2]), "mode", None)
    return None if mode != "generic" else (
        f"the program evaluates {type(kernel).__name__} pair by pair (Gramian mode "
        f"'generic'): it cannot run this configuration on its isotropic route")


class Job(_solve.Job):
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        super().__init__(cfg, traffic, seed, device)
        import cfjax_torch.kernels as tk

        self.ell = lengthscales(cfg).to(device=self.x.device, dtype=self.x.dtype)
        self.outputscale = float(cfg["outputscale"])
        inner = getattr(tk, cfg["kernel"]["name"])(*cfg["kernel"].get("args", []))
        self.kernel = self.outputscale * tk.ARDKernel(inner, self.ell)
        why = pairwise_route(self.kernel, self.x) if self.x.is_cuda else None
        if why is not None:
            raise RuntimeError(why)

    def check(self, outs: list) -> dict:
        kernel, s, noise = self.cfg["kernel"], self.outputscale, self.opts["noise"]
        alpha = torch.stack([o["alpha"] for o in outs]).double()       # (J, n)
        Y = self.Y[[o["y"] for o in outs]].double()
        means = torch.stack([o["mean"] for o in outs]).double()
        Ka = ref.products(kernel, s, self.ell, self.x, self.x, alpha.T).T
        Ks = ref.products(kernel, s, self.ell, self.xt, self.x, alpha.T).T
        res = torch.linalg.norm(Ka + noise * alpha - Y, dim=1) / torch.linalg.norm(Y, dim=1)
        err = torch.linalg.norm(means - Ks, dim=1) / torch.linalg.norm(Ks, dim=1)
        return {"residual": float(res.max()), "mean_err": float(err.max())}
