"""The fit job: one step of `gp/fit.py`'s `fit_kernel` — the log marginal
likelihood of the configuration's kernel under a lengthscale and its
`backward()` to theta = log(lengthscale), theta a float64 host tensor as
the optimizer holds it — at the next theta of a seeded list, y fixed.

Compared with the float64 reference (a dense Cholesky, the derivative by
autograd) on a sample of the window's steps drawn from the seed: the
value's relative error, and the derivative's error over the larger of its
reference's magnitude and the sample's median magnitude (a derivative may
pass through zero); each number is the largest over the sample."""

from __future__ import annotations

import statistics

import torch

from gpbench.harness import data
from gpbench.reference import gp as ref


class Job:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        import cfjax_torch.kernels as tk
        from cfjax_torch.gp.regression import log_marginal_likelihood

        self.cfg, self.traffic = cfg, traffic
        self.x, self.y, self.thetas = data.fit_inputs(cfg, traffic, seed, device)
        base = getattr(tk, cfg["kernel"]["name"])(*cfg["kernel"].get("args", []))
        self.kernel = tk.Lengthscale(base, 1.0)
        self.noise = float(cfg["noise"])
        self._similar, self._logml = tk.similar, log_marginal_likelihood

    def route(self) -> str:
        from cfjax_torch.operators.dispatch import explain

        return f"{explain(self.kernel, self.x)} | logML by Cholesky up to max_cholesky_size"

    def __call__(self, i: int, span) -> dict:
        th = self.thetas[i % len(self.thetas)]
        theta = torch.tensor([th], dtype=torch.float64, requires_grad=True)
        k = self._similar(self.kernel, torch.exp(theta))
        try:
            with span("logml_fwd"):
                loss = -self._logml(k, self.x, self.y, noise=self.noise)
            with span("logml_bwd"):
                loss.backward()
        except torch.linalg.LinAlgError as e:      # the factorization broke down: no answer
            nan = torch.tensor(float("nan"))
            return {"theta": th, "value": nan, "grad": nan, "error": str(e)}
        return {"theta": th, "value": -loss.detach(), "grad": -theta.grad[0]}

    def failed(self, out: dict) -> bool:
        """The step gave no answer."""
        return "error" in out

    def release(self):
        if self.x.is_cuda:
            torch.cuda.empty_cache()

    def check_sample(self, jobs: int) -> int:
        return int(self.traffic["check_sample"])

    def check(self, outs: list) -> dict:
        refs = [ref.logml(self.cfg["kernel"], self.x, self.y, self.noise, o["theta"])
                for o in outs]
        scale = statistics.median(abs(g) for _, g in refs)
        value = [abs(float(o["value"]) - v) / abs(v) for o, (v, _) in zip(outs, refs)]
        grad = [abs(float(o["grad"]) - g) / max(abs(g), scale) for o, (_, g) in zip(outs, refs)]
        # torch's max keeps a NaN (a step without an answer); Python's may drop it
        return {"value_err": float(torch.tensor(value).max()),
                "grad_err": float(torch.tensor(grad).max())}
