"""The solve job: condition a GP on the next observations of a seeded pool
at fixed points, then predict at the test points — `gp_condition` and
`GPPosterior.mean`, as a user calls them. Observations are values, or
gradients through `GradientKernel` (the configuration's `observations`).

Compared with the float64 reference, for every job of the window: the
residual of the returned alpha, ||(K + noise I) alpha - y|| / ||y||, and
the posterior mean's distance from K(x_test, x) alpha over its norm; each
number is the largest over the jobs."""

from __future__ import annotations

import torch

from gpbench.harness import data
from gpbench.reference import gp as ref


def program_kernel(cfg: dict):
    """The configuration's kernel, built by the program's own classes."""
    import cfjax_torch.kernels as tk

    k = getattr(tk, cfg["kernel"]["name"])(*cfg["kernel"].get("args", []))
    if cfg.get("observations", "values") == "gradients":
        from cfjax_torch.derivative import GradientKernel

        k = GradientKernel(k)
    return k


class Job:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from cfjax_torch.gp import gp_condition

        self.cfg = cfg
        self.gradients = cfg.get("observations", "values") == "gradients"
        self.x, self.Y, self.xt = data.solve_inputs(cfg, traffic, seed, device)
        self.kernel = program_kernel(cfg)
        s = cfg["solver"]
        self.opts = {"noise": float(cfg["noise"]), "tol": float(s["tol"]),
                     "maxiter": int(s["maxiter"])}
        if "precond_rank" in s:
            self.opts["precond_rank"] = int(s["precond_rank"])
        self._condition = gp_condition

    def route(self) -> str:
        from cfjax_torch.operators.dispatch import explain

        return (f"operator: {explain(self.kernel, self.x)} | mean: "
                f"{explain(self.kernel, self.xt, self.x)}")

    def __call__(self, i: int, span) -> dict:
        j = i % self.Y.shape[0]
        with span("gp_condition"):
            post = self._condition(self.kernel, self.x, self.Y[j], **self.opts)
        with span("mean"):
            mean = post.mean(self.xt)
        iters, res = post.solve_info
        return {"y": j, "alpha": post.alpha, "mean": mean, "iters": int(iters), "res": res}

    def failed(self, out: dict) -> bool:
        """The solver stopped at maxiter short of its tolerance."""
        tol = self.opts["tol"] * float(torch.linalg.norm(self.Y[out["y"]]))
        return out["iters"] >= self.opts["maxiter"] and float(out["res"]) > tol

    def release(self):
        """Free the program's state; the outputs stay with the records."""
        if self.x.is_cuda:
            torch.cuda.empty_cache()

    def check_sample(self, jobs: int) -> int:
        return jobs

    def check(self, outs: list) -> dict:
        kernel, noise = self.cfg["kernel"], self.opts["noise"]
        alpha = torch.stack([o["alpha"] for o in outs]).double()       # (J, n outputs)
        Y = self.Y[[o["y"] for o in outs]].double()
        means = torch.stack([o["mean"] for o in outs]).double()
        if self.gradients:
            n, d = self.x.shape
            A = alpha.reshape(len(outs), n, d)
            Ka = ref.grad_products(kernel, self.x, self.x, A).reshape(len(outs), -1)
            Ks = ref.grad_products(kernel, self.xt, self.x, A).reshape(len(outs), -1)
        else:
            Ka = ref.products(kernel, self.x, self.x, alpha.T).T
            Ks = ref.products(kernel, self.xt, self.x, alpha.T).T
        res = torch.linalg.norm(Ka + noise * alpha - Y, dim=1) / torch.linalg.norm(Y, dim=1)
        err = torch.linalg.norm(means - Ks, dim=1) / torch.linalg.norm(Ks, dim=1)
        return {"residual": float(res.max()), "mean_err": float(err.max())}
