"""The one generator of the benchmark's inputs: points, observations, test
points and hyperparameters, made from `--seed` by the laws that a
configuration names and at the sizes that a traffic mix names, on the
device in a few large calls. The same seed gives the same inputs; the
program and the reference are handed the same tensors."""

from __future__ import annotations

import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _observe_sin_x0(x, eps):
    """f = sin(x_0) plus noise: values at the points."""
    return torch.sin(x[:, 0]).to(eps.dtype) + eps[..., 0]


def _observe_grad_sum_sin(x, eps):
    """The gradient of f = sum_l sin(x_l), cos(x), plus noise, stacked
    point-major (y[i d + l] = d f / d x_l at x_i)."""
    return (torch.cos(x).to(eps.dtype) + eps).reshape(*eps.shape[:-2], -1)


# law name -> function of (the points in float64, noise)
OBSERVATIONS = {"sin_x0": _observe_sin_x0, "grad_sum_sin": _observe_grad_sum_sin}


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def points(law: dict, n: int, d: int, device):
    """n points in R^d (float64): the law "fixed_normal" draws one sample of
    scale N(0, I) from its own `base_seed`, the same for every seed, as a
    user conditions one training set on many observations. With points
    drawn from the seed, each seed posed the solvers another amount of work
    (PCG iterations 235-312 a job across 12 seeds at n = 2^17)."""
    if law["law"] != "fixed_normal":
        raise ValueError(f"unknown law of points {law['law']!r}")
    return float(law.get("scale", 1.0)) * torch.randn(
        (n, d), generator=generator(law["base_seed"], device), dtype=torch.float64,
        device=device)


def test_points(g, law: dict, d: int, dtype, device):
    scale = float(law.get("scale", 1.0))
    return scale * torch.randn((int(law["points"]), d), generator=g, dtype=dtype,
                               device=device)


def solve_inputs(cfg: dict, traffic: dict, seed: int, device):
    """(x (n, d), Y (pool, n * outputs), xt (n_test, d)) for a solve job."""
    g = generator(seed, device)
    dtype = DTYPES[cfg["precision"]["points"]]
    n, d = int(traffic["n"]), int(cfg["d"])
    x = points(cfg["x"], n, d, device)
    law = cfg["y"]
    eps = float(law["noise_sd"]) * torch.randn((int(traffic["pool"]), n, d), generator=g,
                                               dtype=dtype, device=device)
    Y = OBSERVATIONS[law["law"]](x, eps)
    return x.to(dtype), Y, test_points(g, cfg["test"], d, dtype, device)


def fit_inputs(cfg: dict, traffic: dict, seed: int, device):
    """(x (n, d), y (n,), thetas: float list) for a fit job; thetas are drawn
    uniformly from the configuration's range, on the host in float64 as
    the optimizer holds them."""
    g = generator(seed, device)
    dtype = DTYPES[cfg["precision"]["points"]]
    n, d = int(traffic["n"]), int(cfg["d"])
    x = points(cfg["x"], n, d, device)
    law = cfg["y"]
    eps = float(law["noise_sd"]) * torch.randn((1, n, d), generator=g, dtype=dtype,
                                               device=device)
    y = OBSERVATIONS[law["law"]](x, eps)[0]
    lo, hi = float(cfg["fit"]["low"]), float(cfg["fit"]["high"])
    gh = generator(seed, "cpu")
    thetas = lo + (hi - lo) * torch.rand(int(traffic["thetas"]), generator=gh,
                                          dtype=torch.float64)
    return x.to(dtype), y, thetas.tolist()
