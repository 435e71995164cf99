"""Kernel profiles in float64, plain torch, written from their closed forms
in the scaled distance rho = ||x - y|| / l. Nothing here comes from the
program under test.

- EQ: exp(-rho^2 / 2).
- MaternP(p), smoothness p + 1/2: with r = sqrt(2p + 1) rho,
  exp(-r) p! / (2p)! sum_{i=0..p} (p + i)! / (i! (p - i)!) (2r)^(p - i);
  p = 2 is (1 + r + r^2 / 3) exp(-r).

Both are smooth in rho, so autograd through a lengthscale needs no square
root of a squared distance (whose derivative at 0 is not finite).
"""

from __future__ import annotations

import math

import torch


def _maternp(p: int, rho):
    r = math.sqrt(2 * p + 1) * rho
    poly = torch.zeros_like(r)
    for i in range(p + 1):
        coef = math.factorial(p + i) / (math.factorial(i) * math.factorial(p - i))
        poly = poly + coef * (2 * r) ** (p - i)
    return (math.factorial(p) / math.factorial(2 * p)) * poly * torch.exp(-r)


def profile(kernel: dict, rho):
    """k at scaled distances rho for a configuration's kernel entry
    ({"name": ..., "args": [...]})."""
    name, args = kernel["name"], kernel.get("args", [])
    if name == "EQ":
        return torch.exp(-rho * rho / 2)
    if name == "MaternP":
        return _maternp(int(args[0]) if args else 0, rho)
    raise ValueError(f"the reference has no profile for {name!r}")


def jet(kernel: dict, s):
    """(f', f'') of the profile f(s), s = rho^2, for the gradient kernel's
    blocks -2 f' I - 4 f'' r r^T."""
    if kernel["name"] == "EQ":
        f = torch.exp(-s / 2)
        return -0.5 * f, 0.25 * f
    raise ValueError(f"the reference has no derivative profile for {kernel['name']!r}")


def sqdist(a, b):
    """||a_i - b_j||^2 by the difference form, one coordinate at a time (no
    cancellation)."""
    s = torch.zeros((a.shape[0], b.shape[0]), dtype=a.dtype, device=a.device)
    for k in range(a.shape[1]):
        s += (a[:, k, None] - b[None, :, k]) ** 2
    return s


def dist(a, b):
    """||a_i - b_j||."""
    return torch.sqrt(sqdist(a, b))
