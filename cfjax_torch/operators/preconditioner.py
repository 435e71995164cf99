"""Nystrom preconditioner for large-n kernel CG solves (counterpart of
`cfjax.operators.preconditioner`).

A rank-r Nystrom sketch of the kernel matrix,

    K ~= U U^T,  U = K[:, Z] V diag(w)^{-1/2},  (w, V) = eigh(K[Z, Z]),

and the preconditioner solve through a Woodbury identity — two (n, r)
products per CG iteration:

    P = U U^T + sigma^2 I
    P^-1 v = (v - U E diag(1/d) E^T U^T v) / sigma^2,  (s, E) = eigh(U^T U).

Precision. The r x r eigendecompositions run in float64 on the host, as
cfjax's do. cfjax builds the (n, r) panel U = K_xZ Kzz^-1/2 on the device
in the working dtype and its Gram with float-float accumulation
(`_gram_ff`); for float32 points the port builds the panel, its product
with Kzz^-1/2 and the Gram in float64 on the device, block by block (as
cfjax's float64 build `_build_nystrom_hostf64` computes them), and stores
U in float32: the apply runs in float32. Kzz^-1/2 amplifies the panel's
float32 rounding by up to 1/sqrt(floor_rel) into the small modes of U
(cfjax's docstring: "every mode below ~3e-6 lambda_max is junk"), and on
an H100 BASELINE config 5's PCG on cfjax's own points (n = 10^6, rank
2048, sigma^2 / lambda_max ~ 6e-7) stalled at 5.2e-3 after 60 iterations
with the float32 build and converged in 10 with the float64 one (PERF.md,
`cfjax_torch/benchmarks/config5_probe.py`). `build_dtype=torch.float32`
keeps cfjax's float32 build. Two repairs keep a float32 apply SPD: the
eigenvalue floor `floor_rel` and the scaled Woodbury denominator.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.profile_spec import FAMILY_MATERN_NU, to_spec
from ..ops.tiles import full_fp32, matmul_p, sqdist_tile
from ..utils.grids import as_points
from ..utils.testing import pairwise_xy


def _gram_ff(P, chunk: int = 2048):
    """G = P^T P with float-float (TwoSum) accumulation across row chunks:
    each chunk's (r, r) product is a full-precision matmul; the chunks
    combine into an (hi, lo) pair with compensated summation, so the
    cross-chunk accumulation is exact to ~eps^2. Returns (hi, lo)."""
    r = P.shape[1]
    hi = torch.zeros((r, r), dtype=P.dtype, device=P.device)
    lo = torch.zeros_like(hi)
    for i in range(0, P.shape[0], chunk):
        Pc = P[i:i + chunk]
        C = matmul_p(Pc.T, Pc, precision="highest")
        s = hi + C
        # TwoSum compensation: t = C - (s - hi) is exact when |hi| >= |C|
        lo = lo + (C - (s - hi))
        hi = s
    return hi, lo


def _panel_fn(k):
    """(x, Z) -> K_xZ for the build. A one-leaf real-nu Matern takes its
    tabulated family's plain version on the exact squared distances
    (`ProfileSpec.evaluate(s, family=True)`, the function K1 and K2
    compute): `pairwise_xy` would run cfjax's 400-node quadrature on every
    entry, tens of GiB a block at rank 2048. Every other kernel takes
    `pairwise_xy`."""
    spec, _ = to_spec(k)
    if spec is None or spec.family != FAMILY_MATERN_NU:
        return lambda a, b: pairwise_xy(k, a, b)
    return lambda a, b: spec.evaluate(sqdist_tile(a, b, direct_max_d=a.shape[1]), family=True)


def nystrom_factors(k, x, noise, rank: int = 256, seed: int = 0, floor_rel: float = 1e-8,
                    factor_dtype=np.float32, build_dtype=None):
    """(U, E, denom) of the rank-`rank` Nystrom preconditioner of K + noise
    I (see `nystrom_preconditioner`, which applies them): U the (n, rank)
    panel on x's device in x's dtype, E and denom from the eigh of U^T U,
    in U's dtype.

    `build_dtype` is the dtype of the kernel panel, its product with
    Kzz^-1/2 and the Gram U^T U: by default float64 for float32 points
    (U rounded to float32 as each block is stored, the Gram summed from the
    float64 blocks) and the points' own dtype otherwise; float32 points
    with build_dtype=torch.float32 build as cfjax does (the Gram by
    `_gram_ff`). The host-side factors are rounded to `factor_dtype` before
    they reach the device, float32 as cfjax rounds them, except Kzz^-1/2
    in a float64 build of float32 points."""
    xp = as_points(x)
    n = xp.shape[0]
    rank = min(rank, n)
    bdt = build_dtype or (torch.float64 if xp.dtype == torch.float32 else xp.dtype)
    widened = bdt != xp.dtype
    idx = np.random.default_rng(seed).choice(n, rank, replace=False)
    Z = xp[torch.as_tensor(idx, device=xp.device)]
    panel = _panel_fn(k)
    # Kzz eigh in float64 on the host (rank points — trivial)
    Zh = Z.detach().cpu().to(torch.float64)
    Kzz = panel(Zh, Zh).numpy()
    Kzz = 0.5 * (Kzz + Kzz.T)
    w, V = np.linalg.eigh(Kzz)
    floor = max(float(w[-1]), 0.0) * floor_rel
    inv_sqrt = np.where(w > floor, 1.0 / np.sqrt(np.maximum(w, floor)), 0.0)
    W0 = V * inv_sqrt[None, :]
    W0 = torch.from_numpy(W0 if widened else W0.astype(factor_dtype)).to(device=xp.device,
                                                                         dtype=bdt)
    Zb = Z.to(bdt)

    # U = K_xZ W0, built block by block into one preallocated panel with
    # in-place writes (cfjax donates the panel to a jitted block update):
    # peak memory is U plus one block's kernel panel
    block = 8192
    U = torch.empty((n, rank), dtype=xp.dtype, device=xp.device)
    G = torch.zeros((rank, rank), dtype=bdt, device=xp.device) if widened else None
    for i in range(0, n, block):
        Ub = matmul_p(panel(xp[i:i + block].to(bdt), Zb), W0, precision="highest")
        if widened:
            G += matmul_p(Ub.T, Ub, precision="highest")
        U[i:i + block] = Ub
    if widened:
        B = G.cpu().double().numpy()
    else:
        hi, lo = _gram_ff(U, chunk=block)
        B = hi.cpu().double().numpy() + lo.cpu().double().numpy()
    s, E = np.linalg.eigh(0.5 * (B + B.T))
    s = np.maximum(s, 0.0)
    # Floor the per-mode residue at what a float32 apply can represent by
    # SCALING THE WOODBURY DENOMINATOR, d_i = s_i (s_cap + noise) / s_cap
    # for s_i > s_cap: capping s_i instead would make the apply indefinite
    # on every mode with s_i > s_cap + noise and PCG diverge. Denominator
    # scaling keeps M SPD with cond(M^-1 K) ~ s_max / s_cap.
    s_cap = float(noise) / (16.0 * np.finfo(np.float32).eps)
    denom = np.where(s > s_cap, s * (s_cap + float(noise)) / s_cap, s + float(noise))
    Ej = torch.from_numpy(E.astype(factor_dtype)).to(device=xp.device, dtype=U.dtype)
    dj = torch.from_numpy(denom.astype(factor_dtype)).to(device=xp.device, dtype=U.dtype)
    return U, Ej, dj


def nystrom_apply(U, E, denom, noise):
    """v -> (v - U E diag(1/denom) E^T U^T v) / noise: the Woodbury apply
    of `nystrom_factors`, in U's dtype, its products in full fp32
    whatever torch's global tf32 setting."""
    nz = float(noise)

    def apply(v):
        with full_fp32():
            t = E.T @ (U.T @ v)
            t = E @ (t / denom)
            return (v - U @ t) / nz

    return apply


def nystrom_preconditioner(k, x, noise, rank: int = 256, seed: int = 0,
                           floor_rel: float = 1e-8):
    """Returns apply(v) ~= (K + noise I)^-1 v for use as CG's `M`.

    `noise` is the variance added to the diagonal (sigma^2). The landmarks
    are `rank` rows drawn by `np.random.default_rng(seed).choice`, as cfjax
    draws them, so both packages pick the same points. Memory is one (n,
    rank) panel on the device of x."""
    return nystrom_apply(*nystrom_factors(k, x, noise, rank, seed, floor_rel), noise)
