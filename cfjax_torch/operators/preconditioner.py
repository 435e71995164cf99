"""Nystrom preconditioner for large-n kernel CG solves (counterpart of
`cfjax.operators.preconditioner`).

A rank-r Nystrom sketch of the kernel matrix,

    K ~= U U^T,  U = K[:, Z] V diag(w)^{-1/2},  (w, V) = eigh(K[Z, Z]),

and the preconditioner solve through a Woodbury identity — two (n, r)
products per CG iteration:

    P = U U^T + sigma^2 I
    P^-1 v = (v - U E diag(1/d) E^T U^T v) / sigma^2,  (s, E) = eigh(U^T U).

Precision, as cfjax measured it: everything dynamic-range-critical is r x r
and runs in float64 on the host (the Kzz eigh, the eigh of U^T U); the
device computes the raw panel and U^T U in the working dtype, the latter
with float-float compensated accumulation (`_gram_ff`). Two repairs keep
a float32 apply SPD: the eigenvalue floor `floor_rel` and the scaled
Woodbury denominator.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.tiles import matmul_p
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


def nystrom_preconditioner(k, x, noise, rank: int = 256, seed: int = 0,
                           floor_rel: float = 1e-8):
    """Returns apply(v) ~= (K + noise I)^-1 v for use as CG's `M`.

    `noise` is the variance added to the diagonal (sigma^2). The landmarks
    are `rank` rows drawn by `np.random.default_rng(seed).choice`, as cfjax
    draws them, so both packages pick the same points. Memory is one (n,
    rank) panel on the device of x."""
    xp = as_points(x)
    n = xp.shape[0]
    rank = min(rank, n)
    idx = np.random.default_rng(seed).choice(n, rank, replace=False)
    Z = xp[torch.as_tensor(idx, device=xp.device)]
    # Kzz eigh in float64 on the host (rank points — trivial)
    Zh = Z.detach().cpu().to(torch.float64)
    Kzz = pairwise_xy(k, Zh, Zh).numpy()
    Kzz = 0.5 * (Kzz + Kzz.T)
    w, V = np.linalg.eigh(Kzz)
    floor = max(float(w[-1]), 0.0) * floor_rel
    inv_sqrt = np.where(w > floor, 1.0 / np.sqrt(np.maximum(w, floor)), 0.0)
    W0 = torch.from_numpy((V * inv_sqrt[None, :]).astype(np.float32)).to(
        device=xp.device, dtype=xp.dtype)

    # U = K_xZ W0, built block by block into one preallocated panel with
    # in-place writes (cfjax donates the panel to a jitted block update):
    # peak memory is U plus one block's kernel panel
    block = 8192
    U = torch.empty((n, rank), dtype=xp.dtype, device=xp.device)
    for i in range(0, n, block):
        U[i:i + block] = matmul_p(pairwise_xy(k, xp[i:i + block], Z), W0,
                                  precision="highest")
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
    Ej = torch.from_numpy(E.astype(np.float32)).to(device=xp.device, dtype=U.dtype)
    dj = torch.from_numpy(denom.astype(np.float32)).to(device=xp.device, dtype=U.dtype)
    nz = float(noise)

    def apply(v):
        t = Ej.T @ (U.T @ v)
        t = Ej @ (t / dj)
        return (v - U @ t) / nz

    return apply
