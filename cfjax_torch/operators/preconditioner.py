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
(cfjax's docstring: "every mode below ~3e-6 lambda_max is junk"): on an
H100, BASELINE config 5's PCG stalled with a float32 build and converged
with the float64 one (PERF.md section 6). Two repairs keep a
float32 apply SPD: the eigenvalue floor `floor_rel` and the scaled
Woodbury denominator.

The build reads the lazy `Gramian` it preconditions: its points (divided
by l once for an ARD kernel the dispatch folds) and its entry rule
(`gramian.build_tile`), so the dispatch decides both once.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.tiles import full_fp32, matmul_p
from ..utils import trace
from .dispatch import gramian
from .gramian import Gramian, build_tile


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


def nystrom_factors(G, noise, rank: int = 256, seed: int = 0, floor_rel: float = 1e-8):
    """(U, E, denom) of the rank-`rank` Nystrom preconditioner of G + noise
    I for a square lazy Gramian G (see `nystrom_preconditioner`, which
    applies them): U the (n, rank) panel on G's device in its points'
    dtype, E and denom from the eigh of U^T U, in U's dtype.

    The panel, its product with Kzz^-1/2 and the Gram U^T U are built in
    float64 for float32 points (U rounded to float32 as each block is
    stored, the Gram summed from the float64 blocks), in the points' own
    dtype otherwise (the Gram by `_gram_ff`). The host-side factors reach
    the device rounded to float32, as cfjax rounds them, except Kzz^-1/2 in
    the float64 build of float32 points."""
    if not (isinstance(G, Gramian) and G.is_symmetric):
        raise TypeError(f"the Nystrom build takes a square lazy Gramian, not {G!r}")
    sp = trace.begin("precond.nystrom")
    try:
        return _nystrom_factors(G, noise, rank, seed, floor_rel)
    finally:
        trace.end(sp)


def _nystrom_factors(G, noise, rank, seed, floor_rel):
    """`nystrom_factors`' build, inside its span."""
    xp = G.x
    n = xp.shape[0]
    rank = min(rank, n)
    bdt = torch.float64 if xp.dtype == torch.float32 else xp.dtype
    widened = bdt != xp.dtype
    # the host's part, in two spans: the landmarks and Kzz^-1/2, then the
    # eigh of the Gram and the factors' copies to the device
    host = trace.begin("precond.nystrom.host")
    idx = np.random.default_rng(seed).choice(n, rank, replace=False)
    Z = xp[trace.to_device(torch.as_tensor(idx), xp.device, span=host)]
    panel = build_tile(G)
    # Kzz eigh in float64 on the host (rank points — trivial)
    Zh = trace.cpu(Z.detach(), host).to(torch.float64)
    Kzz = panel(Zh, Zh).numpy()
    Kzz = 0.5 * (Kzz + Kzz.T)
    w, V = np.linalg.eigh(Kzz)
    floor = max(float(w[-1]), 0.0) * floor_rel
    inv_sqrt = np.where(w > floor, 1.0 / np.sqrt(np.maximum(w, floor)), 0.0)
    W0 = V * inv_sqrt[None, :]
    W0 = trace.to_device(torch.from_numpy(W0 if widened else W0.astype(np.float32)),
                         xp.device, bdt, host)
    trace.end(host)
    Zb = Z.to(bdt)

    # U = K_xZ W0, built block by block into one preallocated panel with
    # in-place writes (cfjax donates the panel to a jitted block update):
    # peak memory is U plus one block's kernel panel
    block = 8192
    U = torch.empty((n, rank), dtype=xp.dtype, device=xp.device)
    Gram = torch.zeros((rank, rank), dtype=bdt, device=xp.device) if widened else None
    for i in range(0, n, block):
        Ub = matmul_p(panel(xp[i:i + block].to(bdt), Zb), W0, precision="highest")
        if widened:
            Gram += matmul_p(Ub.T, Ub, precision="highest")
        U[i:i + block] = Ub
    if not widened:
        hi, lo = _gram_ff(U, chunk=block)
    host = trace.begin("precond.nystrom.host")
    if widened:
        B = trace.cpu(Gram, host).double().numpy()
    else:
        B = trace.cpu(hi, host).double().numpy() + trace.cpu(lo, host).double().numpy()
    s, E = np.linalg.eigh(0.5 * (B + B.T))
    s = np.maximum(s, 0.0)
    # Floor the per-mode residue at what a float32 apply can represent by
    # SCALING THE WOODBURY DENOMINATOR, d_i = s_i (s_cap + noise) / s_cap
    # for s_i > s_cap: capping s_i instead would make the apply indefinite
    # on every mode with s_i > s_cap + noise and PCG diverge. Denominator
    # scaling keeps M SPD with cond(M^-1 K) ~ s_max / s_cap.
    s_cap = float(noise) / (16.0 * np.finfo(np.float32).eps)
    denom = np.where(s > s_cap, s * (s_cap + float(noise)) / s_cap, s + float(noise))
    Ej = trace.to_device(torch.from_numpy(E.astype(np.float32)), xp.device, U.dtype, host)
    dj = trace.to_device(torch.from_numpy(denom.astype(np.float32)), xp.device, U.dtype, host)
    trace.end(host)
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
    draws them, so both packages pick the same points. The sketch is of the
    lazy Gramian `gramian(k, x)` returns, or of `Gramian(k, x)` where the
    dispatch finds another structure. Memory is one (n, rank) panel on the
    device of x."""
    G = gramian(k, x)
    if not isinstance(G, Gramian):
        G = Gramian(k, x)
    return nystrom_apply(*nystrom_factors(G, noise, rank, seed, floor_rel), noise)
