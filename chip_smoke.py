"""Smoke run of cfjax_torch's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the checkout (one nvcc per source, in
parallel), checks each kernel against its plain torch version on the
card, then drives the paths a user runs:
  * phases 2-4, the GP on values: `gramian()` -> lazy Gramian MVM (K1,
    K2) -> Cholesky or Nystrom-PCG solve -> posterior mean, at the
    reference README's headline size (MaternP(2), d = 3, n = 16384), in
    the lazy regime (n = 2^17) and through the expansion kernel (d = 64);
  * phases 7-8, the GP on gradient observations: `gramian(GradientKernel)`
    -> gradient-block MVM (K3) -> CG -> posterior mean of the gradients,
    at BASELINE config 4 (EQ, n = 4096, d = 16) and the reference
    README's gradient configuration (MaternP(2), n = d = 1024);
  * phases 10-11, sparsify then solve (reference src/sparse.jl):
    `sparse_gramian` -> TileELL operator (MVM through K4) ->
    `solve(S + noise I)`, which is MINRES, at the reference's sparse
    configuration (EQ, d = 32, n = 16384, scan build) and a spatial sparse
    GP at the tile format's widest m (n = 32768, tree build, nt = 256);
  * phases 12-14, GPs on regular grids: `gramian()` on a UniformGrid /
    LazyGrid placed on the card -> lazy Toeplitz (FFT MVM, Strang-PCG,
    CG, Levinson), circulant (exact spectral solve and logML) and
    Kronecker (mode-product MVM, per-factor Cholesky, exact logML and its
    gradient) operators, at BASELINE config 2 (Exp, n = 65536), a periodic
    kernel at n = 65536 and BASELINE config 3 (separable EQ on 128^3);
    the posterior mean off the grid is a rectangular Gramian through K1;
  * phases 15-16, the lazy log-likelihood and the fit:
    `log_marginal_likelihood` above max_cholesky_size (SLQ logdet through
    the many-column K1, CG quadratic form through K1, the VJP on the plain
    path) with its gradient, at n = 16384 against the float64 dense
    Cholesky logML and at n = 2^17 (phase 3's points), then three
    `fit_kernel` Adam steps at n = 2^17;
  * phases 17-20, the Barnes-Hut treecode and the refinement solvers:
    `BarnesHutFactorization` (host plans, plain-torch MVM; K1 computes
    the exact rows it is held to) at the reference README's n = 65536
    and at BASELINE config 5's n = 10^6, config 5's GP solve at n = 10^6
    (`gp_condition`: K1 + rank-2048 Nystrom PCG, on its own points and on
    cfjax's; `approx_refined_solve` with the treecode inside, K1 outside)
    and `refined_solve` at n = 10^5 (K1 inside, the float64 Gramian
    outside);
  * phase 21, the real-nu Matern kernel through its tabulated families in
    K1 (single- and many-column), K2 and K3 (the K_nu routine of the
    profile interpreter beside each): its profile through K1 at 10^5
    distances for nu from 0.3 to 25, K1 at BASELINE config 1's shape, K2
    at d = 64 and K3 at config 4's shape at each tier, each against a
    float64 reference by the kernels' method and against cfjax's
    quadrature where that is accurate, then three GP solves, each its own
    path: `gp_condition` at n = 2^15, d = 3 (21d, Nystrom PCG through K1's
    family) and d = 64 (21e, through K2's), and on gradient observations
    at n = d = 1024 (21f, CG through K3's jet family);
  * phases 22-23, BASELINE config 5's hyperparameter inference as the
    north-star demo runs it: NUTS and HMC over (log l, log v) on the
    Cholesky logML of a 4096-point subset of n = 2^20 points, then host
    NUTS over the slq logML at n = 2^16 (the demo's knobs; its full
    n = 2^20 waits for a fused VJP: PERF.md);
  * phase 24, the parallel layer (`cfjax_torch.parallel`) on
    torch.distributed: 24a, NCCL at world size 1 in this process
    (`init_distributed`, `default_mesh`): phase 3's solve through
    `ShardedGramian` and `sharded_cg` beside the single-GPU one, and
    `sharded_bh_matvec` on phase 18's n = 10^6 treecode; 24b, four ranks
    spawned on the one card over gloo (NCCL refuses two ranks on one GPU),
    a 2 x 2 mesh: the multi-rank dry run, the 2-D PCG at n = 2^17, a 1-D
    `ShardedGramian` MVM, config 4's gradient CG with the column sum,
    config 3's Kronecker MVM, config 2's Toeplitz with 16 columns and
    Barnes-Hut at n = 10^5, each held to the single-GPU operator; the
    ranks count their K1 and K3 launches, summed here;
  * phase 25, the north-star demo as a user runs it:
    `cfjax_torch.examples.northstar_demo.main(2^20, quick=True)` (BASELINE
    config 5: the exact-subset NUTS chain, rank-1024 Nystrom PCG through
    K1 at n = 2^20, the Barnes-Hut posterior mean and the exact one through
    K1), its stage walls (warm: phases 1-24 ran in this process), K1's
    launches during the PCG, the residual and the mean's miss in float64
    against a tf32 control, and the RMSE;
  * phase 26, BASELINE's two derivative-MVM rows, which no kernel takes:
    the HessianKernel MVM (EQ, n = 128, d = 16) and the composite
    gradient MVM (MaternP(2) + Line(1)^2 + NN(0.1), n = d = 1024, the
    "pair" mode), each built as a user builds it (hyperparameters on the
    host; the gramian moves them to the card once), against float64 and
    its share of the least work (`cfjax_torch.utils.roofline`) from CUDA
    graphs;
  * phase 27, the benchmark entry points (`cfjax_torch/benchmarks/`): the
    headline (`bench_torch.py`), every row of the BASELINE table but the
    heavy ones (`run_baseline`), each valid within its bound and its
    float64 limit, its kernel launched, and the weak-scaling twin at a
    small size (NCCL at world 1, four gloo ranks sharing the card).
Phase 1 holds K1 (its family instances, the real-nu Matern's tabulated
one among them, its many-column instances, whose product runs on the
tensor cores at each matmul tier, and its interpreted one) and K2,
phase 6 K3, phase 9 K4 against their float64 plain versions, and phases
17-20 K1's products at the sizes that path gives it (up to n = 10^6); K2 and K3
at each matmul tier ("highest", "high", "default": their tensor-core
passes) also against their plain version at that tier, on coincident and
near-coincident points. Phase 0 reads the compiler's report (K1's, K2's
and K3's family instances keep no stack frame and spill nothing);
phase 5 times each kernel against its plain version and, for K4, against
one PyTorch call that computes the same product (a CSR SpMV), K2 and K3 at
each tier, and computes each kernel's bound, the least time the card
could take for the same work (each kernel's `work_*` function beside
its wrapper, over the card's peaks in `cfjax_torch.utils.roofline`; the
timers are `cfjax_torch.utils.timing`'s). Phases 7 and 8 run again at the tf32
tiers once the path's launches are counted. One line per phase, then a
JSON line of kernel results, the card's name and power limit, and a last
JSON line
`{"ok": true, "device": {...}}`. Any failed check raises: the script then
exits non-zero and prints no result. It needs a CUDA device and fails at
once without one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch

from cfjax_torch.utils.besselk import matern_nu_ops
from cfjax_torch.utils.roofline import Work, summarize
from cfjax_torch.utils.timing import (call_and_device_ms, event_ms, graph_ms, kernel_times,
                                      sync_time)

K1_BOUND = 1e-5   # relative L2 error of K1 vs its float64 plain version
K2_BOUND = 1e-4   # K2: the expansion cancels (cfjax's interpret tolerance is 2e-4)
K3_BOUND = 1e-4   # K3: float32 jet and Taylor bound (cfjax's interpret tolerance is 3e-4)
# K2 and K3 at each matmul tier (relative L2): (against their plain version
# at the same tier on the card, the tf32 roundings emulated; against
# float64), set from the H100 run in PERF.md: 2-6x above the largest
# sound reading and, at three passes, below the smallest reading of the
# fault control (`check_tiers`). K3's plain version forms s in difference
# form at d <= 16, where the kernel's one pass rounds the expansion: hence
# its looser "default" limit against the plain version.
TIERS = ("highest", "high", "default")
TIER_BOUND = {"K2": ({"highest": 5e-6, "high": 5e-6, "default": 5e-6},
                     {"highest": 5e-6, "high": 5e-6, "default": 1e-3}),
              # the many-column K1's tensor-core product: K1_BOUND at three
              # passes; one pass rounds f and A to tf32 (2^-12 relative each),
              # a row sum without cancellation ~2^-11.5 = 3.5e-4 off float64,
              # and f differs from the plain profile in its last bits, which
              # moves a few of the roundings the plain version emulates
              "K1C": ({"highest": 1e-5, "high": 1e-5, "default": 1e-4},
                      {"highest": 1e-5, "high": 1e-5, "default": 2e-3}),
              "K3": ({"highest": 3e-5, "high": 3e-5, "default": 5e-3},
                     {"highest": 3e-5, "high": 3e-5, "default": 1e-2})}
# the float64 residual of phases 7 and 8's solves at each tier
SOLVE_BOUND = {"highest": 1e-4, "high": 1e-4, "default": 3e-3}
K4_BOUND = {torch.float32: 1e-5, torch.float64: 1e-12}   # K4 vs its float64 plain version
SPARSE_TOL = 1e-6  # the sparsification tolerance of phases 10 and 11
TOEPLITZ_BOUND = 1e-5   # float32 FFT MVMs of phases 12-13 vs float64 (relative L2)
VARIANCE_BOUND = 1e-4   # float32 posterior variance vs float64 (absolute; prior variance 1)
# the SLQ logdet at n = 16384 through the many-column K1 in float32 vs the
# float64 plain path on the same probes (relative): 3x the H100's reading,
# 3.165e-5 (PERF.md)
SLQ_BOUND = 1e-4
# Lanczos steps at which phase 15a holds the slq logML's value to the
# Cholesky one (2%): at cfjax's default 48 the quadrature's bias at n =
# 16384 (kappa ~ 1e5) is 1.8% of the logdet, 3.1% of the logML (PERF.md)
CONVERGED_ITERS = 384
# rows of the many-column K1's product held against its float64 plain
# version in phase 5: all of them at n = 16384, an eighth at n = 2^17; and
# of K1's at n = 10^5 in phase 20
CHECK_ROWS = 16384
# the Barnes-Hut phases (17-20). The reference README's treecode errors at
# n = 65536 (BASELINE.md:29-31): accuracy figures, not times; phase 17
# holds the card's within 2x of each
BH_REF_ERR = {0.5: 1.17e-2, 0.25: 4.29e-3}
# the card's float32 BH MVM against the same plan evaluated in float64 plain
# torch on the card (relative L2): 6.6x the H100's larger reading, 4.543e-8
# at theta 1/2 (PERF.md)
BH_PLAN_BOUND = 3e-7
BH_N6_ERR = 2e-2           # phase 18: error against 16 exact rows at n = 10^6
BH_LINEAR_BOUND = 1e-5     # phase 18: matvec_linear's departure from linearity, float32
RESIDUAL_ROWS = 16384      # phase 19: rows of the float64 residual
NOISE = 1e-2      # the GP's noise variance
Y_NOISE = 0.01    # standard deviation of the noise in the observations y

def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def rel(out, ref):
    return float(torch.linalg.norm(out.double() - ref) / torch.linalg.norm(ref))


def roof(work):
    """(ms, what sets it) of a Work's roofline on this card."""
    return work.roofline_seconds() * 1e3, work.bound()


def cuda_tensor(arr):
    return torch.tensor(arr, dtype=torch.float32, device="cuda")


def phase1_kernels(tk, mvm):
    """Each kernel vs its plain version (float64 from the same f32 inputs).
    K1: every family (Exp is MaternP's p = 0), under lengthscales and a
    constant, through its specialised instance; a sum and MaternP(2) with
    its family cleared through the interpreted instance; d = 5 runs the
    D = 8 instance with zero coordinates. The many-column K1 at every p,
    and at each tier against the plain version at the tier (`check_tiers`,
    the K1C limits); the real-nu Matern family against the kernels' method
    in float64."""
    from cfjax_torch.kernels.profile_spec import to_spec
    from cfjax_torch.ops.tiles import matmul_p

    rng = np.random.default_rng(1)
    k1_profiles = [tk.EQ(), tk.Exp(), tk.MaternP(0), tk.MaternP(1), tk.MaternP(2),
                   tk.MaternP(3), tk.Lengthscale(tk.MaternP(2), 0.5),
                   2.0 * tk.EQ() + 0.5 * tk.MaternP(1), tk.RQ(1.5), tk.Cauchy(),
                   tk.InverseMultiQuadratic(0.7), 3.0 * tk.Lengthscale(tk.EQ(), 0.7)]
    k1_cases = [(k, to_spec(k)[0]) for k in k1_profiles]
    interp = dataclasses.replace(to_spec(tk.MaternP(2))[0], family=0)
    k1_cases.append((tk.MaternP(2), interp))
    # cases, max rel, max abs
    res = {"family": [0, 0.0, 0.0], "interpreted": [0, 0.0, 0.0], "expand": [0, 0.0, 0.0],
           "cols": [0, 0.0, 0.0], "matern": [0, 0.0, 0.0]}
    tiers_c = tier_record()

    def record(kind, out, ref, bound, what):
        r = rel(out, ref)
        check(torch.isfinite(out).all().item(), f"{what}: non-finite output")
        check(r <= bound, f"{what}: relative error {r:.3e} > {bound:.0e}")
        c = res[kind]
        c[0] += 1
        c[1] = max(c[1], r)
        c[2] = max(c[2], float((out.double() - ref).abs().max()))

    for d in (1, 3, 5, 8, 16):
        for n, m in ((5003, 3001), (7, 16384)):
            x = cuda_tensor(rng.standard_normal((n, d)))
            y = cuda_tensor(rng.standard_normal((m, d)))
            a = cuda_tensor(rng.standard_normal(m))
            for k, spec in k1_cases:
                out = mvm.gramian_matvec_direct(k, x, y, a, spec=spec)
                ref = mvm.gramian_matvec_direct_plain(k, x.double(), y.double(), a.double())
                record("family" if spec.family else "interpreted", out, ref, K1_BOUND,
                       f"K1 d={d} {n}x{m} {k!r} family {spec.family}")
    # the many-column K1: every family and the interpreted spec, p columns
    # in one chunk (p <= 16) or more (17, 40), ragged n and m, the first 16
    # rows of y rows of x (s = 0); bit-repeatable
    repeat = 0
    for d in (1, 3, 5, 16):
        for n, m in ((1003, 701), (7, 4099)):
            xs, ys = rng.standard_normal((n, d)), rng.standard_normal((m, d))
            ys[:min(16, n)] = xs[:16]
            x, y = cuda_tensor(xs), cuda_tensor(ys)
            for p in (1, 2, 7, 16, 17, 40):
                A = cuda_tensor(rng.standard_normal((m, p)))
                for k, spec in k1_cases:
                    out = mvm.gramian_matmat_direct(k, x, y, A, spec=spec)
                    ref = mvm.gramian_matmat_direct_plain(k, x.double(), y.double(), A.double())
                    check(tuple(out.shape) == (n, p), f"many-column K1: shape {tuple(out.shape)}")
                    record("cols", out, ref, K1_BOUND,
                           f"many-column K1 d={d} {n}x{m} p={p} {k!r} family {spec.family}")
                    if p == 17 and spec.family:
                        check(torch.equal(out, mvm.gramian_matmat_direct(k, x, y, A, spec=spec)),
                              f"many-column K1 d={d} {n}x{m} {k!r}: two calls differ")
                        repeat += 1
                    if p in (16, 17) and n > 7 and spec.family:
                        check_tiers(tiers_c, "K1C", f"many-column K1 d={d} p={p} {k!r}", ref,
                                    lambda tier: mvm.gramian_matmat_direct(
                                        k, x, y, A, spec=spec, precision=tier),
                                    lambda tier: mvm.gramian_matmat_direct_plain(
                                        k, x, y, A, precision=tier))
    # real-nu Matern through its tabulated family (single- and many-column,
    # each tier) against the kernels' method in float64 (`exact_matern`):
    # cfjax's quadrature, the plain version, is not accurate at small s
    for nu, ls, c in ((2.3, 0.8, 1.0), (0.5, 1.0, 1.0), (10.2, 1.3, 3.0)):
        k = c * tk.Lengthscale(tk.Matern(nu), ls)
        kx = c * tk.Lengthscale(exact_matern(tk, nu), ls)
        for d in (1, 3, 5, 16):
            xs, ys = rng.standard_normal((1003, d)), rng.standard_normal((701, d))
            ys[:16] = xs[:16]
            ys[16:32] = xs[:16] + 1e-3 * rng.standard_normal((16, d))
            x, y = cuda_tensor(xs), cuda_tensor(ys)
            with torch.no_grad():
                K64 = kx.profile_value(torch.cdist(x.double(), y.double(),
                                                   compute_mode="donot_use_mm_for_euclid_dist") ** 2)
            a = cuda_tensor(rng.standard_normal(701))
            record("matern", mvm.gramian_matvec_direct(k, x, y, a), K64 @ a.double(), K1_BOUND,
                   f"K1 Matern({nu}) family d={d}")
            for p in (1, 16, 17):
                A = cuda_tensor(rng.standard_normal((701, p)))
                ref = K64 @ A.double()
                record("matern", mvm.gramian_matmat_direct(k, x, y, A), ref, K1_BOUND,
                       f"many-column K1 Matern({nu}) family d={d} p={p}")
                if p > 1:
                    check_tiers(tiers_c, "K1C", f"many-column K1 Matern({nu}) d={d} p={p}", ref,
                                lambda tier: mvm.gramian_matmat_direct(k, x, y, A, precision=tier),
                                lambda tier: matmul_p(K64.float(), A, tier))
    # points scaled by 1/sqrt(d): distances and inner products O(1), so
    # the profiles neither underflow nor overflow in f32; the first 16 rows
    # of y are rows of x (s = 0) and the next 16 those rows moved by 1e-3
    # (near-coincident); families and the interpreter (a sum)
    iso = [tk.EQ(), tk.MaternP(2), 3.0 * tk.Lengthscale(tk.EQ(), 0.7), tk.RQ(1.5),
           tk.InverseMultiQuadratic(0.7), 2.0 * tk.EQ() + 0.5 * tk.MaternP(1)]
    cases = [(k, "iso", d) for d in (17, 64, 257) for k in iso]
    cases += [(tk.Dot() ** 2, "dot", 64), (tk.ExponentialDot(), "dot", 64)]
    tiers = tier_record()
    for k, mode, d in cases:
        xs = rng.standard_normal((5003, d)) / np.sqrt(d)
        ys = rng.standard_normal((3001, d)) / np.sqrt(d)
        ys[:16] = xs[:16]
        ys[16:32] = xs[:16] + 1e-3 * rng.standard_normal((16, d)) / np.sqrt(d)
        x, y, a = cuda_tensor(xs), cuda_tensor(ys), cuda_tensor(rng.standard_normal(3001))
        out = mvm.gramian_matvec_expand(k, x, y, a, mode)
        ref = mvm.gramian_matvec_expand_plain(k, x.double(), y.double(), a.double(), mode)
        what = f"K2 {mode} d={d} {k!r}"
        record("expand", out, ref, K2_BOUND, what)
        check_tiers(tiers, "K2", what, ref,
                    lambda tier: mvm.gramian_matvec_expand(k, x, y, a, mode, precision=tier),
                    lambda tier: mvm.gramian_matvec_expand_plain(k, x, y, a, mode,
                                                                 precision=tier))
    torch.cuda.synchronize()
    res["tiers"], res["tiers_c"] = tiers, tiers_c
    fam, itp = res["family"], res["interpreted"]
    res["direct"] = [fam[0] + itp[0], max(fam[1], itp[1]), max(fam[2], itp[2])]
    print(f"phase 1 kernels vs plain: K1 family instances {fam[0]} cases (EQ, Exp, MaternP "
          f"0-3, RQ, Cauchy, IMQ, lengthscales, a constant; d in 1, 3, 5, 8, 16) max rel "
          f"{fam[1]:.3e} max abs {fam[2]:.3e}; K1 interpreted {itp[0]} cases max rel "
          f"{itp[1]:.3e} max abs {itp[2]:.3e} (bound {K1_BOUND:.0e}); many-column K1 "
          f"{res['cols'][0]} cases (the same profiles, d in 1, 3, 5, 16, p in 1, 2, 7, 16, 17, "
          f"40, 1003x701 and 7x4099, 16 coincident points) max rel {res['cols'][1]:.3e} max "
          f"abs {res['cols'][2]:.3e} (bound {K1_BOUND:.0e}), {repeat} cases bit-repeatable; "
          f"by tier (p 16, 17) {tier_text(tiers_c, 'K1C')}; the real-nu Matern family (nu 2.3, "
          f"0.5, 10.2 under a lengthscale and a constant; d 1, 3, 5, 16; one column and p 1, "
          f"16, 17; 16 coincident and 16 near-coincident points) against the kernels' method "
          f"in float64: {res['matern'][0]} cases max rel {res['matern'][1]:.3e} max abs "
          f"{res['matern'][2]:.3e} (bound {K1_BOUND:.0e}); "
          f"K2 {res['expand'][0]} cases (6 iso kernels at d 17, 64, 257 and 2 dot at 64, "
          f"16 coincident and 16 near-coincident points each) max rel {res['expand'][1]:.3e} "
          f"(bound {K2_BOUND:.0e}) max abs {res['expand'][2]:.3e}; K2 by tier "
          f"{tier_text(tiers, 'K2')}", flush=True)
    return res


def tier_record():
    """{tier: [cases, max rel vs the plain version at the tier, max rel vs
    float64, min rel of the fault control]}."""
    return {tier: [0, 0.0, 0.0, float("inf")] for tier in TIERS}


def check_tiers(rec, name, what, ref, kern, plain):
    """kern(tier) at each tier against plain(tier) (float32 on the card)
    and ref (float64), within kernel `name`'s TIER_BOUND. The fault
    control: the kernel at the other pass count (one pass where three are
    due, three where one is) against plain(tier); rec keeps its smallest
    reading, which a limit that tells the passes apart stays below."""
    from cfjax_torch.ops.tiles import tier_passes

    outs = {tier: kern(tier) for tier in TIERS}
    for tier, out in outs.items():
        check(torch.isfinite(out).all().item(), f"{what} {tier}: non-finite output")
        r64 = rel(out, ref)
        b_plain, b64 = TIER_BOUND[name][0][tier], TIER_BOUND[name][1][tier]
        check(r64 <= b64, f"{what} {tier}: relative error {r64:.3e} vs float64 > {b64:.0e}")
        same = plain(tier).double()
        rt = rel(out, same)
        check(rt <= b_plain, f"{what} {tier} ({tier_passes(tier)} passes): relative error "
                             f"{rt:.3e} vs the plain version at the tier > {b_plain:.0e}")
        fault = rel(outs["default" if tier_passes(tier) == 3 else "highest"], same)
        c = rec[tier]
        rec[tier] = [c[0] + 1, max(c[1], rt), max(c[2], r64), min(c[3], fault)]


def tier_text(rec, name):
    from cfjax_torch.ops.tiles import tier_passes

    return "; ".join(
        f"{tier} ({tier_passes(tier)} passes) {c[0]} cases, max rel {c[1]:.3e} vs the plain "
        f"version at the tier (bound {TIER_BOUND[name][0][tier]:.0e}; the other pass count "
        f"reads at least {c[3]:.3e}), {c[2]:.3e} vs float64 (bound "
        f"{TIER_BOUND[name][1][tier]:.0e})"
        for tier, c in rec.items())


def residual(Kalpha, alpha, y, noise=NOISE):
    """||(K + noise I) alpha - y|| / ||y|| in float64, given K alpha."""
    alpha, y = alpha.double(), y.double()
    return float(torch.linalg.norm(Kalpha.double() + noise * alpha - y) / torch.linalg.norm(y))


def phase_gp(tk, ops, gp, mvm, n, d, kernel, kind, label, rng, solve_opts, resid_bound):
    """gramian() @ a, gp_condition and post.mean at 4096 test points,
    each checked against the kernel's float64 plain version."""
    x = cuda_tensor(rng.standard_normal((n, d)))
    a = cuda_tensor(rng.standard_normal(n))
    y = torch.sin(x[:, 0]) + Y_NOISE * cuda_tensor(rng.standard_normal(n))
    xt = cuda_tensor(rng.standard_normal((4096, d)))
    name, bound = {"direct": ("K1", K1_BOUND), "expand": ("K2", K2_BOUND)}[kind]
    plain = {"direct": mvm.gramian_matvec_direct_plain,
             "expand": mvm.gramian_matvec_expand_plain}[kind]
    xd = x.double()
    how = ops.explain(kernel, x)
    check(f"cuda kernel {name}" in how, f"{label}: explain() does not report {name}: {how}")
    G = ops.gramian(kernel, x)
    b = G @ a
    check(rel(b[:256], plain(kernel, xd[:256], xd, a.double())) <= bound,
          f"{label}: gramian @ a rows disagree with the plain version")
    before = mvm.LAUNCHES[kind]
    post, wall = sync_time(lambda: gp.gp_condition(kernel, x, y, noise=NOISE, **solve_opts))
    launches = mvm.LAUNCHES[kind] - before
    # the residual recomputed from alpha through the kernel, and through
    # the float64 plain version
    res = residual(G @ post.alpha, post.alpha, y)
    res64 = residual(plain(kernel, xd, xd, post.alpha.double()), post.alpha, y)
    check(max(res, res64) <= resid_bound,
          f"{label}: residual {res:.3e} (kernel) / {res64:.3e} (float64) > {resid_bound:.0e}")
    mean, mean_wall = sync_time(lambda: post.mean(xt))
    check(tuple(mean.shape) == (4096,) and torch.isfinite(mean).all().item(),
          f"{label}: posterior mean is not finite of shape (4096,)")
    mean_err = rel(mean[:64], plain(kernel, xt[:64].double(), xd, post.alpha.double()))
    check(mean_err <= 1e-4, f"{label}: posterior mean rows disagree ({mean_err:.3e})")
    info = post.solve_info
    return dict(residual=res, residual64=res64, mean_err=mean_err, wall_s=wall,
                mean_wall_s=mean_wall, launches=launches,
                cg_iters=None if info is None else info[0], explain=how, x=x, y=y)


def phase_float64_observations(tk, gp, mvm):
    """gp_condition on float32 points with numpy's float64 observations and
    precondition="never" (plain CG: max_cholesky_size lowered to 1024 for
    n = 4096): y takes the points' float32, so every CG iteration runs K1."""
    import cfjax_torch

    rng = np.random.default_rng(2)
    xs = rng.standard_normal((4096, 3))
    x = cuda_tensor(xs)
    y = np.sin(xs[:, 0]) + Y_NOISE * rng.standard_normal(4096)   # float64
    k = tk.MaternP(2)
    cfjax_torch.set_config(max_cholesky_size=1024)
    try:
        before = mvm.LAUNCHES["direct"]
        post = gp.gp_condition(k, x, y, noise=NOISE, precondition="never", tol=1e-5,
                               maxiter=1000)
        launches = mvm.LAUNCHES["direct"] - before
    finally:
        cfjax_torch.set_config(max_cholesky_size=cfjax_torch.config.Config.max_cholesky_size)
    it = post.solve_info[0]
    yt = torch.tensor(y, device="cuda")
    res64 = residual(mvm.gramian_matvec_direct_plain(k, x.double(), x.double(),
                                                     post.alpha.double()), post.alpha, yt)
    check(post.alpha.dtype == torch.float32 and launches >= it and res64 <= 1e-3,
          f"phase 2b: alpha {post.alpha.dtype}, {launches} K1 launches for {it} CG "
          f"iterations, float64 residual {res64:.3e}")
    print(f"phase 2b float32 points, float64 observations, precondition='never' n=4096: "
          f"alpha {post.alpha.dtype}, {it} CG iterations, {launches} K1 launches, float64 "
          f"residual {res64:.3e} (bound 1e-3)", flush=True)
    return dict(iters=it, launches=launches, residual64=res64)


def phase6_grad_kernel(tk, gmvm):
    """K3 vs its float64 plain version, with copies of rows of x in y so
    that s = 0 occurs exactly, and rows moved by 1e-3 (near-coincident:
    the kernel's exact path); at each tier against the plain version at
    the tier. Returns [cases, max rel, max abs error, max |reference|,
    tier record]."""
    rng = np.random.default_rng(6)
    kernels = [(tk.EQ(), "iso"), (tk.MaternP(2), "iso"), (tk.MaternP(3), "iso"),
               (tk.Lengthscale(tk.MaternP(2), 0.5), "iso"),
               (2.0 * tk.EQ() + 0.5 * tk.MaternP(2), "iso"), (tk.RQ(1.5), "iso"),
               (tk.Dot() ** 2, "dot"), (tk.ExponentialDot(), "dot")]
    res = [0, 0.0, 0.0, 0.0]
    tiers = tier_record()
    for d in (1, 3, 16, 64, 257, 1024):
        for n, m in ((1003, 601), (7, 4096)):
            # points scaled by 1/sqrt(d): distances and inner products O(1),
            # so the off-diagonal blocks neither underflow nor overflow
            xs = rng.standard_normal((n, d)) / np.sqrt(d)
            ys = rng.standard_normal((m, d)) / np.sqrt(d)
            c = min(16, n)
            ys[:c] = xs[:c]   # coincident, then near-coincident (moved by 1e-3)
            ys[c:2 * c] = xs[:c] + 1e-3 * rng.standard_normal((c, d)) / np.sqrt(d)
            x, y, A = cuda_tensor(xs), cuda_tensor(ys), cuda_tensor(rng.standard_normal((m, d)))
            for k, mode in kernels:
                out = gmvm.grad_matvec(k, x, y, A, mode)
                ref = gmvm.grad_matvec_plain(k, x.double(), y.double(), A.double(), mode)
                r = rel(out, ref)
                what = f"K3 {mode} d={d} {n}x{m} {k!r}"
                check(torch.isfinite(out).all().item(), f"{what}: non-finite output")
                check(r <= K3_BOUND, f"{what}: relative error {r:.3e} > {K3_BOUND:.0e}")
                res = [res[0] + 1, max(res[1], r),
                       max(res[2], float((out.double() - ref).abs().max())),
                       max(res[3], float(ref.abs().max()))]
                check_tiers(tiers, "K3", what, ref,
                            lambda tier: gmvm.grad_matvec(k, x, y, A, mode, precision=tier),
                            lambda tier: gmvm.grad_matvec_plain(k, x, y, A, mode,
                                                                precision=tier))
    torch.cuda.synchronize()
    print(f"phase 6 K3 vs float64 plain: {res[0]} cases (8 kernels, d in 1..1024, "
          f"1003x601 and 7x4096, up to 16 coincident and 16 near-coincident points each) max "
          f"rel {res[1]:.3e} (bound {K3_BOUND:.0e}) max abs {res[2]:.3e} (largest |entry| "
          f"{res[3]:.3e}); K3 by tier {tier_text(tiers, 'K3')}", flush=True)
    res.append(tiers)
    return res


def phase7_gradient_gp(tk, ops, gp, mvm, gmvm):
    """BASELINE config 4: a GP on gradient observations, EQ, n = 4096,
    d = 16 — CG on 65,536 unknowns through K3, then the posterior mean of
    the gradients at 1024 test points (a rectangular K3 MVM)."""
    from cfjax_torch.derivative import GradientKernel

    rng = np.random.default_rng(7)
    n, d = 4096, 16
    k = tk.EQ()
    x = cuda_tensor(0.5 * rng.standard_normal((n, d)))
    Y = torch.cos(x) + 0.01 * cuda_tensor(rng.standard_normal((n, d)))  # grad of sum(sin)
    y = Y.reshape(-1)
    xt = cuda_tensor(0.5 * rng.standard_normal((1024, d)))
    kernel = GradientKernel(k)
    how = ops.explain(kernel, x)
    check("cuda kernel K3" in how, f"phase 7: explain() does not report K3: {how}")
    G = ops.gramian(kernel, x)
    a = cuda_tensor(rng.standard_normal(n * d))
    Ga = G @ a
    share = float(torch.linalg.norm(Ga - a) / torch.linalg.norm(Ga))  # -2 f'(0) = 1 for EQ
    before = mvm.LAUNCHES["grad"]
    post, wall = sync_time(lambda: gp.gp_condition(kernel, x, y, noise=NOISE, tol=1e-5,
                                                   maxiter=1000))
    launches = mvm.LAUNCHES["grad"] - before
    it, res_norm = post.solve_info
    check(it < 1000, f"phase 7: CG did not converge in 1000 iterations (residual {float(res_norm):.3e})")
    alpha = post.alpha
    res = residual(G @ alpha, alpha, y, NOISE)
    xd = x.double()
    plain = gmvm.grad_matvec_plain(k, xd, xd, alpha.double().reshape(n, d)).reshape(-1)
    res64 = residual(plain, alpha, y, NOISE)
    check(max(res, res64) <= 1e-4,
          f"phase 7: residual {res:.3e} (K3) / {res64:.3e} (float64) > 1e-4")
    mean, mean_wall = sync_time(lambda: post.mean(xt))
    check(tuple(mean.shape) == (1024 * d,) and torch.isfinite(mean).all().item(),
          f"phase 7: posterior mean is not finite of shape ({1024 * d},)")
    ref = gmvm.grad_matvec_plain(k, xt[:64].double(), xd, alpha.double().reshape(n, d))
    mean_err = rel(mean[:64 * d], ref.reshape(-1))
    check(mean_err <= 1e-4, f"phase 7: posterior mean rows disagree ({mean_err:.3e})")

    def solve(tier):
        post, wall = sync_time(lambda: gp.gp_condition(kernel, x, y, noise=NOISE, tol=1e-5,
                                                       maxiter=1000))
        plain = gmvm.grad_matvec_plain(k, xd, xd, post.alpha.double().reshape(n, d))
        return post.solve_info[0], residual(G @ post.alpha, post.alpha, y, NOISE), \
            residual(plain.reshape(-1), post.alpha, y, NOISE), wall

    print(f"phase 7 gradient GP (BASELINE config 4) EQ n=4096 d=16, 65536 unknowns: "
          f"{it} CG iterations (tol 1e-5), residual {res:.3e} (K3) / {res64:.3e} float64 "
          f"(bound 1e-4), K3 launches {launches}, gp_condition {wall:.3f} s, mean(1024) "
          f"{mean_wall:.4f} s, mean rows rel {mean_err:.3e}, off-diagonal share "
          f"||G a - a|| / ||G a|| = {share:.3f} | {how}", flush=True)
    return dict(cg_iters=it, launches=launches, residual=res, residual64=res64,
                wall_s=wall, mean_err=mean_err, share=share, solve=solve, x=x, y=y)


def at_tiers(label, solve):
    """The solve at the tf32 tiers, after the path's launches are counted:
    "CG iterations, residual (K3) / float64, wall" of each, the float64
    residual within SOLVE_BOUND."""
    import cfjax_torch
    from cfjax_torch.ops.tiles import tier_passes

    parts = []
    for tier in ("high", "default"):
        cfjax_torch.set_config(matmul_precision=tier)
        try:
            it, res, res64, wall = solve(tier)
        finally:
            cfjax_torch.set_config(matmul_precision="highest")
        check(np.isfinite(res64) and res64 <= SOLVE_BOUND[tier],
              f"{label} at {tier!r}: float64 residual {res64:.3e} > {SOLVE_BOUND[tier]:.0e}")
        parts.append(f"at {tier!r} ({tier_passes(tier)} tf32 passes): {it} iterations, "
                     f"residual {res:.3e} (K3) / {res64:.3e} float64 (bound "
                     f"{SOLVE_BOUND[tier]:.0e}), {wall:.3f} s")
    return "; ".join(parts)


def phase8_readme_gradient(tk, ops, gmvm):
    """The reference README's gradient configuration: GradientKernel(MaternP(2)),
    n = d = 1024, x standard normal — a 10^6 x 10^6 operator."""
    from cfjax_torch.derivative import GradientKernel
    from cfjax_torch.kernels.profile_spec import to_spec

    rng = np.random.default_rng(8)
    n = d = 1024
    k = tk.MaternP(2)
    x = cuda_tensor(rng.standard_normal((n, d)))
    v = cuda_tensor(rng.standard_normal(n * d))
    G = ops.gramian(GradientKernel(k), x)
    check("cuda kernel K3" in ops.explain(GradientKernel(k), x), "phase 8: K3 not selected")
    b, mvm_wall = sync_time(lambda: G @ v)
    xd = x.double()
    ref = gmvm.grad_matvec_plain(k, xd[:64], xd, v.double().reshape(n, d)).reshape(-1)
    row_err = rel(b[:64 * d], ref)
    check(row_err <= K3_BOUND, f"phase 8: G @ v rows disagree ({row_err:.3e})")
    op = G.add_diagonal(1e-3)
    xs, wall = sync_time(lambda: ops.solve(op, v, tol=1e-6, maxiter=200))
    res = residual(G @ xs, xs, v, 1e-3)
    plain = gmvm.grad_matvec_plain(k, xd, xd, xs.double().reshape(n, d)).reshape(-1)
    res64 = residual(plain, xs, v, 1e-3)
    check(max(res, res64) <= 1e-4, f"phase 8: residual {res:.3e} / {res64:.3e} > 1e-4")

    def solve(tier):
        (z, info), wall = sync_time(lambda: ops.solve_with_info(op, v, tol=1e-6, maxiter=200))
        plain = gmvm.grad_matvec_plain(k, xd, xd, z.double().reshape(n, d)).reshape(-1)
        return info[0], residual(G @ z, z, v, 1e-3), residual(plain, z, v, 1e-3), wall

    # at this draw s = |x_i - x_j|^2 ~ 2 d: f'(s) of MaternP(2) falls out of
    # the float32 range off the diagonal, so G is -2 f'(0) I = 5/3 I in float32
    D2 = torch.cdist(x, x) ** 2
    D2.fill_diagonal_(float("inf"))
    f1 = to_spec(k, derivative=True)[0].evaluate_jet(D2)[1]
    off = ~torch.eye(n, dtype=torch.bool, device=x.device)
    zero_share = float((f1[off] == 0).double().mean())
    f1_max = float(f1[off].abs().max())
    share = float(torch.linalg.norm(b - (5.0 / 3.0) * v) / torch.linalg.norm(b))
    state = "vanish" if share == 0 else "do not vanish"
    print(f"phase 8 README gradient config MaternP(2) n=d=1024 (10^6 x 10^6 operator): "
          f"G @ v {mvm_wall * 1e3:.3f} ms, rows rel {row_err:.3e}; solve(G + 1e-3 I) tol 1e-6 "
          f"{wall:.3f} s, residual {res:.3e} (K3) / {res64:.3e} float64 (bound 1e-4); at this "
          f"draw the off-diagonal blocks {state} in float32: f'(s) underflows to 0 for "
          f"{100 * zero_share:.2f}% of the pairs and at most {f1_max:.3e} (smallest normal "
          f"{torch.finfo(torch.float32).tiny:.3e}, min off-diagonal s = {float(D2.min()):.1f}), "
          f"off-diagonal share ||G v - 5/3 v|| / ||G v|| = {share:.3e}", flush=True)
    return dict(residual=res, residual64=res64, wall_s=wall, row_err=row_err, solve=solve)


def phase9_rows_kernel(tmvm, res, S, a, what):
    """K4 over S's row slices against the float64 slab product of S's
    groups, in float32 and in the float64 instance (the same nonzeros);
    res[dtype] = [cases, max rel, max abs]."""
    ref = slab_plain64(S, tmvm, a)
    for dtype, bound in K4_BOUND.items():
        rs = S.rows._replace(val=S.rows.val.to(dtype))
        out = tmvm.rows_matvec(rs, a.to(dtype))
        r = rel(out, ref)
        check(torch.isfinite(out).all().item(), f"K4 {what} {dtype}: non-finite output")
        check(r <= bound, f"K4 {what} {dtype}: relative error {r:.3e} > {bound:.0e}")
        c = res[dtype]
        res[dtype] = [c[0] + 1, max(c[1], r), max(c[2], float((out.double() - ref).abs().max()))]


def phase9_synthetic(tmvm, t_tile):
    """K4 on synthetic TileELL groups as operators (rows in slab order):
    K in {1, 2, 8, 32, 128}, nt in {1, 2, 128, 256}, B in {8, 136}, offsets
    over the whole lane range, ~70% zero values; groups above 2^28 slots
    are left out (memory of the float64 reference)."""
    g = torch.Generator(device="cuda").manual_seed(9)
    res = {dtype: [0, 0.0, 0.0] for dtype in K4_BOUND}
    skipped = 0
    for K in (1, 2, 8, 32, 128):
        for nt in (1, 2, 128, 256):
            for B in (8, 136):
                shape = (B, K, nt, 128)
                if B * K * nt * 128 > 1 << 28:
                    skipped += 1
                    continue
                a = torch.randn(nt * 128, generator=g, device="cuda")
                off = torch.randint(0, 128, shape, generator=g, device="cuda", dtype=torch.int32)
                val = torch.randn(shape, generator=g, device="cuda")
                val *= torch.rand(shape, generator=g, device="cuda") < 0.3
                S = t_tile.TileEllOperator([(0, B * 128, off, val)],
                                           torch.arange(B * 128, device="cuda"), B * 128,
                                           nt * 128, int(torch.count_nonzero(val)))
                phase9_rows_kernel(tmvm, res, S, a, f"B={B} K={K} nt={nt}")
                del a, off, val, S
    torch.cuda.synchronize()
    return res, skipped


def slab_plain64(S, tmvm, v):
    """S @ v through the float64 plain slab version (the reference for the
    residuals of phases 10 and 11): the same groups, perm and crops as
    `tile_ell_matvec`."""
    n, m = S.shape
    a2 = torch.nn.functional.pad(v.double(), (0, S.nt * 128 - m)).reshape(S.nt, 128)
    outs = [tmvm.slab_matvec_plain(a2, off[:(r1 - r0) // 128], val[:(r1 - r0) // 128].double())
            .reshape(-1) for r0, r1, off, val in S.groups]
    out = torch.zeros(S.perm.shape[0], dtype=torch.float64, device=v.device)
    out[S.perm] = torch.cat(outs)[:S.perm.shape[0]]
    return out[:n]


def slab_stats(S):
    """(groups as (K, B real, B allocated), allocated off+val bytes, slots
    over the real row blocks)."""
    groups = [(off.shape[1], (r1 - r0) // 128, off.shape[0]) for r0, r1, off, val in S.groups]
    nbytes = sum(off.numel() * 4 + val.numel() * val.element_size()
                 for _, _, off, val in S.groups)
    slots = sum(K * b * S.nt * 128 for K, b, _ in groups)
    return groups, nbytes, slots


def slice_warps(rs, tmvm):
    """K4's warps per slice at these row slices on this card."""
    return tmvm.slice_warps(rs.ptr.shape[0] - 1,
                            torch.cuda.get_device_properties(0).multi_processor_count)


def rows_stats(S, t_tile, tmvm):
    """The row-slice layout K4 reads: (slots, col+val bytes, warps per
    slice, seconds to build it again from the groups on the card)."""
    rs, build_s = sync_time(lambda: t_tile.row_slices(S.groups, S.perm, *S.shape, S.dtype))
    check(torch.equal(rs.col, S.rows.col) and torch.equal(rs.val, S.rows.val),
          "the row slices built again differ from the operator's")
    slots = int(rs.ptr[-1])
    return slots, slots * (4 + rs.val.element_size()), slice_warps(rs, tmvm), build_s


def sparse_launches(it, launches, label):
    """MINRES makes one MVM for its first residual and one per iteration."""
    check(launches == it + 1, f"{label}: {launches} K4 launches for {it} MINRES iterations "
                              f"(one per iteration and one for the first residual)")


def sparse_solve(ops, mvm, S, b, label):
    """MINRES on (S + noise I) alpha = b, tol 1e-5, through `solve`; the K4
    launches it made."""
    op = S.add_diagonal(NOISE)
    before = mvm.LAUNCHES["tile_ell"]
    (alpha, info), wall = sync_time(lambda: ops.solve_with_info(op, b, tol=1e-5, maxiter=1000))
    launches = mvm.LAUNCHES["tile_ell"] - before
    it = info[0]
    check(it < 1000, f"{label}: MINRES did not converge in 1000 iterations "
                     f"(residual {float(info[1]):.3e})")
    sparse_launches(it, launches, label)
    return alpha, it, wall, launches


def phase10_reference_sparse(tk, ops, so, tmvm, mvm, t_tile):
    """The reference's sparse configuration (benchmarks/run_baseline.py
    bench_sparse): sparse_gramian(EQ(), x, tol=1e-6), x ~ N(0, I), n = 16384,
    d = 32, float32 — the scan build."""
    from cfjax_torch.ops.tiles import sqdist_tile

    rng = np.random.default_rng(10)
    n, d = 16384, 32
    k = tk.EQ()
    x = cuda_tensor(rng.standard_normal((n, d)))
    (S, ratio), build_s = sync_time(lambda: so.sparse_gramian(k, x, tol=SPARSE_TOL))
    check(type(S).__name__ == "TileEllOperator", f"phase 10: got {type(S).__name__}")
    groups, nbytes, slots = slab_stats(S)
    rslots, rbytes, warps, rows_s = rows_stats(S, t_tile, tmvm)
    # S @ a rows against the float64 dense rows, entries outside the decay
    # radius dropped
    r2 = so.decay_radius(k, SPARSE_TOL) ** 2
    a = cuda_tensor(rng.standard_normal(n))
    xd = x.double()
    D = sqdist_tile(xd[:256], xd, direct_max_d=d)
    ref = torch.where(D <= r2, k.profile_value(D), 0.0) @ a.double()
    row_err = rel((S @ a)[:256], ref)
    check(row_err <= 1e-5, f"phase 10: S @ a rows disagree with the dense rows ({row_err:.3e})")
    b = torch.sin(x[:, 0]) + Y_NOISE * cuda_tensor(rng.standard_normal(n))
    alpha, it, wall, launches = sparse_solve(ops, mvm, S, b, "phase 10")
    res = residual(S @ alpha, alpha, b)
    res64 = residual(slab_plain64(S, tmvm, alpha), alpha, b)
    check(max(res, res64) <= 1e-4, f"phase 10: residual {res:.3e} / {res64:.3e} > 1e-4")
    print(f"phase 10 reference sparse config EQ d=32 n=16384 tol 1e-6 (scan build): build "
          f"{build_s:.3f} s, nnz {S.nnz} ratio {ratio:.6f}, nt {S.nt}, groups (K, B, B "
          f"allocated) {groups}, slabs {nbytes / 1e6:.1f} MB allocated, {slots / S.nnz:.1f} "
          f"slots per nonzero; row slices (what K4 reads) {rslots / S.nnz:.4f} slots per "
          f"nonzero, {rbytes / 1e6:.2f} MB, {warps} warp(s) per slice, built from the groups "
          f"in {rows_s:.4f} s; S @ a rows rel {row_err:.3e}; solve(S + 1e-2 I) MINRES {it} "
          f"iterations {wall:.4f} s, {launches} K4 launches, residual {res:.3e} (K4) / "
          f"{res64:.3e} float64 (bound 1e-4)", flush=True)
    return dict(S=S, iters=it, wall_s=wall, residual=res, residual64=res64, build_s=build_s,
                launches=launches)


def phase11_spatial_sparse(tk, ops, so, tmvm, mvm, t_tile):
    """A spatial sparse GP at the tile format's widest m: Lengthscale(EQ,
    0.2), x uniform in [0, 20]^2, n = 32768, tol 1e-6, the tree build
    (nt = 256), MINRES on (S + 1e-2 I) alpha = sin(x0) + 0.01 eps."""
    rng = np.random.default_rng(11)
    n = 32768
    k = tk.Lengthscale(tk.EQ(), 0.2)
    x = cuda_tensor(rng.uniform(0, 20, (n, 2)))
    (S, ratio), build_s = sync_time(lambda: so.sparse_gramian(k, x, tol=SPARSE_TOL,
                                                              method="tree"))
    check(type(S).__name__ == "TileEllOperator" and S.nt == 256,
          f"phase 11: got {type(S).__name__} with nt {getattr(S, 'nt', None)}")
    groups, nbytes, slots = slab_stats(S)
    rslots, rbytes, warps, rows_s = rows_stats(S, t_tile, tmvm)
    check(rslots <= 1.15 * S.nnz, f"phase 11: the row slices hold {rslots / S.nnz:.3f} slots "
                                  f"per nonzero, more than 1.15")
    b = torch.sin(x[:, 0]) + Y_NOISE * cuda_tensor(rng.standard_normal(n))
    alpha, it, wall, launches = sparse_solve(ops, mvm, S, b, "phase 11")
    res = residual(S @ alpha, alpha, b)
    res64 = residual(slab_plain64(S, tmvm, alpha), alpha, b)
    check(max(res, res64) <= 1e-4, f"phase 11: residual {res:.3e} / {res64:.3e} > 1e-4")
    (SL, ratio_l), lazy_s = sync_time(lambda: so.sparse_gramian(k, x, tol=SPARSE_TOL,
                                                                format="lazy"))
    check(type(SL).__name__ == "TreeSparseOperator" and SL.nnz == S.nnz,
          f"phase 11: format='lazy' gave {type(SL).__name__} with nnz {SL.nnz} != {S.nnz}")
    a = cuda_tensor(rng.standard_normal(n))
    lazy_err = rel(SL @ a, (S @ a).double())
    check(lazy_err <= 1e-5, f"phase 11: S_lazy @ a disagrees with S @ a ({lazy_err:.3e})")
    print(f"phase 11 spatial sparse GP Lengthscale(EQ, 0.2) [0,20]^2 n=32768 tol 1e-6 (tree "
          f"build): build {build_s:.3f} s, nnz {S.nnz} ({S.nnz / n:.1f} per row) ratio "
          f"{ratio:.6f}, nt {S.nt}, groups (K, B, B allocated) {groups}, slabs "
          f"{nbytes / 1e6:.1f} MB allocated, {slots / S.nnz:.1f} slots per nonzero; row slices "
          f"(what K4 reads) {rslots / S.nnz:.4f} slots per nonzero, {rbytes / 1e6:.2f} MB, "
          f"{warps} warp(s) per slice, built from the groups in {rows_s:.4f} s; MINRES {it} "
          f"iterations (tol 1e-5) {wall:.4f} s, {launches} K4 launches, residual {res:.3e} (K4) "
          f"/ {res64:.3e} float64 (bound 1e-4); lazy TreeSparseOperator build {lazy_s:.3f} s, "
          f"rel to S @ a {lazy_err:.3e}", flush=True)
    return dict(S=S, iters=it, wall_s=wall, launches=launches, residual=res, residual64=res64,
                build_s=build_s, nbytes=nbytes)


def csr_of(S):
    """S's nonzeros as a torch CSR tensor with int32 indices, read from its
    row slices: the yardstick of one PyTorch call (cuSPARSE SpMV) that
    computes K4's product. The port never builds it."""
    rs = S.rows
    n, m = S.shape
    width = torch.diff(rs.ptr) // 32
    pos = torch.arange(rs.col.numel(), device="cuda")
    lrow = torch.repeat_interleave(torch.arange(width.numel(), device="cuda") * 32, width * 32) \
        + (pos - torch.repeat_interleave(rs.ptr[:-1], width * 32)) % 32
    live = rs.val != 0
    row, col, val = rs.out_row.long()[lrow[live]], rs.col[live].long(), rs.val[live]
    order = torch.argsort(row * m + col)
    row, col, val = row[order], col[order], val[order]
    crow = torch.zeros(n + 1, dtype=torch.long, device="cuda")
    crow[1:] = torch.cumsum(torch.bincount(row, minlength=n), 0)
    return torch.sparse_csr_tensor(crow.int(), col.int(), val, size=(n, m),
                                   check_invariants=False)


def k4_times(S, S10, tmvm):
    """K4 at S's operator against its plain version and a CSR SpMV over the
    same nonzeros (`kernel_times`; the CSR call timed the same way, a call
    and device); then each warps-per-slice count at S's and S10's
    operators, device times in turns. The bound: nnz (4-byte column,
    4-byte value) + a + out, over the HBM rate."""
    rng = np.random.default_rng(12)
    n, m = S.shape
    a = cuda_tensor(rng.standard_normal(m))
    rs = S.rows
    csr = csr_of(S)
    kern = lambda: tmvm.rows_matvec(rs, a)
    lib = lambda: torch.mv(csr, a)
    lib_err = rel(kern(), lib().double())
    check(lib_err <= 1e-5, f"K4 and the CSR SpMV disagree ({lib_err:.3e})")
    call_ms, ms, plain_ms = kernel_times(kern, lambda: tmvm.rows_matvec_plain(rs, a))
    lib_call, lib_dev = [], []
    for key in ("call", "graph", "graph", "call"):
        (lib_call if key == "call" else lib_dev).extend(
            event_ms(lib, 10) if key == "call" else graph_ms(lib))
    a10 = cuda_tensor(rng.standard_normal(S10.shape[1]))
    sweep = {}
    for label, op, v in (("phase 11", S, a), ("phase 10", S10, a10)):
        warps = {w: [] for w in (1, 2, 4, 8)}
        for w in (1, 2, 4, 8, 8, 4, 2, 1):
            warps[w] += graph_ms(lambda: tmvm.rows_matvec(op.rows, v, warps=w))
        sweep[label] = (slice_warps(op.rows, tmvm), op.rows.ptr.shape[0] - 1,
                        {w: float(np.median(t)) for w, t in warps.items()})
    bound_bytes = tmvm.work_rows(S.nnz, n, m).hbm_bytes
    layout_bytes = int(rs.ptr[-1]) * (4 + rs.val.element_size())
    return dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                library_call_ms=float(np.median(lib_call)),
                library_ms=float(np.median(lib_dev)), bound_bytes=bound_bytes,
                bound_ms=roof(tmvm.work_rows(S.nnz, n, m))[0], layout_bytes=layout_bytes,
                lib_err=lib_err, sweep=sweep)


def ptxas_k1_family(build, kernel, count):
    """K1's family instances of `kernel` ("k1_family", "k1_matmat_family")
    in the compiler's report beside the K1/K2 library: (instances, largest
    stack frame, spill bytes, registers)."""
    log = build.library_path("gramian_mvm").with_suffix(".log").read_text()
    props = re.findall(rf"Function properties for (\S*{kernel}I\S*)\s*\n\s*(\d+) bytes stack "
                       r"frame, (\d+) bytes spill stores, (\d+) bytes spill loads", log)
    regs = [int(r) for name, r in re.findall(
        rf"Compiling entry function '(\S*{kernel}I\S*)'[^\n]*\n(?:[^\n]*\n)*?"
        r"[^\n]*Used (\d+) registers", log)]
    check(len(props) == count, f"ptxas reports {len(props)} {kernel} instances, not {count}")
    stack = max(int(p[1]) for p in props)
    spill = max(int(p[2]) + int(p[3]) for p in props)
    check(stack == 0 and spill == 0, f"{kernel} instances keep a stack frame of up to "
                                     f"{stack} bytes and spill {spill} bytes: "
                                     f"{[p for p in props if int(p[1]) or int(p[2])]}")
    return len(props), stack, spill, (min(regs), max(regs)) if regs else None


def near_pairs(x, y, tau):
    """Pairs with s <= tau (|x|^2 + |y|^2), K3's near-coincident test (s in
    float64 here), counted in row blocks."""
    x, y = x.double(), y.double()
    y2 = torch.sum(y * y, 1)
    total = 0
    for i in range(0, x.shape[0], 1024):
        xb = x[i:i + 1024]
        q = torch.sum(xb * xb, 1)[:, None] + y2[None, :]
        total += int((torch.cdist(xb, y) ** 2 <= tau * q).sum())
    return total


def ptxas_tc(build, lib, kernel, count):
    """The tensor-core kernel's instances (template <ISO, FAM, P, PASSES>) in
    the compiler's report beside its library: the family instances keep no
    stack frame and spill nothing; the interpreted ones (FAM 0) spill
    nothing and keep only the interpreter's stack. Returns (instances,
    registers (min, max), the interpreted instances' stack bytes)."""
    log = build.library_path(lib).with_suffix(".log").read_text()
    ents = re.findall(rf"Compiling entry function '(\S*{kernel}ILb[01]ELi(\d+)ELi\d+ELi\d+E\S*)'"
                      r"[^\n]*\n(?:[^\n]*\n)*?\s*(\d+) bytes stack frame, (\d+) bytes spill "
                      r"stores, (\d+) bytes spill loads\n[^\n]*Used (\d+) registers", log)
    check(len(ents) == count, f"ptxas reports {len(ents)} {kernel} instances, not {count}")
    bad = [e[0] for e in ents if int(e[3]) or int(e[4]) or (int(e[1]) and int(e[2]))]
    check(not bad, f"{kernel} instances spill or keep a stack frame: {bad}")
    regs = [int(e[5]) for e in ents]
    return len(ents), (min(regs), max(regs)), sorted({int(e[2]) for e in ents if not int(e[1])})


def rows64(k, x, y, a):
    """(K a)[i] for the rows x of a 1-D grid Gramian, summed directly in
    float64 through K1's plain version (the reference of the FFT MVMs)."""
    from cfjax_torch.ops import gramian_mvm as mvm

    return mvm.gramian_matvec_direct_plain(k, x.double()[:, None], y.double()[:, None],
                                           a.double())


def phase12_toeplitz(tk, ops, gp, mvm):
    """BASELINE config 2 (cfjax's bench_toeplitz, uncut): Exp() on a uniform
    grid of n = 65536 points over [0, 1), float32 on the card. FFT MVM,
    Strang-PCG, gp_condition (plain CG on Toeplitz + noise), posterior
    mean off the grid (K1) and variance, Levinson at n = 16384, and a
    non-symmetric grid Gramian."""
    from cfjax_torch.utils.grids import UniformGrid

    rng = np.random.default_rng(12)
    n = 65536
    k = tk.Exp()
    g = UniformGrid(0.0, 1.0 / n, n, device="cuda", dtype=torch.float32)
    g64 = UniformGrid(0.0, 1.0 / n, n, device="cuda", dtype=torch.float64)
    T, build_s = sync_time(lambda: ops.gramian(k, g))
    check(type(T).__name__ == "ToeplitzOperator" and callable(T._col_src),
          f"phase 12: gramian gave {type(T).__name__}, or evaluated its column at construction")
    x = g.points()
    a = cuda_tensor(rng.standard_normal(n))
    b = T @ a
    check(T.col.is_cuda and T.col.dtype == torch.float32 and b.dtype == torch.float32,
          "phase 12: the lazy column or the MVM left the card's float32")
    idx = torch.tensor(np.sort(rng.choice(n, 256, replace=False)), device="cuda")
    mvm_err = rel(b[idx], rows64(k, x[idx], x, a))
    check(mvm_err <= TOEPLITZ_BOUND, f"phase 12: FFT MVM rows rel {mvm_err:.3e}")
    mvm_ms = float(np.median(event_ms(lambda: T @ a, 20)))
    T64 = ops.gramian(k, g64)

    def resid64(v, rhs):
        return residual(T64 @ v.double(), v, rhs)

    Tn = T.add_diagonal(NOISE)
    bn = Tn @ a
    (xs, (pcg_it, _)), pcg_s = sync_time(lambda: ops.cg(Tn._matvec, bn, tol=1e-5, maxiter=600,
                                                        M=T.strang_preconditioner()))
    pcg_res = resid64(xs, bn)
    check(pcg_it < 600 and pcg_res <= 1e-4,
          f"phase 12: Strang-PCG {pcg_it} iterations, float64 residual {pcg_res:.3e}")

    y = torch.sin(6 * np.pi * x) + Y_NOISE * cuda_tensor(rng.standard_normal(n))
    post, cond_s = sync_time(lambda: gp.gp_condition(k, g, y, noise=NOISE, tol=1e-5,
                                                     maxiter=2000))
    cg_it = post.solve_info[0]
    cond_res = resid64(post.alpha, y)
    check(cg_it < 2000 and cond_res <= 1e-4,
          f"phase 12: gp_condition CG {cg_it} iterations, float64 residual {cond_res:.3e}")
    xt = cuda_tensor(rng.uniform(0, 1, 4096))
    before = mvm.LAUNCHES["direct"]
    mean, mean_s = sync_time(lambda: post.mean(xt))
    mean_launches = mvm.LAUNCHES["direct"] - before
    check(mean_launches == 1, f"phase 12: post.mean launched K1 {mean_launches} times, not once")
    mean_err = rel(mean[:64], rows64(k, xt[:64], x, post.alpha))
    check(tuple(mean.shape) == (4096,) and mean_err <= 1e-4,
          f"phase 12: posterior mean rows rel {mean_err:.3e}")
    var, var_s = sync_time(lambda: post.variance(xt[:64], tol=1e-6, maxiter=2000))
    post64 = gp.GPPosterior(k, g64, post.alpha.double(), NOISE)
    var64 = post64.variance(xt[:64].double(), tol=1e-10, maxiter=5000)
    var_err = float((var.double() - var64).abs().max())
    check(bool((var64 > 0).all()) and var_err <= VARIANCE_BOUND,
          f"phase 12: variance max abs error {var_err:.3e} (float64 range "
          f"[{float(var64.min()):.3e}, {float(var64.max()):.3e}])")

    # Levinson at n = 16384 (cfjax's toeplitz_levinson_n16384), float64,
    # on T + noise I
    n2 = 16384
    T2 = ops.gramian(k, UniformGrid(0.0, 1.0 / n2, n2, device="cuda", dtype=torch.float64))
    col = T2.col.clone()
    col[0] += NOISE
    T2n = ops.ToeplitzOperator(col)
    b2 = T2n @ torch.tensor(rng.standard_normal(n2), device="cuda")
    lev, lev_s = sync_time(lambda: ops.levinson(col, b2))
    lev_res = float(torch.linalg.norm(T2n @ lev - b2) / torch.linalg.norm(b2))
    check(lev_res <= 1e-8, f"phase 12: levinson float64 residual {lev_res:.3e}")
    lev_ms = event_ms(lambda: ops.levinson(col, b2), 1)[0]

    # a non-symmetric grid Gramian: y = x + h/2
    gy = UniformGrid(0.5 / n, 1.0 / n, n, device="cuda", dtype=torch.float32)
    Tns = ops.gramian(k, g, gy)
    check(type(Tns).__name__ == "ToeplitzOperator" and not Tns.is_symmetric,
          f"phase 12: gramian(Exp, gx, gy) gave {type(Tns).__name__}")
    ns_err = rel((Tns @ a)[idx], rows64(k, x[idx], gy.points(), a))
    check(ns_err <= TOEPLITZ_BOUND, f"phase 12: non-symmetric FFT MVM rows rel {ns_err:.3e}")
    print(f"phase 12 Toeplitz (BASELINE config 2) Exp uniform grid n=65536 float32: lazy "
          f"construction {build_s * 1e3:.3f} ms; FFT MVM {mvm_ms:.4f} ms (CUDA events, median "
          f"of 20), rows rel {mvm_err:.3e} vs float64 direct sums (bound {TOEPLITZ_BOUND:.0e}); "
          f"Strang-PCG on T + 1e-2 I tol 1e-5: {pcg_it} iterations {pcg_s:.3f} s, float64 "
          f"residual {pcg_res:.3e}; gp_condition CG tol 1e-5: {cg_it} iterations {cond_s:.3f} s, "
          f"float64 residual {cond_res:.3e} (bound 1e-4); mean(4096 off-grid) {mean_s:.4f} s, "
          f"{mean_launches} K1 launch, rows rel {mean_err:.3e}; variance(64) {var_s:.3f} s, max "
          f"abs error {var_err:.3e} vs float64 (bound {VARIANCE_BOUND:.0e}, float64 values "
          f"[{float(var64.min()):.3e}, {float(var64.max()):.3e}]); levinson n=16384 float64 "
          f"{lev_s:.3f} s wall, {lev_ms:.1f} ms CUDA events, residual {lev_res:.3e}; "
          f"non-symmetric Toeplitz rows rel {ns_err:.3e}", flush=True)
    return dict(mvm_ms=mvm_ms, pcg_it=pcg_it, pcg_s=pcg_s, cg_it=cg_it, cond_s=cond_s,
                mean_launches=mean_launches, lev_s=lev_s, lev_ms=lev_ms)


def phase13_circulant(tk, ops, gp):
    """Periodic(EQ()) on a uniform grid of n = 65536 over [0, 1): a
    CirculantOperator. MVM, exact spectral solve of C + noise I and the
    circulant logML, each against a float64 run of the same on the card."""
    from cfjax_torch.utils.grids import UniformGrid

    rng = np.random.default_rng(13)
    n = 65536
    k = tk.Periodic(tk.EQ())
    g, g64 = (UniformGrid(0.0, 1.0 / n, n, device="cuda", dtype=dt)
              for dt in (torch.float32, torch.float64))
    C, C64 = ops.gramian(k, g), ops.gramian(k, g64)
    check(type(C).__name__ == "CirculantOperator" and callable(C._c_src),
          f"phase 13: gramian gave {type(C).__name__}, or evaluated its column at construction")
    a = cuda_tensor(rng.standard_normal(n))
    b = C @ a
    mvm_err = rel(b, C64 @ a.double())
    x = g.points()
    idx = torch.tensor(np.sort(rng.choice(n, 256, replace=False)), device="cuda")
    rows_err = rel(b[idx], ops.Gramian(k, x[idx].double(), x.double()) @ a.double())
    check(max(mvm_err, rows_err) <= TOEPLITZ_BOUND,
          f"phase 13: MVM rel {mvm_err:.3e} vs float64 FFT, {rows_err:.3e} vs direct rows")
    mvm_ms = float(np.median(event_ms(lambda: C @ a, 20)))
    e0 = torch.zeros(n, device="cuda")
    e0[0] = NOISE
    Cn = ops.CirculantOperator(C.c + e0)
    Cn64 = ops.CirculantOperator(C64.c + e0.double())
    xs = Cn.solve(b)
    solve_res = float(torch.linalg.norm(Cn64 @ xs.double() - b.double()) / torch.linalg.norm(b))
    check(solve_res <= 1e-5, f"phase 13: exact solve float64 residual {solve_res:.3e}")
    y = torch.cos(4 * np.pi * x) + 0.1 * cuda_tensor(rng.standard_normal(n))
    lml, lml_s = sync_time(lambda: gp.log_marginal_likelihood(k, g, y, noise=NOISE))
    lml64 = gp.log_marginal_likelihood(k, g64, y.double(), noise=NOISE)
    lml_err = abs(float(lml) - float(lml64)) / abs(float(lml64))
    check(lml_err <= 1e-4, f"phase 13: circulant logML {float(lml):.6e} vs float64 "
                           f"{float(lml64):.6e} (rel {lml_err:.3e})")
    print(f"phase 13 circulant Periodic(EQ) uniform grid n=65536 float32: FFT MVM "
          f"{mvm_ms:.4f} ms (CUDA events, median of 20), rel {mvm_err:.3e} vs float64 FFT, "
          f"{rows_err:.3e} vs float64 direct rows (bound {TOEPLITZ_BOUND:.0e}); exact solve of "
          f"C + 1e-2 I float64 residual {solve_res:.3e} (bound 1e-5); logML {float(lml):.6e} in "
          f"{lml_s * 1e3:.2f} ms vs float64 {float(lml64):.6e} (rel {lml_err:.3e}, bound 1e-4)",
          flush=True)
    return dict(mvm_ms=mvm_ms)


def phase14_kronecker(tk, ops, gp):
    """BASELINE config 3 at the reference README's 128^3 (n = 2,097,152):
    separable("^", EQ(), d=3) on a LazyGrid of three uniform axes over
    [0, 1). Kronecker MVM (float32 vs float64), the per-factor Cholesky
    solve and logdet, gp_condition in float64, the exact float64 Kronecker
    logML and its gradient in one lengthscale, the posterior mean on a
    32^3 test grid, and a SeparableKernel's MVM."""
    from cfjax_torch.derivative import SeparableKernel
    from cfjax_torch.utils.grids import LazyGrid, UniformGrid

    rng = np.random.default_rng(14)
    m = 128
    n = m ** 3
    k = tk.separable("^", tk.EQ(), d=3)
    grid, grid64 = (LazyGrid(tuple(UniformGrid(0.0, 1.0 / m, m) for _ in range(3)),
                             device="cuda", dtype=dt) for dt in (torch.float32, torch.float64))
    K, build_s = sync_time(lambda: ops.gramian(k, grid))
    check(type(K).__name__ == "KroneckerOperator"
          and all(type(f).__name__ == "ToeplitzOperator" and callable(f._col_src)
                  for f in K.factors),
          f"phase 14: gramian gave {ops.explain(k, grid)}, or evaluated a column at construction")
    K64 = ops.gramian(k, grid64)
    a = cuda_tensor(rng.standard_normal(n))
    b = K @ a
    mvm_err = rel(b, K64 @ a.double())
    P = grid64.points()
    rows = torch.tensor(rng.choice(n, 8, replace=False), device="cuda")
    rows_err = rel((K64 @ a.double())[rows], ops.Gramian(k, P[rows], P) @ a.double())
    check(mvm_err <= 1e-5 and rows_err <= 1e-12,
          f"phase 14: Kronecker MVM rel {mvm_err:.3e} vs float64, float64 rows "
          f"{rows_err:.3e} vs direct sums")
    mvm_ms = float(np.median(event_ms(lambda: K @ a, 20)))

    # per-factor Cholesky (jitter 1e-10 x mean diagonal): the factors are
    # numerically singular, so the solve is held to its backward error
    F, chol_s = sync_time(lambda: K64.cholesky())
    xs, solve_s = sync_time(lambda: F.solve(a.double()))
    mats = [f.todense() + 1e-10 * torch.mean(torch.diagonal(f.todense()))
            * torch.eye(m, dtype=torch.float64, device="cuda") for f in K64.factors]
    KJ = ops.KroneckerOperator([ops.DenseOperator(M) for M in mats])
    norm = float(np.prod([float(torch.linalg.matrix_norm(M, 2)) for M in mats]))
    bwd = float(torch.linalg.norm(KJ @ xs - a.double())
                / (norm * torch.linalg.norm(xs) + torch.linalg.norm(a.double())))
    ld = float(F.logdet())
    ld_ref = sum((n // m) * float(torch.sum(torch.log(torch.linalg.eigvalsh(M)))) for M in mats)
    ld_err = abs(ld - ld_ref) / abs(ld_ref)
    check(bwd <= 1e-12 and ld_err <= 1e-6,
          f"phase 14: Cholesky solve backward error {bwd:.3e}, logdet rel {ld_err:.3e}")

    # gp_condition in float64: the spectrum of K + 1e-2 I spans ~1.7e8
    y = torch.sin(2 * np.pi * P.sum(1)) + Y_NOISE * torch.tensor(rng.standard_normal(n),
                                                                 device="cuda")
    post, cond_s = sync_time(lambda: gp.gp_condition(k, grid64, y, noise=NOISE, tol=1e-8,
                                                     maxiter=2000))
    cg_it = post.solve_info[0]
    cond_res = residual(K64 @ post.alpha, post.alpha, y)
    check(cg_it < 2000 and cond_res <= 1e-6,
          f"phase 14: gp_condition CG {cg_it} iterations, float64 residual {cond_res:.3e}")

    # the exact Kronecker logML in float64 (in float32 the factors'
    # eigenvalues carry ~4e-6 of rounding, which times lambda_max^2 ~ 1.4e4
    # exceeds the noise: log of a negative number) against y . alpha from
    # the CG solve and the logdet from the factors' eigvalsh; and d/dl in
    # the first axis' lengthscale against a central difference
    lml, lml_s = sync_time(lambda: gp.log_marginal_likelihood(k, grid64, y, noise=NOISE))
    w = [torch.linalg.eigvalsh(f.todense()) for f in K64.factors]
    lam = (w[0][:, None, None] * w[1][None, :, None] * w[2][None, None, :]).reshape(-1)
    lml_ref = -0.5 * (float(y @ post.alpha) + float(torch.sum(torch.log(lam + NOISE)))
                      + n * np.log(2 * np.pi))
    lml_err = abs(float(lml) - lml_ref) / abs(lml_ref)

    def lml_l(l):
        kl = tk.separable("*", tk.Lengthscale(tk.EQ(), l), tk.EQ(), tk.EQ())
        return gp.log_marginal_likelihood(kl, grid64, y, noise=NOISE)

    l = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    (dl,), grad_s = sync_time(lambda: torch.autograd.grad(lml_l(l), l))
    h = 1e-4
    with torch.no_grad():
        fd = float(lml_l(torch.tensor(1 + h, dtype=torch.float64))
                   - lml_l(torch.tensor(1 - h, dtype=torch.float64))) / (2 * h)
    grad_err = abs(float(dl) - fd) / abs(fd)
    check(lml_err <= 1e-6 and grad_err <= 1e-4,
          f"phase 14: Kronecker logML {float(lml):.9e} vs {lml_ref:.9e} from CG and eigvalsh "
          f"(rel {lml_err:.3e}), d/dl {float(dl):.6e} vs central difference {fd:.6e} (rel "
          f"{grad_err:.3e})")

    # the posterior mean on a 32^3 test grid (a Kronecker of rectangular
    # factors) against direct float64 sums; alpha's entries cancel, so the
    # error is held to the rounding scale sum_j |K_ij| |alpha_j|
    tgrid = LazyGrid(tuple(UniformGrid(0.5 / 32, 1.0 / 32, 32) for _ in range(3)),
                     device="cuda", dtype=torch.float64)
    Ks = ops.gramian(k, tgrid, grid64)
    check(type(Ks).__name__ == "KroneckerOperator" and Ks.shape == (32 ** 3, n),
          f"phase 14: test x train gramian gave {type(Ks).__name__}{Ks.shape}")
    mean, mean_s = sync_time(lambda: post.mean(tgrid))
    T = tgrid.points()
    trows = torch.tensor(rng.choice(32 ** 3, 8, replace=False), device="cuda")
    Krows = ops.Gramian(k, T[trows], P)
    mean_err = float(torch.max(torch.abs(mean[trows] - Krows @ post.alpha)
                               / (Krows @ torch.abs(post.alpha))))
    check(tuple(mean.shape) == (32 ** 3,) and mean_err <= 1e-10,
          f"phase 14: posterior mean on the 32^3 grid, error {mean_err:.3e} of sum |K||alpha|")

    # SeparableKernel(EQ(), B), n = 4096, d = 3, B 3 x 3
    Bm = rng.standard_normal((3, 3))
    B = Bm @ Bm.T + 3 * np.eye(3)
    xq = cuda_tensor(rng.standard_normal((4096, 3)))
    G = ops.gramian(SeparableKernel(tk.EQ(), B), xq)
    check(type(G).__name__ == "KroneckerOperator", f"phase 14: SeparableKernel gave {type(G)}")
    v = cuda_tensor(rng.standard_normal(4096 * 3))
    sep_err = rel(G @ v, ops.gramian(SeparableKernel(tk.EQ(), B), xq.double()) @ v.double())
    check(sep_err <= 1e-5, f"phase 14: SeparableKernel MVM rel {sep_err:.3e} vs float64")
    print(f"phase 14 Kronecker (BASELINE config 3) separable EQ^3 on a 128^3 LazyGrid "
          f"(n=2097152): lazy construction {build_s * 1e3:.3f} ms; MVM float32 {mvm_ms:.4f} ms "
          f"(CUDA events, median of 20), rel {mvm_err:.3e} vs float64 (bound 1e-5), float64 rows "
          f"rel {rows_err:.3e} vs direct sums; float64 per-factor Cholesky {chol_s:.4f} s, solve "
          f"{solve_s:.4f} s, backward error {bwd:.3e} (bound 1e-12), logdet {ld:.6e} rel "
          f"{ld_err:.3e}; float64 logML {float(lml):.9e} in {lml_s:.3f} s, rel {lml_err:.3e} vs "
          f"CG and eigvalsh; d/dl {float(dl):.6e} ({grad_s:.3f} s) vs central difference {fd:.6e} (rel "
          f"{grad_err:.3e}); gp_condition float64 CG tol 1e-8: {cg_it} iterations {cond_s:.3f} "
          f"s, residual {cond_res:.3e} (bound 1e-6); mean on the 32^3 grid {mean_s:.4f} s, error "
          f"{mean_err:.3e} of sum |K||alpha| (bound 1e-10); SeparableKernel(EQ, 3x3 B) n=4096 d=3 MVM rel {sep_err:.3e}",
          flush=True)
    return dict(mvm_ms=mvm_ms, cg_it=cg_it, cond_s=cond_s)


def time_k1(mvm, tk, xh, ah, x17, a17):
    """K1 at the headline (MaternP(2), d = 3, n = 16384): the family
    instance and the interpreted instance on the same spec with its family
    cleared (`kernel_times`), and the family instance at n = 2^17 (phase
    3's shape; a call, median of 3, and device time from a graph of 3
    calls)."""
    from cfjax_torch.kernels.profile_spec import to_spec

    k = tk.MaternP(2)
    spec = to_spec(k)[0]
    interp = dataclasses.replace(spec, family=0)
    plain = lambda: mvm.gramian_matvec_direct_plain(k, xh, xh, ah)
    fam = kernel_times(lambda: mvm.gramian_matvec_direct(k, xh, xh, ah, spec=spec), plain)
    itp = kernel_times(lambda: mvm.gramian_matvec_direct(k, xh, xh, ah, spec=interp), plain)
    k17 = lambda: mvm.gramian_matvec_direct(k, x17, x17, a17, spec=spec)
    ms17 = float(np.median(graph_ms(k17, 3, 3)))
    call17 = float(np.median(event_ms(k17, 3)))
    prof = mvm.profile_ops(spec)
    return dict(ms=fam[1], call_ms=fam[0], plain_ms=fam[2], interp_ms=itp[1],
                interp_call_ms=itp[0], ms17=ms17, call17=call17,
                bound=roof(mvm.work_direct(16384, 16384, 3, prof)),
                bound17=roof(mvm.work_direct(131072, 131072, 3, prof)))


def cols_text(k1c):
    """The many-column K1's times against its bound and 16 single-column calls."""
    parts = []
    for n, t in k1c.items():
        plain = "" if t["plain_ms"] is None else f" vs plain {t['plain_ms']:.4f} ms"
        parts.append(
            f"n={n} {t['call_ms']:.4f} ms a call ({t['ms']:.4f} ms device){plain}; against "
            f"float64 plain on rows 0..{t['rows']} rel {t['err']:.3e} max abs {t['abs_err']:.3e} "
            f"(bound {K1_BOUND:.0e}); 16 single-column K1 calls {t['singles_ms']:.4f} ms device "
            f"({t['singles_ms'] / t['ms']:.2f}x); bound {t['bound'][0]:.4f} ms "
            f"({t['bound'][1]}) = {t['pct']:.1f}% of device (valid); \"default\" (1 pass) "
            f"{t['default_ms']:.4f} ms device, bound {t['bound1'][0]:.4f} ms ({t['bound1'][1]}) "
            f"= {t['pct1']:.1f}%; the count with p FFMAs an entry {t['old'][0]:.4f} ms "
            f"({t['old'][1]})")
    return "; ".join(parts)


def lml_grads(tk, gp, x, y, l0=1.0, **kw):
    """log_marginal_likelihood of Lengthscale(MaternP(2), l0) + NOISE I at
    (x, y) and its gradient in log l and in the noise (autograd over
    float64 leaves): (value, d/dlog l, d/dnoise)."""
    l = torch.tensor(l0, dtype=torch.float64, requires_grad=True)
    nz = torch.tensor(NOISE, dtype=torch.float64, requires_grad=True)
    v = gp.log_marginal_likelihood(tk.Lengthscale(tk.MaternP(2), l), x, y, noise=nz, **kw)
    gl, gn = torch.autograd.grad(v, (l, nz))
    return float(v.detach()), l0 * float(gl), float(gn)


@contextlib.contextmanager
def slq_stages(slq, maxiter):
    """The iterations and walls of the slq stages of the logML calls made
    inside: wraps `_lanczos_batch`, `cg_columns`, `cg` and `_pull_back` in
    `cfjax_torch.operators.slq`, each between two synchronizes, and keeps
    the quadratic form's alpha."""
    st = dict(lanczos_calls=0, lanczos_s=0.0, cols_s=0.0, quad_s=0.0, vjp_s=0.0)
    orig = {name: getattr(slq, name) for name in ("_lanczos_batch", "cg_columns", "cg",
                                                  "_pull_back")}

    def lanczos(out):
        st["lanczos_calls"] += 1

    def cols(out):
        st["cols_iters"] = int(out[1])
        st["cols_hit"] = st["cols_iters"] >= maxiter

    def quad(out):
        st["quad_iters"], st["alpha"] = int(out[1][0]), out[0]
        st["quad_hit"] = st["quad_iters"] >= maxiter

    def timed(name, key, seen=None):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig[name](*a, **kw)
            torch.cuda.synchronize()
            st[key] += time.perf_counter() - t0
            if seen is not None:
                seen(out)
            return out
        return run

    slq._lanczos_batch = timed("_lanczos_batch", "lanczos_s", lanczos)
    slq.cg_columns = timed("cg_columns", "cols_s", cols)
    slq.cg = timed("cg", "quad_s", quad)
    slq._pull_back = timed("_pull_back", "vjp_s")
    try:
        yield st
    finally:
        for name, fn in orig.items():
            setattr(slq, name, fn)


def stage_text(st):
    return (f"Lanczos {st['lanczos_s']:.3f} s (48 steps), cg_columns {st['cols_iters']} iterations "
            f"{'(hit solve_maxiter) ' if st['cols_hit'] else ''}{st['cols_s']:.3f} s, quadratic "
            f"form CG {st['quad_iters']} iterations {'(hit solve_maxiter) ' if st['quad_hit'] else ''}"
            f"{st['quad_s']:.3f} s, VJP (plain, checkpointed) {st['vjp_s']:.3f} s")


def logml_launches(label, before, after, st):
    """Every forward product of the logML ran on K1: one many-column launch a
    Lanczos step (one probe sweep) and a cg_columns iteration, one
    single-column launch a quadratic-form CG iteration and one for its
    first residual."""
    cols = after["direct_cols"] - before["direct_cols"]
    one = after["direct"] - before["direct"]
    check(cols == 48 + st["cols_iters"] and one == st["quad_iters"] + 1,
          f"{label}: {cols} many-column K1 launches for 48 Lanczos steps and "
          f"{st['cols_iters']} cg_columns iterations, {one} K1 launches for "
          f"{st['quad_iters']} CG iterations: a forward product ran elsewhere")
    return cols, one


def phase15_logdet(tk, ops, slq):
    """The SLQ logdet of Lengthscale(MaternP(2), 1) + NOISE I at n = 16384
    (phase 15a's points): float32 through the many-column K1 against
    float64 through the plain path on the same probes (a generator seeded
    with 0), and the float32 estimate's error against the exact logdet
    (float64 dense Cholesky) over probes and Lanczos steps: the variance
    (probes) and the quadrature's bias (steps)."""
    rng = np.random.default_rng(15)
    n = 16384
    x = cuda_tensor(rng.standard_normal((n, 3)))
    k = tk.Lengthscale(tk.MaternP(2), 1.0)

    def logdet(xx, probes=16, iters=48):
        G = ops.gramian(k, xx)
        est = slq.slq_logdet(lambda ps, V: G.matvec(V) + NOISE * V, n, probes, iters, 1e-6, 500,
                             (), torch.Generator(device="cuda").manual_seed(0), dtype=xx.dtype,
                             device=xx.device)
        return float(est)

    (ld32, s32), (ld64, s64) = sync_time(lambda: logdet(x)), sync_time(lambda: logdet(x.double()))
    err = abs(ld32 - ld64) / abs(ld64)
    check(err <= SLQ_BOUND, f"phase 15: SLQ logdet float32 (K1) {ld32:.9e} vs float64 plain "
                            f"{ld64:.9e}, rel {err:.3e} > {SLQ_BOUND:.0e}")
    with torch.no_grad():
        A = ops.gramian(k, x.double()).todense()
        A.diagonal().add_(NOISE)
        exact = float(2 * torch.sum(torch.log(torch.diagonal(torch.linalg.cholesky(A)))))
        del A
    sweep = {(p, it): (logdet(x, p, it) - exact) / abs(exact)
             for p, it in ((16, 48), (64, 48), (16, 96), (16, 192), (16, 384))}
    return dict(ld32=ld32, ld64=ld64, err=err, s32=s32, s64=s64, exact=exact, sweep=sweep)


def phase15_logml(tk, gp, mvm, slq, p3):
    """The lazy logML and its gradient in log l and the noise.
    (a) n = 16384, phase 3's kind of points, method="slq" forced (solves to
    cfjax's 1e-6, up to 2000 iterations), against the float64 dense
    Cholesky logML on the card with cfjax's test tolerances: the gradient
    (0.15 max(1, |g|)) at cfjax's 16 probes and 48 Lanczos steps, whose
    value is biased here (printed), the value (2%) at CONVERGED_ITERS
    steps.
    (b) n = 2^17, phase 3's points, the auto route (slq above
    max_cholesky_size), cfjax's defaults but solve_tol 1e-5: no reference,
    the solves' iterations and the float64 residual of alpha."""
    rng = np.random.default_rng(15)
    n = 16384
    x = cuda_tensor(rng.standard_normal((n, 3)))
    y = torch.sin(x[:, 0]) + Y_NOISE * cuda_tensor(rng.standard_normal(n))
    before = dict(mvm.LAUNCHES)
    with slq_stages(slq, 2000) as st_a:
        (va, gla, gna), wall_a = sync_time(lambda: lml_grads(tk, gp, x, y, method="slq",
                                                             solve_maxiter=2000))
    cols_a, one_a = logml_launches("phase 15a", before, dict(mvm.LAUNCHES), st_a)
    (vc, glc, gnc), wall_c = sync_time(lambda: lml_grads(tk, gp, x.double(), y.double(),
                                                         method="cholesky"))
    err_v = abs(va - vc) / abs(vc)
    err_l, err_n = abs(gla - glc), abs(gna - gnc)
    tol_l, tol_n = 0.15 * max(1.0, abs(glc)), 0.15 * max(1.0, abs(gnc))
    with torch.no_grad():
        vs = float(gp.log_marginal_likelihood(tk.Lengthscale(tk.MaternP(2), 1.0), x, y,
                                              noise=NOISE, method="slq",
                                              lanczos_iters=CONVERGED_ITERS, solve_maxiter=2000))
    err_s = abs(vs - vc) / abs(vc)
    check(err_s <= 0.02 and err_l <= tol_l and err_n <= tol_n,
          f"phase 15a: slq logML at {CONVERGED_ITERS} Lanczos steps {vs:.6e} vs Cholesky "
          f"{vc:.6e} (rel {err_s:.3e}, bound 0.02); d/dlog l {gla:.6e} vs {glc:.6e} (|diff| "
          f"{err_l:.3e}, bound {tol_l:.3e}); d/dnoise {gna:.6e} vs {gnc:.6e} (|diff| "
          f"{err_n:.3e}, bound {tol_n:.3e})")
    print(f"phase 15a lazy logML n=16384 d=3 Lengthscale(MaternP(2), 1) method='slq' (16 probes, "
          f"solve_tol 1e-6, solve_maxiter 2000), float32 on K1: value at {CONVERGED_ITERS} "
          f"Lanczos steps {vs:.6e} vs float64 dense Cholesky {vc:.6e} (rel {err_s:.3e}, bound "
          f"0.02); at cfjax's 48 steps {va:.6e} (rel {err_v:.3e}, the quadrature's bias), d/dlog l {gla:.6e} "
          f"vs {glc:.6e} (|diff| {err_l:.3e}, bound {tol_l:.3e}); d/dnoise {gna:.6e} vs "
          f"{gnc:.6e} (|diff| {err_n:.3e}, bound {tol_n:.3e}); value and gradient {wall_a:.3f} "
          f"s ({stage_text(st_a)}), Cholesky and its gradient {wall_c:.3f} s; launches: "
          f"{cols_a} many-column K1, {one_a} K1", flush=True)

    x, y = p3["x"], p3["y"]
    n = x.shape[0]
    before = dict(mvm.LAUNCHES)
    with slq_stages(slq, 500) as st_b:
        (vb, glb, gnb), wall_b = sync_time(lambda: lml_grads(tk, gp, x, y, solve_tol=1e-5))
    check(st_b["lanczos_calls"] > 0, "phase 15b: the auto route did not take the slq branch")
    cols_b, one_b = logml_launches("phase 15b", before, dict(mvm.LAUNCHES), st_b)
    check(all(np.isfinite([vb, glb, gnb])), f"phase 15b: logML {vb} gradient {glb}, {gnb}")
    alpha = st_b["alpha"]
    k = tk.Lengthscale(tk.MaternP(2), 1.0)
    res64 = residual(mvm.gramian_matvec_direct_plain(k, x.double(), x.double(), alpha.double()),
                     alpha, y)
    print(f"phase 15b lazy logML n=131072 (phase 3's points) Lengthscale(MaternP(2), 1), the "
          f"auto route to slq, solve_tol 1e-5, solve_maxiter 500: value {vb:.6e}, d/dlog l "
          f"{glb:.6e}, d/dnoise {gnb:.6e}; {wall_b:.3f} s: {stage_text(st_b)}; float64 "
          f"relative residual of alpha {res64:.3e}; launches: {cols_b} many-column K1 (48 + "
          f"{st_b['cols_iters']}), {one_b} K1 ({st_b['quad_iters']} + 1); no preconditioner "
          f"(as cfjax's slq branch)", flush=True)
    return dict(va=va, vc=vc, err_v=err_v, wall_a=wall_a, st_a=st_a, vb=vb, glb=glb, gnb=gnb,
                wall_b=wall_b, st_b=st_b, res64=res64, launches_b=(cols_b, one_b))


def phase16_fit(tk, gp, mvm, p3, step_s):
    """fit_kernel: 3 Adam steps (lr 0.05) from Lengthscale(MaternP(2), 2) at
    phase 3's points through the slq branch, cfjax's defaults; at n = 2^16
    (its first half) when three of phase 15b's logML walls exceed 180 s.
    The wall and launches of each step are read at each call of the
    logML (a wrapper in fit's namespace)."""
    import cfjax_torch.gp.fit as fit_mod

    x, y = p3["x"], p3["y"]
    cut = 3 * step_s > 180
    if cut:
        x, y = x[:65536], y[:65536]
    marks = []
    orig = fit_mod.log_marginal_likelihood

    def timed(*a, **kw):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), dict(mvm.LAUNCHES)))
        return orig(*a, **kw)

    fit_mod.log_marginal_likelihood = timed
    try:
        (kfit, hist), wall = sync_time(lambda: gp.fit_kernel(tk.Lengthscale(tk.MaternP(2), 2.0),
                                                             x, y, noise=NOISE, steps=3, lr=0.05))
    finally:
        fit_mod.log_marginal_likelihood = orig
    marks.append((time.perf_counter(), dict(mvm.LAUNCHES)))
    walls = [b[0] - a[0] for a, b in zip(marks, marks[1:])]
    launches = [(b[1]["direct_cols"] - a[1]["direct_cols"], b[1]["direct"] - a[1]["direct"])
                for a, b in zip(marks, marks[1:])]
    l_fit = float(kfit.l)
    check(hist.shape == (3,) and bool(torch.isfinite(hist).all()) and np.isfinite(l_fit)
          and l_fit > 0 and l_fit != 2.0, f"phase 16: history {hist.tolist()}, l {l_fit}")
    check(all(c > 48 and o > 1 for c, o in launches), f"phase 16: launches per step {launches}")
    why = (f"cut to n=65536: three logML walls of phase 15b ({step_s:.1f} s each) exceed 180 s"
           if cut else "n=131072, uncut")
    print(f"phase 16 fit_kernel 3 Adam steps (lr 0.05) from Lengthscale(MaternP(2), 2) through "
          f"slq ({why}): losses {', '.join(f'{v:.6e}' for v in hist.tolist())}, l {l_fit:.6f}; "
          f"{wall:.3f} s, steps {', '.join(f'{w:.3f}' for w in walls)} s; launches per step "
          f"(many-column K1, K1) {launches}", flush=True)
    return dict(hist=hist.tolist(), walls=walls, launches=launches, l=l_fit, cut=cut, wall=wall)


def uncounted_k1(mvm, label, fn):
    """fn() through K1, for a comparison with K1's plain version: checks
    that K1 ran, and leaves the launch counts as they were."""
    with mvm.uncounted():
        before = mvm.LAUNCHES["direct"]
        out = fn()
        check(mvm.LAUNCHES["direct"] > before, f"{label}: the product did not run K1")
    return out


def k1_against_plain(label, out, ref64, mag64=None):
    """K1's product K v against its float64 plain version on the same
    inputs, at K1_BOUND: the error's L2 norm over the product's, or, where
    v has entries of both signs, over that of K |v| (mag64), the sum of
    magnitudes that a float32 product's rounding scales with. A solve's
    solution cancels in K v (GP weights alpha: K alpha ~ y, |alpha| >> |y|),
    so there the error over ||K v|| measures the cancellation, not the
    kernel. Returns (that error, the largest absolute one)."""
    err = float(torch.linalg.norm(out.double() - ref64)
                / torch.linalg.norm(ref64 if mag64 is None else mag64))
    over = "||K v||" if mag64 is None else "||K |v|||"
    check(err <= K1_BOUND, f"{label}: K1's error over {over} {err:.3e} against float64 plain")
    return err, float((out.double() - ref64).abs().max())


def cancels(Kv64, mag64):
    """||K |v||| / ||K v||: how far the product cancels."""
    return float(torch.linalg.norm(mag64) / torch.linalg.norm(Kv64))


def bh_plan64(F, bh, v):
    """F's MVM over its own buckets and plans, evaluated in float64 plain
    torch on the card: the plain version of the float32 MVM, term for term."""
    t = F.tree
    wp = F._permuted_weights(v.double())
    flat = torch.zeros(F._tgt_P, dtype=torch.float64, device=v.device)
    for xg, rows, flv, fidx, lidx in F._device_plans():
        flat[rows] = bh.bh_matvec_planned(F.k, xg.double(), fidx, lidx, t.points.double(), wp,
                                          flv, t.levels, t.leafsize, F.order).reshape(-1)
    out = torch.zeros_like(flat)
    out[F._tgt_perm.long()] = flat
    return out[:F.n]


def bh_without(bh, fn, graph_reps):
    """Device ms of fn from CUDA graphs with the near field, then the far
    field, taken out (each returns zeros of its shape; the far field's mask
    and sum stay): what each half adds to the device's time."""
    no_near = lambda k, xt, *a: xt.new_zeros(xt.shape[:2])
    no_far = lambda k, xt, st, ic, order: xt.new_zeros(()).expand(*xt.shape[:2], ic.shape[1])
    out = []
    for name, stub in (("_near_field", no_near), ("_far_field", no_far)):
        orig = getattr(bh, name)
        setattr(bh, name, stub)
        try:
            out.append(float(np.median(graph_ms(fn, graph_reps, 3))))
        finally:
            setattr(bh, name, orig)
    return tuple(out)


def bh_times(bh, fn, reps, graph_reps):
    """(ms of a call, CUDA events around one call, median of reps; device ms
    from a CUDA graph of graph_reps calls; device ms without the near field
    and without the far field). Events around each half would hold the
    host's gaps between launches, which are most of a call at n = 65536."""
    fn()
    call = float(np.median(event_ms(fn, reps)))
    dev = float(np.median(graph_ms(fn, graph_reps, 3)))
    return call, dev, bh_without(bh, fn, graph_reps)


def bh_pairs(F):
    """(near-field pairs, far-field pairs) an MVM evaluates: per bucket, its
    group size times the valid slots of its plan (leaf slots times the leaf
    size for the near field)."""
    ls = F.tree.leafsize
    near = far = 0
    for (_, _, _, rows, _), (_, fidx, lidx) in zip(F.buckets, F.plans):
        G = rows.shape[1]
        near += G * ls * int((lidx >= 0).sum())
        far += G * sum(int((f >= 0).sum()) for f in fidx)
    return near, far


def bh_text(F, t):
    call, dev, (no_near, no_far) = t
    pn, pf = bh_pairs(F)
    bound = roof(Work(sfu=pn + pf))[0]
    return (f"{pn:.4e} near-field and {pf:.4e} far-field pairs, at one SFU operation a pair "
            f"{bound:.3f} ms ({100 * bound / dev:.2f}% of device); "
            f"MVM {call:.3f} ms a call, {dev:.3f} ms device (graph); device without the near field "
            f"{no_near:.3f} ms, without the far field {no_far:.3f} ms (near {dev - no_near:.3f} "
            f"ms = {100 * (dev - no_near) / dev:.1f}%, far {dev - no_far:.3f} ms = "
            f"{100 * (dev - no_far) / dev:.1f}% of device); F = {F.max_open}, {len(F.buckets)} "
            f"buckets, {sum(len(b[3]) for b in F.buckets)} groups")


def bh_build(bh, k, x, theta, fresh=None):
    """A warm build's wall (min of 3; on points that `fresh` draws anew
    each time when given), then the plan: the buckets' gathers, the host
    sweep and the copy to the card. Returns (F, its points, build s,
    buckets s, plans s, copy s)."""
    bh.BarnesHutFactorization(k, x, theta=theta)
    best, F = float("inf"), None
    for _ in range(3):
        x = x if fresh is None else fresh()
        F, s = sync_time(lambda: bh.BarnesHutFactorization(k, x, theta=theta))
        best = min(best, s)
    _, b_s = sync_time(lambda: F.buckets)
    _, p_s = sync_time(lambda: F.plans)
    _, c_s = sync_time(F._device_plans)
    return F, x, best, b_s, p_s, c_s


def phase17_treecode(tk, ops, bh, mvm):
    """The reference README's treecode (BASELINE.md:29-31): EQ, n = 65536,
    d = 2, x ~ N(0, I), w ~ U(0, 1), theta 1/2 and 1/4, order 1. The error
    against 256 exact rows through K1 (a 256 x n rectangular Gramian, held
    against float64), the MVM against the same plan in float64 on the card."""
    rng = np.random.default_rng(17)
    n = 65536
    k = tk.EQ()
    x = cuda_tensor(rng.standard_normal((n, 2)))
    w = cuda_tensor(rng.uniform(0, 1, n))
    idx = torch.as_tensor(rng.integers(0, n, 256), device="cuda")
    exact = ops.gramian(k, x[idx], x) @ w
    k1_err, k1_abs = k1_against_plain("phase 17: 256 exact rows", exact,
                                      mvm.gramian_matvec_direct_plain(k, x[idx].double(),
                                                                      x.double(), w.double()))
    for theta in (0.5, 0.25):
        F, _, build_s, b_s, p_s, c_s = bh_build(bh, k, x, theta)
        b = F @ w
        check(tuple(b.shape) == (n,) and b.dtype == torch.float32 and bool(torch.isfinite(b).all()),
              f"phase 17: theta {theta}: MVM not finite float32 of shape (n,)")
        err = rel(b[idx], exact.double())
        plan_err = rel(b, bh_plan64(F, bh, w))
        t = bh_times(bh, lambda: F @ w, 10, 5)
        check(plan_err <= BH_PLAN_BOUND,
              f"phase 17: theta {theta}: float32 MVM vs float64 plan rel {plan_err:.3e}")
        check(err <= 2 * BH_REF_ERR[theta],
              f"phase 17: theta {theta}: error {err:.3e} > 2 x the reference's {BH_REF_ERR[theta]}")
        print(f"phase 17 treecode EQ n=65536 d=2 theta={theta}: build {build_s:.4f} s (warm, min "
              f"of 3), plan {p_s:.4f} s (buckets {b_s:.4f} s, copy {c_s:.4f} s); {bh_text(F, t)}; "
              f"rel err vs 256 exact rows (K1) {err:.3e} (reference {BH_REF_ERR[theta]:.2e}); "
              f"float32 vs the same plan in float64 {plan_err:.3e} (bound "
              f"{BH_PLAN_BOUND:.0e}); K1's rows vs float64 plain {k1_err:.3e}", flush=True)
        del F
    return k1_abs


def phase18_treecode_1e6(tk, ops, bh, mvm):
    """BASELINE config 5's treecode (run_baseline.py:449-479): EQ, n = 10^6,
    d = 2, x ~ N(0, I), w ~ U(0, 1), theta 1/2: build (min of 3 on fresh
    points), plan, MVM with its near / far split and its peak memory, the
    error against 16 exact rows through K1 (held against float64 plain),
    and the linearity of matvec_linear."""
    rng = np.random.default_rng(18)
    n = 1_000_000
    k = tk.EQ()
    w = cuda_tensor(rng.uniform(0, 1, n))
    F, x, build_s, b_s, p_s, c_s = bh_build(
        bh, k, cuda_tensor(rng.standard_normal((n, 2))), 0.5,
        fresh=lambda: cuda_tensor(rng.standard_normal((n, 2))))
    b = F @ w
    check(tuple(b.shape) == (n,) and bool(torch.isfinite(b).all()),
          "phase 18: the MVM is not finite of shape (n,)")
    idx = torch.as_tensor(rng.integers(0, n, 16), device="cuda")
    exact = ops.gramian(k, x[idx], x) @ w
    k1_err, k1_abs = k1_against_plain("phase 18: 16 exact rows", exact,
                                      mvm.gramian_matvec_direct_plain(k, x[idx].double(),
                                                                      x.double(), w.double()))
    err = rel(b[idx], exact.double())
    check(np.isfinite(err) and err <= BH_N6_ERR, f"phase 18: error {err:.3e} > {BH_N6_ERR}")
    t = bh_times(bh, lambda: F @ w, 5, 2)
    # the MVM's peak memory above its inputs
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    F @ w
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    u, v = cuda_tensor(rng.standard_normal(n)), cuda_tensor(rng.standard_normal(n))
    lhs = F.matvec_linear(2.0 * u - 3.0 * v)
    lin = float(torch.linalg.norm(lhs - (2.0 * F.matvec_linear(u) - 3.0 * F.matvec_linear(v)))
                / torch.linalg.norm(lhs))
    check(lin <= BH_LINEAR_BOUND, f"phase 18: matvec_linear departs from linear by {lin:.3e}")
    print(f"phase 18 treecode EQ n=1000000 d=2 theta=0.5: build {build_s:.4f} s (warm, min of 3 "
          f"on fresh points), plan {p_s:.4f} s (buckets {b_s:.4f} s, copy {c_s:.4f} s); "
          f"{bh_text(F, t)}; peak {peak:.2f} GiB at {bh.CHUNK_ELEMENTS} chunk elements; rel err "
          f"vs 16 exact rows (K1) {err:.3e} (bound {BH_N6_ERR:.0e}); K1's rows vs float64 plain "
          f"{k1_err:.3e}; matvec_linear linearity {lin:.3e} (bound {BH_LINEAR_BOUND:.0e})",
          flush=True)
    return k1_abs, F, w


def plain_rows(k, x, v, rows, mvm, block=64, dtype=torch.float64):
    """(K v) on the given rows (all rows for None) through K1's plain
    version in dtype (blocks of 64 rows: 0.5 GB tiles at n = 10^6)."""
    xr = x if rows is None else x[rows]
    return mvm.gramian_matvec_direct_plain(k, xr.to(dtype), x.to(dtype), v.to(dtype), block=block)


def relres64(k, x, y, v, noise, rows, mvm, block=64):
    """(K v) on the given rows (all rows for None) in float64 through K1's
    plain version, and ||y - (K + noise I) v|| / ||y|| there."""
    yr, vr = (y, v) if rows is None else (y[rows], v[rows])
    Kv = plain_rows(k, x, v, rows, mvm, block)
    r = yr.double() - Kv - noise * vr.double()
    return Kv, float(torch.linalg.norm(r) / torch.linalg.norm(yr.double()))


def phase19_gp_solves(tk, ops, gp, bh, mvm):
    """BASELINE config 5's GP solve (run_baseline.py:495-548): Lengthscale(EQ,
    1), n = 10^6, x ~ U(-10, 10)^2, sigma^2 = 1e-2, y = sin(x_0) + 0.1 w.
    (a) gp_condition, rank-2048 Nystrom PCG through K1, tol 1e-4, maxiter 60,
    on this phase's points (seed 19) and on cfjax's own (run_baseline's
    draw), where the float32 Nystrom build stalled (PERF.md);
    (b) approx_refined_solve: GMRES with the same preconditioner against the
    theta = 1/2 Barnes-Hut matvec_linear + sigma^2 I, corrected by K1 +
    sigma^2 I residuals. Whether (b) converges is read, not checked. K1 at
    n = 10^6 is held against its float64 plain version: on RESIDUAL_ROWS
    rows of K alpha in (a), on every row of K x in (b), where the reported
    residual is held to the float64 one of the returned x."""
    rng = np.random.default_rng(19)
    n, s2 = 1_000_000, 1e-2
    k = tk.Lengthscale(tk.EQ(), 1.0)
    x = cuda_tensor(rng.uniform(-10, 10, (n, 2)))
    y = torch.sin(x[:, 0]) + 0.1 * cuda_tensor(rng.uniform(0, 1, n))
    yn = float(torch.linalg.norm(y))
    rows = torch.as_tensor(rng.choice(n, RESIDUAL_ROWS, replace=False), device="cuda")
    G = ops.gramian(k, x)
    before = mvm.LAUNCHES["direct"]
    post, wall_a = sync_time(lambda: gp.gp_condition(k, x, y, noise=s2, precond_rank=2048,
                                                     tol=1e-4, maxiter=60))
    it_a, res_a = post.solve_info
    launches_a = mvm.LAUNCHES["direct"] - before
    rel_a = float(res_a) / yn
    check(it_a < 60 and rel_a <= 1e-4,
          f"phase 19a: Nystrom PCG did not converge: {it_a} iterations, relres {rel_a:.3e}")
    # K1 at n = 10^6 against float64 plain on RESIDUAL_ROWS rows: K |alpha|
    # (no cancellation), then K alpha, beside the plain version in float32
    a = post.alpha
    Ka64, r64_a = relres64(k, x, y, a, s2, rows, mvm)
    mag64 = plain_rows(k, x, a.abs(), rows, mvm)
    k1_m, k1_abs_m = k1_against_plain(f"phase 19a: K |alpha| on {RESIDUAL_ROWS} rows",
                                      uncounted_k1(mvm, "phase 19a", lambda: G @ a.abs())[rows],
                                      mag64)
    Ka = uncounted_k1(mvm, "phase 19a", lambda: G @ a)[rows]
    k1_a, k1_abs_a = k1_against_plain(f"phase 19a: K alpha on {RESIDUAL_ROWS} rows", Ka, Ka64,
                                      mag64)
    f32_a = float(torch.linalg.norm(plain_rows(k, x, a, rows, mvm, dtype=torch.float32).double()
                                    - Ka64) / torch.linalg.norm(mag64))
    can_a, rel_Ka = cancels(Ka64, mag64), rel(Ka, Ka64)
    check(r64_a <= 2e-4, f"phase 19a: float64 residual on {RESIDUAL_ROWS} rows {r64_a:.3e} "
          f"> 2 x the tolerance 1e-4")
    del post, a, Ka, Ka64, mag64
    # (a) again on cfjax's own points (run_baseline's draw, seed 0), where
    # the float32 Nystrom build stalled at relres 5.2e-3 after 60 iterations
    from cfjax_torch.benchmarks.run_baseline import SIZES, barneshut_draws

    dr = barneshut_draws(SIZES["full"])
    x0 = cuda_tensor(dr["x5"])
    y0 = torch.sin(x0[:, 0]) + 0.1 * cuda_tensor(dr["w3"])
    del dr
    post0, wall_0 = sync_time(lambda: gp.gp_condition(k, x0, y0, noise=s2, precond_rank=2048,
                                                      tol=1e-4, maxiter=60))
    it_0, rel_0 = post0.solve_info[0], float(post0.solve_info[1]) / float(torch.linalg.norm(y0))
    _, r64_0 = relres64(k, x0, y0, post0.alpha, s2, rows, mvm)
    check(it_0 < 60 and rel_0 <= 1e-4 and r64_0 <= 2e-4,
          f"phase 19a: on cfjax's points the Nystrom PCG took {it_0} iterations to relres "
          f"{rel_0:.3e}, float64 residual on {RESIDUAL_ROWS} rows {r64_0:.3e}")
    del post0, x0, y0
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    M, m_s = sync_time(lambda: ops.nystrom_preconditioner(k, x, s2, rank=2048))
    F, f_s = sync_time(lambda: bh.BarnesHutFactorization(k, x, theta=0.5))
    _, plan_s = sync_time(F._device_plans)
    steps, last, calls = [], {}, [0]

    def exact(v):
        Kv = G @ v
        last.update(v=v, Kv=Kv)
        out = Kv + s2 * v
        steps.append(float(torch.linalg.norm(y - out)) / yn)
        return out

    def approx(v):
        calls[0] += 1
        return F.matvec_linear(v) + s2 * v

    before = mvm.LAUNCHES["direct"]
    (xb, (outer, res_b)), solve_s = sync_time(lambda: ops.approx_refined_solve(
        exact, approx, y, M=M, tol=1e-4, inner_tol=3e-2, inner_maxiter=20, refinements=8))
    wall_b = time.perf_counter() - t0
    launches_b = mvm.LAUNCHES["direct"] - before
    check(bool(torch.isfinite(xb).all()), "phase 19b: x is not finite")
    check(last["v"] is xb, "phase 19b: the last exact residual is not of the returned x")
    del M, F
    torch.cuda.empty_cache()
    (Kx64, r64_b), check_s = sync_time(lambda: relres64(k, x, y, xb, s2, None, mvm, 128))
    k1_b, k1_abs_b = k1_against_plain(f"phase 19b: K x on {RESIDUAL_ROWS} rows",
                                      last["Kv"][rows], Kx64[rows],
                                      plain_rows(k, x, xb.abs(), rows, mvm))
    rel_b = float(res_b) / yn
    check(abs(rel_b - r64_b) <= 1e-3 * r64_b,
          f"phase 19b: reported relres {rel_b:.6e} vs float64 {r64_b:.6e} of the returned x")
    print(f"phase 19 config-5 GP solve Lengthscale(EQ, 1) n=1000000 x~U(-10,10)^2 sigma^2=1e-2: "
          f"(a) gp_condition rank-2048 Nystrom PCG {it_a} iterations, relres {rel_a:.3e}, "
          f"{wall_a:.3f} s, K1 launches {launches_a}, float64 residual on {RESIDUAL_ROWS} rows "
          f"{r64_a:.3e}; K1 there vs float64 plain: K |alpha| {k1_m:.3e}, K alpha {k1_a:.3e} "
          f"of ||K |alpha||| (plain float32 {f32_a:.3e}; {rel_Ka:.3e} of ||K alpha||, which "
          f"cancels {can_a:.1f}x); on cfjax's points (seed 0) {it_0} iterations, relres "
          f"{rel_0:.3e}, {wall_0:.3f} s, float64 residual {r64_0:.3e} | (b) "
          f"approx_refined_solve (theta 0.5 BH inner, GMRES(20), inner_tol 3e-2, tol 1e-4): "
          f"{outer} outer steps, exact relres per step "
          f"{', '.join(f'{r:.3e}' for r in steps)}; converged: {rel_b <= 1e-4}; {calls[0]} BH "
          f"MVMs, K1 launches {launches_b}; wall {wall_b:.3f} s (Nystrom {m_s:.3f} s, BH build "
          f"{f_s:.3f} s, plan {plan_s:.3f} s, solve {solve_s:.3f} s) vs (a) {wall_a:.3f} s; "
          f"reported relres {rel_b:.6e} vs {r64_b:.6e} in float64 on every row ({check_s:.1f} "
          f"s), K1's K x on {RESIDUAL_ROWS} rows vs float64 plain {k1_b:.3e} of ||K |x|||",
          flush=True)
    return max(k1_abs_m, k1_abs_a, k1_abs_b)


def phase20_refined(tk, ops, mvm):
    """refined_solve at n = 10^5 (run_baseline.py:683-765): x ~ N(0, I),
    d = 2, Lengthscale(EQ, 1), sigma^2 = 4e-3, rank-768 Nystrom, inner_tol
    1e-2, inner_maxiter 80, refinements 10, tol 1e-8. matvec_lo: K1 +
    sigma^2 I; matvec_hi: the float64 Gramian on the card (the plain path).
    Beside it plain float32 PCG (tol 1e-10, maxiter 300) by its true float64
    residual."""
    rng = np.random.default_rng(20)
    n, s2 = 100_000, 4e-3
    k = tk.Lengthscale(tk.EQ(), 1.0)
    x = cuda_tensor(rng.standard_normal((n, 2)))
    G, G64 = ops.gramian(k, x), ops.gramian(k, x.double())
    M, m_s = sync_time(lambda: ops.nystrom_preconditioner(k, x, s2, rank=768))
    hi = lambda v: G64 @ v + s2 * v
    lo = lambda v: G @ v + s2 * v
    b = hi(torch.tensor(rng.standard_normal(n), device="cuda"))
    bn = float(torch.linalg.norm(b))
    true = lambda v: float(torch.linalg.norm(
        b - mvm.gramian_matvec_direct_plain(k, x.double(), x.double(), v.double()) - s2 * v)) / bn
    (x32, (it32, _)), s32 = sync_time(lambda: ops.cg(lo, b.float(), tol=1e-10, maxiter=300, M=M))
    rel32 = true(x32.double())
    (xr, (outer, res)), sr = sync_time(lambda: ops.refined_solve(
        hi, lo, b, M=M, tol=1e-8, inner_tol=1e-2, inner_maxiter=80, refinements=10))
    rel_r = float(res) / bn
    true_r = true(xr)
    check(xr.dtype == torch.float64 and bool(torch.isfinite(xr).all()), "phase 20: x not finite")
    check(abs(true_r - rel_r) <= 1e-3 * true_r,
          f"phase 20: reported relres {rel_r:.6e} is not the true float64 one {true_r:.6e}")
    check(rel_r <= rel32, f"phase 20: refinement {rel_r:.3e} above float32 PCG's {rel32:.3e}")
    # matvec_lo's K1 product on its first CHECK_ROWS rows against float64 plain
    v = xr.float()
    Kv = uncounted_k1(mvm, "phase 20", lambda: G @ v)[:CHECK_ROWS]
    top = slice(CHECK_ROWS)
    k1_err, k1_abs = k1_against_plain(f"phase 20: K x on {CHECK_ROWS} rows", Kv,
                                      plain_rows(k, x, v, top, mvm),
                                      plain_rows(k, x, v.abs(), top, mvm))
    print(f"phase 20 refined_solve n=100000 d=2 N(0,I) Lengthscale(EQ, 1) sigma^2=4e-3 rank-768 "
          f"Nystrom: {outer} refinements to float64 relres {rel_r:.3e} (true {true_r:.3e}; reaches "
          f"1e-8: {rel_r <= 1e-8}) in {sr:.3f} s; plain float32 PCG {it32} iterations, true "
          f"float64 relres {rel32:.3e} in {s32:.3f} s; Nystrom build {m_s:.3f} s; matvec_lo's K1 "
          f"on {CHECK_ROWS} rows vs float64 plain {k1_err:.3e} of ||K |x|||", flush=True)
    return k1_abs


def time_k1_cols(mvm, tk, xh, x17, p=16):
    """The many-column K1 at p = 16 columns (the SLQ probe batch), MaternP(2),
    d = 3: at n = 16384 (`kernel_times` against its plain version), and at
    n = 2^17 (phase 3's shape: a call, median of 3, and device time from a
    graph of 3 calls); beside each, p single-column K1 calls on the same
    columns (device, from graphs) and the bound. At both shapes the
    product is held against its float64 plain version at K1_BOUND: all of
    it at n = 16384, its first CHECK_ROWS rows (against every column of K)
    at n = 2^17."""
    from cfjax_torch.kernels.profile_spec import to_spec

    k = tk.MaternP(2)
    spec = to_spec(k)[0]
    g = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for n, x in ((16384, xh), (131072, x17)):
        A = torch.randn((n, p), generator=g, device="cuda")
        cols = [A[:, c].contiguous() for c in range(p)]
        kern = lambda: mvm.gramian_matmat_direct(k, x, x, A, spec=spec)
        singles = lambda: [mvm.gramian_matvec_direct(k, x, x, a, spec=spec) for a in cols]
        rows = min(n, CHECK_ROWS)
        got = kern()[:rows]
        ref = mvm.gramian_matmat_direct_plain(k, x[:rows].double(), x.double(), A.double())
        err = rel(got, ref)
        abs_err = float((got.double() - ref).abs().max())
        del ref
        check(bool(torch.isfinite(got).all()) and err <= K1_BOUND,
              f"many-column K1 n={n} p={p}, rows 0..{rows}: relative error {err:.3e} against "
              f"float64 plain > {K1_BOUND:.0e}")
        if n == 16384:
            call, dev, plain = kernel_times(kern, lambda: mvm.gramian_matmat_direct_plain(
                k, x, x, A))
            singles_ms = float(np.median(graph_ms(singles, 1, 5)))
        else:
            dev = float(np.median(graph_ms(kern, 3, 3)))
            call, plain = float(np.median(event_ms(kern, 3))), None
            singles_ms = float(np.median(graph_ms(singles, 1, 3)))
        check(dev < singles_ms, f"many-column K1 n={n} p={p}: {dev:.4f} ms device, not below "
                                f"{p} single-column calls ({singles_ms:.4f} ms)")
        one = float(np.median(graph_ms(lambda: mvm.gramian_matmat_direct(
            k, x, x, A, spec=spec, precision="default"), 3, 3)))
        # the least work with the product on the tensor cores at 3 and 1
        # passes; beside it the count with the product as p FFMAs an entry
        # on the CUDA cores
        work = mvm.work_direct(n, n, 3, mvm.profile_ops(spec), p=p)
        work1 = mvm.work_direct(n, n, 3, mvm.profile_ops(spec), p=p, passes=1)
        summ, summ1 = summarize(work, dev / 1e3), summarize(work1, one / 1e3)
        check(summ["valid"] and summ1["valid"], f"many-column K1 n={n}: {summ.get('why')} "
                                                f"{summ1.get('why')}")
        out[n] = dict(call_ms=call, ms=dev, plain_ms=plain, singles_ms=singles_ms, rows=rows,
                      err=err, abs_err=abs_err, bound=roof(work), default_ms=one,
                      bound1=roof(work1), old=roof(Work(fp32=n * n * (2 * 3 + 6 + p))),
                      pct=summ["roofline_pct"], pct1=summ1["roofline_pct"])
    return out


# ---------------------------------------------------------------------------
# Phases 21-23: real-nu Matern on K1-K3, and BASELINE config 5's
# hyperparameter sampling
# ---------------------------------------------------------------------------

# phase 21a: K1's Matern profile against the float64 reference, relative,
# at every point whose value is above 1e-30
MATERN_BOUND = 1e-5
# phase 21a: where cfjax's quadrature (the float64 plain version) is within
# this of the reference, K1 is held to it at MATERN_BOUND too
PLAIN_SOUND = 1e-6
MATERN_NUS = (0.3, 0.5, 1.3, 2.3, 2.5, 3.7, 10.2, 25.0)
def exact_matern(tk, nu):
    """Matern(nu) whose profile is the kernels' method in float64
    (`matern_nu_reference`): the reference the kernels are held to, where
    cfjax's quadrature is not accurate (small s)."""
    from cfjax_torch.utils.besselk import matern_nu_reference

    class ExactMatern(tk.Matern):
        def profile(self, s):
            return matern_nu_reference(float(self.nu), s.double())[0].to(s.dtype)

    return ExactMatern(nu)


def pair_histogram(x, y, scale=1.0, bins=4096, block=2048):
    """Histogram of the squared distances s = |x_i - y_j|^2 / scale over
    every pair (on the card, in row blocks), on log-spaced bins from 1e-12
    to 1e6 (s outside them in the end bins): (centres, counts)."""
    edges = torch.logspace(-12, 6, bins + 1, dtype=torch.float64, device=x.device)
    counts = torch.zeros(bins, dtype=torch.float64, device=x.device)
    for i in range(0, x.shape[0], block):
        s = (torch.cdist(x[i:i + block].double(), y.double()) ** 2 / scale).reshape(-1)
        idx = torch.bucketize(s.clamp(1e-12, 1e6), edges[1:-1])
        counts += torch.bincount(idx, minlength=bins).double()
    return torch.sqrt(edges[:-1] * edges[1:]), counts


def phase21a_profile(tk, mvm):
    """K1 returns the profile itself for x (N, 1) = r, y = 0 and a = [1]: N =
    10^5 log-spaced r in [1e-6, 80] at each of MATERN_NUS, through the
    tabulated family and through the interpreted instance (the K_nu
    routine K2 and K3 run), each held against the float64 reference
    (`matern_nu_reference`) at every point above 1e-30, and against the
    float64 plain version (cfjax's quadrature) where that is within
    PLAIN_SOUND of the reference; where it is not, its own error is
    reported."""
    from cfjax_torch.kernels.profile_spec import FAMILY_MATERN_NU, to_spec
    from cfjax_torch.utils.besselk import matern_nu_reference

    N = 100000
    r = torch.logspace(-6, math.log10(80.0), N, dtype=torch.float64, device="cuda")
    x = r.float()[:, None].contiguous()
    y, a = torch.zeros((1, 1), device="cuda"), torch.ones(1, device="cuda")
    s = x.double()[:, 0] ** 2
    rows = []
    for nu in MATERN_NUS:
        spec, why = to_spec(tk.Matern(nu))
        check(spec is not None and spec.family == FAMILY_MATERN_NU,
              f"phase 21a: Matern({nu}) spec: {why}")
        ref = matern_nu_reference(nu, s)[0]
        plain = spec.evaluate(s)
        live = ref > 1e-30
        sound = live & ((plain - ref).abs() <= PLAIN_SOUND * ref)
        off = live & ~sound
        plain_off = float(((plain - ref).abs() / ref)[off].max()) if off.any() else 0.0
        errs = []
        for route, sp in (("family", spec), ("interpreted", dataclasses.replace(spec, family=0))):
            out = mvm.gramian_matvec_direct(tk.Matern(nu), x, y, a, spec=sp).double()
            check(bool(torch.isfinite(out).all()), f"phase 21a: Matern({nu}) non-finite profile")
            err = float(((out - ref).abs() / ref)[live].max())
            err_plain = float(((out - plain).abs() / plain)[sound].max())
            check(err <= MATERN_BOUND and err_plain <= MATERN_BOUND,
                  f"phase 21a: Matern({nu}) through K1's {route} instance: relative error "
                  f"{err:.3e} against the float64 reference, {err_plain:.3e} against the float64 "
                  f"plain version where it is sound (bound {MATERN_BOUND:.0e})")
            errs.append((err, err_plain, float((out - ref).abs().max())))
        rows.append((nu, int(live.sum()), errs, int(sound.sum()), int(off.sum()), plain_off,
                     float(r[off].max()) if off.any() else 0.0))
    print("phase 21a K1 Matern profile (x = r, N = 100000 log-spaced r in [1e-6, 80], y = 0, "
          f"a = 1), the tabulated family / the interpreted instance: against the float64 "
          f"reference at every value above 1e-30, and against the float64 plain version "
          f"(cfjax's quadrature) where it is within {PLAIN_SOUND:.0e} of the reference (bound "
          f"{MATERN_BOUND:.0e}): " + "; ".join(
              f"nu={nu}: {lv} points max rel {ef[0]:.3e} / {ei[0]:.3e}, vs plain on {sd} "
              f"{ef[1]:.3e} / {ei[1]:.3e}; the plain version misses by more than "
              f"{PLAIN_SOUND:.0e} on {no} points (r <= {rmax:.3e}), by up to {po:.3e}"
              for nu, lv, (ef, ei), sd, no, po, rmax in rows), flush=True)
    return max(row[2][0][2] for row in rows), max(row[2][1][2] for row in rows)


def phase21a_headline(tk, mvm):
    """K1 at BASELINE config 1's shape (d = 3, n = 16384, N(0, I) points)
    with Matern(2.3) and Matern(2.5) through the tabulated family, its
    first 4096 rows against the float64 plain version and the float64
    reference at K1_BOUND; Matern(2.5) against the MaternP(2) family
    instance; times and the bound of Matern(2.3) through the family (the
    bound by `work_direct` on its `profile_ops`, valid by `summarize`) and
    through the interpreted instance (the K_nu routine's operations on this
    run's distances, `matern_nu_ops`); the many-column family at p = 16,
    one launch, against 16 single-column launches."""
    from cfjax_torch.kernels.profile_spec import FAMILY_MATERN_NU, to_spec

    rng = np.random.default_rng(21)
    n = 16384
    x = cuda_tensor(rng.standard_normal((n, 3)))
    a = cuda_tensor(rng.standard_normal(n))
    res = {}
    for nu in (2.3, 2.5):
        k = tk.Matern(nu)
        check(to_spec(k)[0].family == FAMILY_MATERN_NU, "phase 21a: Matern takes no K1 family")
        out = mvm.gramian_matvec_direct(k, x, x, a)
        rows = slice(4096)
        with torch.no_grad():
            plain = mvm.gramian_matvec_direct_plain(k, x[rows].double(), x.double(), a.double(),
                                                    block=32)
            exact = mvm.gramian_matvec_direct_plain(exact_matern(tk, nu), x[rows].double(),
                                                    x.double(), a.double(), block=256)
        res[nu] = (rel(out[rows], plain), rel(out[rows], exact),
                   float((out[rows].double() - exact).abs().max()))
        check(bool(torch.isfinite(out).all()) and max(res[nu][:2]) <= K1_BOUND,
              f"phase 21a: K1 Matern({nu}) n={n} d=3: relative error {res[nu][0]:.3e} vs float64 "
              f"plain, {res[nu][1]:.3e} vs the float64 reference (bound {K1_BOUND:.0e})")
        if nu == 2.5:
            fam = mvm.gramian_matvec_direct(tk.MaternP(2), x, x, a)
            res["family"] = rel(out, fam.double())
            check(res["family"] <= 1e-5, f"phase 21a: Matern(2.5) vs MaternP(2)'s family "
                                         f"instance {res['family']:.3e} > 1e-5")
    k = tk.Matern(2.3)
    spec = to_spec(k)[0]
    itp = dataclasses.replace(spec, family=0)
    A = cuda_tensor(rng.standard_normal((n, 16)))
    cols = [A[:, c].contiguous() for c in range(16)]
    before = dict(mvm.LAUNCHES)
    call, dev = call_and_device_ms(lambda: mvm.gramian_matvec_direct(k, x, x, a))
    icall, idev = call_and_device_ms(lambda: mvm.gramian_matvec_direct(k, x, x, a, spec=itp))
    ccall, cdev = call_and_device_ms(lambda: mvm.gramian_matmat_direct(k, x, x, A))
    singles = float(np.median(graph_ms(lambda: [mvm.gramian_matvec_direct(k, x, x, c)
                                                for c in cols], 1, 3)))
    got, ref = mvm.gramian_matmat_direct(k, x, x, A)[:4096], None
    with torch.no_grad():
        ref = mvm.gramian_matmat_direct_plain(exact_matern(tk, 2.3), x[:4096].double(),
                                              x.double(), A.double(), block=256)
    cerr = rel(got, ref)
    check(cerr <= K1_BOUND, f"phase 21a: the many-column Matern(2.3) family, rows 0..4095: "
                            f"{cerr:.3e} vs the float64 reference > {K1_BOUND:.0e}")
    _, plain_s = sync_time(lambda: mvm.gramian_matvec_direct_plain(k, x, x, a, block=32))
    mvm.LAUNCHES.update(before)   # the timing's launches are not the path's
    work = mvm.work_direct(n, n, 3, mvm.profile_ops(spec))
    wcols = mvm.work_direct(n, n, 3, mvm.profile_ops(spec), p=16)
    summ, summc = summarize(work, dev / 1e3), summarize(wcols, cdev / 1e3)
    check(summ["valid"] and summc["valid"], f"phase 21a: {summ.get('why')} {summc.get('why')}")
    hist = pair_histogram(x, x)
    fp32, sfu = matern_nu_ops(2.3, hist)
    ibound = roof(mvm.work_direct(n, n, 3, (fp32, sfu)))
    res.update(call_ms=call, ms=dev, plain_ms=plain_s * 1e3, bound=roof(work),
               pct=summ["roofline_pct"], interp_call_ms=icall, interp_ms=idev, ibound=ibound,
               ops=(fp32, sfu), cols_call_ms=ccall, cols_ms=cdev, cols_bound=roof(wcols),
               cols_pct=summc["roofline_pct"], singles_ms=singles, cols_abs=float(
                   (got.double() - ref).abs().max()))
    print(f"phase 21a K1 n={n} d=3 N(0, I) (BASELINE config 1's shape), the tabulated family, "
          f"rows 0..4095: Matern(2.3) rel {res[2.3][0]:.3e} vs float64 plain, {res[2.3][1]:.3e} "
          f"vs the float64 reference; Matern(2.5) {res[2.5][0]:.3e} / {res[2.5][1]:.3e} (bound "
          f"{K1_BOUND:.0e}), vs MaternP(2)'s family instance {res['family']:.3e} (bound 1e-5); "
          f"Matern(2.3) {call:.4f} ms a call ({dev:.4f} ms device), bound {res['bound'][0]:.4f} "
          f"ms ({res['bound'][1]}, {mvm.profile_ops(spec)} fp32 and SFU an entry) = "
          f"{summ['roofline_pct']:.1f}% of device (valid); the interpreted instance "
          f"{icall:.4f} ms a call ({idev:.4f} ms device), the K_nu routine {fp32:.1f} fp32 + "
          f"{sfu:.2f} SFU an entry on this run's distances, bound {ibound[0]:.4f} ms "
          f"({ibound[1]}) = {100 * ibound[0] / idev:.1f}%; the many-column family p=16 "
          f"{ccall:.4f} ms a call ({cdev:.4f} ms device, one launch), 16 single-column launches "
          f"{singles:.4f} ms device, bound {res['cols_bound'][0]:.4f} ms "
          f"({res['cols_bound'][1]}) = {summc['roofline_pct']:.1f}%, rows 0..4095 rel "
          f"{cerr:.3e} vs the float64 reference; plain (float32, cfjax's quadrature, 32-row "
          f"blocks) {plain_s * 1e3:.1f} ms", flush=True)
    return res


def phase21b_k2(tk, mvm):
    """K2: Lengthscale(Matern(1.3), 4) at d = 64, n = 16384 (N(0, I) points,
    rows 16..31 rows 0..15 moved by 1e-3), through its tabulated family
    (`family_value` on K1's table) at each tier: against the float64
    reference and against the reference's profile on the tier's squared
    distances (`check_tiers`, the TIER_BOUND["K2"] limits), its launches
    counted under "expand_matern"; the interpreted instance (the K_nu
    opcodes) once, at "highest", against the same reference. Times and
    bounds of the family at "highest" and "default" and of the interpreted
    instance at "highest" (the K_nu routine's operations on this run's
    distances); the plain version's time (cfjax's quadrature)."""
    from cfjax_torch.kernels.profile_spec import FAMILY_MATERN_NU, to_spec
    from cfjax_torch.ops.tiles import tier_passes

    rng = np.random.default_rng(212)
    n, d = 16384, 64
    xs = rng.standard_normal((n, d))
    xs[16:32] = xs[:16] + 1e-3 * rng.standard_normal((16, d))
    x, a = cuda_tensor(xs), cuda_tensor(rng.standard_normal(n))
    k, kx = tk.Lengthscale(tk.Matern(1.3), 4.0), tk.Lengthscale(exact_matern(tk, 1.3), 4.0)
    spec = to_spec(k)[0]
    check(spec.family == FAMILY_MATERN_NU, "phase 21b: Lengthscale(Matern(1.3), 4) has no family")
    itp = dataclasses.replace(spec, family=0)
    with torch.no_grad():
        ref = mvm.gramian_matvec_direct_plain(kx, x.double(), x.double(), a.double(), block=256)
    tiers = tier_record()
    before = dict(mvm.LAUNCHES)
    outs = {}

    def fam(tier):
        outs[tier] = mvm.gramian_matvec_expand(k, x, x, a, precision=tier)
        return outs[tier]

    check_tiers(tiers, "K2", "phase 21b K2 Lengthscale(Matern(1.3), 4) d=64 (the family)", ref,
                fam, lambda tier: mvm.gramian_matvec_expand_plain(kx, x, x, a, precision=tier,
                                                                  block=256))
    moved = {key: mvm.LAUNCHES[key] - before[key] for key in before}
    check(moved["expand_matern"] == len(TIERS) and moved["expand"] == 0,
          f"phase 21b: the family did not launch at each tier: {moved}")
    out_i = mvm.gramian_matvec_expand(k, x, x, a, spec=itp)
    check(mvm.LAUNCHES["expand"] == before["expand"] + 1, "phase 21b: the interpreter's launch")
    err_i = rel(out_i, ref)
    check(err_i <= TIER_BOUND["K2"][1]["highest"], f"phase 21b: the interpreted instance "
          f"{err_i:.3e} vs float64 > {TIER_BOUND['K2'][1]['highest']:.0e}")
    abs_err = max(float((o.double() - ref).abs().max()) for o in [out_i, *outs.values()])
    hist = pair_histogram(x, x, scale=16.0)
    fp32, sfu = matern_nu_ops(1.3, hist)
    times = {}
    for tier in ("highest", "default"):
        call, dev = call_and_device_ms(lambda: mvm.gramian_matvec_expand(k, x, x, a,
                                                                         precision=tier))
        work = mvm.work_expand(n, n, d, mvm.profile_ops(spec), tier_passes(tier))
        summ = summarize(work, dev / 1e3)
        check(summ["valid"], f"phase 21b: {summ.get('why')}")
        times[tier] = (call, dev, roof(work))
    icall, idev = call_and_device_ms(lambda: mvm.gramian_matvec_expand(k, x, x, a, spec=itp))
    ibound = roof(mvm.work_expand(n, n, d, (fp32, sfu), tier_passes("highest")))
    with torch.no_grad():
        _, plain_s = sync_time(lambda: mvm.gramian_matvec_expand_plain(k, x, x, a, block=64))
    mvm.LAUNCHES.update(before)   # the checks and timings are not the path's
    print(f"phase 21b K2 Lengthscale(Matern(1.3), 4) n={n} d={d}, 16 coincident and 16 "
          f"near-coincident rows, the tabulated family: {tier_text(tiers, 'K2')}; the "
          f"interpreted instance (K_nu opcodes) {err_i:.3e} vs float64; max abs "
          f"{abs_err:.3e}; " + "; ".join(
              f"family {tier} {c:.4f} ms a call ({dv:.4f} device), bound {b[0]:.4f} ms ({b[1]}, "
              f"{mvm.profile_ops(spec)} fp32 and SFU an entry) = {100 * b[0] / dv:.1f}% of device"
              for tier, (c, dv, b) in times.items()) +
          f"; the interpreted instance at highest {icall:.4f} ms a call ({idev:.4f} device), "
          f"the K_nu routine {fp32:.1f} fp32 + {sfu:.2f} SFU an entry, bound {ibound[0]:.4f} ms "
          f"({ibound[1]}) = {100 * ibound[0] / idev:.1f}%; plain (float32, cfjax's quadrature) "
          f"{plain_s * 1e3:.1f} ms", flush=True)
    return dict(tiers=tiers, times=times, abs_err=abs_err, ops=(fp32, sfu), interp=(icall, idev),
                ibound=ibound, plain_ms=plain_s * 1e3)


def k3_matern_reference(nu, x, y, A, precision=None, block=256):
    """The gradient-block product of Matern(nu) (grad_matvec_plain's closed
    form) with f' and f'' from the kernels' method in float64
    (`matern_nu_reference`), the products at `precision`."""
    from cfjax_torch.ops.tiles import inner_tile, map_rows, matmul_p, sqdist_tile
    from cfjax_torch.utils.besselk import matern_nu_reference

    t = torch.sum(y * A, dim=1)

    def body(xb):
        s = sqdist_tile(xb, y, precision)
        _, f1, f2 = (v.to(xb.dtype) for v in matern_nu_reference(nu, s.double()))
        W = f2 * (inner_tile(xb, A, precision) - t[None, :])
        return -2.0 * matmul_p(f1, A, precision) - 4.0 * (torch.sum(W, dim=1)[:, None] * xb
                                                          - matmul_p(W, y, precision))

    return map_rows(body, x, block, x.shape[1])


def phase21c_k3(tk, gmvm):
    """K3: GradientKernel(Matern(2.7)) at BASELINE config 4's shape (n =
    4096, d = 16, 0.5 N(0, I) points; the gradient gramian of x with
    itself: every diagonal pair coincident, and rows 16..31 rows 0..15
    moved by 1e-3 / sqrt(d)), and Matern(1.5), through the tabulated jet
    family (two tables of nu) at each tier against the float64 reference
    and the reference's jet on the tier's products (`check_tiers`, the K3
    limits), its launches counted under "grad_matern"; the interpreted
    instance (the K_nu jet opcodes) once, Matern(2.7) at "highest"; K3
    against the float64 plain version (cfjax's quadrature, autograd's
    jet) on rows 0..255, reported; times and bounds of Matern(2.7) through
    the family and the interpreted instance; the plain version's time."""
    from cfjax_torch.kernels.profile_spec import FAMILY_MATERN_NU, to_spec
    from cfjax_torch.ops import gramian_mvm as mvm
    from cfjax_torch.ops.tiles import tier_passes

    rng = np.random.default_rng(213)
    n, d = 4096, 16
    xs = 0.5 * rng.standard_normal((n, d))
    xs[16:32] = xs[:16] + 1e-3 * rng.standard_normal((16, d)) / np.sqrt(d)
    x, A = cuda_tensor(xs), cuda_tensor(rng.standard_normal((n, d)))
    tiers, plain_err, out, abs_err = tier_record(), {}, {}, 0.0
    before = dict(mvm.LAUNCHES)
    for nu in (2.7, 1.5):
        k = tk.Matern(nu)
        check(to_spec(k, derivative=True)[0].family == FAMILY_MATERN_NU,
              f"phase 21c: Matern({nu}) has no jet family")
        ref = k3_matern_reference(nu, x.double(), x.double(), A.double())
        outs = {}

        def fam(tier, k=k, outs=outs):
            outs[tier] = gmvm.grad_matvec(k, x, x, A, precision=tier)
            return outs[tier]

        check_tiers(tiers, "K3", f"phase 21c K3 Matern({nu}) n={n} d={d} (the family)", ref, fam,
                    lambda tier: k3_matern_reference(nu, x, x, A, precision=tier))
        out[nu] = outs["highest"]
        abs_err = max([abs_err] + [float((o.double() - ref).abs().max()) for o in outs.values()])
        with torch.no_grad():
            plain = gmvm.grad_matvec_plain(k, x[:256].double(), x.double(), A.double(), block=8)
        plain_err[nu] = (rel(out[nu][:256], plain), rel(plain, ref[:256]))
        if nu == 2.7:
            ref27 = ref
    moved = {key: mvm.LAUNCHES[key] - before[key] for key in before}
    check(moved["grad_matern"] == 2 * len(TIERS) and moved["grad"] == 0,
          f"phase 21c: the family did not launch at each tier: {moved}")
    k = tk.Matern(2.7)
    spec = to_spec(k, derivative=True)[0]
    itp = dataclasses.replace(spec, family=0)
    out_i = gmvm.grad_matvec(k, x, x, A, spec=itp)
    check(mvm.LAUNCHES["grad"] == before["grad"] + 1, "phase 21c: the interpreter's launch")
    err_i = rel(out_i, ref27)
    check(err_i <= TIER_BOUND["K3"][1]["highest"], f"phase 21c: the interpreted instance "
          f"{err_i:.3e} vs float64 > {TIER_BOUND['K3'][1]['highest']:.0e}")
    abs_err = max(abs_err, float((out_i.double() - ref27).abs().max()))
    times = {}
    hist = pair_histogram(x, x)
    fp32, sfu = matern_nu_ops(2.7, hist, jet=True)
    for tier in ("highest", "default"):
        call, dev = call_and_device_ms(lambda: gmvm.grad_matvec(k, x, x, A, precision=tier))
        work = gmvm.work_grad(n, n, d, gmvm.jet_ops(spec), tier_passes(tier))
        summ = summarize(work, dev / 1e3)
        check(summ["valid"], f"phase 21c: {summ.get('why')}")
        times[tier] = (call, dev, roof(work))
    icall, idev = call_and_device_ms(lambda: gmvm.grad_matvec(k, x, x, A, spec=itp))
    ibound = roof(gmvm.work_grad(n, n, d, (fp32, sfu), tier_passes("highest")))
    with torch.no_grad():
        _, plain_s = sync_time(lambda: gmvm.grad_matvec_plain(k, x, x, A, block=64))
    mvm.LAUNCHES.update(before)   # the checks and timings are not the path's
    print(f"phase 21c K3 GradientKernel(Matern(2.7)) and (Matern(1.5)) n={n} d={d} (config 4's "
          f"shape, coincident and near-coincident pairs), the tabulated jet family: "
          f"{tier_text(tiers, 'K3')}; the interpreted instance (K_nu jet opcodes) {err_i:.3e} vs "
          f"float64; max abs {abs_err:.3e}; against the float64 plain version (cfjax's "
          f"quadrature, autograd's jet) on rows 0..255: " + ", ".join(
              f"Matern({nu}) {e:.3e} (the plain version vs the reference {p:.3e})"
              for nu, (e, p) in plain_err.items()) + "; " + "; ".join(
              f"family {tier} {c:.4f} ms a call ({dv:.4f} device), bound {b[0]:.4f} ms ({b[1]}, "
              f"{gmvm.jet_ops(spec)} fp32 and SFU a pair's jet) = {100 * b[0] / dv:.1f}% of device"
              for tier, (c, dv, b) in times.items()) +
          f"; the interpreted instance at highest {icall:.4f} ms a call ({idev:.4f} device), the "
          f"K_nu jet {fp32:.1f} fp32 + {sfu:.2f} SFU an entry, bound {ibound[0]:.4f} ms "
          f"({ibound[1]}) = {100 * ibound[0] / idev:.1f}%; plain (float32, autograd through "
          f"cfjax's quadrature) {plain_s * 1e3:.1f} ms", flush=True)
    return dict(tiers=tiers, times=times, ops=(fp32, sfu), abs_err=abs_err, interp=(icall, idev),
                ibound=ibound, plain_ms=plain_s * 1e3)


def phase21d_solve(tk, ops, gp, mvm):
    """gp_condition(Lengthscale(Matern(2.3), 1), x, y) at n = 2^15, d = 3,
    N(0, I) points, y = sin(x_0) + 0.01 N(0, 1): above max_cholesky_size,
    so Nystrom PCG through K1's tabulated Matern family (counted under
    "matern"); the float64 residual of alpha on 4096 rows through the
    float64 reference (<= 2e-4)."""
    from cfjax_torch.kernels.profile_spec import to_spec

    rng = np.random.default_rng(214)
    n = 1 << 15
    x = cuda_tensor(rng.standard_normal((n, 3)))
    y = torch.sin(x[:, 0]) + Y_NOISE * cuda_tensor(rng.standard_normal(n))
    k = tk.Lengthscale(tk.Matern(2.3), 1.0)
    how = ops.explain(k, x)
    check("K1 gramian_matvec_direct (family instance)" in how, f"phase 21d: explain() {how!r}")
    before = mvm.LAUNCHES["matern"]
    torch.cuda.reset_peak_memory_stats()
    post, wall = sync_time(lambda: gp.gp_condition(k, x, y, noise=NOISE, tol=1e-5, maxiter=500))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = mvm.LAUNCHES["matern"] - before
    it = int(post.solve_info[0])
    check(it < 500 and launches >= it, f"phase 21d: {it} PCG iterations, {launches} K1 launches")
    rows = slice(4096)
    with torch.no_grad():
        Ka = mvm.gramian_matvec_direct_plain(tk.Lengthscale(exact_matern(tk, 2.3), 1.0),
                                             x[rows].double(), x.double(),
                                             post.alpha.double(), block=64)
    res64 = float(torch.linalg.norm(Ka + NOISE * post.alpha[rows].double() - y[rows].double())
                  / torch.linalg.norm(y[rows].double()))
    check(res64 <= 2e-4, f"phase 21d: float64 residual on 4096 rows {res64:.3e} > 2e-4")
    a = cuda_tensor(rng.standard_normal(n))
    call, dev = call_and_device_ms(lambda: mvm.gramian_matvec_direct(k, x, x, a), reps=5)
    mvm.LAUNCHES["matern"] = before + launches
    work = mvm.work_direct(n, n, 3, mvm.profile_ops(to_spec(k)[0]))
    summ = summarize(work, dev / 1e3)
    check(summ["valid"], f"phase 21d: {summ.get('why')}")
    bound = roof(work)
    print(f"phase 21d gp_condition Lengthscale(Matern(2.3), 1) n={n} d=3 noise {NOISE}: "
          f"{it} Nystrom-PCG iterations, {launches} K1 launches of the tabulated family, "
          f"{wall:.3f} s (peak {peak:.2f} GiB), "
          f"float64 residual on 4096 rows {res64:.3e} (bound 2e-4); K1 at this shape "
          f"{call:.3f} ms a call ({dev:.3f} ms device), bound {bound[0]:.3f} ms ({bound[1]}) = "
          f"{summ['roofline_pct']:.1f}% of device (valid) | {how}", flush=True)
    return dict(iters=it, wall=wall, res64=res64, call_ms=call, ms=dev, launches=launches,
                bound=bound)


def timed_cg(gp):
    """Wrap the GP module's `cg` to time each call (to a synchronize); the
    walls land in the returned list. Undo with `gp_regression.cg =
    walls.cg`."""
    import cfjax_torch.gp.regression as gp_regression

    walls, inner = [], gp_regression.cg

    def cg(*args, **kw):
        out, wall = sync_time(lambda: inner(*args, **kw))
        walls.append(wall)
        return out

    gp_regression.cg = cg
    return walls, lambda: setattr(gp_regression, "cg", inner)


def phase21e_k2_solve(tk, ops, gp, mvm):
    """gp_condition(Lengthscale(Matern(1.3), 4), x, y, noise=1e-2) at n =
    2^15, d = 64, x ~ N(0, I), y = sin(x_0) + 0.1 N(0, 1): above
    max_cholesky_size, so Nystrom PCG at the default rank through K2's
    tabulated Matern family (counted under "expand_matern"; the Nystrom
    panel through the family's plain version). explain() names the family;
    its launches cover the iterations; the float64 residual on 4096 rows
    through the float64 reference <= 2e-4. The wall, the PCG's share, K2's
    device ms a call."""
    rng = np.random.default_rng(215)
    n, d = 1 << 15, 64
    x = cuda_tensor(rng.standard_normal((n, d)))
    y = torch.sin(x[:, 0]) + 0.1 * cuda_tensor(rng.standard_normal(n))
    k = tk.Lengthscale(tk.Matern(1.3), 4.0)
    how = ops.explain(k, x)
    check("cuda kernel K2 gramian_matvec_expand (family instance: the real-nu Matern's table"
          in how, f"phase 21e: explain() {how!r}")
    before = mvm.LAUNCHES["expand_matern"]
    walls, undo = timed_cg(gp)
    torch.cuda.reset_peak_memory_stats()
    try:
        post, wall = sync_time(lambda: gp.gp_condition(k, x, y, noise=NOISE, tol=1e-5,
                                                       maxiter=500))
    finally:
        undo()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = mvm.LAUNCHES["expand_matern"] - before
    it = int(post.solve_info[0])
    check(len(walls) == 1 and it < 500 and launches >= it,
          f"phase 21e: {it} PCG iterations, {launches} K2 launches, {len(walls)} PCG calls")
    rows = slice(4096)
    with torch.no_grad():
        Ka = mvm.gramian_matvec_direct_plain(tk.Lengthscale(exact_matern(tk, 1.3), 4.0),
                                             x[rows].double(), x.double(),
                                             post.alpha.double(), block=64)
    res64 = float(torch.linalg.norm(Ka + NOISE * post.alpha[rows].double() - y[rows].double())
                  / torch.linalg.norm(y[rows].double()))
    check(res64 <= 2e-4, f"phase 21e: float64 residual on 4096 rows {res64:.3e} > 2e-4")
    a = cuda_tensor(rng.standard_normal(n))
    with mvm.uncounted():
        call, dev = call_and_device_ms(lambda: mvm.gramian_matvec_expand(k, x, x, a), reps=5)
    print(f"phase 21e gp_condition Lengthscale(Matern(1.3), 4) n={n} d={d} noise {NOISE}: {it} "
          f"Nystrom-PCG iterations, {launches} K2 launches of the tabulated family, {wall:.3f} s "
          f"(the PCG {walls[0]:.3f} s = {100 * walls[0] / wall:.1f}%; peak {peak:.2f} GiB), "
          f"float64 residual on 4096 rows {res64:.3e} (bound 2e-4); K2 at this shape "
          f"{call:.3f} ms a call ({dev:.3f} ms device) | {how}", flush=True)
    return dict(iters=it, wall=wall, pcg=walls[0], res64=res64, launches=launches, ms=dev,
                call_ms=call, peak=peak)


def phase21f_k3_solve(tk, ops, gp, mvm):
    """gp_condition(GradientKernel(Matern(2.7)), x, g, noise=1e-3, tol=1e-6,
    maxiter=200) at n = d = 1024, x ~ N(0, I), g the gradients of sin(x_0)
    stacked point-major plus 0.01 N(0, 1): the system of `run_baseline`'s
    gradient_solve_maternp2_n1024_d1024 row with Matern(2.7), CG through
    K3's tabulated jet family (counted under "grad_matern"; a gradient
    gramian takes no Nystrom preconditioner). Its launches cover the
    iterations; the float64 residual through the float64 reference's jet
    <= SOLVE_BOUND."""
    from cfjax_torch.derivative import GradientKernel

    rng = np.random.default_rng(216)
    n = d = 1024
    x = cuda_tensor(rng.standard_normal((n, d)))
    g = torch.zeros((n, d), device="cuda")
    g[:, 0] = torch.cos(x[:, 0])
    g = (g + Y_NOISE * cuda_tensor(rng.standard_normal((n, d)))).reshape(-1)
    k = GradientKernel(tk.Matern(2.7))
    how = ops.explain(k, x)
    check("cuda kernel K3 grad_matvec (family instance: the real-nu Matern's table" in how,
          f"phase 21f: explain() {how!r}")
    before = dict(mvm.LAUNCHES)
    post, wall = sync_time(lambda: gp.gp_condition(k, x, g, noise=1e-3, tol=1e-6, maxiter=200))
    launches = mvm.LAUNCHES["grad_matern"] - before["grad_matern"]
    it = int(post.solve_info[0])
    check(it < 200 and launches >= it and mvm.LAUNCHES["grad"] == before["grad"],
          f"phase 21f: {it} CG iterations, {launches} launches of K3's Matern family, "
          f"{mvm.LAUNCHES['grad'] - before['grad']} of other K3 instances")
    al = post.alpha.double().reshape(n, d)
    Ka = k3_matern_reference(2.7, x.double(), x.double(), al).reshape(-1)
    res64 = float(torch.linalg.norm(Ka + 1e-3 * post.alpha.double() - g.double())
                  / torch.linalg.norm(g.double()))
    check(res64 <= SOLVE_BOUND["highest"],
          f"phase 21f: float64 residual {res64:.3e} > {SOLVE_BOUND['highest']:.0e}")
    A, G = cuda_tensor(rng.standard_normal((n, d))), ops.gramian(k, x)
    with mvm.uncounted():
        call, dev = call_and_device_ms(lambda: G._apply(A), reps=5)
    print(f"phase 21f gp_condition GradientKernel(Matern(2.7)) n=d={n} noise 1e-3 tol 1e-6: "
          f"{it} CG iterations, {launches} K3 launches of the tabulated jet family, {wall:.3f} s, "
          f"float64 residual {res64:.3e} (bound {SOLVE_BOUND['highest']:.0e}); K3 at this shape "
          f"{call:.3f} ms a call ({dev:.3f} ms device) | {how}", flush=True)
    return dict(iters=it, wall=wall, res64=res64, launches=launches, ms=dev, call_ms=call)


def config5_data(n, seed=22):
    """BASELINE config 5's data law (examples/northstar_demo.py): n points
    uniform on [-10, 10]^2, float32, on the card, y = sin(x_0) cos(x_1 / 2)
    + 0.1 N(0, 1)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = 20 * torch.rand((n, 2), generator=g, device="cuda") - 10
    y = torch.sin(x[:, 0]) * torch.cos(0.5 * x[:, 1]) + 0.1 * torch.randn(
        n, generator=g, device="cuda")
    return x, y


def config5_logpost(tk, gp, x, y, counter, **slq):
    """log p(theta) = logML of exp(log v) Lengthscale(EQ(), exp(log l)) with
    noise 0.01 at (x, y), minus |theta|^2 / 2; theta = (log l, log v)
    float64 on the host. Counts its calls in counter["evals"]."""
    def logpost(theta):
        counter["evals"] += 1
        k = tk.Lengthscale(tk.EQ(), torch.exp(theta[0])) * torch.exp(theta[1])
        lml = gp.log_marginal_likelihood(k, x, y, noise=0.01, **slq)
        return lml.double().cpu() - 0.5 * torch.sum(theta ** 2)
    return logpost


def chain_text(label, wall, evals, astat, samples):
    m, sd = samples.mean(0).tolist(), samples.std(0).tolist()
    return (f"{label} {wall:.1f} s, {evals} log-density evaluations ({1e3 * wall / evals:.1f} ms "
            f"each), accept-stat {astat:.3f}, log l {m[0]:.4f} +- {sd[0]:.4f}, log v {m[1]:.4f} "
            f"+- {sd[1]:.4f}")


def phase22_subset_chain(tk, gp, hmc):
    """BASELINE config 5's hyperparameter inference on the exact subset, as
    the north-star demo runs it, uncut: n = 2^20 points, a subset of m =
    4096, the Cholesky logML (float32 on the card) under a standard normal
    prior on (log l, log v). NUTS (128 warmup, 128 samples, tree depth 6,
    from 0), then HMC (32 + 32, 16 leapfrog steps). Checks: finite samples,
    NUTS's accept-stat in [0.5, 1], and at the chain's mean the float32
    log density within 1e-4 of float64's on the card (relative), its
    gradient within 1e-4 of the scale of the gradient's two terms (the
    data fit's and the log determinant's, float64: at the mean they
    cancel)."""
    from cfjax_torch.operators import gramian

    x, y = config5_data(1 << 20)
    idx = torch.as_tensor(np.random.default_rng(22).choice(x.shape[0], 4096, replace=False),
                          device="cuda")
    xs, ys = x[idx].contiguous(), y[idx].contiguous()
    del x, y
    cnt = {"evals": 0}
    logpost = config5_logpost(tk, gp, xs, ys, cnt)
    (s_nuts, a_nuts), w_nuts = sync_time(lambda: hmc.nuts_sample(
        logpost, torch.zeros(2, dtype=torch.float64), torch.Generator().manual_seed(1),
        num_samples=128, num_warmup=128, max_tree_depth=6))
    e_nuts, cnt["evals"] = cnt["evals"], 0
    (s_hmc, a_hmc), w_hmc = sync_time(lambda: hmc.hmc_sample(
        logpost, torch.zeros(2, dtype=torch.float64), torch.Generator().manual_seed(2),
        num_samples=32, num_warmup=32, num_leapfrog=16))
    e_hmc = cnt["evals"]
    check(bool(torch.isfinite(s_nuts).all() and torch.isfinite(s_hmc).all()),
          "phase 22: non-finite samples")
    check(0.5 <= float(a_nuts) <= 1.0, f"phase 22: NUTS accept-stat {float(a_nuts):.3f}")
    # the log density and its gradient at NUTS's mean: float32 against float64
    mean = s_nuts.mean(0)
    vals = {}
    for dt in (torch.float32, torch.float64):
        th = mean.clone().requires_grad_(True)
        v = config5_logpost(tk, gp, xs.to(dt), ys.to(dt), {"evals": 0})(th)
        (g,) = torch.autograd.grad(v, th)
        vals[dt] = (float(v.detach()), g)
    th = mean.clone().requires_grad_(True)
    k = tk.Lengthscale(tk.EQ(), torch.exp(th[0])) * torch.exp(th[1])
    K = gramian(k, xs.double()).todense()
    L = torch.linalg.cholesky(K + 0.01 * torch.eye(K.shape[0], dtype=K.dtype, device=K.device))
    z = torch.linalg.solve_triangular(L, ys.double()[:, None], upper=False)
    g_fit = torch.autograd.grad(0.5 * torch.sum(z * z), th, retain_graph=True)[0]
    g_det = torch.autograd.grad(torch.sum(torch.log(torch.diagonal(L))), th)[0]
    scale = float(torch.linalg.norm(g_fit) + torch.linalg.norm(g_det))
    (v32, g32), (v64, g64) = vals[torch.float32], vals[torch.float64]
    err_v = abs(v32 - v64) / abs(v64)
    err_g = float(torch.linalg.norm(g32 - g64)) / scale
    check(err_v <= 1e-4 and err_g <= 1e-4,
          f"phase 22: float32 log density {v32:.8e} vs float64 {v64:.8e} (rel {err_v:.3e}), "
          f"gradient {g32.tolist()} vs {g64.tolist()} ({err_g:.3e} of the terms' scale "
          f"{scale:.3e}; bound 1e-4)")
    print(f"phase 22 config 5's exact-subset chain (n = 2^20 uniform on [-10, 10]^2, m = 4096, "
          f"Cholesky logML float32 on the card, EQ, noise 0.01, N(0, I) prior on (log l, log v)): "
          f"{chain_text('NUTS 128 + 128, depth 6:', w_nuts, e_nuts, float(a_nuts), s_nuts)}; "
          f"{chain_text('HMC 32 + 32, 16 leapfrog steps:', w_hmc, e_hmc, float(a_hmc), s_hmc)}; "
          f"at NUTS's mean float32 vs float64: log density {v32:.8e} / {v64:.8e} (rel "
          f"{err_v:.3e}), gradient {[round(v, 6) for v in g32.tolist()]} / "
          f"{[round(v, 6) for v in g64.tolist()]} ({err_g:.3e} of its terms' scale "
          f"{scale:.3e}; bound 1e-4 each)", flush=True)
    return dict(mean=mean, sd=s_nuts.std(0), w_nuts=w_nuts, e_nuts=e_nuts, a_nuts=float(a_nuts),
                w_hmc=w_hmc, e_hmc=e_hmc, a_hmc=float(a_hmc))


def phase23_host_chain(tk, gp, hmc, mvm, slq, p22):
    """nuts_sample_host over the lazy slq logML at n = 2^16 (config 5's data
    law, kernel and prior), with the north-star demo's knobs (2 probes, 10
    Lanczos steps, solves to 3e-2 in at most 15 iterations; 3 warmup, 8
    samples, tree depth 2, initial step 0.02), from phase 22's posterior
    mean. Reports the wall of an evaluation by stage (`slq_stages`), the
    evaluations, the accept-stat and log l's mean beside phase 22's;
    checks finite samples and that the many-column K1 and K1 ran."""
    x, y = config5_data(1 << 16, seed=23)
    cnt = {"evals": 0}
    logpost = config5_logpost(tk, gp, x, y, cnt, probes=2, lanczos_iters=10, solve_tol=3e-2,
                              solve_maxiter=15)
    before = dict(mvm.LAUNCHES)
    with slq_stages(slq, 15) as st:
        (s, a), wall = sync_time(lambda: hmc.nuts_sample_host(
            logpost, p22["mean"], 3, num_samples=8, num_warmup=3, max_tree_depth=2,
            init_step=0.02))
    cols = mvm.LAUNCHES["direct_cols"] - before["direct_cols"]
    one = mvm.LAUNCHES["direct"] - before["direct"]
    e = cnt["evals"]
    check(bool(torch.isfinite(s).all()), "phase 23: non-finite samples")
    # the estimator's gradient against a central difference of its value,
    # along log l, at the start and at the step size: a leapfrog step is
    # accepted only where the two agree
    th0 = p22["mean"].clone()
    g = hmc._value_and_grad(logpost, th0)[1]
    h = torch.tensor([0.02, 0.0], dtype=torch.float64)
    fd = (hmc._value(logpost, th0 + h) - hmc._value(logpost, th0 - h)) / 0.04
    check(cols > 0 and one > 0, f"phase 23: many-column K1 {cols}, K1 {one} launches")
    per = {key: st[key] / e for key in ("lanczos_s", "cols_s", "quad_s", "vjp_s")}
    m, sd = float(s[:, 0].mean()), float(s[:, 0].std())
    print(f"phase 23 host NUTS over the slq logML (n = 2^16, config 5's data law, kernel and "
          f"prior; 2 probes, 10 Lanczos steps, solve_tol 3e-2, solve_maxiter 15; 3 warmup, 8 "
          f"samples, depth 2, step 0.02, from phase 22's mean): {wall:.1f} s, {e} evaluations, "
          f"{wall / e:.3f} s each: Lanczos {per['lanczos_s']:.3f} s, cg_columns "
          f"{per['cols_s']:.3f} s, the quadratic form's CG {per['quad_s']:.3f} s, the VJP (plain) "
          f"{per['vjp_s']:.3f} s; accept-stat {float(a):.3f}; log l {m:.4f} +- {sd:.4f} (phase "
          f"22's exact subset: {float(p22['mean'][0]):.4f} +- {float(p22['sd'][0]):.4f}); "
          f"launches: many-column K1 {cols}, K1 {one}; at the start d/dlog l {float(g[0]):.4e} "
          f"(the estimator's gradient) against {fd:.4e} (a central difference of its value at "
          f"+-0.02)", flush=True)
    return dict(wall=wall, evals=e, per=per, launches=(cols, one), grad=float(g[0]), fd=fd,
                astat=float(a))


# ---------------------------------------------------------------------------
# Phase 24: the parallel layer (cfjax_torch.parallel) on torch.distributed
# ---------------------------------------------------------------------------

# a sharded product against the single-GPU operator's on the same inputs
# (relative L2): float32, and the float64 Kronecker product
SHARD_BOUND = 1e-6
SHARD_BOUND64 = 1e-12
PARALLEL_RANKS = 4   # 24b: ranks sharing the one card over gloo, a 2 x 2 mesh


def collective_checks(mesh):
    """The three collectives of the parallel layer's helpers on CUDA tensors,
    each held to its value: `_psum` (all_reduce) and `_psum_scatter`
    (reduce_scatter, list form) over "cols", `_gather_rows` (all_gather, list
    form) over "rows". Returns (what ran, over which backend)."""
    import torch.distributed as dist
    from cfjax_torch.parallel.mesh import _coord, _gather_rows, _psum, _psum_scatter

    nc, c = _coord(mesh, "cols")
    nr, r = _coord(mesh, "rows")
    base = torch.arange(4 * nc, dtype=torch.float32, device="cuda")
    s = _psum(base + c, mesh, "cols")
    check(torch.equal(s, nc * base + nc * (nc - 1) / 2), "phase 24b: all_reduce over gloo on CUDA")
    rs = _psum_scatter(base + c, mesh, "cols")
    check(torch.equal(rs, s.chunk(nc)[c]), "phase 24b: reduce_scatter over gloo on CUDA")
    g = _gather_rows(torch.full((3, 2), float(r), device="cuda"), mesh, "rows", 3 * nr)
    check(torch.equal(g[:, 0], torch.arange(nr, device="cuda").repeat_interleave(3).float()),
          "phase 24b: all_gather over gloo on CUDA")
    return ("all_reduce, reduce_scatter (list form), all_gather (list form)",
            str(dist.get_backend(mesh.get_group("cols"))))


def collective_ms(mesh, n, reps=20):
    """ms of one sharded MVM's collectives at n rows on the 2-D mesh: the
    psum of an (n / rows) partial over "cols", then the all-gather of the
    row blocks; host clock around `reps` rounds ending in a synchronize."""
    from cfjax_torch.parallel.mesh import _coord, _gather_rows, _psum

    nr, _ = _coord(mesh, "rows")
    part = torch.ones(n // nr, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        _gather_rows(_psum(part, mesh, "cols"), mesh, "rows", n)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def same_on_every_rank(label, t):
    """Checks that `t` is bit for bit the same on every rank."""
    import torch.distributed as dist

    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t.contiguous())
    check(all(torch.equal(p, parts[0]) for p in parts), f"{label}: the ranks disagree")


def phase24b_rank(data):
    """Phase 24b on each rank of a gloo world whose ranks share the card:
    the dry run, the 2-D PCG at n = 2^17, a 1-D ShardedGramian MVM at n =
    2^17, config 4's gradient CG on the 2-D mesh with the column sum, the
    Kronecker MVM at 128^3, the Toeplitz matmat with 16 columns and the
    Barnes-Hut MVM at n = 10^5. Counts its own launches from zero; the
    single-GPU products it is held to (plain torch) launch nothing. Rank 0
    returns the results, every rank's launches and times."""
    import torch.distributed as dist

    import cfjax_torch.kernels as tk
    import cfjax_torch.operators as ops
    from cfjax_torch import parallel as par
    from cfjax_torch.barneshut import BarnesHutFactorization
    from cfjax_torch.operators.preconditioner import nystrom_preconditioner
    from cfjax_torch.operators.solvers import cg
    from cfjax_torch.ops import gramian_mvm as mvm
    from cfjax_torch.parallel.dryrun import dryrun_multichip
    from cfjax_torch.parallel.mesh import sharded_gramian_matvec_2d
    from cfjax_torch.utils.grids import LazyGrid, UniformGrid

    mesh2 = par.init_distributed()
    mesh1 = par.default_mesh()
    check(tuple(mesh2.mesh.shape) == (2, 2), f"phase 24b: mesh {tuple(mesh2.mesh.shape)}")
    coll = collective_checks(mesh2)
    out = {"collectives": coll}
    for key in mvm.LAUNCHES:
        mvm.LAUNCHES[key] = 0
    t_path = time.perf_counter()

    dry, out["dry_s"] = sync_time(lambda: dryrun_multichip(PARALLEL_RANKS))
    out["dry"] = {key: dry[key] for key in ("loss", "cg_iters", "grad_iters", "pcg_iters")}

    # the 2-D PCG at n = 2^17: phase 3's points, kernel, noise and preconditioner
    k = tk.MaternP(2)
    x, y = cuda_tensor(data["x3"]), cuda_tensor(data["y3"])
    M = nystrom_preconditioner(k, x, NOISE, rank=512)
    mv = lambda v: sharded_gramian_matvec_2d(k, x, x, v, "iso", mesh2) + NOISE * v
    before = mvm.LAUNCHES["direct"]
    (alpha, (it, _)), out["pcg_s"] = sync_time(lambda: cg(mv, y, tol=1e-5, maxiter=500, M=M))
    out["pcg_launches"] = mvm.LAUNCHES["direct"] - before
    check(out["pcg_launches"] == it + 1,
          f"phase 24b: {out['pcg_launches']} K1 launches for {it} PCG iterations")
    same_on_every_rank("phase 24b PCG", alpha)
    out["pcg_iters"], out["alpha"] = it, alpha
    out["coll_ms"] = collective_ms(mesh2, x.shape[0])

    # a 1-D ShardedGramian MVM at n = 2^17 against the parent's single-GPU K1
    G = par.ShardedGramian(k, x, mesh=mesh1)
    check(G.kernel_reason is None and G.kernel == "direct",
          f"phase 24b: the 1-D shard does not run K1: {G.kernel_reason}")
    b1, out["mvm1_s"] = sync_time(lambda: G @ cuda_tensor(data["a3"]))
    ref = torch.as_tensor(data["ref1"], device="cuda")
    out["mvm1_err"] = rel(b1, ref.double())
    out["mvm1_max"] = float((b1 - ref).abs().max())
    check(out["mvm1_err"] <= SHARD_BOUND, f"phase 24b: 1-D MVM rel {out['mvm1_err']:.3e}")

    # config 4's gradient CG: rows on "rows", the column sum on "cols"
    x7, y7 = cuda_tensor(data["x7"]), cuda_tensor(data["y7"])
    Gg = par.ShardedGradientGramian(tk.EQ(), x7, mesh=mesh2, row_axis="rows", col_axis="cols")
    check(Gg.kernel_reason is None, f"phase 24b: the gradient shard declines K3: {Gg.kernel_reason}")
    before = mvm.LAUNCHES["grad"]
    (alpha_g, (it_g, _)), out["grad_s"] = sync_time(
        lambda: cg(lambda v: Gg @ v + NOISE * v, y7, tol=1e-5, maxiter=1000))
    out["grad_launches"] = mvm.LAUNCHES["grad"] - before
    check(out["grad_launches"] == it_g + 1,
          f"phase 24b: {out['grad_launches']} K3 launches for {it_g} CG iterations")
    same_on_every_rank("phase 24b gradient CG", alpha_g)
    out["grad_iters"], out["alpha_g"] = it_g, alpha_g

    # config 3's Kronecker MVM at 128^3 (float64, phase 14's solve dtype)
    m = 128
    grid = LazyGrid(tuple(UniformGrid(0.0, 1.0 / m, m) for _ in range(3)), device="cuda",
                    dtype=torch.float64)
    K = ops.gramian(tk.separable("^", tk.EQ(), d=3), grid)
    a = torch.as_tensor(np.random.default_rng(24).standard_normal(m ** 3), device="cuda")
    bk, out["kron_s"] = sync_time(lambda: par.sharded_kronecker_matvec(K, a, mesh1))
    out["kron_err"] = rel(bk, K @ a)
    check(out["kron_err"] <= SHARD_BOUND64, f"phase 24b: Kronecker rel {out['kron_err']:.3e}")

    # config 2's Toeplitz at n = 65536 with 16 columns
    n2 = 65536
    T = ops.gramian(tk.Exp(), UniformGrid(0.0, 1.0 / n2, n2, device="cuda", dtype=torch.float32))
    V = cuda_tensor(np.random.default_rng(25).standard_normal((n2, 16)))
    bt, out["toep_s"] = sync_time(lambda: par.sharded_toeplitz_matmat(T, V, mesh1))
    out["toep_err"] = rel(bt, (T @ V).double())
    check(out["toep_err"] <= SHARD_BOUND, f"phase 24b: Toeplitz rel {out['toep_err']:.3e}")

    # Barnes-Hut at n = 10^5, theta 1/2, as phase 18 builds it
    r = np.random.default_rng(26)
    xb, wb = cuda_tensor(r.standard_normal((100_000, 2))), cuda_tensor(r.uniform(0, 1, 100_000))
    F, out["bh_build_s"] = sync_time(lambda: BarnesHutFactorization(tk.EQ(), xb, theta=0.5))
    F.plans   # the host sweep, before the timed MVM
    bb, out["bh_s"] = sync_time(lambda: par.sharded_bh_matvec(F, wb, mesh1))
    out["bh_err"] = rel(bb, (F @ wb).double())
    check(out["bh_err"] <= SHARD_BOUND, f"phase 24b: Barnes-Hut rel {out['bh_err']:.3e}")

    torch.cuda.synchronize()
    out["path_s"] = time.perf_counter() - t_path
    mine = {"launches": dict(mvm.LAUNCHES), "path_s": out["path_s"]}
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)
    for i, rk in enumerate(ranks):
        check(rk["launches"]["direct"] > 0 and rk["launches"]["grad"] > 0,
              f"phase 24b: rank {i} launched K1 {rk['launches']['direct']}, K3 "
              f"{rk['launches']['grad']} times")
    out["ranks"] = ranks
    return out


def phase24a_nccl(tk, ops, mvm, p3, F18, w18):
    """24a, the production backend: NCCL at world size 1 in this process,
    through `init_distributed()` and `default_mesh()`. BASELINE config 1's
    lazy solve at full size (phase 3's points: ShardedGramian(MaternP(2))
    + noise I, the rank-512 Nystrom preconditioner, `sharded_cg`) beside
    the same solve through the single-GPU Gramian, and config 5's
    `sharded_bh_matvec` at n = 10^6 on phase 18's factorization. The
    single-GPU solve's launches are taken back out of the counts."""
    import torch.distributed as dist

    from cfjax_torch import parallel as par
    from cfjax_torch.operators.preconditioner import nystrom_preconditioner
    from cfjax_torch.operators.solvers import cg

    mesh2 = par.init_distributed()
    mesh = par.default_mesh()
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1
          and tuple(mesh2.mesh.shape) == (1, 1),
          f"phase 24a: {dist.get_backend()} world {dist.get_world_size()}, mesh "
          f"{tuple(mesh2.mesh.shape)}")
    k = tk.MaternP(2)
    x, y = p3["x"], p3["y"]
    M = nystrom_preconditioner(k, x, NOISE, rank=512)
    G = par.ShardedGramian(k, x, mesh=mesh)
    check(G.kernel_reason is None and G.kernel == "direct",
          f"phase 24a: the shard does not run K1: {G.kernel_reason}")
    op = G.add_diagonal(NOISE)
    before = mvm.LAUNCHES["direct"]
    (alpha, (it, _)), wall = sync_time(
        lambda: par.sharded_cg(op._matvec, y, tol=1e-5, maxiter=500, M=M))
    launches = mvm.LAUNCHES["direct"] - before
    check(launches == it + 1, f"phase 24a: {launches} K1 launches for {it} PCG iterations")
    check(abs(it - p3["cg_iters"]) <= 3,
          f"phase 24a: {it} PCG iterations against phase 3's {p3['cg_iters']}")
    xd = x.double()
    res64 = residual(mvm.gramian_matvec_direct_plain(k, xd, xd, alpha.double()), alpha, y)
    check(res64 <= 2e-5, f"phase 24a: float64 residual {res64:.3e} > 2e-5")
    op1 = ops.Gramian(k, x).add_diagonal(NOISE)
    (_, (it1, _)), wall1 = uncounted_k1(mvm, "phase 24a single-GPU solve", lambda: sync_time(
        lambda: cg(op1._matvec, y, tol=1e-5, maxiter=500, M=M)))
    coll_ms = collective_ms(mesh2, x.shape[0])
    # config 5's treecode at n = 10^6, target groups over the one rank
    b, bh_s = sync_time(lambda: par.sharded_bh_matvec(F18, w18, mesh))
    ref, bh1_s = sync_time(lambda: F18 @ w18)
    bh_err = rel(b, ref.double())
    check(bh_err <= SHARD_BOUND, f"phase 24a: sharded Barnes-Hut rel {bh_err:.3e}")
    dist.destroy_process_group()
    return dict(iters=it, iters1=it1, wall=wall, wall1=wall1, launches=launches, res64=res64,
                coll_ms=coll_ms, bh_err=bh_err, bh_max=float((b - ref).abs().max()), bh_s=bh_s, bh1_s=bh1_s)


def phase24(tk, ops, mvm, p3, p7, F18, w18):
    """Phase 24, the parallel layer: 24a in this process (NCCL, world 1),
    then 24b on `PARALLEL_RANKS` spawned ranks sharing the card over gloo.
    The kernels were built before: the ranks only load them. Returns the
    K1 and K3 launches of the phase's path, the ranks' summed: the counts
    are set to 0 before it."""
    from cfjax_torch.utils.testing import run_world

    t24 = time.perf_counter()
    a = phase24a_nccl(tk, ops, mvm, p3, F18, w18)
    t_a = time.perf_counter() - t24
    print(f"phase 24a parallel layer, NCCL at world size 1 (init_distributed, default_mesh): "
          f"ShardedGramian(MaternP(2)) n=131072 d=3 + noise, rank-512 Nystrom, sharded_cg: "
          f"{a['iters']} PCG iterations (phase 3: {p3['cg_iters']}; the single-GPU Gramian "
          f"here: {a['iters1']}), float64 residual {a['res64']:.3e} (bound 2e-5), K1 launches "
          f"{a['launches']}, solve {a['wall']:.3f} s against {a['wall1']:.3f} s through the "
          f"single-GPU Gramian ({1e3 * (a['wall'] - a['wall1']) / max(a['iters'], 1):.3f} ms an "
          f"iteration; phase 3's gp_condition {p3['wall_s']:.3f} s with its Nystrom build), "
          f"collectives {a['coll_ms']:.3f} ms an iteration | "
          f"sharded_bh_matvec n=10^6 theta 1/2 (phase 18's F): rel {a['bh_err']:.3e} (bound "
          f"{SHARD_BOUND:.0e}), max abs {a['bh_max']:.3e}, {a['bh_s']:.4f} s against F @ w "
          f"{a['bh1_s']:.4f} s | {t_a:.1f} s", flush=True)

    x3 = p3["x"]
    a3 = cuda_tensor(np.random.default_rng(24).standard_normal(x3.shape[0]))
    ref1 = uncounted_k1(mvm, "phase 24b reference", lambda: ops.Gramian(tk.MaternP(2), x3) @ a3)
    data = {"x3": x3.cpu().numpy(), "y3": p3["y"].cpu().numpy(), "a3": a3.cpu().numpy(),
            "ref1": ref1.cpu().numpy(), "x7": p7["x"].cpu().numpy(),
            "y7": p7["y"].cpu().numpy()}
    t_b = time.perf_counter()
    b = run_world(phase24b_rank, PARALLEL_RANKS, data, backend="gloo", device="cuda")
    wall_b = time.perf_counter() - t_b
    alpha = torch.as_tensor(b["alpha"], device="cuda")
    xd = x3.double()
    res64 = residual(mvm.gramian_matvec_direct_plain(tk.MaternP(2), xd, xd, alpha.double()),
                     alpha, p3["y"])
    check(res64 <= 2e-5, f"phase 24b: 2-D PCG float64 residual {res64:.3e} > 2e-5")
    check(abs(b["pcg_iters"] - p3["cg_iters"]) <= 3,
          f"phase 24b: {b['pcg_iters']} PCG iterations against phase 3's {p3['cg_iters']}")
    from cfjax_torch.ops import grad_mvm as gmvm

    x7, y7 = p7["x"], p7["y"]
    ag = torch.as_tensor(b["alpha_g"], device="cuda")
    n7, d7 = x7.shape
    plain = gmvm.grad_matvec_plain(tk.EQ(), x7.double(), x7.double(),
                                   ag.double().reshape(n7, d7)).reshape(-1)
    res_g = residual(plain, ag, y7)
    check(res_g <= 1e-4, f"phase 24b: gradient CG float64 residual {res_g:.3e} > 1e-4")
    check(abs(b["grad_iters"] - p7["cg_iters"]) <= 3,
          f"phase 24b: {b['grad_iters']} gradient CG iterations against phase 7's "
          f"{p7['cg_iters']}")
    launches = {key: mvm.LAUNCHES[key] for key in ("direct", "grad")}
    for rk in b["ranks"]:
        for key in launches:
            launches[key] += rk["launches"][key]
    per_rank = ", ".join(f"rank {i} K1 {rk['launches']['direct']} K3 {rk['launches']['grad']} "
                         f"({rk['path_s']:.1f} s)" for i, rk in enumerate(b["ranks"]))
    dry = b["dry"]
    print(f"phase 24b collectives over gloo on CUDA tensors (torch {torch.__version__}): "
          f"{b['collectives'][0]} run and agree with their values on backend "
          f"{b['collectives'][1]}; nothing is staged through host memory", flush=True)
    print(f"phase 24b parallel layer, {PARALLEL_RANKS} ranks on one card over gloo, a 2 x 2 "
          f"mesh: dry run (float32) loss {float(dry['loss']):.4e}, CG {int(dry['cg_iters'])} / "
          f"gradient CG {int(dry['grad_iters'])} / Nystrom PCG {int(dry['pcg_iters'])} "
          f"iterations, {b['dry_s']:.2f} s | sharded_gramian_matvec_2d Nystrom PCG n=131072 d=3: "
          f"{b['pcg_iters']} iterations (phase 3: {p3['cg_iters']}), float64 residual "
          f"{res64:.3e} (bound 2e-5), {b['pcg_launches']} K1 launches a rank, {b['pcg_s']:.3f} s "
          f"(24a at world 1: {a['wall']:.3f} s), collectives {b['coll_ms']:.3f} ms an "
          f"iteration | 1-D ShardedGramian MVM n=131072: rel {b['mvm1_err']:.3e} (bound "
          f"{SHARD_BOUND:.0e}) max abs {b['mvm1_max']:.3e} against the single-GPU K1 product, "
          f"{b['mvm1_s']:.4f} s | ShardedGradientGramian(EQ) n=4096 d=16, the column sum on "
          f"'cols': {b['grad_iters']} CG iterations (phase 7: {p7['cg_iters']}), float64 "
          f"residual {res_g:.3e} (bound 1e-4), {b['grad_launches']} K3 launches a rank, "
          f"{b['grad_s']:.3f} s | Kronecker 128^3 float64 rel {b['kron_err']:.3e} (bound "
          f"{SHARD_BOUND64:.0e}) {b['kron_s']:.4f} s | Toeplitz n=65536 x 16 columns rel "
          f"{b['toep_err']:.3e} {b['toep_s']:.4f} s | Barnes-Hut n=10^5 theta 1/2 rel "
          f"{b['bh_err']:.3e}, build {b['bh_build_s']:.2f} s a rank, MVM {b['bh_s']:.4f} s | "
          f"launches: {per_rank} | spawn and run {wall_b:.1f} s; phase 24 "
          f"{time.perf_counter() - t24:.1f} s", flush=True)
    return launches


# ---------------------------------------------------------------------------
# Phases 25-26: the north-star demo end to end, and BASELINE's two
# derivative-MVM rows (paths with no kernel)
# ---------------------------------------------------------------------------

# phase 26: each row's float32 product against its float64 plain version
# on the card (relative L2): 5.5x the H100's larger reading, 3.641e-7 for
# the composite (9.433e-8 for the Hessian; PERF.md)
DERIV_BOUND = 2e-6
# phase 25: the demo's v K alpha at n = 2^20 through float32 products, where
# K alpha cancels ~2.7e6x: the exact mean's miss against its float64 value
# and the PCG's float64 residual, each over ||y|| on RESIDUAL_ROWS rows.
# 2.5x the H100's sound readings (7.407e-4 and 8.087e-4, PERF.md); the
# control, alpha rounded to tf32's 10-bit mantissa (what a one-pass tf32
# product reads of it), must read above it
DEMO_F32_BOUND = 2e-3


def tf32_round(t):
    """float32 t rounded to nearest at tf32's 10-bit mantissa."""
    return ((t.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def phase25_northstar(ops, mvm):
    """The north-star demo as a user runs it:
    `cfjax_torch.examples.northstar_demo.main(2^20, quick=True)` on the
    card, float32 (BASELINE config 5: NUTS on the exact logML of a 4096-point
    subset, rank-1024 Nystrom PCG through K1, the Barnes-Hut posterior mean
    at theta 1/2 and the exact one through K1). Checks: the Gramian takes K1
    (kernel_reason None) and K1 launched at least once a PCG iteration; the
    solve's float64 residual on RESIDUAL_ROWS rows through K1's plain
    version, and the exact mean's miss against its float64 value there,
    both over ||y|| and within DEMO_F32_BOUND (K alpha cancels ~10^6x at
    l ~ 2.6, so float32 products certify no less: PERF.md), where the same
    two readings of a tf32-rounded alpha must exceed it; the exact mean's
    K1 rows against float64 plain (K1_BOUND over v ||K |alpha|||); the
    Barnes-Hut mean on 16 of those rows within BH_N6_ERR of them over the
    same norm; the chain's accept-stat in [0.5, 1]; the exact mean's RMSE
    below the noise. The Barnes-Hut mean's RMSE is printed, not checked:
    the treecode's error times K alpha's cancellation (the demo's
    docstring). The stage walls are warm: phases 1-24 ran in this process
    (a fresh process's are in PERF.md)."""
    from cfjax_torch.examples import northstar_demo as demo

    pcg, solve = {}, demo.solve

    def counted_solve(*args, **kw):
        before = dict(mvm.LAUNCHES)
        out = solve(*args, **kw)
        pcg.update({key: mvm.LAUNCHES[key] - before[key] for key in before})
        return out

    demo.solve = counted_solve
    try:
        (rmse, walls, parts), wall = sync_time(lambda: demo.main(1 << 20, quick=True))
    finally:
        demo.solve = solve
    x, y, _, _ = parts["data"]
    chain, sol, bh, mean = parts["chain"], parts["solve"], parts["bh"], parts["mean"]
    n, it, v, s2 = x.shape[0], sol["iters"], chain["v_hat"], demo.NOISE ** 2
    relres = sol["res"] / float(torch.linalg.norm(y))
    check(sol["G"].kernel_reason is None,
          f"phase 25: the Gramian declines K1: {sol['G'].kernel_reason}")
    check(relres <= 1e-4 and pcg["direct"] >= it,
          f"phase 25: PCG relres {relres:.3e} after {it} iterations, {pcg['direct']} K1 launches")
    check(0.5 <= chain["astat"] <= 1.0, f"phase 25: NUTS accept-stat {chain['astat']:.3f}")
    check(bool(torch.isfinite(mean).all() and torch.isfinite(bh["mean"]).all()),
          "phase 25: a posterior mean is not finite")
    check(rmse < demo.NOISE, f"phase 25: the exact mean's RMSE {rmse:.4f} >= the noise")
    rows = torch.as_tensor(np.random.default_rng(25).choice(n, RESIDUAL_ROWS, replace=False),
                           device="cuda")
    k, alpha = sol["k"], sol["alpha"]
    Ka64, r64 = relres64(k, x, y, v * alpha, s2 / v, rows, mvm)
    mags64 = v * plain_rows(k, x, alpha.abs(), rows, mvm)
    # what float32 products can certify where K alpha cancels: the mean's
    # miss and the true residual, against a control that rounds alpha to tf32
    ynorm = torch.linalg.norm(y[rows].double())
    miss = float(torch.linalg.norm(mean[rows].double() - Ka64) / ynorm)
    Kc64, rc64 = relres64(k, x, y, v * tf32_round(alpha), s2 / v, rows, mvm)
    miss_c = float(torch.linalg.norm(Kc64 - Ka64) / ynorm)
    del Kc64
    for what, sound, ctl in (("the exact mean's miss", miss, miss_c),
                             ("the PCG's float64 residual", r64, rc64)):
        check(sound <= DEMO_F32_BOUND < ctl,
              f"phase 25: {what} on {RESIDUAL_ROWS} rows {sound:.3e} of ||y||, the tf32 "
              f"control's {ctl:.3e}: not <= {DEMO_F32_BOUND:.0e} < the control")
    idx = rows[:16]
    ref64, mag64 = Ka64[:16], mags64[:16]     # relres64 took v alpha
    k1_err, k1_abs = k1_against_plain("phase 25: the exact mean's 16 rows", mean[idx], ref64,
                                      mag64)
    bh_err = float(torch.linalg.norm(bh["mean"][idx].double() - mean[idx].double())
                   / torch.linalg.norm(mag64))
    check(bh_err <= BH_N6_ERR, f"phase 25: Barnes-Hut mean vs K1's rows {bh_err:.3e} of "
                               f"v ||K |alpha||| > {BH_N6_ERR}")
    can = cancels(Ka64, mags64)
    del Ka64, mags64
    stages = ", ".join(f"{key[:-2]} {t:.3f} s" for key, t in walls.items())
    print(f"phase 25 the north-star demo, main(2^20, quick=True) (BASELINE config 5, float32 "
          f"on the card): {wall:.1f} s; stages {stages}; NUTS {chain['evals']} evaluations, "
          f"accept-stat {chain['astat']:.3f}, l {chain['l_hat']:.4f} (sd of log l "
          f"{chain['l_sd']:.4f}), v {v:.4f}; PCG {it} iterations, relres {relres:.3e}, float64 "
          f"residual on {RESIDUAL_ROWS} rows {r64:.3e} and the exact mean's miss {miss:.3e} of ||y|| "
          f"(bound {DEMO_F32_BOUND:.0e}; K alpha cancels {can:.1f}x there; the tf32 control "
          f"{rc64:.3e} and {miss_c:.3e}), K1 launches during the "
          f"PCG {pcg['direct']} | {ops.explain(k, x)}; RMSE vs the true field: exact mean "
          f"(K1) {rmse:.4f} (bound {demo.NOISE}), Barnes-Hut mean {parts['rmse_bh']:.4f} "
          f"(reported: K alpha cancels {cancels(ref64, mag64):.1f}x on 16 rows; the treecode's "
          f"error there {bh_err:.3e} of v ||K |alpha||| (bound {BH_N6_ERR:.0e}), "
          f"{rel(bh['mean'][idx], mean[idx].double()):.3e} of the mean; max_open "
          f"{bh['F'].max_open}); K1's rows vs float64 plain {k1_err:.3e} of v ||K |alpha|||",
          flush=True)
    return dict(wall=wall, walls=walls, k1_abs=k1_abs, pcg_launches=pcg["direct"], iters=it,
                r64=r64, miss=miss, rmse=rmse, rmse_bh=parts["rmse_bh"], astat=chain["astat"])


def phase26_derivative_rows(tk, ops):
    """BASELINE.md's two derivative-MVM rows on the card, float32, through
    the paths a user gets (no kernel: K3 takes iso / dot gradient gramians
    only): HessianKernel(EQ()).gramian(x), n = 128, d = 16, v of n d^2
    (run_baseline.py:391-401), and GradientKernel(MaternP(2) + Line(1)^2 +
    NN(0.1)), n = d = 1024, the "pair" mode (run_baseline.py:375-387),
    x ~ N(0, I). Each: its route, ms a call and device ms (CUDA graphs),
    the peak memory of a call above its inputs, the error against the
    float64 product on the card (at DERIV_BOUND), and the share of the
    least work (`work_hessian_mvm`, `work_gradient_mvm`: cfjax's
    benchmark counts on this card), which `summarize` must call valid.
    Both kernels are built as a user builds them, their hyperparameters on
    the host: the gramian moves them to the card once, so the device ms
    come from CUDA graphs of the operators as built."""
    from cfjax_torch.kernels.parameters import leaves
    from cfjax_torch.derivative import GradientKernel, HessianKernel
    from cfjax_torch.derivative.gradient import work_gradient_mvm
    from cfjax_torch.derivative.hessian import work_hessian_mvm

    rng = np.random.default_rng(26)
    xh = cuda_tensor(rng.standard_normal((128, 16)))
    xc = cuda_tensor(rng.standard_normal((1024, 1024)))
    composite = tk.MaternP(2) + tk.Line(1.0) ** 2 + tk.NN(0.1)
    cases = (("HessianKernel(EQ) n=128 d=16", HessianKernel(tk.EQ()), xh, 128 * 16 * 16,
              work_hessian_mvm(128, 16)),
             ("GradientKernel(MaternP(2) + Line(1)^2 + NN(0.1)) n=d=1024",
              GradientKernel(composite), xc, 1024 * 1024, work_gradient_mvm(1024, 1024)))
    out = {}
    for label, mk, x, size, work in cases:
        v = cuda_tensor(rng.standard_normal(size))
        G = ops.gramian(mk, x)
        check(not any(l.is_cuda for l in leaves(mk.k))
              and all(l.is_cuda and l.dtype == torch.float32 for l in leaves(G.k)),
              f"phase 26: {label}: the gramian's hyperparameters are not on the card")
        route = f"{ops.explain(mk, x)}; mode {G.mode}, plain torch"
        b = G @ v
        ref = ops.gramian(mk, x.double()) @ v.double()
        err = rel(b, ref)
        check(bool(torch.isfinite(b).all()) and err <= DERIV_BOUND,
              f"phase 26: {label}: relative error {err:.3e} against float64 > {DERIV_BOUND:.0e}")
        del ref
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        G @ v
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        call, dev = call_and_device_ms(lambda: G @ v)
        summ = summarize(work, dev / 1e3)
        check(summ["valid"], f"phase 26: {label}: {summ.get('why')}")
        ms, by = roof(work)
        out[label] = dict(call_ms=call, ms=dev, err=err, peak_mib=peak, bound_ms=ms,
                          pct=summ["roofline_pct"])
        print(f"phase 26 {label}: {route} | {call:.4f} ms a call ({dev:.4f} ms device), "
              f"peak {peak:.1f} MiB above the inputs, rel {err:.3e} vs float64 (bound "
              f"{DERIV_BOUND:.0e}); least work {ms:.5f} ms ({by}) = "
              f"{summ['roofline_pct']:.3f}% of device (valid)", flush=True)
    return out


# phase 27: the rows of the BASELINE table that chip_smoke.py runs; the
# heavy ones (the n = 10^6 Barnes-Hut and Nystrom / PCG rows, the 2^20 SLQ
# logML rows, refined_solve at n = 10^5) are left to the table's own run,
# their paths being those of phases 18-20, 23 and 25
WEAK_SMALL = dict(worlds=(1, 4), rows=512, tile=512, cg_n=2048)


def phase27_benchmarks(mvm):
    """The port's benchmark entry points on the card, each through the
    functions its command runs: 27a the headline (`bench_torch.py`:
    `headline.measure`, its row error within `headline.ROW_BOUND` and K1's
    counter moved); 27b every row of the BASELINE table but the heavy ones
    (`run_baseline.run(skip_heavy=True)`), each valid: its reading told
    from the spread and within 105% of its bound (`summarize`), its float64
    error within the limit it states, its kernel launched where it names
    one; 27c the weak-scaling twin at a small size, NCCL at world 1 and
    four gloo ranks sharing the card, each sharded answer within
    `weak_scaling.SHARD_BOUND` of one rank's. Returns the spawned ranks'
    launches (this process's stay in `mvm.LAUNCHES`)."""
    from cfjax_torch.benchmarks import headline, run_baseline, weak_scaling

    t27 = time.perf_counter()
    h = headline.measure()
    bad = headline.failures(h)
    check(not bad, f"phase 27a: {'; '.join(bad)}")
    print(f"phase 27a headline (bench_torch.py): {h['metric']} {h['value'] * 1e3:.4f} ms a call "
          f"(time_chained), {h['device_ms']:.4f} ms device, {h['vs_baseline']:.1f}x the "
          f"reference's 0.585 s; row check {h['row_check_rel_err']:.3e} (bound "
          f"{headline.ROW_BOUND:.0e}); K1 launches {h['k1_launches']}", flush=True)
    t_b = time.perf_counter()
    rows = run_baseline.run(skip_heavy=True, echo=False)
    want = [c for g in run_baseline.GROUPS.values() for c in g if c not in run_baseline.HEAVY]
    check([r["cfjax_config"] for r in rows] == want,
          f"phase 27b: {len(rows)} rows, not the table's {len(want)} non-heavy ones")
    for r in rows:
        check(r["valid"], f"phase 27b: {r['config']}: {r['why']}")
    text = "; ".join(
        f"{r['config']} {r['seconds'] * 1e3:.4f} ms"
        + ("" if r["device_ms"] is None else f" ({r['device_ms']:.4f} device)")
        + ("" if r["bound_ms"] is None else f", bound {r['bound_ms']:.5f} ms ({r['bound_by']}) "
                                            f"{r['share']:.2f}%")
        + ("" if r["rel_err_f64"] is None else f", err {r['rel_err_f64']:.2e}"
           + ("" if r["err_bound"] is None else f" (<= {r['err_bound']:.0e})"))
        + f", {r['route']}" for r in rows)
    print(f"phase 27b BASELINE table (run_baseline, {len(rows)} rows, the {len(run_baseline.HEAVY)} "
          f"heavy ones left out) {time.perf_counter() - t_b:.1f} s, every row valid: {text}",
          flush=True)
    t_c = time.perf_counter()
    ws = weak_scaling.run(device="cuda", **WEAK_SMALL)
    bad = weak_scaling.failures(ws["rows"])
    check(not bad, f"phase 27c: {'; '.join(bad)}")
    text = "; ".join(
        f"{r['config']} " + (f"{r['seconds'] * 1e3:.3f} ms, rel {r['rel_err_vs_single']:.2e}"
                             if "seconds" in r else
                             f"{r['iters_sharded']} iterations (one rank {r['iters_single']}), "
                             f"rel {r['rel_err_vs_single_cg']:.2e}")
        for r in ws["rows"] if r["config"].startswith(("weak_scaling_mvm", "gp_cg")))
    print(f"phase 27c weak scaling (worlds {WEAK_SMALL['worlds']}, {WEAK_SMALL['rows']} rows a "
          f"rank, tile {WEAK_SMALL['tile']}, CG n={WEAK_SMALL['cg_n']}; one card: overheads, not "
          f"scaling) {time.perf_counter() - t_c:.1f} s: {text} (bound "
          f"{weak_scaling.SHARD_BOUND:.0e}) | phase 27 {time.perf_counter() - t27:.1f} s",
          flush=True)
    return ws["launches"]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    import cfjax_torch.kernels as tk
    import cfjax_torch.gp as gp
    import cfjax_torch.operators as ops
    from cfjax_torch.ops import build
    from cfjax_torch.operators import sparse_op as so
    from cfjax_torch.operators import tile_ell as t_tile
    from cfjax_torch.ops import grad_mvm as gmvm
    from cfjax_torch.ops import gramian_mvm as mvm
    from cfjax_torch.ops import tile_ell_mvm as tmvm
    from cfjax_torch.kernels.profile_spec import to_spec
    from cfjax_torch.operators import slq
    from cfjax_torch.barneshut import bh

    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    build.build()
    mvm.library(), mvm.expand_library(), gmvm.library(), tmvm.library()
    built_s = time.perf_counter() - t0
    fam_n, fam_stack, fam_spill, fam_regs = ptxas_k1_family(build, "k1_family", 54)
    cols_n, cols_stack, cols_spill, cols_regs = ptxas_k1_family(build, "k1_matmat_family", 108)
    k2_n, k2_regs, k2_stack = ptxas_tc(build, "expand_mvm", "k2_tc", 22)
    k3_n, k3_regs, k3_stack = ptxas_tc(build, "grad_mvm", "k3_tc", 20)
    print(f"phase 0 card: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"kernel libraries {', '.join(build.LIBRARIES)} built in {built_s:.1f} s | ptxas: "
          f"{fam_n} K1 family instances (6 D x 9 profiles, the real-nu Matern's table among "
          f"them), stack frame {fam_stack} bytes, spills {fam_spill} bytes, registers "
          f"{fam_regs}; {cols_n} many-column K1 instances (6 D x 9 profiles x 1 or 3 tensor-"
          f"core passes, 16 columns a chunk), stack frame {cols_stack} bytes, spills {cols_spill} "
          f"bytes, registers {cols_regs}; K2 {k2_n} instances (11 profiles x 1, 3 passes), "
          f"K3 {k3_n} (10 x 1, 3 passes): family instances 0 bytes stack, no instance spills, "
          f"registers {k2_regs} / {k3_regs}, the interpreted instances' stack {k2_stack} / {k3_stack} "
          f"bytes (the profile interpreter's)", flush=True)

    p1 = phase1_kernels(tk, mvm)

    # ---- the main path: counts from here to the end of phase 4 ----
    for key in mvm.LAUNCHES:
        mvm.LAUNCHES[key] = 0
    rng = np.random.default_rng(0)
    p2 = phase_gp(tk, ops, gp, mvm, 16384, 3, tk.MaternP(2), "direct",
                  "phase 2", rng, {}, 1e-3)
    print(f"phase 2 cholesky n=16384 d=3 MaternP(2): residual {p2['residual']:.3e} / {p2['residual64']:.3e} f64 "
          f"(bound 1e-3) gp_condition {p2['wall_s']:.3f} s mean(4096) "
          f"{p2['mean_wall_s']:.4f} s | {p2['explain']}", flush=True)
    p2b = phase_float64_observations(tk, gp, mvm)
    p3 = phase_gp(tk, ops, gp, mvm, 131072, 3, tk.MaternP(2), "direct",
                  "phase 3", rng, dict(tol=1e-5, maxiter=500), 2e-5)
    check(p3["cg_iters"] is not None and p3["cg_iters"] < 500,
          f"phase 3: PCG did not converge in 500 iterations ({p3['cg_iters']})")
    check(p3["launches"] >= p3["cg_iters"],
          f"phase 3: {p3['launches']} K1 launches < {p3['cg_iters']} CG iterations")
    print(f"phase 3 nystrom-pcg n=131072 d=3 MaternP(2): {p3['cg_iters']} CG iterations, "
          f"residual {p3['residual']:.3e} / {p3['residual64']:.3e} f64 (bound 2e-5), K1 launches {p3['launches']}, "
          f"gp_condition {p3['wall_s']:.3f} s mean(4096) {p3['mean_wall_s']:.4f} s | "
          f"{p3['explain']}", flush=True)
    p4 = phase_gp(tk, ops, gp, mvm, 16384, 64, tk.Lengthscale(tk.EQ(), 4.0), "expand",
                  "phase 4", rng, {}, 1e-3)
    print(f"phase 4 expansion n=16384 d=64 Lengthscale(EQ, 4): residual "
          f"{p4['residual']:.3e} / {p4['residual64']:.3e} f64 (bound 1e-3) gp_condition {p4['wall_s']:.3f} s "
          f"mean(4096) {p4['mean_wall_s']:.4f} s | {p4['explain']}", flush=True)
    launches = dict(mvm.LAUNCHES)
    for key in ("direct", "expand"):
        check(launches[key] > 0, f"kernel {key!r} was not launched on the GP path")

    # ---- phase 5: times, plain / kernel / kernel / plain, median of 20 each ----
    rng = np.random.default_rng(0)
    xh = cuda_tensor(rng.standard_normal((16384, 3)))
    ah = cuda_tensor(rng.standard_normal(16384))
    x64 = cuda_tensor(rng.standard_normal((16384, 64)))
    k2 = tk.Lengthscale(tk.EQ(), 4.0)
    # K3 at the shapes of phase 7 (EQ, n = 4096, d = 16, x = 0.5 N(0, I))
    # and phase 8 (MaternP(2), n = d = 1024, x = N(0, I))
    xg7 = cuda_tensor(0.5 * rng.standard_normal((4096, 16)))
    ag7 = cuda_tensor(rng.standard_normal((4096, 16)))
    xg8 = cuda_tensor(rng.standard_normal((1024, 1024)))
    ag8 = cuda_tensor(rng.standard_normal((1024, 1024)))
    x17 = cuda_tensor(rng.standard_normal((131072, 3)))
    a17 = cuda_tensor(rng.standard_normal(131072))
    keq, km2 = tk.EQ(), tk.MaternP(2)
    k1t = time_k1(mvm, tk, xh, ah, x17, a17)
    k1c = time_k1_cols(mvm, tk, xh, x17)
    from cfjax_torch.ops.tiles import tier_passes

    def runs(tier):
        return {
            "expand": (lambda: mvm.gramian_matvec_expand(k2, x64, x64, ah, precision=tier),
                       lambda: mvm.gramian_matvec_expand_plain(k2, x64, x64, ah,
                                                               precision=tier)),
            "grad": (lambda: gmvm.grad_matvec(keq, xg7, xg7, ag7, precision=tier),
                     lambda: gmvm.grad_matvec_plain(keq, xg7, xg7, ag7, precision=tier)),
            "grad8": (lambda: gmvm.grad_matvec(km2, xg8, xg8, ag8, precision=tier),
                      lambda: gmvm.grad_matvec_plain(km2, xg8, xg8, ag8, precision=tier)),
        }

    # (ms of one call with the wrapper's host time, device ms, plain ms at the tier)
    times = {"direct": (k1t["call_ms"], k1t["ms"], k1t["plain_ms"]),
             "direct_cols": (k1c[16384]["call_ms"], k1c[16384]["ms"], k1c[16384]["plain_ms"])}
    tier_times = {}
    for tier in TIERS:
        for key, (kern, plain) in runs(tier).items():
            tier_times[key, tier] = kernel_times(kern, plain)
    for key in ("expand", "grad", "grad8"):
        times[key] = tier_times[key, "highest"]
    # the cost of K3's near-coincident path: the shapes against a fresh draw
    # of points (no pair within tau) beside the timed run against themselves
    # (each point's own pair; device ms)
    near = {}
    for key, k, xx, A in (("grad", keq, xg7, ag7), ("grad8", km2, xg8, ag8)):
        scale = 0.5 if key == "grad" else 1.0
        yy = cuda_tensor(scale * rng.standard_normal(tuple(xx.shape)))
        far = float(np.median(graph_ms(lambda: gmvm.grad_matvec(k, xx, yy, A))))
        near[key] = (times[key][1], far, near_pairs(xx, xx, gmvm.NEAR_TAU),
                     near_pairs(xx, yy, gmvm.NEAR_TAU))
    # bounds: each kernel's function's least work (`work_direct`,
    # `work_expand`, `work_grad`, `work_rows` beside the wrappers). K1 by its
    # family's least operations (SFU), and beside it its fp32 issue with the
    # 4 instructions an entry of exp2's split argument. K2 / K3 on the tensor
    # cores at the tier's passes, against their fp32 and SFU work. Beside
    # them the CUDA-core bound of the fp32 kernel's count: K2 d FFMA + 5 fp32
    # + 1 SFU an entry, K3 9 d flops a pair.
    work_k1 = mvm.work_direct(131072, 131072, 3, mvm.profile_ops(to_spec(tk.MaternP(2))[0]))
    k1_issue = roof(Work(fp32=work_k1.fp32 + 4.0 * 131072 ** 2))
    eq_value = mvm.profile_ops(to_spec(k2)[0])
    eq_jet = gmvm.jet_ops(to_spec(keq, derivative=True)[0])
    m2_jet = gmvm.jet_ops(to_spec(km2, derivative=True)[0])
    tcb = {"expand": lambda ps: roof(mvm.work_expand(16384, 16384, 64, eq_value, ps)),
           "grad": lambda ps: roof(gmvm.work_grad(4096, 4096, 16, eq_jet, ps)),
           "grad8": lambda ps: roof(gmvm.work_grad(1024, 1024, 1024, m2_jet, ps))}
    core = {"expand": roof(Work(fp32=16384 ** 2 * (64 + 5), sfu=16384 ** 2)),
            "grad": roof(Work(fp32=4096 ** 2 * 4.5 * 16)),
            "grad8": roof(Work(fp32=1024 ** 2 * 4.5 * 1024))}
    bounds = {"direct": k1t["bound"], "direct_cols": k1c[16384]["bound"]}
    for key in tcb:
        bounds[key] = tcb[key](tier_passes("highest"))
    share = lambda key, i: 100 * bounds[key][0] / times[key][i]
    line = lambda key: (f"{times[key][0]:.4f} ms a call ({times[key][1]:.4f} ms device) vs "
                        f"plain {times[key][2]:.4f} ms, bound {bounds[key][0]:.4f} ms "
                        f"({bounds[key][1]}) = {share(key, 0):.1f}% of a call "
                        f"({share(key, 1):.1f}% of device)")

    def tier_line(key):
        parts = []
        for tier in TIERS:
            call, dev, plain = tier_times[key, tier]
            b, by = tcb[key](tier_passes(tier))
            parts.append(f"{tier} ({tier_passes(tier)} passes) {call:.4f} ms a call ({dev:.4f} "
                         f"device) vs plain {plain:.4f}, bound {b:.4f} ms ({by}) = "
                         f"{100 * b / dev:.1f}% of device, CUDA-core bound {core[key][0]:.4f} "
                         f"ms ({core[key][1]})")
        return "; ".join(parts)

    near_text = "; ".join(
        f"{label}: {near[key][2]} near pairs {near[key][0]:.4f} ms, {near[key][3]} near pairs "
        f"{near[key][1]:.4f} ms device ({1e6 * (near[key][0] - near[key][1]) / max(1, near[key][2] - near[key][3]):.1f} ns a pair)"
        for key, label in (("grad", "n=4096 d=16"), ("grad8", "n=d=1024")))
    print(f"phase 5 times (a call: CUDA events around one call, the wrapper's host time "
          f"included, median of 20; device: CUDA graphs of 20 calls, median of 10 replays; "
          f"plain: as a call, median of 20) and bounds: K1 MaternP(2) n=16384 d=3 family "
          f"instance {line('direct')}; interpreted instance {k1t['interp_call_ms']:.4f} ms a "
          f"call ({k1t['interp_ms']:.4f} ms device); K1 n=131072 d=3 (phase 3's shape) "
          f"{k1t['call17']:.3f} ms a call ({k1t['ms17']:.3f} ms device), bound "
          f"{k1t['bound17'][0]:.3f} ms ({k1t['bound17'][1]}) = "
          f"{100 * k1t['bound17'][0] / k1t['call17']:.1f}% of a call "
          f"({100 * k1t['bound17'][0] / k1t['ms17']:.1f}% of device), fp32-issue bound with "
          f"exp2's split argument ({work_k1.fp32 / 131072 ** 2 + 4:.0f} fp32 an entry) {k1_issue[0]:.3f} ms = "
          f"{100 * k1_issue[0] / k1t['ms17']:.1f}% of device | many-column K1 MaternP(2) d=3 "
          f"p=16: {cols_text(k1c)} | K2 Lengthscale(EQ, 4) n=16384 "
          f"d=64: {tier_line('expand')} | K3 EQ n=4096 d=16: {tier_line('grad')} | K3 "
          f"MaternP(2) n=1024 d=1024: {tier_line('grad8')} | K3's near-coincident path (pairs "
          f"with s <= tau (|x|^2 + |y|^2), tau = {gmvm.NEAR_TAU}), the points against themselves "
          f"and against a fresh draw: {near_text} | library call: none for K1-K3 "
          f"(one PyTorch call would form the n x m matrix) | phase walls: 2 "
          f"{p2['wall_s']:.3f} s, 3 {p3['wall_s']:.3f} s ({p3['cg_iters']} CG iterations, "
          f"{p3['launches']} K1 launches), 4 {p4['wall_s']:.3f} s", flush=True)

    p6 = phase6_grad_kernel(tk, gmvm)

    # ---- the gradient-observation path: counts from here to the end of phase 8 ----
    for key in mvm.LAUNCHES:
        mvm.LAUNCHES[key] = 0
    p7 = phase7_gradient_gp(tk, ops, gp, mvm, gmvm)
    p8 = phase8_readme_gradient(tk, ops, gmvm)
    grad_launches = mvm.LAUNCHES["grad"]
    check(grad_launches > 0, "kernel 'grad' was not launched on the gradient-observation path")
    check(p7["launches"] >= p7["cg_iters"],
          f"phase 7: {p7['launches']} K3 launches < {p7['cg_iters']} CG iterations")
    launches["grad"] = grad_launches
    # phases 7 and 8 again at the tf32 tiers, outside the path's count
    print(f"phases 7-8 at the tf32 tiers: phase 7 {at_tiers('phase 7', p7['solve'])} | "
          f"phase 8 {at_tiers('phase 8', p8['solve'])}", flush=True)

    p9, p9_skipped = phase9_synthetic(tmvm, t_tile)

    # ---- the sparsify-then-solve path: counts from here to the end of phase 11 ----
    for key in mvm.LAUNCHES:
        mvm.LAUNCHES[key] = 0
    p10 = phase10_reference_sparse(tk, ops, so, tmvm, mvm, t_tile)
    p11 = phase11_spatial_sparse(tk, ops, so, tmvm, mvm, t_tile)
    launches["tile_ell"] = mvm.LAUNCHES["tile_ell"]
    check(launches["tile_ell"] > 0, "kernel 'tile_ell' was not launched on the sparse path")

    # ---- phase 9 (continued): K4 on the operators of phases 10 and 11 ----
    rng = np.random.default_rng(9)
    for label, S in (("phase 10", p10["S"]), ("phase 11", p11["S"])):
        phase9_rows_kernel(tmvm, p9, S, cuda_tensor(rng.standard_normal(S.shape[1])),
                           f"{label} operator")
    torch.cuda.synchronize()
    f32, f64 = p9[torch.float32], p9[torch.float64]
    print(f"phase 9 K4 vs the float64 slab product: {f32[0]} operators ({f32[0] - 2} synthetic "
          f"TileELL groups, {p9_skipped} over 2^28 slots left out, and the operators of phases "
          f"10 and 11): float32 max rel {f32[1]:.3e} (bound {K4_BOUND[torch.float32]:.0e}) max "
          f"abs {f32[2]:.3e}; float64 instance max rel {f64[1]:.3e} (bound "
          f"{K4_BOUND[torch.float64]:.0e}) max abs {f64[2]:.3e}", flush=True)

    # ---- phase 5 (K4): at phase 11's operator ----
    k4 = k4_times(p11["S"], p10["S"], tmvm)
    times["tile_ell"] = (k4["call_ms"], k4["ms"], k4["plain_ms"])
    bounds["tile_ell"] = (k4["bound_ms"], "HBM")
    gbs = k4["bound_bytes"] / k4["ms"] / 1e6
    sweep = "; ".join(f"{label} ({slices} slices, {w} by the rule): " + " / ".join(
        f"{t[v]:.4f}" for v in (1, 2, 4, 8)) + " ms device"
        for label, (w, slices, t) in k4["sweep"].items())
    print(f"phase 5 (K4) at phase 11's operator (nnz {p11['S'].nnz}; timed as above): K4 "
          f"{k4['call_ms']:.4f} ms a call ({k4['ms']:.4f} ms device) vs plain "
          f"{k4['plain_ms']:.4f} ms vs CSR SpMV (torch.mv, cuSPARSE, int32 indices) "
          f"{k4['library_call_ms']:.4f} ms a call ({k4['library_ms']:.4f} ms device; rel "
          f"{k4['lib_err']:.2e}); warps per slice 1 / 2 / 4 / 8: {sweep}; bound "
          f"{k4['bound_ms']:.4f} ms ({k4['bound_bytes'] / 1e6:.1f} MB: nnz x 8 B + a + out, "
          f"over 3.35 TB/s) = {100 * k4['bound_ms'] / k4['call_ms']:.1f}% of a call "
          f"({100 * k4['bound_ms'] / k4['ms']:.1f}% of device, {gbs:.1f} GB/s); the layout "
          f"read per MVM {k4['layout_bytes'] / 1e6:.1f} MB = "
          f"{k4['layout_bytes'] / (8 * p11['S'].nnz):.4f} x nnz x 8 B; MINRES solves "
          f"{p11['wall_s']:.4f} s ({p11['iters']} iterations, {p11['launches']} K4 launches) "
          f"and {p10['wall_s']:.4f} s ({p10['iters']} iterations)", flush=True)

    # ---- the structured path: counts from here to the end of phase 14 ----
    for key in mvm.LAUNCHES:
        mvm.LAUNCHES[key] = 0
    t_struct = time.perf_counter()
    p12, w12 = sync_time(lambda: phase12_toeplitz(tk, ops, gp, mvm))
    p13, w13 = sync_time(lambda: phase13_circulant(tk, ops, gp))
    p14, w14 = sync_time(lambda: phase14_kronecker(tk, ops, gp))
    check(mvm.LAUNCHES["direct"] > 0, "kernel 'direct' was not launched on the structured path")
    launches["direct"] += mvm.LAUNCHES["direct"]
    print(f"phases 12-14 structured path {time.perf_counter() - t_struct:.1f} s (walls: 12 "
          f"{w12:.3f} s, 13 {w13:.3f} s, 14 {w14:.3f} s, checks included): FFT MVM "
          f"{p12['mvm_ms']:.4f} ms (Toeplitz n=65536) / {p13['mvm_ms']:.4f} ms (circulant "
          f"n=65536), Kronecker MVM {p14['mvm_ms']:.4f} ms (128^3), levinson n=16384 "
          f"{p12['lev_ms']:.1f} ms; K1 launches {mvm.LAUNCHES['direct']}", flush=True)

    # ---- the lazy logML and the fit: counts from here to the end of phase 16 ----
    p15d = phase15_logdet(tk, ops, slq)
    sweep = ", ".join(f"{p} probes {it} steps {100 * e:+.3f}%" for (p, it), e in p15d["sweep"].items())
    print(f"phase 15 SLQ logdet n=16384 (16 probes, 48 Lanczos steps, the same probes): "
          f"float32 through the many-column K1 {p15d['ld32']:.9e} ({p15d['s32']:.3f} s) vs "
          f"float64 plain {p15d['ld64']:.9e} ({p15d['s64']:.3f} s), rel {p15d['err']:.3e} "
          f"(bound {SLQ_BOUND:.0e}); against the exact logdet {p15d['exact']:.9e} (float64 "
          f"dense Cholesky), float32: {sweep}", flush=True)
    for key in mvm.LAUNCHES:
        mvm.LAUNCHES[key] = 0
    t_lml = time.perf_counter()
    p15 = phase15_logml(tk, gp, mvm, slq, p3)
    p16 = phase16_fit(tk, gp, mvm, p3, p15["wall_b"])
    launches["direct_cols"] = mvm.LAUNCHES["direct_cols"]
    launches["direct"] += mvm.LAUNCHES["direct"]
    check(launches["direct_cols"] > 0 and mvm.LAUNCHES["direct"] > 0,
          "the many-column K1 or K1 was not launched on the logML path")
    print(f"phases 15-16 logML path {time.perf_counter() - t_lml:.1f} s: launches many-column "
          f"K1 {mvm.LAUNCHES['direct_cols']}, K1 {mvm.LAUNCHES['direct']}", flush=True)

    # ---- the Barnes-Hut path and the refinement solvers: counts from here to the end of phase 20 ----
    for key in mvm.LAUNCHES:
        mvm.LAUNCHES[key] = 0
    t_bh = time.perf_counter()
    # the largest absolute error of K1's products held against float64 plain
    k1_17 = phase17_treecode(tk, ops, bh, mvm)
    k1_18, F18, w18 = phase18_treecode_1e6(tk, ops, bh, mvm)
    k1_bh = max(k1_17, k1_18, phase19_gp_solves(tk, ops, gp, bh, mvm),
                phase20_refined(tk, ops, mvm))
    check(mvm.LAUNCHES["direct"] > 0, "kernel 'direct' was not launched on the Barnes-Hut path")
    launches["direct"] += mvm.LAUNCHES["direct"]
    print(f"phases 17-20 Barnes-Hut and refinement path {time.perf_counter() - t_bh:.1f} s: K1 "
          f"launches {mvm.LAUNCHES['direct']}", flush=True)

    # ---- phase 21: real-nu Matern on K1-K3 (checks, then the GP solve path) ----
    t21 = time.perf_counter()
    m21_fam, k1_21 = phase21a_profile(tk, mvm)
    p21h = phase21a_headline(tk, mvm)
    times["matern"] = (p21h["call_ms"], p21h["ms"], p21h["plain_ms"])
    bounds["matern"] = p21h["bound"]
    p21b = phase21b_k2(tk, mvm)
    p21c = phase21c_k3(tk, gmvm)
    times["expand_matern"] = (p21b["times"]["highest"][0], p21b["times"]["highest"][1],
                              p21b["plain_ms"])
    bounds["expand_matern"] = p21b["times"]["highest"][2]
    times["grad_matern"] = (p21c["times"]["highest"][0], p21c["times"]["highest"][1],
                            p21c["plain_ms"])
    bounds["grad_matern"] = p21c["times"]["highest"][2]
    # the three Matern GP paths, each with the counts set to 0 just before it
    paths = {}
    for key, label, run in (
            ("matern", "21d K1", lambda: phase21d_solve(tk, ops, gp, mvm)),
            ("expand_matern", "21e K2", lambda: phase21e_k2_solve(tk, ops, gp, mvm)),
            ("grad_matern", "21f K3", lambda: phase21f_k3_solve(tk, ops, gp, mvm))):
        for kind in mvm.LAUNCHES:
            mvm.LAUNCHES[kind] = 0
        paths[key] = run()
        check(mvm.LAUNCHES[key] > 0,
              f"phase {label}: the real-nu Matern family was not launched on its GP path")
        launches[key] = mvm.LAUNCHES[key]
        launches["direct"] += mvm.LAUNCHES["direct"]
    p21d = paths["matern"]
    print(f"phase 21 real-nu Matern {time.perf_counter() - t21:.1f} s: launches on the GP "
          f"paths: K1's Matern family {launches['matern']} (21d), K2's {launches['expand_matern']} "
          f"(21e), K3's {launches['grad_matern']} (21f)", flush=True)

    # ---- phases 22-23: config 5's hyperparameter sampling: counts from here to the end of 23 ----
    from cfjax_torch.gp import hmc

    for key in mvm.LAUNCHES:
        mvm.LAUNCHES[key] = 0
    t22 = time.perf_counter()
    p22 = phase22_subset_chain(tk, gp, hmc)
    p23 = phase23_host_chain(tk, gp, hmc, mvm, slq, p22)
    check(mvm.LAUNCHES["direct_cols"] > 0 and mvm.LAUNCHES["direct"] > 0,
          "the many-column K1 or K1 was not launched on the sampling path")
    launches["direct_cols"] += mvm.LAUNCHES["direct_cols"]
    launches["direct"] += mvm.LAUNCHES["direct"]
    print(f"phases 22-23 sampling path {time.perf_counter() - t22:.1f} s: launches many-column "
          f"K1 {mvm.LAUNCHES['direct_cols']}, K1 {mvm.LAUNCHES['direct']}", flush=True)

    # ---- phase 24: the parallel layer: counts from here to its end, the ranks' included ----
    for key in mvm.LAUNCHES:
        mvm.LAUNCHES[key] = 0
    l24 = phase24(tk, ops, mvm, p3, p7, F18, w18)
    check(l24["direct"] > 0 and l24["grad"] > 0,
          f"phase 24: K1 {l24['direct']}, K3 {l24['grad']} launches on the parallel path")
    launches["direct"] += l24["direct"]
    launches["grad"] += l24["grad"]

    # ---- phase 25: the north-star demo: counts from here to its end ----
    for key in mvm.LAUNCHES:
        mvm.LAUNCHES[key] = 0
    p25 = phase25_northstar(ops, mvm)
    check(mvm.LAUNCHES["direct"] > 0, "kernel 'direct' was not launched on the demo's path")
    launches["direct"] += mvm.LAUNCHES["direct"]
    print(f"phase 25 demo path: K1 launches {mvm.LAUNCHES['direct']}", flush=True)

    # ---- phase 26: the BASELINE derivative rows (no kernel) ----
    phase26_derivative_rows(tk, ops)

    # ---- phase 27: the benchmark entry points: counts from here to its end, the ranks' included ----
    for key in mvm.LAUNCHES:
        mvm.LAUNCHES[key] = 0
    ranks27 = phase27_benchmarks(mvm)
    for key in launches:
        launches[key] += mvm.LAUNCHES[key] + ranks27.get(key, 0)
    check(all(mvm.LAUNCHES[key] > 0 for key in ("direct", "direct_cols", "expand", "grad",
                                                 "tile_ell")),
          f"phase 27: a kernel was not launched on the benchmarks' path: {mvm.LAUNCHES}")

    # at "highest", the configured tier
    meta = {"direct": ("K1 gramian_matvec_direct", "cfjax_torch/csrc/gramian_mvm.cu",
                       "cfjax/ops/pallas_mvm.py:253",
                       max(p1["direct"][2], k1_bh, k1_21, p25["k1_abs"]), None),
            "direct_cols": ("K1 gramian_matmat_direct (many columns on the tensor cores, p=16)",
                            "cfjax_torch/csrc/gramian_mvm.cu", "cfjax/ops/pallas_mvm.py:253",
                            max([p1["cols"][2]] + [t["abs_err"] for t in k1c.values()]), None),
            "matern": ("K1 real-nu Matern family (tabulated; Matern(2.3) d=3 n=16384)",
                       "cfjax_torch/csrc/gramian_mvm.cu", "cfjax/ops/pallas_mvm.py:253",
                       max(p1["matern"][2], m21_fam, p21h[2.3][2], p21h[2.5][2],
                           p21h["cols_abs"]), None),
            "expand": ("K2 gramian_matvec_expand", "cfjax_torch/csrc/expand_mvm.cu",
                       "cfjax/ops/pallas_mvm.py:152", p1["expand"][2], None),
            "expand_matern": ("K2 real-nu Matern family (tabulated; Lengthscale(Matern(1.3), 4) "
                              "d=64 n=16384)", "cfjax_torch/csrc/expand_mvm.cu",
                              "cfjax/ops/pallas_mvm.py:152", p21b["abs_err"], None),
            "grad": ("K3 grad_matvec", "cfjax_torch/csrc/grad_mvm.cu",
                     "cfjax/ops/pallas_mvm.py:374", p6[2], None),
            "grad_matern": ("K3 real-nu Matern jet family (tabulated; GradientKernel(Matern(2.7)) "
                            "n=4096 d=16)", "cfjax_torch/csrc/grad_mvm.cu",
                            "cfjax/ops/pallas_mvm.py:374", p21c["abs_err"], None),
            "tile_ell": ("K4 rows_matvec", "cfjax_torch/csrc/tile_ell_mvm.cu",
                         "cfjax/operators/tile_ell.py:344", f32[2],
                         (k4["library_call_ms"], k4["library_ms"]))}
    lib_ms = lambda key: "none" if meta[key][4] is None else \
        f"{meta[key][4][0]:.4f} ms ({meta[key][4][1]:.4f} device)"
    print("phase 5 kernel table (ms a call and device, bound ms and what sets it, share of "
          "the bound a call and device, launches on the path's run, library call ms a call "
          "and device): " + "; ".join(
              f"{' '.join(meta[key][0].split()[:2])} {times[key][0]:.4f} ms ({times[key][1]:.4f} device), "
              f"bound {bounds[key][0]:.4f} ms ({bounds[key][1]}), {share(key, 0):.1f}% "
              f"({share(key, 1):.1f}%), {launches[key]} launches, library {lib_ms(key)}"
              for key in meta), flush=True)
    # ms, plain_ms and library_ms: one call between CUDA events, host time
    # included; device_ms and library_device_ms: from CUDA graphs
    print(json.dumps({"kernels": [
        {"name": meta[key][0], "route": "cuda", "source": meta[key][1],
         "replaces": meta[key][2], "launches": launches[key], "max_abs_err": meta[key][3],
         "ms": times[key][0], "device_ms": times[key][1], "plain_ms": times[key][2],
         "bound_ms": bounds[key][0],
         "bound_by": "bytes" if bounds[key][1] == "HBM" else "operations",
         "library_ms": None if meta[key][4] is None else meta[key][4][0],
         "library_device_ms": None if meta[key][4] is None else meta[key][4][1]}
        for key in meta]}))
    print(f"chip_smoke total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
