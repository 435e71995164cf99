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
    the posterior mean off the grid is a rectangular Gramian through K1.
Phase 1 holds K1 and K2, phase 6 K3, phase 9 K4 against their float64
plain versions; phase 5 times each kernel against its plain version (K4
after phase 11, at its operator). One line per phase, then a JSON line of
kernel results, the card's name and power limit, and a last JSON line
`{"ok": true, "device": {...}}`. Any failed check raises: the script then
exits non-zero and prints no result. It needs a CUDA device and fails at
once without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

K1_BOUND = 1e-5   # relative L2 error of K1 vs its float64 plain version
K2_BOUND = 1e-4   # K2: the expansion cancels (cfjax's interpret tolerance is 2e-4)
K3_BOUND = 1e-4   # K3: float32 jet and Taylor bound (cfjax's interpret tolerance is 3e-4)
K4_BOUND = {torch.float32: 1e-5, torch.float64: 1e-12}   # K4 vs its float64 plain version
SPARSE_TOL = 1e-6  # the sparsification tolerance of phases 10 and 11
TOEPLITZ_BOUND = 1e-5   # float32 FFT MVMs of phases 12-13 vs float64 (relative L2)
VARIANCE_BOUND = 1e-4   # float32 posterior variance vs float64 (absolute; prior variance 1)
NOISE = 1e-2      # the GP's noise variance
Y_NOISE = 0.01    # standard deviation of the noise in the observations y


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def rel(out, ref):
    return float(torch.linalg.norm(out.double() - ref) / torch.linalg.norm(ref))


def cuda_tensor(arr):
    return torch.tensor(arr, dtype=torch.float32, device="cuda")


def sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def median_ms(fn, reps):
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ts = []
    for _ in range(reps):
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        ts.append(e0.elapsed_time(e1))
    return ts


def phase1_kernels(tk, mvm):
    """Each kernel vs its plain version (float64 from the same f32 inputs)."""
    rng = np.random.default_rng(1)
    k1_profiles = [tk.EQ(), tk.Exp(), tk.MaternP(0), tk.MaternP(1), tk.MaternP(2),
                   tk.MaternP(3), tk.Lengthscale(tk.MaternP(2), 0.5),
                   2.0 * tk.EQ() + 0.5 * tk.MaternP(1), tk.RQ(1.5)]
    res = {"direct": [0, 0.0, 0.0], "expand": [0, 0.0, 0.0]}   # cases, max rel, max abs

    def record(kind, out, ref, bound, what):
        r = rel(out, ref)
        check(torch.isfinite(out).all().item(), f"{what}: non-finite output")
        check(r <= bound, f"{what}: relative error {r:.3e} > {bound:.0e}")
        c = res[kind]
        c[0] += 1
        c[1] = max(c[1], r)
        c[2] = max(c[2], float((out.double() - ref).abs().max()))

    for d in (1, 3, 8, 16):
        for n, m in ((5003, 3001), (7, 16384)):
            x = cuda_tensor(rng.standard_normal((n, d)))
            y = cuda_tensor(rng.standard_normal((m, d)))
            a = cuda_tensor(rng.standard_normal(m))
            for k in k1_profiles:
                out = mvm.gramian_matvec_direct(k, x, y, a)
                ref = mvm.gramian_matvec_direct_plain(k, x.double(), y.double(), a.double())
                record("direct", out, ref, K1_BOUND, f"K1 d={d} {n}x{m} {k!r}")
    # points scaled by 1/sqrt(d): distances and inner products O(1), so
    # the profiles neither underflow nor overflow in f32
    cases = [(tk.EQ(), "iso", d) for d in (17, 64, 257)]
    cases += [(tk.MaternP(2), "iso", d) for d in (17, 64, 257)]
    cases += [(tk.Dot() ** 2, "dot", 64), (tk.ExponentialDot(), "dot", 64)]
    for k, mode, d in cases:
        x = cuda_tensor(rng.standard_normal((5003, d)) / np.sqrt(d))
        y = cuda_tensor(rng.standard_normal((3001, d)) / np.sqrt(d))
        a = cuda_tensor(rng.standard_normal(3001))
        out = mvm.gramian_matvec_expand(k, x, y, a, mode)
        ref = mvm.gramian_matvec_expand_plain(k, x.double(), y.double(), a.double(), mode)
        record("expand", out, ref, K2_BOUND, f"K2 {mode} d={d} {k!r}")
    torch.cuda.synchronize()
    print(f"phase 1 kernels vs plain: K1 {res['direct'][0]} cases max rel "
          f"{res['direct'][1]:.3e} (bound {K1_BOUND:.0e}) max abs {res['direct'][2]:.3e}; "
          f"K2 {res['expand'][0]} cases max rel {res['expand'][1]:.3e} "
          f"(bound {K2_BOUND:.0e}) max abs {res['expand'][2]:.3e}", flush=True)
    return res


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
                cg_iters=None if info is None else info[0], explain=how)


def phase6_grad_kernel(tk, gmvm):
    """K3 vs its float64 plain version, with copies of rows of x in y so
    that s = 0 occurs exactly. Returns (cases, max rel, max abs error,
    max |reference|)."""
    rng = np.random.default_rng(6)
    kernels = [(tk.EQ(), "iso"), (tk.MaternP(2), "iso"), (tk.MaternP(3), "iso"),
               (tk.Lengthscale(tk.MaternP(2), 0.5), "iso"),
               (2.0 * tk.EQ() + 0.5 * tk.MaternP(2), "iso"), (tk.RQ(1.5), "iso"),
               (tk.Dot() ** 2, "dot"), (tk.ExponentialDot(), "dot")]
    res = [0, 0.0, 0.0, 0.0]
    for d in (1, 3, 16, 64, 257, 1024):
        for n, m in ((1003, 601), (7, 4096)):
            # points scaled by 1/sqrt(d): distances and inner products O(1),
            # so the off-diagonal blocks neither underflow nor overflow
            xs = rng.standard_normal((n, d)) / np.sqrt(d)
            ys = rng.standard_normal((m, d)) / np.sqrt(d)
            ys[:min(16, n)] = xs[:16]
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
    torch.cuda.synchronize()
    print(f"phase 6 K3 vs float64 plain: {res[0]} cases (8 kernels, d in 1..1024, "
          f"1003x601 and 7x4096, up to 16 coincident points each) max rel {res[1]:.3e} "
          f"(bound {K3_BOUND:.0e}) max abs {res[2]:.3e} (largest |entry| {res[3]:.3e})",
          flush=True)
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
    print(f"phase 7 gradient GP (BASELINE config 4) EQ n=4096 d=16, 65536 unknowns: "
          f"{it} CG iterations (tol 1e-5), residual {res:.3e} (K3) / {res64:.3e} float64 "
          f"(bound 1e-4), K3 launches {launches}, gp_condition {wall:.3f} s, mean(1024) "
          f"{mean_wall:.4f} s, mean rows rel {mean_err:.3e}, off-diagonal share "
          f"||G a - a|| / ||G a|| = {share:.3f} | {how}", flush=True)
    return dict(cg_iters=it, launches=launches, residual=res, residual64=res64,
                wall_s=wall, mean_err=mean_err, share=share)


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
    return dict(residual=res, residual64=res64, wall_s=wall, row_err=row_err)


def phase9_tile_kernel(tmvm, res, a2, off, val, what):
    """K4 against its float64 plain version on one group, in float32 and in
    the float64 instance; res[dtype] = [cases, max rel, max abs]."""
    ref = tmvm.slab_matvec_plain(a2.double(), off, val.double())
    for dtype, bound in K4_BOUND.items():
        out = tmvm.slab_matvec(a2.to(dtype), off, val.to(dtype))
        r = rel(out, ref)
        check(torch.isfinite(out).all().item(), f"K4 {what} {dtype}: non-finite output")
        check(r <= bound, f"K4 {what} {dtype}: relative error {r:.3e} > {bound:.0e}")
        c = res[dtype]
        res[dtype] = [c[0] + 1, max(c[1], r), max(c[2], float((out.double() - ref).abs().max()))]


def phase9_synthetic(tmvm):
    """K4 on synthetic groups: K in {1, 2, 8, 32, 128}, nt in {1, 2, 128,
    256}, B in {8, 136}, offsets over the whole lane range, ~70% zero
    values; groups above 2^28 slots are left out (memory of the float64
    reference)."""
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
                a2 = torch.randn((nt, 128), generator=g, device="cuda")
                off = torch.randint(0, 128, shape, generator=g, device="cuda", dtype=torch.int32)
                val = torch.randn(shape, generator=g, device="cuda")
                val *= torch.rand(shape, generator=g, device="cuda") < 0.3
                phase9_tile_kernel(tmvm, res, a2, off, val, f"B={B} K={K} nt={nt}")
                del a2, off, val
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


def sparse_solve(ops, S, b, label):
    """MINRES on (S + noise I) alpha = b, tol 1e-5, through `solve`."""
    op = S.add_diagonal(NOISE)
    (alpha, info), wall = sync_time(lambda: ops.solve_with_info(op, b, tol=1e-5, maxiter=1000))
    it = info[0]
    check(it < 1000, f"{label}: MINRES did not converge in 1000 iterations "
                     f"(residual {float(info[1]):.3e})")
    return alpha, it, wall


def phase10_reference_sparse(tk, ops, so, tmvm):
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
    alpha, it, wall = sparse_solve(ops, S, b, "phase 10")
    res = residual(S @ alpha, alpha, b)
    res64 = residual(slab_plain64(S, tmvm, alpha), alpha, b)
    check(max(res, res64) <= 1e-4, f"phase 10: residual {res:.3e} / {res64:.3e} > 1e-4")
    print(f"phase 10 reference sparse config EQ d=32 n=16384 tol 1e-6 (scan build): build "
          f"{build_s:.3f} s, nnz {S.nnz} ratio {ratio:.6f}, nt {S.nt}, groups (K, B, B "
          f"allocated) {groups}, slabs {nbytes / 1e6:.1f} MB allocated, {slots / S.nnz:.1f} "
          f"slots per nonzero; S @ a rows rel {row_err:.3e}; solve(S + 1e-2 I) MINRES {it} "
          f"iterations {wall:.4f} s, residual {res:.3e} (K4) / {res64:.3e} float64 (bound 1e-4)",
          flush=True)
    return dict(S=S, iters=it, wall_s=wall, residual=res, residual64=res64, build_s=build_s)


def phase11_spatial_sparse(tk, ops, so, tmvm, mvm):
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
    b = torch.sin(x[:, 0]) + Y_NOISE * cuda_tensor(rng.standard_normal(n))
    before = mvm.LAUNCHES["tile_ell"]
    alpha, it, wall = sparse_solve(ops, S, b, "phase 11")
    launches = mvm.LAUNCHES["tile_ell"] - before
    check(launches >= it, f"phase 11: {launches} K4 launches < {it} MINRES iterations")
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
          f"{nbytes / 1e6:.1f} MB allocated, {slots / S.nnz:.1f} slots per nonzero; MINRES {it} "
          f"iterations (tol 1e-5) {wall:.4f} s, {launches} K4 launches, residual {res:.3e} (K4) "
          f"/ {res64:.3e} float64 (bound 1e-4); lazy TreeSparseOperator build {lazy_s:.3f} s, "
          f"rel to S @ a {lazy_err:.3e}", flush=True)
    return dict(S=S, iters=it, wall_s=wall, launches=launches, residual=res, residual64=res64,
                build_s=build_s, nbytes=nbytes)


def k4_times(S, tmvm):
    """K4 against its plain version on every group of S, plain / kernel /
    kernel / plain, median of 20 each; and the bytes one MVM reads."""
    rng = np.random.default_rng(12)
    n, m = S.shape
    a2 = torch.nn.functional.pad(cuda_tensor(rng.standard_normal(m)),
                                 (0, S.nt * 128 - m)).reshape(S.nt, 128)
    slabs = [(off[:(r1 - r0) // 128], val[:(r1 - r0) // 128]) for r0, r1, off, val in S.groups]
    kern = lambda: [tmvm.slab_matvec(a2, off, val) for off, val in slabs]
    plain = lambda: [tmvm.slab_matvec_plain(a2, off, val) for off, val in slabs]
    kern(), plain()   # warm-up
    t_plain = median_ms(plain, 10)
    t_kern = median_ms(kern, 10) + median_ms(kern, 10)
    t_plain += median_ms(plain, 10)
    nbytes = sum(off.numel() * 4 + val.numel() * 4 for off, val in slabs) + a2.numel() * 4
    return float(np.median(t_kern)), float(np.median(t_plain)), nbytes


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
    mvm_ms = float(np.median(median_ms(lambda: T @ a, 20)))
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
    lev_ms = median_ms(lambda: ops.levinson(col, b2), 1)[0]

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
    mvm_ms = float(np.median(median_ms(lambda: C @ a, 20)))
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
    mvm_ms = float(np.median(median_ms(lambda: K @ a, 20)))

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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    import cfjax_torch.kernels as tk
    import cfjax_torch.gp as gp
    import cfjax_torch.operators as ops
    from cfjax_torch.ops import build
    from cfjax_torch.operators import sparse_op as so
    from cfjax_torch.ops import grad_mvm as gmvm
    from cfjax_torch.ops import gramian_mvm as mvm
    from cfjax_torch.ops import tile_ell_mvm as tmvm

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    build.build()
    mvm.library(), gmvm.library(), tmvm.library()
    print(f"phase 0 card: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"kernel libraries {', '.join(build.LIBRARIES)} built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

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
    k1, k2 = tk.MaternP(2), tk.Lengthscale(tk.EQ(), 4.0)
    # K3 at the shapes of phase 7 (EQ, n = 4096, d = 16, x = 0.5 N(0, I))
    # and phase 8 (MaternP(2), n = d = 1024, x = N(0, I))
    xg7 = cuda_tensor(0.5 * rng.standard_normal((4096, 16)))
    ag7 = cuda_tensor(rng.standard_normal((4096, 16)))
    xg8 = cuda_tensor(rng.standard_normal((1024, 1024)))
    ag8 = cuda_tensor(rng.standard_normal((1024, 1024)))
    keq, km2 = tk.EQ(), tk.MaternP(2)
    runs = {
        "direct": (lambda: mvm.gramian_matvec_direct(k1, xh, xh, ah),
                   lambda: mvm.gramian_matvec_direct_plain(k1, xh, xh, ah)),
        "expand": (lambda: mvm.gramian_matvec_expand(k2, x64, x64, ah),
                   lambda: mvm.gramian_matvec_expand_plain(k2, x64, x64, ah)),
        "grad": (lambda: gmvm.grad_matvec(keq, xg7, xg7, ag7),
                 lambda: gmvm.grad_matvec_plain(keq, xg7, xg7, ag7)),
        "grad8": (lambda: gmvm.grad_matvec(km2, xg8, xg8, ag8),
                  lambda: gmvm.grad_matvec_plain(km2, xg8, xg8, ag8)),
    }
    times = {}
    for key, (kern, plain) in runs.items():
        kern(), plain()   # warm-up
        t_plain = median_ms(plain, 10)
        t_kern = median_ms(kern, 10) + median_ms(kern, 10)
        t_plain += median_ms(plain, 10)
        times[key] = (float(np.median(t_kern)), float(np.median(t_plain)))
    print(f"phase 5 times (median of 20, CUDA events): K1 MaternP(2) n=16384 d=3 "
          f"{times['direct'][0]:.4f} ms vs plain {times['direct'][1]:.4f} ms; K2 "
          f"Lengthscale(EQ, 4) n=16384 d=64 {times['expand'][0]:.4f} ms vs plain "
          f"{times['expand'][1]:.4f} ms; K3 EQ n=4096 d=16 {times['grad'][0]:.4f} ms vs "
          f"plain {times['grad'][1]:.4f} ms; K3 MaternP(2) n=1024 d=1024 "
          f"{times['grad8'][0]:.4f} ms vs plain {times['grad8'][1]:.4f} ms | phase walls: "
          f"2 {p2['wall_s']:.3f} s, 3 {p3['wall_s']:.3f} s ({p3['cg_iters']} CG iterations), "
          f"4 {p4['wall_s']:.3f} s", flush=True)

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

    p9, p9_skipped = phase9_synthetic(tmvm)

    # ---- the sparsify-then-solve path: counts from here to the end of phase 11 ----
    for key in mvm.LAUNCHES:
        mvm.LAUNCHES[key] = 0
    p10 = phase10_reference_sparse(tk, ops, so, tmvm)
    p11 = phase11_spatial_sparse(tk, ops, so, tmvm, mvm)
    launches["tile_ell"] = mvm.LAUNCHES["tile_ell"]
    check(launches["tile_ell"] > 0, "kernel 'tile_ell' was not launched on the sparse path")

    # ---- phase 9 (continued): K4 on the groups of the phase-10 and phase-11 operators ----
    rng = np.random.default_rng(9)
    for label, S in (("phase 10", p10["S"]), ("phase 11", p11["S"])):
        a2 = torch.nn.functional.pad(cuda_tensor(rng.standard_normal(S.shape[1])),
                                     (0, S.nt * 128 - S.shape[1])).reshape(S.nt, 128)
        for gi, (r0, r1, off, val) in enumerate(S.groups):
            blocks = (r1 - r0) // 128
            phase9_tile_kernel(tmvm, p9, a2, off[:blocks], val[:blocks],
                               f"{label} group {gi} K={off.shape[1]} B={blocks}")
    torch.cuda.synchronize()
    f32, f64 = p9[torch.float32], p9[torch.float64]
    synthetic = f32[0] - len(p10["S"].groups) - len(p11["S"].groups)
    print(f"phase 9 K4 vs float64 plain: {f32[0]} groups ({synthetic} synthetic, "
          f"{p9_skipped} over 2^28 slots left out, and the groups of phases 10 and "
          f"11): float32 max rel {f32[1]:.3e} (bound {K4_BOUND[torch.float32]:.0e}) max abs "
          f"{f32[2]:.3e}; float64 instance max rel {f64[1]:.3e} (bound "
          f"{K4_BOUND[torch.float64]:.0e}) max abs {f64[2]:.3e}", flush=True)

    # ---- phase 5 (K4): at phase 11's operator ----
    k4_ms, k4_plain_ms, k4_bytes = k4_times(p11["S"], tmvm)
    times["tile_ell"] = (k4_ms, k4_plain_ms)
    gbs = k4_bytes / k4_ms / 1e6
    print(f"phase 5 (K4) times (median of 20, CUDA events) at phase 11's operator (all groups): "
          f"K4 {k4_ms:.4f} ms vs plain {k4_plain_ms:.4f} ms; {k4_bytes / 1e6:.1f} MB of off+val+a "
          f"read per MVM, {gbs:.1f} GB/s = {100 * gbs / 3350:.1f}% of the H100 SXM's 3350 GB/s; "
          f"one MINRES solve {p11['wall_s']:.4f} s ({p11['iters']} "
          f"iterations), phase 10's {p10['wall_s']:.4f} s ({p10['iters']} iterations)", flush=True)

    # ---- the structured path: counts from here to the end of phase 14 ----
    for key in mvm.LAUNCHES:
        mvm.LAUNCHES[key] = 0
    t_struct = time.perf_counter()
    p12, w12 = sync_time(lambda: phase12_toeplitz(tk, ops, gp, mvm))
    p13, w13 = sync_time(lambda: phase13_circulant(tk, ops, gp))
    p14, w14 = sync_time(lambda: phase14_kronecker(tk, ops, gp))
    check(mvm.LAUNCHES["direct"] > 0, "kernel 'direct' was not launched on the structured path")
    print(f"phases 12-14 structured path {time.perf_counter() - t_struct:.1f} s (walls: 12 "
          f"{w12:.3f} s, 13 {w13:.3f} s, 14 {w14:.3f} s, checks included): FFT MVM "
          f"{p12['mvm_ms']:.4f} ms (Toeplitz n=65536) / {p13['mvm_ms']:.4f} ms (circulant "
          f"n=65536), Kronecker MVM {p14['mvm_ms']:.4f} ms (128^3), levinson n=16384 "
          f"{p12['lev_ms']:.1f} ms; K1 launches {mvm.LAUNCHES['direct']}", flush=True)

    meta = {"direct": ("K1 gramian_matvec_direct", "cfjax_torch/csrc/gramian_mvm.cu",
                       "cfjax/ops/pallas_mvm.py:253", p1["direct"][2]),
            "expand": ("K2 gramian_matvec_expand", "cfjax_torch/csrc/gramian_mvm.cu",
                       "cfjax/ops/pallas_mvm.py:152", p1["expand"][2]),
            "grad": ("K3 grad_matvec", "cfjax_torch/csrc/grad_mvm.cu",
                     "cfjax/ops/pallas_mvm.py:374", p6[2]),
            "tile_ell": ("K4 slab_matvec", "cfjax_torch/csrc/tile_ell_mvm.cu",
                         "cfjax/operators/tile_ell.py:344", f32[2])}
    print(json.dumps({"kernels": [
        {"name": meta[key][0], "route": "cuda", "source": meta[key][1],
         "replaces": meta[key][2], "launches": launches[key], "max_abs_err": meta[key][3],
         "ms": times[key][0], "plain_ms": times[key][1]} for key in meta]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
