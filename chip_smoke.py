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
    README's gradient configuration (MaternP(2), n = d = 1024).
Phase 1 holds K1 and K2, phase 6 K3, against their float64 plain
versions; phase 5 times each kernel against its plain version. One line
per phase, then a JSON line of kernel results, the card's name and power
limit, and a last JSON line `{"ok": true, "device": {...}}`. Any failed
check raises: the script then exits non-zero and prints no result. It
needs a CUDA device and fails at once without one.
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    import cfjax_torch.kernels as tk
    import cfjax_torch.gp as gp
    import cfjax_torch.operators as ops
    from cfjax_torch.ops import build
    from cfjax_torch.ops import grad_mvm as gmvm
    from cfjax_torch.ops import gramian_mvm as mvm

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    build.build()
    mvm.library(), gmvm.library()
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

    meta = {"direct": ("K1 gramian_matvec_direct", "cfjax_torch/csrc/gramian_mvm.cu",
                       "cfjax/ops/pallas_mvm.py:253", p1["direct"][2]),
            "expand": ("K2 gramian_matvec_expand", "cfjax_torch/csrc/gramian_mvm.cu",
                       "cfjax/ops/pallas_mvm.py:152", p1["expand"][2]),
            "grad": ("K3 grad_matvec", "cfjax_torch/csrc/grad_mvm.cu",
                     "cfjax/ops/pallas_mvm.py:374", p6[2])}
    print(json.dumps({"kernels": [
        {"name": meta[key][0], "route": "cuda", "source": meta[key][1],
         "replaces": meta[key][2], "launches": launches[key], "max_abs_err": meta[key][3],
         "ms": times[key][0], "plain_ms": times[key][1]} for key in ("direct", "expand", "grad")]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
