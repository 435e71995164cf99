"""Smoke run of cfjax_torch's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA Gramian MVM kernels from the checkout, checks each kernel
against its plain torch version on the card, then drives the GP path a
user runs: `gramian()` -> lazy Gramian MVM -> Cholesky or Nystrom-PCG
solve -> posterior mean, at the reference README's headline size
(MaternP(2), d = 3, n = 16384), in the lazy regime (n = 2^17) and through
the expansion kernel (d = 64). One line per phase, then a JSON line of
kernel results, the card's name and power limit, and a last JSON line
`{"ok": true, "device": {...}}`. Any failed check raises: the script then
exits non-zero and prints no result. It needs a CUDA device and fails
at once without one.
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


def residual(Kalpha, alpha, y):
    """||(K + noise I) alpha - y|| / ||y|| in float64, given K alpha."""
    alpha, y = alpha.double(), y.double()
    return float(torch.linalg.norm(Kalpha.double() + NOISE * alpha - y) / torch.linalg.norm(y))


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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    import cfjax_torch.kernels as tk
    import cfjax_torch.gp as gp
    import cfjax_torch.operators as ops
    from cfjax_torch.ops import gramian_mvm as mvm

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    mvm.library()
    print(f"phase 0 card: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"kernel library built in {time.perf_counter() - t0:.1f} s", flush=True)

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
    for key, n_launch in launches.items():
        check(n_launch > 0, f"kernel {key!r} was not launched on the main path")

    # ---- phase 5: times, plain / kernel / kernel / plain, median of 20 each ----
    rng = np.random.default_rng(0)
    xh = cuda_tensor(rng.standard_normal((16384, 3)))
    ah = cuda_tensor(rng.standard_normal(16384))
    x64 = cuda_tensor(rng.standard_normal((16384, 64)))
    k1, k2 = tk.MaternP(2), tk.Lengthscale(tk.EQ(), 4.0)
    runs = {
        "direct": (lambda: mvm.gramian_matvec_direct(k1, xh, xh, ah),
                   lambda: mvm.gramian_matvec_direct_plain(k1, xh, xh, ah)),
        "expand": (lambda: mvm.gramian_matvec_expand(k2, x64, x64, ah),
                   lambda: mvm.gramian_matvec_expand_plain(k2, x64, x64, ah)),
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
          f"{times['expand'][1]:.4f} ms | phase walls: 2 {p2['wall_s']:.3f} s, 3 "
          f"{p3['wall_s']:.3f} s ({p3['cg_iters']} CG iterations), 4 {p4['wall_s']:.3f} s",
          flush=True)

    meta = {"direct": ("K1 gramian_matvec_direct", "cfjax/ops/pallas_mvm.py:253"),
            "expand": ("K2 gramian_matvec_expand", "cfjax/ops/pallas_mvm.py:152")}
    print(json.dumps({"kernels": [
        {"name": meta[key][0], "route": "cuda", "source": "cfjax_torch/csrc/gramian_mvm.cu",
         "replaces": meta[key][1], "launches": launches[key], "max_abs_err": p1[key][2],
         "ms": times[key][0], "plain_ms": times[key][1]} for key in ("direct", "expand")]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
