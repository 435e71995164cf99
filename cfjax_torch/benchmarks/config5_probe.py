"""Config 5's Nystrom PCG, bisected on the card.

    python3 -m cfjax_torch.benchmarks.config5_probe [--variants abcdefg]
        [--points cfjax,seed19] [--rank 2048] [--tol 1e-4] [--maxiter 60]
        [--rows 4096] [--out PATH] [--device cpu --scale tiny]

BASELINE config 5's solve (`run_baseline`'s `gp_solve_nystrom_pcg_exact_
n1e6_box20_rank*` rows): Lengthscale(EQ, 1) on n = 10^6 points uniform in
the 20 x 20 box, sigma^2 = 1e-2, y = sin(x_0) + 0.1 w, rank-r Nystrom PCG
(landmarks from seed 0) to `tol` within `maxiter` iterations. The points
are cfjax's own (`run_baseline.barneshut_draws`, seed 0, drawn in cfjax's
order) or chip_smoke.py phase 19a's (seed 19). The variants change one
component at a time:

  a  as the package runs it: M built in float64 on the device (float32
     points) and applied in float32, the operator K1 (float32);
  b  M built and applied in float64 (`nystrom_factors` on float64 points,
     its host factors kept in float64), K1;
  c  M as in (a), the operator in float64 (`eq_matvec_f64`: csrc/
     reference_f64.cu on the card, K1's plain version on the CPU), rounded
     to float32 for the float32 recurrence;
  d  both in float64, the recurrence too;
  e  M of (b), applied in float32 (its factors rounded), K1;
  f  M built in float32 as cfjax builds it (`build_dtype=torch.float32`),
     applied in float64 (its factors widened), K1;
  g  M built in float32 as cfjax builds it, applied in float32, K1: the
     package's build before the float64 one.

For each: the recursive relres at every iteration, the float64 residual
on `--rows` rows every 10 iterations (and at the end), the iterations, the
walls; for each M, the difference of its apply from the float64 build's on
y and on a normal vector. One JSON object goes to `--out` (default
`chiprun_out/config5_probe.json`) and a summary line per run to stdout.
Without a card it exits 2 unless given `--device cpu` (then `--scale tiny`
shrinks n and the rank, `run_baseline`'s tiny sizes).
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import set_config
from ..kernels import EQ, Lengthscale
from ..operators import cg, gramian
from ..operators.preconditioner import nystrom_apply, nystrom_factors
from ..ops import build as _build
from ..ops import gramian_mvm as mvm
from .common import card, commit
from .run_baseline import SIZES, barneshut_draws, check_rows

SIGMA2 = 1e-2
LENGTHSCALE = 1.0
VARIANTS = "abcdefg"


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("reference_f64")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.eq_matvec_f64.argtypes = [p, p, p, p, i, i, i, ctypes.c_double, p]
    lib.eq_matvec_f64.restype = i
    return lib


def eq_matvec_f64(x, y, a, lengthscale: float = LENGTHSCALE):
    """b = K a in float64 for Lengthscale(EQ, lengthscale): the reference
    kernel on CUDA tensors (csrc/reference_f64.cu), K1's plain version in
    float64 on CPU tensors."""
    x, y, a = x.double().contiguous(), y.double().contiguous(), a.double().contiguous()
    if not x.is_cuda:
        k = Lengthscale(EQ(), lengthscale)
        return mvm.gramian_matvec_direct_plain(k, x, y, a)
    out = torch.empty(x.shape[0], dtype=torch.float64, device=x.device)
    err = _library().eq_matvec_f64(x.data_ptr(), y.data_ptr(), a.data_ptr(), out.data_ptr(),
                                   x.shape[0], y.shape[0], x.shape[1],
                                   0.5 / lengthscale ** 2,
                                   torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"eq_matvec_f64 failed to launch: cudaError {err}")
    return out


def points(which: str, z: dict):
    """(x, w) as float64 numpy arrays: cfjax's config-5 points or phase 19a's."""
    if which == "cfjax":
        dr = barneshut_draws(z)
        return dr["x5"], dr["w3"]
    rng = np.random.default_rng(19)
    n = z["bh_n3"]
    x = rng.uniform(-10, 10, (n, 2))
    return x, rng.uniform(0, 1, n)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def probe_points(which, z, device, rank, tol, maxiter, nrows, variants, log):
    """Every variant on one point set; returns the runs and the M diagnostics."""
    k = Lengthscale(EQ(), LENGTHSCALE)
    xn, wn = points(which, z)
    x32 = torch.tensor(xn, dtype=torch.float32, device=device)
    y32 = torch.sin(x32[:, 0]) + 0.1 * torch.tensor(wn, dtype=torch.float32, device=device)
    x64, y64 = x32.double(), y32.double()
    n = x32.shape[0]
    rows = torch.as_tensor(check_rows(n, nrows), device=device)
    yr = y64[rows]
    G = gramian(k, x32)
    K1 = lambda v: G._matvec(v) + SIGMA2 * v
    K64 = lambda v: eq_matvec_f64(x64, x64, v) + SIGMA2 * v
    K64r = lambda v: (eq_matvec_f64(x64, x64, v.double()) + SIGMA2 * v.double()).to(v.dtype)

    def resid64(v):
        v = v.double()
        r = yr - eq_matvec_f64(x64[rows], x64, v) - SIGMA2 * v[rows]
        return float(torch.linalg.norm(r) / torch.linalg.norm(yr))

    factors, walls = {}, {}

    def build(prec):
        if prec not in factors:
            t0 = time.perf_counter()
            if prec == "package":
                factors[prec] = nystrom_factors(k, x32, SIGMA2, rank=rank)
            elif prec == "f32":
                factors[prec] = nystrom_factors(k, x32, SIGMA2, rank=rank,
                                                build_dtype=torch.float32)
            else:
                factors[prec] = nystrom_factors(k, x64, SIGMA2, rank=rank,
                                                factor_dtype=np.float64)
            _sync(device)
            walls[prec] = time.perf_counter() - t0
        return factors[prec]

    def cast(f, dt):
        return tuple(t.to(dt) for t in f)

    def M_of(variant):
        if variant in "ac":
            f = build("package")
        elif variant in "fg":
            f = build("f32")
            if variant == "f":
                M = nystrom_apply(*cast(f, torch.float64), SIGMA2)
                return lambda v: M(v.double()).to(v.dtype)
        else:
            f = build("f64")
            if variant == "e":
                f = cast(f, torch.float32)
        M = nystrom_apply(*f, SIGMA2)
        return lambda v: M(v.to(f[0].dtype)).to(v.dtype)

    runs = []
    for variant in variants:
        M = M_of(variant)
        if variant == "d":
            op, b = K64, y64
        else:
            op, b = (K64r if variant == "c" else K1), y32
        bn = float(torch.linalg.norm(b))
        relres, checks = [], []

        def seen(i, xa, r):
            relres.append(float(torch.linalg.norm(r)) / bn)
            if i % 10 == 0:
                checks.append([i, resid64(xa)])

        before = mvm.LAUNCHES["direct"]
        _sync(device)
        t0 = time.perf_counter()
        alpha, (it, res) = cg(op, b, tol=tol, maxiter=maxiter, M=M, callback=seen)
        _sync(device)
        wall = time.perf_counter() - t0
        launches = mvm.LAUNCHES["direct"] - before
        final = resid64(alpha)
        run = {"points": which, "variant": variant, "rank": rank, "n": n,
               "iterations": int(it), "converged": bool(float(res) / bn <= tol),
               "final_relres": float(res) / bn, "final_resid64": final,
               "relres": relres, "resid64": checks, "solve_s": wall,
               "k1_launches": launches, "dtype": str(b.dtype).replace("torch.", "")}
        runs.append(run)
        log(f"config5_probe {which} ({variant}): {it} iterations to relres "
            f"{float(res) / bn:.3e}, float64 residual on {len(rows)} rows {final:.3e}, "
            f"{wall:.1f} s, {launches} K1 launches")
        del M
    diag = {"build_s": walls}
    _sync(device)
    t0 = time.perf_counter()
    K64(y64)
    _sync(device)
    diag["f64_product_s"] = time.perf_counter() - t0
    if "f64" in factors:
        # each float32 apply against the float64 build's, on y and on a
        # normal vector
        M64 = nystrom_apply(*factors["f64"], SIGMA2)
        g = torch.Generator(device="cpu").manual_seed(5)
        v = torch.randn(n, generator=g, dtype=torch.float64).to(device)
        others = {prec: f for prec, f in factors.items() if prec != "f64"}
        others["f64_rounded"] = cast(factors["f64"], torch.float32)
        for name in ("y", "normal"):
            u = y64 if name == "y" else v
            ref = M64(u)
            for prec, f in others.items():
                out = nystrom_apply(*f, SIGMA2)(u.float()).double()
                diag[f"apply_{prec}_vs_f64_{name}"] = float(torch.linalg.norm(out - ref)
                                                            / torch.linalg.norm(ref))
        for prec, f in factors.items():
            U, E, d = f
            diag[f"denom_{prec}"] = {"min": float(d.min()), "max": float(d.max())}
    factors.clear()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return runs, diag


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=VARIANTS)
    ap.add_argument("--points", default="cfjax,seed19")
    ap.add_argument("--seed19-variants", default="ad",
                    help="the variants run on phase 19a's points")
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument("--maxiter", type=int, default=60)
    ap.add_argument("--rows", type=int, default=4096)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", default="full", choices=sorted(SIZES))
    ap.add_argument("--out", default="chiprun_out/config5_probe.json")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("config5_probe: no CUDA device (--device cpu runs on the host)", file=sys.stderr)
        return 2
    device = torch.device(args.device)
    set_config(device=args.device)
    if device.type == "cuda":
        _build.build(("gramian_mvm", "reference_f64"))   # K1 and the float64 reference
    z = SIZES[args.scale]
    rank = args.rank or z["ranks"][1]
    out = {"card": card() if device.type == "cuda" else None, "commit": commit(),
           "torch": torch.__version__, "device": str(device),
           "fp32_precision": getattr(torch.backends.cuda.matmul, "fp32_precision", None),
           "sigma2": SIGMA2, "rank": rank, "tol": args.tol, "maxiter": args.maxiter,
           "rows": args.rows, "points": {}}
    t0 = time.perf_counter()
    for which in args.points.split(","):
        variants = args.variants if which == "cfjax" else args.seed19_variants
        runs, diag = probe_points(which, z, device, rank, args.tol, args.maxiter, args.rows,
                                  [v for v in variants if v in VARIANTS],
                                  lambda s: print(s, flush=True))
        out["points"][which] = {"runs": runs, "diagnostics": diag}
    out["wall_s"] = time.perf_counter() - t0
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1) + "\n")
    print(f"config5_probe: wrote {path} in {out['wall_s']:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
