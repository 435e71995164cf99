"""Time the port's four kernels through their public wrappers, at the
shapes of `chip_smoke.py` phase 5, for the `cfjax_torch` of a checkout;
K2 and K3 at each matmul tier ("highest" under the kernels' names, the
tf32 tiers as "... @ high" / "... @ default", null where the checkout's
kernel declines the tier).

    python3 kernel_times.py [--root DIR] [--label NAME]

`--root` is the checkout whose `cfjax_torch` is imported (default: this
one), so that two commits can be timed one after the other on one card: unpack
the other commit with `git archive` into a directory that `.gitignore`
lists and run both, alternating (parent, change, change, parent). Each
kernel is timed as one call between CUDA events, the wrapper's host time
included (median of 2 x 20), and as device time from a CUDA graph of 20
calls (median of 2 x 5 replays; null where the wrapper cannot be
captured). K4 is timed as `S @ a` on phase 11's operator, so that a
layout of several launches a product is timed whole. Prints one JSON
object with the card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch


def call_ms(fn, reps=20):
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ts = []
    for _ in range(reps):
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        ts.append(e0.elapsed_time(e1))
    return ts


def device_ms(fn, reps=20, replays=5):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ts = []
    for _ in range(replays):
        e0.record()
        g.replay()
        e1.record()
        torch.cuda.synchronize()
        ts.append(e0.elapsed_time(e1) / reps)
    return ts


def times(fn):
    fn()
    torch.cuda.synchronize()
    calls, dev = [], []
    for turn in ("call", "device", "device", "call"):
        if turn == "call":
            calls += call_ms(fn)
        elif dev is not None:
            try:
                dev += device_ms(fn)
            except RuntimeError:
                dev = None
    return {"call_ms": float(np.median(calls)),
            "device_ms": None if dev is None else float(np.median(dev))}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import cfjax_torch.kernels as tk
    from cfjax_torch.operators.sparse_op import sparse_gramian
    from cfjax_torch.ops import grad_mvm as gmvm
    from cfjax_torch.ops import gramian_mvm as mvm

    rng = np.random.default_rng(0)
    f = lambda *shape, scale=1.0: torch.tensor(scale * rng.standard_normal(shape),
                                               dtype=torch.float32, device="cuda")
    xh, ah, x64 = f(16384, 3), f(16384), f(16384, 64)
    xg7, ag7 = f(4096, 16, scale=0.5), f(4096, 16)
    xg8, ag8 = f(1024, 1024), f(1024, 1024)
    x11 = torch.tensor(np.random.default_rng(11).uniform(0, 20, (32768, 2)),
                       dtype=torch.float32, device="cuda")
    S, _ = sparse_gramian(tk.Lengthscale(tk.EQ(), 0.2), x11, tol=1e-6, method="tree")
    a11 = f(32768)
    k1, k2, keq, km2 = tk.MaternP(2), tk.Lengthscale(tk.EQ(), 4.0), tk.EQ(), tk.MaternP(2)
    runs = {
        "K1 MaternP(2) n=16384 d=3": lambda: mvm.gramian_matvec_direct(k1, xh, xh, ah),
        "K2 Lengthscale(EQ, 4) n=16384 d=64": lambda: mvm.gramian_matvec_expand(k2, x64, x64,
                                                                                 ah),
        "K3 EQ n=4096 d=16": lambda: gmvm.grad_matvec(keq, xg7, xg7, ag7),
        "K3 MaternP(2) n=d=1024": lambda: gmvm.grad_matvec(km2, xg8, xg8, ag8),
        f"K4 S @ a, phase 11's operator (nnz {S.nnz})": lambda: S @ a11,
    }
    out = {name: times(fn) for name, fn in runs.items()}
    import cfjax_torch

    for tier in ("high", "default"):
        cfjax_torch.set_config(matmul_precision=tier)
        try:
            for name, fn in runs.items():
                if name.startswith(("K2", "K3")):
                    try:
                        out[f"{name} @ {tier}"] = times(fn)
                    except ValueError as e:   # only a kernel that declines the tier
                        if "tf32 tiers are not ported" not in str(e):
                            raise
                        out[f"{name} @ {tier}"] = None
        finally:
            cfjax_torch.set_config(matmul_precision="highest")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"label": args.label, "root": args.root, "card": smi, "kernels": out}))


if __name__ == "__main__":
    main()
