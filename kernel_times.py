"""Time the port's four kernels through their public wrappers, at the
shapes of `chip_smoke.py` phase 5 (with the ARD cell's K2 product), for
the `cfjax_torch` of a checkout; K2 and K3 at each matmul tier
("highest" under the kernels' names, the tf32 tiers as "... @ high" /
"... @ default", null where the checkout's kernel declines the tier);
K1's many-column variant at p = 16 (the SLQ probe batch), null where the
checkout has none.

    python3 kernel_times.py [--root DIR] [--label NAME]

`--root` is the checkout whose `cfjax_torch` is imported (default: this
one), so that two commits can be timed one after the other on one card: unpack
the other commit with `git archive` into a directory that `.gitignore`
lists and run both, alternating (parent, change, change, parent). Each
kernel is timed by `cfjax_torch/utils/timing.py`'s `kernel_times`, loaded
from this checkout by its path: one call between CUDA events, the
wrapper's host time included (median of 2 x 10), and device time from a
CUDA graph of 20 calls (median of 2 x 5 replays; null where the wrapper
cannot be captured). K4 is timed as `S @ a` on phase 11's operator, so that a
layout of several launches a product is timed whole. Prints one JSON
object with the card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch


def load_timing():
    """This checkout's `cfjax_torch/utils/timing.py`, loaded by its path, so
    that `--root` imports the other checkout's `cfjax_torch` for the
    kernels under test and the timers stay the same for both."""
    path = Path(__file__).resolve().parent / "cfjax_torch" / "utils" / "timing.py"
    spec = importlib.util.spec_from_file_location("kernel_times_timing", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


timing = None


def times(fn):
    """{"call_ms", "device_ms"} of fn by `timing.kernel_times` (calls between
    CUDA events and CUDA graphs, in turns); a wrapper that cannot be
    captured in a graph gets its calls alone and a null device time."""
    try:
        call, dev, _ = timing.kernel_times(fn)
    except RuntimeError:   # not capturable
        torch.cuda.synchronize()
        return {"call_ms": float(np.median(timing.event_ms(fn, 40))), "device_ms": None}
    return {"call_ms": call, "device_ms": dev}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        sys.exit(2)
    global timing
    timing = load_timing()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import cfjax_torch.kernels as tk
    from cfjax_torch.operators.sparse_op import sparse_gramian
    from cfjax_torch.ops import grad_mvm as gmvm
    from cfjax_torch.ops import gramian_mvm as mvm

    rng = np.random.default_rng(0)
    f = lambda *shape, scale=1.0: torch.tensor(scale * rng.standard_normal(shape),
                                               dtype=torch.float32, device="cuda")
    xh, ah, x64 = f(16384, 3), f(16384), f(16384, 64)
    xg7, ag7, xgm = f(4096, 16, scale=0.5), f(4096, 16), f(1024, 16, scale=0.5)
    xg8, ag8 = f(1024, 1024), f(1024, 1024)
    x11 = torch.tensor(np.random.default_rng(11).uniform(0, 20, (32768, 2)),
                       dtype=torch.float32, device="cuda")
    S, _ = sparse_gramian(tk.Lengthscale(tk.EQ(), 0.2), x11, tol=1e-6, method="tree")
    a11 = f(32768)
    k1, k2, keq, km2 = tk.MaternP(2), tk.Lengthscale(tk.EQ(), 4.0), tk.EQ(), tk.MaternP(2)
    km27 = tk.Matern(2.7)
    runs = {
        "K1 MaternP(2) n=16384 d=3": lambda: mvm.gramian_matvec_direct(k1, xh, xh, ah),
        "K2 Lengthscale(EQ, 4) n=16384 d=64": lambda: mvm.gramian_matvec_expand(k2, x64, x64,
                                                                                 ah),
        "K3 EQ n=4096 d=16": lambda: gmvm.grad_matvec(keq, xg7, xg7, ag7),
        "K3 MaternP(2) n=d=1024": lambda: gmvm.grad_matvec(km2, xg8, xg8, ag8),
        "K3 Matern(2.7) n=4096 d=16": lambda: gmvm.grad_matvec(km27, xg7, xg7, ag7),
        # config 4's posterior mean: 1024 test points against the 4096
        "K3 EQ 1024x4096 d=16": lambda: gmvm.grad_matvec(keq, xgm, xg7, ag7),
        f"K4 S @ a, phase 11's operator (nnz {S.nnz})": lambda: S @ a11,
    }
    # the ARD cell's product: K2 on the points the fold divides by l, d = 90
    x90, a90 = f(65536, 90, scale=90 ** -0.5), f(65536)
    kard = 6.67 * tk.MaternP(2)
    runs["K2 6.67 MaternP(2) n=65536 d=90 (the ARD cell's product)"] = (
        lambda: mvm.gramian_matvec_expand(kard, x90, x90, a90))
    x17 = f(131072, 3)
    for n, x in ((16384, xh), (131072, x17)):
        A = f(n, 16)
        runs[f"K1 many-column MaternP(2) n={n} d=3 p=16"] = (
            (lambda x=x, A=A: mvm.gramian_matmat_direct(k1, x, x, A))
            if hasattr(mvm, "gramian_matmat_direct") else None)
    out = {name: None if fn is None else times(fn) for name, fn in runs.items()}
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
