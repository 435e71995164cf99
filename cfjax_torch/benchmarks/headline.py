"""The headline lazy MVM on the card: the port's twin of `bench.py`.

    python3 bench_torch.py [--n N] [--device cpu]
    python3 -m cfjax_torch.benchmarks.headline [--n N] [--device cpu]

The reference README's headline configuration (BASELINE.md: 0.585 s on the
reference's CPU): MaternP(2), d = 3, n = 16384, float32, the points and
the vector drawn from `np.random.default_rng(0)` as `bench.py` draws
them, the operator built as `Gramian(k, x)`. Prints one JSON line:

  * `value`: seconds per `G._matvec` by `time_chained` (slope timing over
    chained calls on the host clock, a synchronize at each end), as
    `bench.py` measures, the wrapper's host time included;
  * `device_ms`: the same call's device time from a CUDA graph;
  * `row_check_rel_err`: the product over the first 1024 entries of row 0
    through the wrapper, against the same sum in float64, over |b_0|
    (bench.py:44-47);
  * `k1_launches`: K1's launches while `value` and `device_ms` were taken;
  * the card's name and power limit (`nvidia-smi`).

Exits non-zero when the row error exceeds ROW_BOUND, or, on the card,
when K1's launch counter did not move. On the CPU (`--device cpu`) the
wrapper takes its plain version: no launch and no device time there.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .. import config as _config
from ..kernels import MaternP
from ..operators import Gramian
from ..ops import gramian_mvm as mvm
from ..utils.timing import MeasurementError, graph_ms, time_chained
from .common import DEVICES, card, take_device

METRIC = "maternp2_n16384_d3_lazy_mvm_seconds"
REF_SECONDS = 0.585   # BASELINE.md: the reference's lazy dense MVM on its CPU
ROW_BOUND = 1e-5      # the row check's relative error
ROW_ENTRIES = 1024


def measure(n: int = 16384, d: int = 3) -> dict:
    """The headline's JSON object on the port's configured device."""
    device = _config.default_device()
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((n, d)), dtype=torch.float32, device=device)
    a = torch.tensor(rng.standard_normal(n), dtype=torch.float32, device=device)
    k = MaternP(2)
    G = Gramian(k, x)
    before = mvm.LAUNCHES["direct"]
    try:
        value = time_chained(G._matvec, a)
    except MeasurementError:   # reported as null, never a clamped number
        value = None
    dev = float(np.median(graph_ms(lambda: G._matvec(a)))) if device.type == "cuda" else None
    launches = mvm.LAUNCHES["direct"] - before
    m = min(ROW_ENTRIES, n)
    with mvm.uncounted():   # products made only for the check
        b0 = float(G._matvec(a)[0])
        part = Gramian(k, x[:1], x[:m])._matvec(a[:m])
    ref = mvm.gramian_matvec_direct_plain(k, x[:1].double(), x[:m].double(), a[:m].double())
    rel = float(torch.abs(part.double() - ref)[0]) / (abs(b0) + 1e-30)
    c = card()
    return {"metric": METRIC if n == 16384 and d == 3 else f"maternp2_n{n}_d{d}_lazy_mvm_seconds",
            "value": value, "unit": "s", "vs_baseline": value and REF_SECONDS / value,
            "row_check_rel_err": rel, "device_ms": dev, "k1_launches": launches,
            "backend": device.type, "card": c["name"], "power_limit": c["power_limit"]}


def failures(out: dict) -> list:
    """What a headline reading fails: its row error, and on the card K1's
    launch counter."""
    bad = []
    if out["value"] is None:
        bad.append("the slope was not separable from the timing spread")
    if not out["row_check_rel_err"] <= ROW_BOUND:
        bad.append(f"row_check_rel_err {out['row_check_rel_err']:.3e} > {ROW_BOUND:.0e}")
    if out["backend"] == "cuda" and out["k1_launches"] <= 0:
        bad.append("K1's launch counter did not move")
    return bad


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--device", choices=DEVICES, default="cuda")
    args = ap.parse_args(argv)
    take_device(args.device, "headline")
    out = measure(args.n)
    print(json.dumps(out), flush=True)
    bad = failures(out)
    if bad:
        print("headline: " + "; ".join(bad), file=sys.stderr)
        sys.exit(1)
    return out


if __name__ == "__main__":
    main()
