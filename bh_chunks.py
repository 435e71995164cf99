"""Time cfjax_torch's Barnes-Hut MVM against its group chunk size, at
BASELINE config 5's treecode (EQ, n = 10^6, d = 2, x ~ N(0, I),
w ~ U(0, 1), theta 1/2, the points and weights of `chip_smoke.py` phase
18): for each `bh.CHUNK_ELEMENTS`, one call between CUDA events (median of
5, host time included) and the MVM's peak device memory above its inputs.
The shipped chunk is the one `chip_smoke.py` runs.

    python3 bh_chunks.py

Prints one JSON object with the card's name and power limit. Needs a CUDA
device.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

CHUNKS = (4_000_000, 2**25, 2**27, 2**28)   # cfjax's chunk, then powers of two


def main():
    if not torch.cuda.is_available():
        print("bh_chunks: no CUDA device", file=sys.stderr)
        sys.exit(2)
    import cfjax_torch.kernels as tk
    from cfjax_torch.barneshut import bh

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(18)
    n = 1_000_000
    w = torch.tensor(rng.uniform(0, 1, n), dtype=torch.float32, device="cuda")
    x = torch.tensor(rng.standard_normal((n, 2)), dtype=torch.float32, device="cuda")
    F = bh.BarnesHutFactorization(tk.EQ(), x, theta=0.5)
    shipped, out = bh.CHUNK_ELEMENTS, {}
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    try:
        for c in CHUNKS:
            bh.CHUNK_ELEMENTS = c
            F @ w
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            F @ w
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 2**30
            ms = []
            for _ in range(5):
                e0.record()
                F @ w
                e1.record()
                torch.cuda.synchronize()
                ms.append(e0.elapsed_time(e1))
            out[str(c)] = {"ms": float(np.median(ms)), "peak_gib": peak}
    finally:
        bh.CHUNK_ELEMENTS = shipped
    print(json.dumps({"card": smi, "shipped": shipped, "chunks": out}))


if __name__ == "__main__":
    main()
