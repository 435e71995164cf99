"""Weak scaling of the parallel layer: the port's twin of cfjax's
`benchmarks/weak_scaling.py`.

    python3 -m cfjax_torch.benchmarks.weak_scaling [--device cpu]
        [--worlds 1,2,4] [--rows R] [--tile T] [--cg-n N] [--write] [--out PATH]

Runs `cfjax_torch.parallel` at fixed work per rank, each answer beside the
single-rank one on the same points:

  * the row-sharded MVM (`ShardedGramian`, EQ, d = 3) at R rows per rank
    (cfjax's 2048): each rank owns (n / N) x n entries, so per-rank work
    grows with N; efficiency N T(1) / T(N);
  * the 2-D mesh MVM (`sharded_gramian_matvec_2d`) with a fixed T x T tile
    per rank (cfjax's 2048): efficiency T(1) / T(N);
  * `sharded_cg` on the GP system K + 0.5 I at n = 8192 over the largest
    world's 2-D mesh, to tol 1e-6 in at most 400 iterations, against the
    single-rank CG;
  * `comm_model`, the analytic per-iteration collective volume (a copy of
    cfjax's, not an import).

Worlds: on the card, world 1 joins NCCL in this process and worlds 2 and 4
are gloo ranks spawned to share the one card (NCCL refuses two ranks on
one GPU); with `--device cpu`, every world is gloo ranks on the host, as
cfjax's run on a fake 8-device CPU mesh. On one card the ranks share its
SMs and its memory: the readings are the layer's overheads, not scaling,
which waits for a machine with one card a rank. Prints one JSON line a
row; `--write` writes `weak_scaling_h100.json` beside this file, or
`--out` (the card only). Exits non-zero when a sharded answer misses the single-rank one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .common import DEVICES, card, commit, take_device

RESULTS = Path(__file__).resolve().parent / "weak_scaling_h100.json"
SHARD_BOUND = 1e-5    # a sharded product or solve against the single-rank one (max rel)
CG_NOISE = 0.5
ONE_CARD = ("ranks share one card (NCCL at world 1 in the main process, gloo ranks at "
            "worlds 2 and 4): the layer's overheads, not scaling")


def comm_model(n: int, R: int, C: int, dtype_bytes: int = 4):
    """Analytic per-CG-iteration communication for the 2-D mesh MVM
    (`sharded_gramian_matvec_2d`): the psum over the column axis moves
    2 (C-1)/C * (n/R) * dtype_bytes bytes per device (bidirectional ring
    all-reduce), plus 2 scalar psums for the CG dot products (latency
    only). Compute per device is n^2/(R C) kernel entries, so the
    comm:compute byte:flop ratio falls as 1/n — the basis of the
    weak-scaling claim in README."""
    psum_bytes = 2 * (C - 1) / C * (n / R) * dtype_bytes
    tile_entries = n * n / (R * C)
    return {
        "per_device_psum_bytes_per_iter": psum_bytes,
        "per_device_tile_entries": tile_entries,
        "bytes_per_entry": psum_bytes / tile_entries,
    }


def mesh_shape(world: int) -> tuple:
    """The 2-D mesh of a world: (1, 1), (1, 2), (2, 2), (2, 4)."""
    rows = 2 if world >= 4 else 1
    return rows, world // rows


def _time(fn, v, iters=5, repeats=3):
    """Median seconds per call of fn(v) over `repeats` runs of `iters` calls,
    the same counts on every rank (their collectives pair up), a barrier
    and a synchronize at each end of a run."""
    import torch.distributed as dist

    def sync():
        if v.is_cuda:
            torch.cuda.synchronize(v.device)
        dist.barrier()

    fn(v), fn(v)   # warm-up: the first calls build caches and load the kernels
    ts = []
    for _ in range(repeats):
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(v)
        sync()
        ts.append((time.perf_counter() - t0) / iters)
    return float(np.median(ts))


def _max_rel(got, ref):
    return float((got.double() - ref.double()).abs().max() / ref.double().abs().max())


def rank_case(rows: int, tile: int, cg_n: int, seed: int = 0, d: int = 3) -> dict:
    """One world's rows on this rank (every rank draws the same points).
    Rank 0 returns them with every rank's kernel launches summed."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from .. import config as _config
    from ..kernels import EQ
    from ..operators import Gramian
    from ..operators.solvers import cg
    from ..ops import gramian_mvm as mvm
    from ..parallel.mesh import (ShardedGramian, default_mesh, sharded_cg,
                                 sharded_gramian_matvec_2d)

    mesh1 = default_mesh()   # joins a one-rank group where none is initialised
    world = dist.get_world_size()
    dev = _config.default_device()
    rng = np.random.default_rng(seed + world)
    t = lambda *s: torch.tensor(rng.standard_normal(s), dtype=torch.float32, device=dev)
    before = dict(mvm.LAUNCHES)
    k = EQ()
    out = {"world": world}

    n = rows * world
    x, a = t(n, d), t(n)
    G = ShardedGramian(k, x, mesh=mesh1)
    out["row_s"] = _time(G._matvec, a)
    with mvm.uncounted():
        ref = Gramian(k, x)._matvec(a)
    out["row_err"] = _max_rel(G._matvec(a), ref)
    out["row_n"] = n

    R, C = mesh_shape(world)
    mesh2 = init_device_mesh(dev.type, (R, C), mesh_dim_names=("rows", "cols"))
    n, m = R * tile, C * tile
    x, y, a = t(n, d), t(m, d), t(m)
    fn = lambda v: sharded_gramian_matvec_2d(k, x, y, v, "iso", mesh2)
    out["tile_s"] = _time(fn, a)
    with mvm.uncounted():
        ref = Gramian(k, x, y)._matvec(a)
    out["tile_err"] = _max_rel(fn(a), ref)
    out["tile_shape"] = (n, m, R, C)

    xc = t(cg_n, d)
    yv = torch.sin(xc[:, 0])
    mv2 = lambda v: sharded_gramian_matvec_2d(k, xc, xc, v, "iso", mesh2) + CG_NOISE * v
    xs, (it, res) = sharded_cg(mv2, yv, tol=1e-6, maxiter=400)
    with mvm.uncounted():
        G1 = Gramian(k, xc)
        ref, (it1, res1) = cg(lambda v: G1._matvec(v) + CG_NOISE * v, yv, tol=1e-6, maxiter=400)
    bn = float(torch.linalg.norm(yv))
    out.update(cg_iters=int(it), cg_relres=float(res) / bn, cg_iters1=int(it1),
               cg_relres1=float(res1) / bn, cg_err=_max_rel(xs, ref))
    mine = {key: mvm.LAUNCHES[key] - before[key] for key in before}
    every = [None] * world
    dist.all_gather_object(every, mine)
    out["launches"] = {key: sum(r[key] for r in every) for key in mine}
    return out


def _rows(res: dict, rows: int, tile: int, cg_n: int, device: str) -> list:
    """cfjax's row names and fields for one world's results."""
    w = res["world"]
    R, C = mesh_shape(w)
    note = ONE_CARD if device == "cuda" else "gloo ranks sharing the host's cores"
    return [
        {"config": f"weak_scaling_mvm_rowsharded_{w}rank_rows{rows}", "n": res["row_n"],
         "ranks": w, "seconds": res["row_s"], "rel_err_vs_single": res["row_err"],
         "note": f"rows per rank fixed (per-rank work grows as N); {note}"},
        {"config": f"weak_scaling_mvm_2dmesh_{R}x{C}_tile{tile}", "n": res["tile_shape"][0],
         "m": res["tile_shape"][1], "ranks": w, "seconds": res["tile_s"],
         "rel_err_vs_single": res["tile_err"], "note": f"per-rank tile fixed; {note}"},
        {"config": f"gp_cg_2dmesh_{R}x{C}_n{cg_n}", "ranks": w, "noise": CG_NOISE,
         "iters_sharded": res["cg_iters"], "relres_sharded": res["cg_relres"],
         "iters_single": res["cg_iters1"], "relres_single": res["cg_relres1"],
         "rel_err_vs_single_cg": res["cg_err"],
         "converged": res["cg_iters"] < 400 and res["cg_iters1"] < 400},
    ]


def run(worlds=(1, 2, 4), device="cuda", rows=2048, tile=2048, cg_n=8192) -> dict:
    """Each world's rows, the efficiency summaries and `comm_model` at
    config 5's scale; `launches` sums the spawned ranks' kernel launches
    (world 1 on the card runs in this process: its launches are in
    `LAUNCHES` here)."""
    import torch.distributed as dist

    from ..ops import build
    from ..utils.testing import run_world

    device = torch.device(device).type
    if device == "cuda":
        build.build()   # the spawned ranks only load the kernels
    results, launches = {}, {}
    for w in worlds:
        if w == 1 and device == "cuda":
            try:
                res = rank_case(rows, tile, cg_n)   # joins NCCL at world size 1
            finally:
                if dist.is_initialized():
                    dist.destroy_process_group()
        else:
            res = run_world(rank_case, w, rows, tile, cg_n, backend="gloo", device=device)
            for key, v in res["launches"].items():
                launches[key] = launches.get(key, 0) + v
        results[w] = res
    out = []
    for w in worlds:
        out += _rows(results[w], rows, tile, cg_n, device)
    t1 = results[worlds[0]]
    summary = {"config": "weak_scaling_summary", "device": device,
               "row_sharded_work_normalized_efficiency": {
                   w: w * t1["row_s"] / results[w]["row_s"] for w in worlds[1:]},
               "tile_fixed_efficiency": {w: t1["tile_s"] / results[w]["tile_s"]
                                         for w in worlds[1:]},
               "note": "1.0 = ideal; " + (ONE_CARD if device == "cuda"
                                          else "gloo ranks sharing the host's cores")}
    model = comm_model(1 << 20, 4, 4)
    model.update(config="comm_model_cg_iter_n2pow20_mesh4x4",
                 note="per-rank all-reduce bytes of one CG iteration against the rank's tile "
                      "entries, at config 5's n on a 4 x 4 mesh")
    return {"rows": out + [summary, model], "launches": launches}


def failures(rows) -> list:
    bad = []
    for r in rows:
        for key in ("rel_err_vs_single", "rel_err_vs_single_cg"):
            if key in r and not r[key] <= SHARD_BOUND:
                bad.append(f"{r['config']}: {key} {r[key]:.3e} > {SHARD_BOUND:.0e}")
        if r.get("converged") is False:
            bad.append(f"{r['config']}: CG did not converge in 400 iterations")
    return bad


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Weak scaling of the parallel layer.")
    ap.add_argument("--device", choices=DEVICES, default="cuda")
    ap.add_argument("--worlds", default="1,2,4")
    ap.add_argument("--rows", type=int, default=2048)
    ap.add_argument("--tile", type=int, default=2048)
    ap.add_argument("--cg-n", type=int, default=8192)
    ap.add_argument("--write", action="store_true")
    ap.add_argument("--out", default=str(RESULTS))
    args = ap.parse_args(argv)
    if args.write and args.device != "cuda":
        ap.error("--write records the card's run")
    take_device(args.device, "weak_scaling")
    worlds = tuple(int(w) for w in args.worlds.split(","))
    t0 = time.perf_counter()
    out = run(worlds, args.device, args.rows, args.tile, args.cg_n)
    for row in out["rows"]:
        print(json.dumps(row), flush=True)
    c = card()
    header = {"card": c["name"], "power_limit": c["power_limit"], "commit": commit(),
              "date": time.strftime("%Y-%m-%d %H:%M UTC", time.gmtime()),
              "wall_s": time.perf_counter() - t0, "note": ONE_CARD}
    print(json.dumps({"header": header, "launches": out["launches"]}), flush=True)
    if args.write:
        Path(args.out).write_text(json.dumps({"header": header, "rows": out["rows"]}, indent=1)
                                  + "\n")
        print(f"wrote {args.out}")
    bad = failures(out["rows"])
    if bad:
        print("weak_scaling: " + "; ".join(bad), file=sys.stderr)
        sys.exit(1)
    return out


if __name__ == "__main__":
    main()
