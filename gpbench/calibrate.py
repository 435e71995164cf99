"""Readings that a cell's limits are set from: the numbers that `correct`
compares, from the program on many seeds and from the control on a few,
in one process on the card. The benchmark's runs do not run this.

    python3 gpbench/calibrate.py --workload <name> --seeds 1,2,3 [--control-seeds 4,5,6]
                                 [--jobs J] [--out chiprun_out/x.jsonl]

For each seed the cell's inputs are made from the seed, J whole jobs run
through the timed path (`runner.jobs`, as a run's window runs them), and
the comparison of a run (`runner.compare`) reads them; J defaults to the
jobs a run of `run_seconds` holds (the mix's `calibrate_jobs`). The
control is the program with its own TF32 path switched on: every distance
on the tensor cores' expansion and every tensor-core product in one tf32
pass (`CONTROL`), the nearest precision below the configurations' full
fp32. One JSON line a seed."""

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CONTROL = {"matmul_precision": "default", "direct_sqdist_max_d": 0}


def seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def readings(cell, seed: int, jobs: int, device, control: bool) -> dict:
    """The compared numbers of `jobs` jobs on the inputs of `seed`."""
    from gpbench.harness import runner, spec

    sync = runner.syncer(device)
    with runner.program_settings(cell, device, CONTROL if control else None):
        job = spec.job_module(cell.job).Job(cell.config, cell.traffic, seed, device)
        records = []
        t0 = time.perf_counter()
        runner.jobs(job, jobs, math.inf, runner.Spans(False, sync), sync, records)
        seconds = time.perf_counter() - t0
        job.release()
        # a job that gave no answer (a factorization that broke down) sets no
        # number; the numbers are those of the jobs that answered
        answered = [r for r in records if "error" not in r.out]
        checks, correct = runner.compare(cell, job, answered, seed) if answered else ({}, False)
    iters = [r.out["iters"] for r in records if "iters" in r.out]
    return {"workload": cell.name, "seed": seed, "control": control, "jobs": len(records),
            "no_answer": len(records) - len(answered), "seconds": seconds, "iters": iters,
            "checks": checks, "correct": correct and len(answered) == len(records)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, default=[])
    p.add_argument("--control-seeds", type=seeds, default=[])
    p.add_argument("--jobs", type=int)
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch

    from gpbench.harness import spec

    if not torch.cuda.is_available():
        print("gpbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(spec.load_benchmark(), args.workload)
    device = torch.device("cuda", 0)
    jobs = args.jobs or int(cell.traffic["calibrate_jobs"])
    out = open(args.out, "a") if args.out else None
    try:
        for control, group in ((False, args.seeds), (True, args.control_seeds)):
            for seed in group:
                line = json.dumps(readings(cell, seed, jobs, device, control))
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
