"""Run one cell of the benchmark once, on the machine it is started on.

    python3 gpbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cells, their configurations, traffic mixes,
limits and metrics are named in BENCHMARK.json and found by name under
gpbench/. Standard output ends in one JSON line: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer ones), `device`, and last `checks`, each compared number beside
its limit; the same comparisons are the last lines of standard error.
Earlier lines give the route the program took, the card's name, clocks and
power limit, and the peak memory.

Exit codes: 0 a result was printed; 2 no card, or fewer than the cell asks
for; 3 the program (`cfjax_torch`) cannot be imported from the checkout; 4
a module of JAX or of the JAX package was loaded; 1 anything else.
"""

import time

T_LAUNCH = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every compiler cache of the program at a fixed path inside the checkout,
# which `.gitignore` lists (the port's nvcc libraries go to build/ there)
CACHE = ROOT / "build" / "gpbench_cache"
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = str(CACHE / _sub)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(code: int, msg: str) -> int:
    print(f"gpbench: {msg}", file=sys.stderr)
    return code


def main(argv=None) -> int:
    args = parse(argv)
    from gpbench.harness import imports, runner, spec

    cell = spec.cell(spec.load_benchmark(), args.workload)
    import torch

    if not torch.cuda.is_available():
        return fail(2, "no CUDA device: the benchmark measures the card and does not fall "
                       "back to the CPU")
    if torch.cuda.device_count() < cell.chips:
        return fail(2, f"{cell.name} asks for {cell.chips} cards, "
                       f"{torch.cuda.device_count()} found")
    try:
        import cfjax_torch  # noqa: F401
    except ImportError as e:
        return fail(3, f"the program cannot be imported from {ROOT}: {e}")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    try:
        result = runner.run(cell, args.seed, args.seconds, bool(args.trace), device, T_LAUNCH,
                            log=lambda s: print(s, flush=True))
    except imports.ForbiddenImport as e:
        return fail(4, str(e))
    print(f"setup_s {result['setup_s']!r}, window {result['window_s']!r} s, "
          f"{result['attempted']} jobs, {result['failed']} failed", flush=True)
    runner.report_checks(result)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
