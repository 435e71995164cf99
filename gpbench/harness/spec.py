"""`BENCHMARK.json` and the files that it names, found by name: a workload's
configuration (`configs`' `file`), its traffic mix (`traffic/<traffic>.json`),
the job that the mix names (`jobs/<job>.py`), the cell's limits
(`limits/<workload>.json`) and each metric's reader (`metrics/<metric>.py`).
A cell, a configuration, a mix or a metric is added with new files and
entries only."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def job(self) -> str:
        return self.traffic["job"]


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def read_json(path: Path) -> dict:
    return json.loads(path.read_text())


def reports(metric: dict, workload: str) -> bool:
    """Whether a metric is reported in a cell: every cell, unless its
    `workloads` names the cells."""
    return "workloads" not in metric or workload in metric["workloads"]


def cell(bench: dict, workload: str, root: Path = ROOT) -> Cell:
    """The cell `workload` of BENCHMARK.json with its files read."""
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(workloads: {', '.join(sorted(entries))})")
    w = entries[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = read_json(root / cfg_entry["file"])
    traffic = read_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    limits = read_json(BENCH_DIR / "limits" / f"{workload}.json")
    return Cell(workload, int(w["chips"]), config, traffic, limits,
                [m for m in bench["end_to_end"] if reports(m, workload)],
                [m for m in bench["per_layer"] if reports(m, workload)])


def load_module(path: Path, name: str):
    """The module at `path`, loaded by its path (a metric's name holds dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def job_module(job: str):
    return load_module(BENCH_DIR / "jobs" / f"{job}.py", f"gpbench_job_{job}")


def metric_path(metric: str) -> Path:
    return BENCH_DIR / "metrics" / f"{metric}.py"


def metric_reader(metric: str):
    """The `read(ctx)` of metric `metric`."""
    return load_module(metric_path(metric), "gpbench_metric_" + metric.replace(".", "_")).read


def kernel_patterns(metric: str) -> list:
    """The kernel-name patterns of a roofline metric: one regular expression
    a line in each `metrics/<metric>.names/*.txt`, blank lines and lines
    that start with # left out. A later name file adds to them."""
    out = []
    for f in sorted((BENCH_DIR / "metrics" / f"{metric}.names").glob("*.txt")):
        out += [ln.strip() for ln in f.read_text().splitlines()
                if ln.strip() and not ln.strip().startswith("#")]
    return out
