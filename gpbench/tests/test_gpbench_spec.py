"""BENCHMARK.json against the benchmark's contract, and every workload
resolving to its configuration, traffic mix, job, limits and metric files."""

import json
import re

import pytest

from gpbench.harness import spec

BENCH = spec.load_benchmark()
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
LINE = re.compile(r"[^\n\t]{1,200}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            yield e["name"]
    for w in BENCH["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in BENCH["configs"]:
        yield from c["reduced"]


def test_top_level_keys_and_command():
    assert set(BENCH) == TOP
    assert 1 <= len(BENCH["paths"]) <= 16 and 1 <= len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert PATH.fullmatch(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    for word in BENCH["command"]:
        assert LINE.fullmatch(word) and not word.startswith("/") and ".." not in word
    assert (spec.ROOT / BENCH["command"][1]).resolve().is_relative_to(spec.BENCH_DIR)
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("name", sorted(set(names())))
def test_name_characters(name):
    assert spec.NAME.fullmatch(name), name


def test_names_unique():
    for group in ("configs", "workloads"):
        ns = [e["name"] for e in BENCH[group]]
        assert len(ns) == len(set(ns))
    ms = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(ms) == len(set(ms))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    e2e = metric in BENCH["end_to_end"]
    keys = {"name", "unit", "better", "source"} | ({"bound"} if e2e else {"layer", "moves"})
    assert set(metric) - {"workloads"} == keys
    assert spec.UNIT.fullmatch(metric["unit"]) and metric["better"] in ("lower", "higher")
    if e2e:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert LINE.fullmatch(metric["layer"])
        moved = {m["name"]: m for m in BENCH["end_to_end"]}[metric["moves"]]
        for w in metric.get("workloads", WORKLOADS):
            assert spec.reports(moved, w), (metric["name"], w)
    if metric["name"].endswith("_roofline") or "_roofline." in metric["name"]:
        assert metric["unit"] == "%"
    assert set(metric.get("workloads", WORKLOADS)) <= set(WORKLOADS)
    assert spec.metric_path(metric["name"]).is_file()


def test_layers_named_alike():
    """Metrics of one layer give the same name, letter for letter."""
    by_module = {}
    for m in BENCH["per_layer"]:
        by_module.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_module.values())


@pytest.mark.parametrize("workload", WORKLOADS)
def test_workload_resolves(workload):
    entry = {w["name"]: w for w in BENCH["workloads"]}[workload]
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert entry["chips"] in (1, 4) and LINE.fullmatch(entry["why"])
    cell = spec.cell(BENCH, workload)
    assert cell.job in ("solve", "fit")
    assert (spec.BENCH_DIR / "jobs" / f"{cell.job}.py").is_file()
    assert cell.limits["limits"] and all(v > 0 for v in cell.limits["limits"].values())
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert spec.metric_path(m["name"]).is_file()
        if "roofline" in m["name"]:
            assert spec.kernel_patterns(m["name"])


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert LINE.fullmatch(config["source"]) and LINE.fullmatch(config["why"])
    assert config["file"].startswith(BENCH["paths"][0] + "/")
    body = json.loads((spec.ROOT / config["file"]).read_text())
    assert body["name"] == config["name"] and "assumed" in body
    assert len(config["reduced"]) <= 16
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))


def test_files_under_paths_named_from_name_characters():
    for p in spec.BENCH_DIR.rglob("*"):
        if "__pycache__" in p.parts or p.suffix == ".pyc":
            continue
        rel = p.relative_to(spec.ROOT).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel


def test_four_chip_cells_within_quarter():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
