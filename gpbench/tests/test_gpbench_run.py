"""The run: without a card it fails and prints no result; in a directory
holding only BENCHMARK.json and gpbench/ it fails; a tiny run on the CPU
(the harness's look for a card skipped) gives a result line to the
contract and is correct."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from gpbench.harness import runner
from gpbench.tests.conftest import ROOT
from gpbench.tests.tiny import TINY, tiny_cell

CMD = [sys.executable, "gpbench/run.py", "--workload", "grad_eq_d16.cg_n4096", "--seed",
       "2147483659", "--seconds", "1", "--trace", "0"]


def no_result(stdout: str) -> bool:
    return not any(line.startswith("{") for line in stdout.splitlines())


def test_without_a_card_fails():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(CMD, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and no_result(out.stdout)
    assert "no CUDA device" in out.stderr


def test_bare_directory_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "gpbench", tmp_path / "gpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(CMD, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and no_result(out.stdout)


@pytest.mark.parametrize("workload", sorted(TINY))
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_run_on_cpu(workload, trace):
    cell, control = tiny_cell(workload)
    seed = 2**31 + 99
    result = runner.run(cell, seed, 0.5, trace, torch.device("cpu"), 0.0, log=lambda s: None,
                        control=control)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    wanted = cell.per_layer if trace else cell.end_to_end
    names = {m["name"] for m in wanted}
    # the device-trace metrics of a kernel have nothing to read on the CPU
    assert set(result["metrics"]) == {n for n in names if "roofline" not in n}
    for m in wanted:
        if m["name"] in result["metrics"]:
            assert result["metrics"][m["name"]]["unit"] == m["unit"]
    assert set(result["checks"]) == set(cell.limits["limits"])
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert len(result["breakdown"]["device_ops"]) <= 10
        assert len(result["breakdown"]["idle_gaps"]) <= 10
    json.dumps(result)


def test_same_seed_same_inputs():
    from gpbench.harness import data

    cell, _ = tiny_cell("grad_eq_d16.cg_n4096")
    a = data.solve_inputs(cell.config, cell.traffic, 2**31 + 5, "cpu")
    b = data.solve_inputs(cell.config, cell.traffic, 2**31 + 5, "cpu")
    c = data.solve_inputs(cell.config, cell.traffic, 2**31 + 6, "cpu")
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    # one training set for every seed; the seed draws the noise and the test points
    assert torch.equal(a[0], c[0])
    assert not torch.equal(a[1], c[1]) and not torch.equal(a[2], c[2])
    x, Y, xt = a
    n, d = cell.traffic["n"], cell.config["d"]
    assert x.shape == (n, d) and Y.shape == (cell.traffic["pool"], n * d)
    assert xt.shape == (cell.config["test"]["points"], d)
