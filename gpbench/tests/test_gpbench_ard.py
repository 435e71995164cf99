"""The ARD cell (`song_ard_d90.pcg_n65536`) at a size a CPU test holds: the
same configuration, mix, job, limits and metrics, 512 points and 64 test
points, `max_cholesky_size` lowered so that the solve takes Nystrom PCG.
A sound run is correct; a run comes out not correct when the program takes
every lengthscale as 1 or its solver returns its start; the job refuses a
program that would evaluate the kernel pair by pair; the cell's new metric
readers load and give None where they find nothing to read."""

import pytest
import torch

import cfjax_torch.gp.regression as regression
import cfjax_torch.operators.dispatch as dispatch
import cfjax_torch.operators.preconditioner as preconditioner
from gpbench.harness import runner, spec

WORKLOAD = "song_ard_d90.pcg_n65536"
METRICS = ("k2_roofline.ard_solve", "plain_mvms.ard_solve", "cg_iters.ard_solve",
           "precond_ms.ard_solve", "idle_share.ard_solve")


def tiny_cell():
    cell = spec.cell(spec.load_benchmark(), WORKLOAD)
    cell.traffic = dict(cell.traffic, n=512, trace_jobs=2)
    cell.config = dict(cell.config, test=dict(cell.config["test"], points=64))
    return cell


def run(trace=False, seed=2**31 + 4321):
    return runner.run(tiny_cell(), seed, 0.3, trace, torch.device("cpu"), 0.0,
                      log=lambda s: None, control={"max_cholesky_size": 128})


def test_sound_run_is_correct():
    result = run()
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["metrics"]) == {"solve_s", "setup_s"}


def test_traced_run_reads_the_new_metrics():
    """On the CPU the kernel's share has no device time to read; every other
    new metric reads: no plain product on a card (none is counted on the
    CPU), the iterations and the build's milliseconds."""
    result = run(trace=True)
    assert result["correct"] is True
    got = result["metrics"]
    assert set(got) == set(METRICS) - {"k2_roofline.ard_solve"}
    assert got["plain_mvms.ard_solve"]["value"] == 0
    assert got["cg_iters.ard_solve"]["value"] > 0 and got["precond_ms.ard_solve"]["value"] > 0


def test_lengthscales_taken_as_ones(monkeypatch):
    fold = dispatch.ard_fold

    def ones(k):
        out = fold(k)
        return None if out is None else (out[0], torch.ones_like(out[1]))

    monkeypatch.setattr(dispatch, "ard_fold", ones)
    monkeypatch.setattr(preconditioner, "ard_fold", ones)
    assert run()["correct"] is False


def test_solver_returns_its_start(monkeypatch):
    def unchanged(matvec, b, x0=None, **kw):
        return torch.zeros_like(b), (1, torch.linalg.norm(b))

    monkeypatch.setattr(regression, "cg", unchanged)
    monkeypatch.setattr(regression, "solve_with_info", lambda op, b, **kw: unchanged(None, b))
    assert run()["correct"] is False


def test_pairwise_route_is_named():
    """A kernel the program evaluates pair by pair (here its structure hidden
    by a `LambdaKernel`) is named; the configuration's kernel is not."""
    job = spec.job_module("solve_ard")
    cell = tiny_cell()
    ell = job.lengthscales(cell.config)
    import cfjax_torch.kernels as tk

    k = 6.67 * tk.ARDKernel(tk.MaternP(2), ell)
    x = torch.randn(4, 90, dtype=torch.float64)
    assert job.pairwise_route(k, x) is None
    assert "pair by pair" in job.pairwise_route(dispatch.LambdaKernel(lambda a, b: k(a, b)), x)
    assert ell.shape == (90,) and torch.equal(ell, job.lengthscales(cell.config))


@pytest.mark.parametrize("metric", METRICS)
def test_metric_reads_nothing_without_a_trace(metric, monkeypatch):
    from cfjax_torch.utils import trace

    monkeypatch.setattr(trace, "spans", lambda: [])
    read = spec.metric_reader(metric)
    cell = tiny_cell()
    empty = runner.Context(cell, [], 1.0, 0.0)
    assert read(empty) is None
    if metric != "cg_iters.ard_solve":      # the iterations come from the jobs' outputs
        records = [runner.Record(0.0, 1.0, {"iters": 7}, {})]
        assert read(runner.Context(cell, records, 1.0, 0.0)) is None
