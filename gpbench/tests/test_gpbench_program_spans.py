"""The readers of the program's own spans and counters (`cfjax_torch.utils.
trace`), on synthetic spans: the window selection (only spans that start
inside a profiled job), None where the program records none or has no
tracing module, and each metric's formula."""

import sys

import pytest

from gpbench.harness import runner, spec

READERS = ("precond_ms.solve", "pcg_iter_ms.solve", "cg_host_ms.grad_solve",
           "sync_wait_ms.grad_solve", "host_syncs.grad_solve", "chol_bwd_ms.fit")


def span(name, start, end, **attrs):
    return {"name": name, "id": 0, "parent": None, "root": 0, "start": start, "end": end,
            "attrs": attrs}


def ctx(*windows):
    records = [runner.Record(a, b, {}, {}) for a, b in windows]
    return runner.Context(None, records, 1.0, 0.0)


@pytest.fixture
def program(monkeypatch):
    """Sets the spans the program's record returns."""
    from cfjax_torch.utils import trace

    def use(spans):
        monkeypatch.setattr(trace, "spans", lambda: list(spans))
    return use


def test_window_selection(program):
    job_spans = spec.load_module(spec.metric_path("precond_ms.solve"), "m").job_spans
    inside = [span("solvers.cg", 1.5, 1.9), span("solvers.cg", 3.0, 3.5)]
    program(inside + [span("solvers.cg", 0.5, 1.2),        # the warm job, before
                      span("solvers.cg", 2.5, 2.8),        # between two jobs
                      span("solvers.cg", 9.0, 9.5),        # the host-profiled pass
                      span("gp.mean", 1.6, 1.7)])
    assert job_spans(ctx((1.0, 2.0), (3.0, 4.0)), "solvers.cg") == inside
    assert job_spans(ctx((1.0, 2.0)), "precond.nystrom") is None


@pytest.mark.parametrize("metric", READERS)
def test_none_without_spans(metric, program):
    program([])
    assert spec.metric_reader(metric)(ctx((0.0, 10.0))) is None


@pytest.mark.parametrize("metric", READERS)
def test_none_without_tracing_module(metric, program, monkeypatch):
    """A program without `cfjax_torch.utils.trace` (the parent of the change
    that adds it) gives None, and raises nothing."""
    import cfjax_torch.utils

    program([span(name, 1.0, 2.0, iters=10, host_syncs=12, device_ms=5.0)
             for name in ("precond.nystrom", "solvers.cg", "gp.condition",
                          "gp.logml.cholesky.bwd")])
    assert spec.metric_reader(metric)(ctx((0.0, 10.0))) is not None
    monkeypatch.setitem(sys.modules, "cfjax_torch.utils.trace", None)
    monkeypatch.delattr(cfjax_torch.utils, "trace")
    assert spec.metric_reader(metric)(ctx((0.0, 10.0))) is None


def test_precond_ms(program):
    program([span("precond.nystrom", 1.0, 1.25), span("precond.nystrom", 3.0, 3.35),
             span("precond.nystrom.host", 1.0, 1.1)])
    # 0.6 s of builds over two jobs
    assert spec.metric_reader("precond_ms.solve")(ctx((0.9, 2.0), (2.9, 4.0))) == \
        pytest.approx(300.0)


def test_cg_iteration_metrics(program):
    program([span("solvers.cg", 1.0, 1.3, iters=100, sync_wait_s=0.1, host_syncs=102),
             span("solvers.cg", 2.0, 2.5, iters=150, sync_wait_s=0.15, host_syncs=152),
             span("precond.nystrom", 1.0, 1.9)])
    c = ctx((0.5, 1.9), (1.9, 3.0))
    # 0.8 s over 250 iterations, of which 0.25 s waiting in the reads
    assert spec.metric_reader("pcg_iter_ms.solve")(c) == pytest.approx(3.2)
    assert spec.metric_reader("cg_host_ms.grad_solve")(c) == pytest.approx(2.2)
    assert spec.metric_reader("sync_wait_ms.grad_solve")(c) == pytest.approx(1.0)


def test_host_syncs(program):
    program([span("gp.condition", 1.0, 1.5, host_syncs=348),
             span("gp.mean", 1.6, 1.7, host_syncs=0),
             span("solvers.cg", 1.1, 1.4, host_syncs=347),      # inside gp.condition's count
             span("gp.condition", 2.0, 2.5, host_syncs=352),
             span("gp.mean", 2.6, 2.7, host_syncs=1)])
    assert spec.metric_reader("host_syncs.grad_solve")(ctx((0.9, 1.8), (1.9, 2.8))) == 350.5


def test_chol_bwd_ms(program):
    program([span("gp.logml.cholesky.bwd", 1.2, 1.5, device_ms=280.0),
             span("gp.logml.cholesky.bwd", 2.2, 2.5, device_ms=300.0),
             span("gp.logml.build.bwd", 1.5, 1.6, device_ms=50.0)])
    assert spec.metric_reader("chol_bwd_ms.fit")(ctx((1.0, 2.0), (2.0, 3.0))) == 290.0
    # a CPU run has no device events: the span's own duration
    program([span("gp.logml.cholesky.bwd", 1.2, 1.5)])
    assert spec.metric_reader("chol_bwd_ms.fit")(ctx((1.0, 2.0))) == pytest.approx(300.0)
