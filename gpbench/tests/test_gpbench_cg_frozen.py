"""The readers of CG's frozen steps (`cg_frozen.solve`, `cg_frozen.grad_solve`)
on synthetic spans: frozen steps a profiled job, and None where the program
records no spans, has no tracing module, or records `solvers.cg` spans
without `frozen` (a CG that reads the residual every iteration)."""

import sys

import pytest

from gpbench.harness import runner, spec

READERS = ("cg_frozen.solve", "cg_frozen.grad_solve")


def span(name, start, end, **attrs):
    return {"name": name, "id": 0, "parent": None, "root": 0, "start": start, "end": end,
            "attrs": attrs}


def ctx(*windows):
    return runner.Context(None, [runner.Record(a, b, {}, {}) for a, b in windows], 1.0, 0.0)


@pytest.fixture
def program(monkeypatch):
    from cfjax_torch.utils import trace

    def use(spans):
        monkeypatch.setattr(trace, "spans", lambda: list(spans))
    return use


@pytest.mark.parametrize("metric", READERS)
def test_frozen_steps_a_job(metric, program):
    program([span("solvers.cg", 1.1, 1.4, iters=300, frozen=3, reads=14, captured=1),
             span("solvers.cg", 2.1, 2.4, iters=290, frozen=0, reads=13, captured=1),
             span("solvers.cg", 0.1, 0.4, iters=290, frozen=30, reads=13, captured=1),
             span("gp.condition", 1.0, 1.5, host_syncs=20)])
    # the warm job's span (0.1) lies outside the profiled windows
    assert spec.metric_reader(metric)(ctx((1.0, 2.0), (2.0, 3.0))) == pytest.approx(1.5)


@pytest.mark.parametrize("metric", READERS)
def test_none_where_nothing_is_recorded(metric, program, monkeypatch):
    program([span("solvers.cg", 1.1, 1.4, iters=300, host_syncs=302)])
    assert spec.metric_reader(metric)(ctx((1.0, 2.0))) is None
    program([])
    assert spec.metric_reader(metric)(ctx((1.0, 2.0))) is None
    import cfjax_torch.utils

    program([span("solvers.cg", 1.1, 1.4, iters=300, frozen=2)])
    assert spec.metric_reader(metric)(ctx((1.0, 2.0))) == 2
    monkeypatch.setitem(sys.modules, "cfjax_torch.utils.trace", None)
    monkeypatch.delattr(cfjax_torch.utils, "trace")
    assert spec.metric_reader(metric)(ctx((1.0, 2.0))) is None
