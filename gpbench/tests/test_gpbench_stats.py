"""The window, percentile, interval and idle-share arithmetic, and the
trace's reductions, on synthetic intervals."""

import statistics

import pytest

from gpbench.harness import stats
from gpbench.harness.trace import Trace


def test_window_and_rate():
    ends = [1.5, 3.0, 4.4, 10.2]
    assert stats.window_seconds(0.2, ends) == pytest.approx(10.0)
    assert stats.per_job(10.0, 4) == 2.5


def test_percentile_interpolates():
    assert stats.percentile(range(1, 101), 95) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([1.0, 2.0], 50) == 1.5
    assert stats.percentile([5, 1, 3], 100) == 5
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_union_busy_gaps_idle():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.8), (9, 12)]
    assert stats.union(iv) == [(0, 3), (5, 6), (9, 12)]
    assert stats.busy(iv, 1, 10) == pytest.approx(2 + 1 + 1)
    assert stats.gaps(iv, 1, 10) == [(3, 5), (6, 9)]
    assert stats.idle_share(iv, 1, 10) == pytest.approx(100 * 5 / 9)
    assert stats.idle_share([], 0, 4) == 100.0
    assert stats.idle_share([(-1, 5)], 0, 4) == 0.0


def test_spread_matches_statistics():
    v = [10.0, 10.2, 9.9, 10.4, 10.1, 10.0]
    q1, q2, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / q2)


def synthetic():
    device = [(10, 20, "void k1_family<3, 2, 2>(float const*)"), (20, 25, "reduce_splits(x)"),
              (30, 40, "void k1_matmat_family<3, 2, 2, 3>(...)"), (45, 50, "Memcpy DtoH"),
              (50, 52, "void k1_family<3, 2, 2>(float const*)")]
    host = [(0, 60, "gpbench.job"), (2, 58, "gpbench.gp_condition"), (25, 29, "aten::dot"),
            (41, 44, "cudaStreamSynchronize")]
    return Trace(device, host, [(0, 60)])


def test_trace_window_busy_kernels():
    t = synthetic()
    assert t.window_s == pytest.approx(60e-6)
    assert t.busy_s == pytest.approx(32e-6)
    assert t.idle_share == pytest.approx(100 * 28 / 60)
    pats = [r"(^|\s)k1_family\b", r"(^|\s)reduce_splits\b"]
    assert t.kernel_seconds(pats) == pytest.approx(17e-6)
    assert t.top_device_ops(2)[0] == ["void k1_family<3, 2, 2>(float const*)",
                                      pytest.approx(12e-6)]


def test_trace_idle_by_host():
    t = synthetic()
    gaps = dict((name, s) for name, s in t.idle_by_host())
    # gaps: 0-10 (mid 5: gp_condition), 25-30 (mid 27.5: aten::dot), 40-45 (mid
    # 42.5: the synchronize), 52-60 (mid 56: gp_condition)
    assert gaps == {"gpbench.gp_condition": pytest.approx(18e-6),
                    "aten::dot": pytest.approx(5e-6),
                    "cudaStreamSynchronize": pytest.approx(5e-6)}
    assert sum(gaps.values()) == pytest.approx(t.window_s - t.busy_s)


def test_trace_window_clips_to_jobs():
    t = Trace([(0, 10, "k"), (95, 120, "k")], [], [(5, 50), (60, 100)])
    assert t.window_s == pytest.approx(95e-6)
    assert t.busy_s == pytest.approx(10e-6)
    assert t.kernel_seconds(["k"]) == pytest.approx(10e-6)


def test_trace_device_only_window_by_host_clock():
    # a profile of the device alone: the window is the host's, from the first
    # interval on, and holds every interval
    t = Trace.device_only([(100, 110, "k"), (130, 150, "k"), (150, 160, "m")], 80e-6)
    assert t.window_s == pytest.approx(80e-6)
    assert t.busy_s == pytest.approx(40e-6)
    assert t.idle_share == pytest.approx(100 * 40 / 80)
    assert t.kernel_seconds(["^k$"]) == pytest.approx(30e-6)
    empty = Trace.device_only([], 1.0)
    assert empty.busy_s == 0.0 and empty.idle_share == 100.0
