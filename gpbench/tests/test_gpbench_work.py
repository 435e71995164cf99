"""The frozen work models reproduce the bounds the port's kernel table
gives (PERF.md §6): K1 MaternP(2), d = 3, 0.1284 ms (SFU) at n = 16384
and 8.217 ms at n = 2^17; K3 EQ, n = 4096, d = 16, 0.0130 ms on the
tensor cores at 3 passes."""

import pytest

from gpbench import work


def test_k1_maternp2():
    ops = work.PROFILE_OPS[work.profile_key({"name": "MaternP", "args": [2]})]
    w = work.work_direct(16384, 16384, 3, ops)
    assert w.bound() == "SFU"
    assert 1e3 * w.roofline_seconds() == pytest.approx(0.1284, abs=5e-5)
    assert 1e3 * work.work_direct(2**17, 2**17, 3, ops).roofline_seconds() == \
        pytest.approx(8.217, abs=5e-4)


def test_k3_eq():
    jet = work.JET_OPS[work.profile_key({"name": "EQ"})]
    w = work.work_grad(4096, 4096, 16, jet, 3)
    assert w.bound() == "tensor cores"
    assert 1e3 * w.roofline_seconds() == pytest.approx(0.0130, abs=5e-5)
    one = work.work_grad(4096, 4096, 16, jet, 1)
    assert one.seconds()["tensor cores"] == pytest.approx(w.seconds()["tensor cores"] / 3)
    assert one.bound() == "fp32"


def test_work_algebra():
    a = work.Work(fp32=1.0, sfu=2.0, tc_flops=3.0, tc_passes=1, hbm_bytes=4.0)
    b = work.Work(fp32=1.0, tc_passes=3)
    s = a + b
    assert (s.fp32, s.sfu, s.tc_flops, s.tc_passes, s.hbm_bytes) == (2.0, 2.0, 3.0, 3, 4.0)
    t = 3 * a
    assert (t.fp32, t.sfu, t.tc_flops, t.tc_passes, t.hbm_bytes) == (3.0, 6.0, 9.0, 1, 12.0)


def test_peaks():
    assert work.FP32_RATE == pytest.approx(33.45e12, rel=1e-3)
    assert work.SFU_RATE == pytest.approx(4.18e12, rel=1e-3)
    assert (work.TC_RATE, work.HBM_RATE, work.PEAK_SLACK) == (495e12, 3.35e12, 1.05)
