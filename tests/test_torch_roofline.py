"""The port's roofline (`cfjax_torch/utils/roofline.py`) and each kernel's
least work (`work_*` beside the wrappers), on the CPU: no timing here,
only arithmetic.

`summarize` keeps cfjax's guard: a plausible reading is valid, one that
implies more than a peak, or a non-positive time, is not (the same readings
through both packages' `summarize`). Each kernel's work at the shapes of
chip_smoke.py's phase 5 reproduces the bound column of PERF.md's kernel
table to four significant digits (the arithmetic of the H100's peaks, not
a measurement)."""

import math

import numpy as np
import pytest
import torch

import cfjax.utils.roofline as jr
import cfjax_torch.kernels as tk
from cfjax_torch.derivative.gradient import work_gradient_mvm
from cfjax_torch.derivative.hessian import work_hessian_mvm
from cfjax_torch.kernels.profile_spec import to_spec
from cfjax_torch.ops import grad_mvm, tile_ell_mvm
from cfjax_torch.ops import gramian_mvm as mvm
from cfjax_torch.utils import roofline as rf
from cfjax_torch.utils.besselk import MATERN_OPS, matern_nu_ops


def test_summarize_valid_invalid_and_nonpositive_like_cfjax():
    """cfjax's test (tests/test_utils_extra.py) on both packages: 8.6e9
    matmul flops in 1 ms is plausible on either device, in 1 us impossible;
    a time <= 0 is refused."""
    jw = jr.Work(mxu=8.6e9, vpu=1e7, hbm_bytes=1e7)
    tw = rf.Work(tc_flops=8.6e9, fp32=1e7, hbm_bytes=1e7)
    for t, valid in ((1e-3, True), (1e-6, False)):
        assert jr.summarize(jw, t)["valid"] is valid
        assert rf.summarize(tw, t)["valid"] is valid
    assert rf.summarize(tw, 1e-3)["bound"] == "tensor cores"
    bad = rf.summarize(tw, 1e-6)
    assert "tensor cores peak" in bad["why"] and bad["peak_pct"]["tensor cores"] > 105
    for t in (0.0, -1e-3, float("nan")):
        out = rf.summarize(tw, t)
        assert out["valid"] is False and "non-positive" in out["why"]
        assert jr.summarize(jw, 0.0)["valid"] is False


@pytest.mark.parametrize("work,name", [
    (rf.Work(fp32=1e12), "fp32"), (rf.Work(sfu=1e12), "SFU"),
    (rf.Work(hbm_bytes=1e12), "HBM"), (rf.Work(tc_flops=1e15), "tensor cores"),
    (rf.Work(tc_flops=1e15, tc_passes=3), "tensor cores/3x"), (rf.Work(), "latency")])
def test_bound_names_the_resource(work, name):
    assert work.bound() == name


def test_peak_slack_and_one_pass_floor():
    """A reading at 104% of the fp32 peak is valid, at 106% not; the floor
    counts the tensor cores at one pass, the bound at the work's passes."""
    w = rf.Work(fp32=rf.FP32_RATE)   # one second at the peak
    assert rf.summarize(w, 1 / 1.04)["valid"] and not rf.summarize(w, 1 / 1.06)["valid"]
    t = rf.Work(tc_flops=rf.TC_RATE, tc_passes=3)
    assert math.isclose(t.roofline_seconds(), 3.0) and math.isclose(t.sanity_floor(), 1 / 1.05)
    assert rf.summarize(t, 1.0)["valid"]      # 300% of the three-pass bound, 100% of the peak
    assert math.isclose(rf.summarize(t, 1.0)["roofline_pct"], 300.0)


def test_peaks_are_the_h100_sxm_at_700_w():
    assert rf.FP32_RATE == 132 * 128 * 1.98e9 and rf.SFU_RATE == 132 * 16 * 1.98e9
    assert rf.TC_RATE == 495e12 and rf.HBM_RATE == 3.35e12


def _ms(work):
    return work.roofline_seconds() * 1e3


MATERN2 = to_spec(tk.MaternP(2))[0]
# PERF.md's kernel table, bound column (ms, what sets it)
BOUNDS = {
    "K1 n=16384": (lambda: mvm.work_direct(16384, 16384, 3, mvm.profile_ops(MATERN2)),
                   0.1284, "SFU"),
    "K1 n=2^17": (lambda: mvm.work_direct(131072, 131072, 3, mvm.profile_ops(MATERN2)),
                  8.217, "SFU"),
    "K1 p=16 n=16384": (lambda: mvm.work_direct(16384, 16384, 3, mvm.profile_ops(MATERN2),
                                                p=16), 0.2247, "fp32"),
    "K1 p=16 n=2^17": (lambda: mvm.work_direct(131072, 131072, 3, mvm.profile_ops(MATERN2),
                                               p=16), 14.38, "fp32"),
    "K2 d=64": (lambda: mvm.work_expand(
        16384, 16384, 64, mvm.profile_ops(to_spec(tk.Lengthscale(tk.EQ(), 4.0))[0]), 3),
        0.2082, "tensor cores/3x"),
    "K3 EQ n=4096 d=16": (lambda: grad_mvm.work_grad(
        4096, 4096, 16, grad_mvm.jet_ops(to_spec(tk.EQ(), derivative=True)[0]), 3),
        0.01302, "tensor cores/3x"),
    "K3 MaternP(2) n=d=1024": (lambda: grad_mvm.work_grad(
        1024, 1024, 1024, grad_mvm.jet_ops(to_spec(tk.MaternP(2), derivative=True)[0]), 3),
        0.05206, "tensor cores/3x"),
    "K4 nnz 8934446": (lambda: tile_ell_mvm.work_rows(8_934_446, 32768, 32768), 0.02141,
                       "HBM"),
}


@pytest.mark.parametrize("name", list(BOUNDS))
def test_kernel_work_reproduces_the_bound_column(name):
    make, ms, by = BOUNDS[name]
    work = make()
    assert work.bound() == by
    assert _ms(work) == pytest.approx(ms, rel=5e-4)


def test_work_counts_per_entry():
    """K1: 2d + the profile + one FFMA a column an entry; MaternP(2)'s
    profile 6 fp32 and 2 SFU; K3's EQ jet 3 + 1 and 10 fp32 besides; bytes
    each input once and each output once."""
    assert mvm.profile_ops(MATERN2) == (6, 2)
    w = mvm.work_direct(10, 20, 3, (6, 2))
    assert (w.fp32, w.sfu, w.hbm_bytes) == (200 * 13, 400, 4 * (30 * 3 + 30))
    w = mvm.work_direct(10, 20, 3, (6, 2), p=4)
    assert (w.fp32, w.hbm_bytes) == (200 * 16, 4 * (30 * 3 + 30 * 4))
    w = grad_mvm.work_grad(10, 20, 4, (3, 1), 3)
    assert (w.fp32, w.sfu, w.tc_flops, w.tc_passes) == (200 * 13, 200, 200 * 32, 3)
    assert tile_ell_mvm.work_rows(100, 10, 20, itemsize=8).hbm_bytes == 100 * 12 + 30 * 8
    with pytest.raises(ValueError):
        mvm.profile_ops(to_spec(2.0 * tk.EQ() + tk.MaternP(1))[0])   # interpreted
    with pytest.raises(ValueError):
        grad_mvm.jet_ops(to_spec(tk.RQ(1.5), derivative=True)[0])


def test_derivative_rows_count_cfjax_benchmark_work():
    """The BASELINE derivative rows' work: cfjax's run_baseline counts
    (matmul flops 8 n^2 d, 8 n^2 d^2 for the Hessian; its 20 n^2
    elementwise flops) on this card's resources; both readings a plain
    path could give are valid, and one faster than a peak allows is not."""
    g = work_gradient_mvm(1024, 1024)
    assert g.tc_flops == 8 * 1024 ** 3 and g.tc_passes == 3 and g.sfu == 1024 ** 2
    assert g.bound() == "tensor cores/3x"
    assert _ms(g) == pytest.approx(0.05206, rel=5e-4)
    h = work_hessian_mvm(128, 16)
    assert h.tc_flops == 8 * 128 ** 2 * 16 ** 2 and h.fp32 == 20 * 128 ** 2
    for w in (g, h):
        assert rf.summarize(w, 1e-3)["valid"]
        assert not rf.summarize(w, 0.5 * w.sanity_floor())["valid"]


def test_matern_nu_ops_weights_the_histogram():
    """One bin: the count of the entry at that distance; two bins: the
    count-weighted mean; below the guard's bound, the guard's polynomial."""
    c = torch.tensor([0.5, 4.0], dtype=torch.float64)
    one = matern_nu_ops(2.3, (c[:1], torch.tensor([1.0])))
    two = matern_nu_ops(2.3, (c[1:], torch.tensor([1.0])))
    mix = matern_nu_ops(2.3, (c, torch.tensor([1.0, 3.0])))
    assert all(math.isclose(m, (a + 3 * b) / 4) for m, a, b in zip(mix, one, two))
    assert one[0] >= MATERN_OPS["value"][0] and one[1] >= MATERN_OPS["value"][1]
    tiny = matern_nu_ops(2.3, (torch.tensor([1e-12], dtype=torch.float64),
                               torch.tensor([1.0])))
    assert tiny == (6.0, 0.0)
    jet = matern_nu_ops(2.7, (c[:1], torch.tensor([1.0])), jet=True)
    assert np.all(np.asarray(jet) > np.asarray(matern_nu_ops(2.7, (c[:1], torch.tensor([1.0])))))
