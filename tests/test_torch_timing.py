"""The port's timing helpers (`cfjax_torch/utils/timing.py`) on CPU
tensors, beside cfjax's (`cfjax/utils/timing.py`) on the same numpy
inputs: slope timing refuses a slope it cannot separate from the spread
(both packages raise MeasurementError with a positive upper bound) and
measures a real op (a 256^2 matvec: both positive); `_spread` is cfjax's
to the sample. Times are the CPU's, compared only in sign. The helpers
time on the device their tensors lie on: CPU tensors never reach CUDA,
whatever device is configured."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfjax.utils.timing as jt
import cfjax_torch
from cfjax_torch.utils import timing as tt

torch.set_num_threads(2)


@pytest.fixture
def no_cuda(monkeypatch):
    """The configured device is the card, and any call into torch.cuda
    fails: what runs here runs on the CPU tensors' own device."""
    shipped = cfjax_torch.config.DEFAULT.device
    cfjax_torch.set_config(device="cuda")

    def refuse(*a, **k):
        raise AssertionError("a CPU-tensor timing reached torch.cuda")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    yield
    cfjax_torch.set_config(device=shipped)


def test_slope_timing_rejects_noise_like_cfjax(no_cuda):
    """A slope that cannot dominate the spread raises MeasurementError with
    an upper bound instead of a clamped 0, in both packages."""
    with pytest.raises(tt.MeasurementError) as ei:
        tt.time_chained(lambda v: v + 1.0, torch.zeros(8), repeats=2, delta_ratio=1e12,
                        time_budget=0.5)
    assert ei.value.upper_bound is not None and ei.value.upper_bound > 0
    with pytest.raises(jt.MeasurementError) as ej:
        jt.time_chained(lambda v: v + 1.0, jnp.zeros(8), repeats=2, delta_ratio=1e12,
                        time_budget=0.5)
    assert ej.value.upper_bound > 0


def test_slope_timing_measures_a_matvec_like_cfjax(no_cuda):
    A = np.random.default_rng(0).standard_normal((256, 256)).astype(np.float32)
    At = torch.tensor(A)
    dt = tt.time_chained(lambda v: At @ v, torch.ones(256), repeats=3, time_budget=30.0)
    Aj = jnp.asarray(A)
    dj = jt.time_chained(lambda v: Aj @ v, jnp.ones(256), repeats=3, time_budget=30.0)
    assert dt > 0 and dj > 0


@pytest.mark.parametrize("n", [1, 2, 3, 5, 7, 12])
def test_spread_matches_cfjax(n):
    ts = list(np.random.default_rng(n).uniform(0, 1, n))
    assert tt._spread(ts) == jt._spread(ts)


def test_dispatch_and_sync_time_on_cpu_tensors(no_cuda):
    A = torch.randn(128, 128)
    sec, spread = tt.time_dispatch(lambda a: a @ a, A, iters=3)
    assert sec >= 0 and spread >= 0
    assert tt.dispatch_overhead(device="cpu", iters=5) > 0
    out, wall = tt.sync_time(lambda: A @ A, device="cpu")
    assert wall > 0 and torch.equal(out, A @ A)
    with pytest.raises(ValueError, match="no tensor argument"):
        tt.time_dispatch(lambda: None)


def test_sync_time_follows_the_configured_device(monkeypatch):
    """Without a device, sync_time synchronizes the configured one."""
    seen = []
    monkeypatch.setattr(tt, "_sync", lambda d: seen.append(torch.device(d)))
    shipped = cfjax_torch.config.DEFAULT.device
    try:
        for dev in ("cuda", "cpu"):
            cfjax_torch.set_config(device=dev)
            tt.sync_time(lambda: None)
            assert seen[-2:] == [torch.device(dev)] * 2
    finally:
        cfjax_torch.set_config(device=shipped)
