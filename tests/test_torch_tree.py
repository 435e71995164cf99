"""Parity of the port's ball tree (`cfjax_torch.barneshut.tree`) with cfjax.

The host builds (median, morton) do cfjax's numpy arithmetic in the same
order, so permutations, points, centers and radii are equal exactly. The
device build is compared with cfjax's `_build_tree_device` run on the CPU
on float32 points: the same Hilbert codes and a stable argsort give the
same permutation; centers are min/max averages (exact), radii sums over d
in another order (rtol 1e-6, a few float32 ulps)."""

import numpy as np
import pytest
import torch

from cfjax.barneshut import build_tree as j_build_tree
import cfjax_torch
from cfjax_torch.barneshut import BalancedTree, build_tree


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """Input without a device goes to the CPU in this module's tests; the
    configured device is restored after them."""
    shipped = cfjax_torch.config.DEFAULT.device
    cfjax_torch.set_config(device="cpu")
    yield
    cfjax_torch.set_config(device=shipped)


SHAPES = [(100, 2), (5000, 3), (3001, 1), (2000, 4), (700, 9)]


@pytest.mark.parametrize("n,d", SHAPES)
@pytest.mark.parametrize("method", ["median", "morton"])
def test_host_builds_match_reference(method, n, d, rng):
    y = rng.standard_normal((n, d))
    tj = j_build_tree(y, leafsize=16, method=method)
    tt = build_tree(y, leafsize=16, method=method)
    assert isinstance(tt, BalancedTree)
    assert (tt.levels, tt.leafsize, tt.pad, tt.n_leaves) == (tj.levels, tj.leafsize, tj.pad,
                                                           tj.n_leaves)
    np.testing.assert_array_equal(tt.perm, np.asarray(tj.perm))
    np.testing.assert_array_equal(tt.points.numpy(), np.asarray(tj.points))
    for l in range(tj.levels + 1):
        np.testing.assert_array_equal(tt.centers_np[l], tj.centers_np[l])
        np.testing.assert_array_equal(tt.radii_np[l], tj.radii_np[l])
        np.testing.assert_array_equal(tt.radii[l].numpy(), tj.radii_np[l])


@pytest.mark.parametrize("n,d", [(5000, 3), (3001, 1), (2000, 4), (20000, 2)])
def test_device_build_matches_reference(n, d, rng):
    y = rng.standard_normal((n, d)).astype(np.float32)
    tj = j_build_tree(y, leafsize=16, method="device")
    tt = build_tree(torch.tensor(y), leafsize=16, method="device")
    np.testing.assert_array_equal(tt.perm, np.asarray(tj.perm))
    assert tt.perm.dtype == np.int32
    np.testing.assert_array_equal(tt.points_np, tj.points_np)
    P = tt.points_np.shape[0]
    for l in range(tj.levels + 1):
        np.testing.assert_array_equal(tt.centers_np[l], tj.centers_np[l])
        np.testing.assert_allclose(tt.radii_np[l], tj.radii_np[l], rtol=1e-6)
        # the radii cover their slices
        pts = tt.points_np.reshape(2**l, P // 2**l, -1)
        dist = np.sqrt(((pts - tt.centers_np[l][:, None, :]) ** 2).sum(-1)).max(1)
        assert np.all(dist <= tt.radii_np[l] + 1e-5)
    assert torch.equal(tt.perm_dev.long(), torch.as_tensor(tt.perm).long())


def test_auto_on_cpu_tensors_takes_the_host_builds(rng):
    """"device" is chosen only for CUDA tensors: a CPU tensor at the size
    where cfjax would take the device build on a TPU builds by median."""
    y = rng.standard_normal((20000, 2))
    tt = build_tree(torch.tensor(y), leafsize=16)
    tm = build_tree(y, leafsize=16, method="median")
    np.testing.assert_array_equal(tt.perm, tm.perm)
    assert tt.points.dtype == torch.float64 and tt.points.device.type == "cpu"
    # a 1-D input is one coordinate per point
    t1 = build_tree(torch.tensor(y[:, 0]), leafsize=16)
    np.testing.assert_array_equal(t1.perm, np.asarray(j_build_tree(y[:, 0], leafsize=16).perm))
