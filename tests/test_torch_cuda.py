"""The port's CUDA kernels on the card, and its independence from jax.

The tests marked `needs_gpu` compare K1, K2 and K3 with their plain torch
versions on a CUDA device; they skip where there is none (the skip is
decided when the test runs, not when the module is imported). The two
import checks run everywhere: the port package never imports jax."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import cfjax_torch.kernels as tk
from cfjax_torch.derivative import GradientKernel
from cfjax_torch.kernels.profile_spec import to_spec
from cfjax_torch.operators.dispatch import explain, gramian
from cfjax_torch.ops import grad_mvm
from cfjax_torch.ops import gramian_mvm as mvm

PACKAGE = Path(__file__).resolve().parents[1] / "cfjax_torch"

needs_gpu = pytest.mark.skipif(
    "not torch.cuda.is_available()",
    reason="needs a CUDA device: the CUDA kernels have no CPU mode")


def test_port_source_has_no_jax_import():
    pattern = re.compile(r"^\s*(import jax|from jax)\b", re.MULTILINE)
    offenders = [str(p) for p in PACKAGE.rglob("*.py") if pattern.search(p.read_text())]
    assert offenders == []


def test_port_import_loads_no_jax():
    code = ("import sys, cfjax_torch, cfjax_torch.gp, cfjax_torch.operators, cfjax_torch.ops,"
            " cfjax_torch.derivative, cfjax_torch.utils.linalg;"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'cfjax.'))];"
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=PACKAGE.parent,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _rel(out, ref):
    return float(torch.linalg.norm(out.double() - ref) / torch.linalg.norm(ref))


def _cuda_data(n, m, d, scale=1.0, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.tensor(rng.standard_normal(s) * scale, dtype=torch.float32,
                                device="cuda")
    return f(n, d), f(m, d), torch.tensor(rng.standard_normal(m), dtype=torch.float32,
                                          device="cuda")


@needs_gpu
@pytest.mark.parametrize("d", [1, 3, 16])
@pytest.mark.parametrize("k", [tk.MaternP(2), tk.Exp(), 2.0 * tk.EQ() + 0.5 * tk.MaternP(1)],
                         ids=["MaternP2", "Exp", "SumScaled"])
def test_direct_kernel_matches_plain(d, k):
    x, y, a = _cuda_data(1003, 701, d)
    before = mvm.LAUNCHES["direct"]
    out = mvm.gramian_matvec_direct(k, x, y, a)
    torch.cuda.synchronize()
    assert mvm.LAUNCHES["direct"] == before + 1
    ref = mvm.gramian_matvec_direct_plain(k, x.double(), y.double(), a.double())
    assert _rel(out, ref) <= 1e-5


@needs_gpu
@pytest.mark.parametrize("k,mode", [(tk.EQ(), "iso"), (tk.MaternP(2), "iso"),
                                    (tk.Dot() ** 2, "dot"), (tk.ExponentialDot(), "dot")],
                         ids=["EQ", "MaternP2", "Dot2", "ExponentialDot"])
def test_expand_kernel_matches_plain(k, mode):
    x, y, a = _cuda_data(1003, 701, 64, scale=64 ** -0.5)
    before = mvm.LAUNCHES["expand"]
    out = mvm.gramian_matvec_expand(k, x, y, a, mode)
    torch.cuda.synchronize()
    assert mvm.LAUNCHES["expand"] == before + 1
    ref = mvm.gramian_matvec_expand_plain(k, x.double(), y.double(), a.double(), mode)
    assert _rel(out, ref) <= 1e-4


@needs_gpu
def test_kernels_refuse_grad_and_wrong_inputs():
    x, y, a = _cuda_data(64, 32, 3)
    with pytest.raises(RuntimeError, match="forward-only"):
        mvm.gramian_matvec_direct(tk.EQ(), x, y, a.clone().requires_grad_(True))
    with pytest.raises(TypeError):
        mvm.gramian_matvec_direct(tk.EQ(), x.double(), y.double(), a.double())
    with pytest.raises(ValueError):
        mvm.gramian_matvec_direct(tk.NN(0.3), x, y, a)


@needs_gpu
def test_gramian_on_cuda_selects_kernels():
    x, _, _ = _cuda_data(300, 1, 3)
    assert "K1" in explain(tk.MaternP(2), x)
    x64, _, _ = _cuda_data(300, 1, 64)
    assert "K2" in explain(tk.Lengthscale(tk.EQ(), 4.0), x64)
    assert "K2" in explain(tk.Dot() ** 2, x64)
    G = gramian(tk.MaternP(2), x)
    v = torch.ones(300, device="cuda")
    before = mvm.LAUNCHES["direct"]
    G @ v
    assert mvm.LAUNCHES["direct"] == before + 1
    assert "declined" in explain(tk.MaternP(2), x.double())


def _grad_data(n, m, d, coincident=16, seed=0):
    """Points scaled by 1/sqrt(d) (O(1) distances and inner products),
    with the first rows of y copies of rows of x (s = 0 exactly)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)) / np.sqrt(d)
    y = rng.standard_normal((m, d)) / np.sqrt(d)
    c = min(coincident, n, m)
    y[:c] = x[:c]
    f = lambda v: torch.tensor(v, dtype=torch.float32, device="cuda")
    return f(x), f(y), f(rng.standard_normal((m, d)))


@needs_gpu
@pytest.mark.parametrize("d", [1, 3, 16, 17, 257])
@pytest.mark.parametrize("k,mode", [(tk.EQ(), "iso"), (tk.MaternP(2), "iso"),
                                    (tk.Lengthscale(tk.MaternP(3), 0.5), "iso"),
                                    (tk.Dot() ** 2, "dot"), (tk.ExponentialDot(), "dot")],
                         ids=["EQ", "MaternP2", "LengthscaleMaternP3", "Dot2", "ExponentialDot"])
def test_grad_kernel_matches_plain(d, k, mode):
    x, y, A = _grad_data(1003, 601, d)
    before = mvm.LAUNCHES["grad"]
    out = grad_mvm.grad_matvec(k, x, y, A, mode)
    torch.cuda.synchronize()
    assert mvm.LAUNCHES["grad"] == before + 1
    ref = grad_mvm.grad_matvec_plain(k, x.double(), y.double(), A.double(), mode)
    assert torch.isfinite(out).all()
    assert _rel(out, ref) <= 1e-4


@needs_gpu
@pytest.mark.parametrize("d", [2, 33])
def test_grad_kernel_on_coincident_points(d):
    """x is y: every diagonal block is -2 f'(0) I, the whole block at s = 0."""
    x, _, A = _grad_data(300, 300, d)
    for k in (tk.MaternP(2), tk.EQ()):
        out = grad_mvm.grad_matvec(k, x, x, A)
        ref = grad_mvm.grad_matvec_plain(k, x.double(), x.double(), A.double())
        assert _rel(out, ref) <= 1e-4
    # a lone point: the product is the diagonal block alone
    one = x[:1].contiguous()
    out = grad_mvm.grad_matvec(tk.MaternP(2), one, one, A[:1].contiguous())
    torch.testing.assert_close(out, (5.0 / 3.0) * A[:1], rtol=1e-6, atol=0)


@needs_gpu
def test_grad_kernel_ragged_and_rectangular_shapes():
    for n, m, d in ((7, 4096, 1024), (1, 65, 31), (129, 1, 5)):
        x, y, A = _grad_data(n, m, d)
        out = grad_mvm.grad_matvec(tk.MaternP(2), x, y, A)
        ref = grad_mvm.grad_matvec_plain(tk.MaternP(2), x.double(), y.double(), A.double())
        assert out.shape == (n, d) and _rel(out, ref) <= 1e-4


@needs_gpu
def test_grad_kernel_refuses_grad_and_wrong_inputs():
    x, y, A = _grad_data(64, 32, 3)
    with pytest.raises(RuntimeError, match="forward-only"):
        grad_mvm.grad_matvec(tk.EQ(), x, y, A.clone().requires_grad_(True))
    with pytest.raises(TypeError):
        grad_mvm.grad_matvec(tk.EQ(), x.double(), y.double(), A.double())
    with pytest.raises(ValueError, match="derivative spec"):
        grad_mvm.grad_matvec(tk.Exp(), x, y, A)
    with pytest.raises(ValueError, match="derivative spec"):
        grad_mvm.grad_matvec(tk.EQ(), x, y, A, spec=to_spec(tk.EQ())[0])
    with pytest.raises(ValueError, match="value spec"):
        mvm.gramian_matvec_direct(tk.EQ(), x, y, A[:, 0].contiguous(),
                                  spec=to_spec(tk.EQ(), derivative=True)[0])


@needs_gpu
def test_gradient_gramian_on_cuda_selects_k3():
    x, _, _ = _grad_data(300, 1, 16)
    how = explain(GradientKernel(tk.EQ()), x)
    assert "cuda kernel K3" in how
    G = gramian(GradientKernel(tk.EQ()), x)
    v = torch.ones(G.shape[1], device="cuda")
    before = mvm.LAUNCHES["grad"]
    out = G @ v
    assert mvm.LAUNCHES["grad"] == before + 1
    ref = grad_mvm.grad_matvec_plain(tk.EQ(), x.double(), x.double(),
                                     v.double().reshape(300, 16)).reshape(-1)
    assert _rel(out, ref) <= 1e-4
    assert "declined: dtype" in explain(GradientKernel(tk.EQ()), x.double())
    assert "no derivative spec" in explain(GradientKernel(tk.Exp()), x)
    assert "cuda kernel K3" in explain(GradientKernel(tk.Warped(tk.EQ(), torch.tanh)), x)
