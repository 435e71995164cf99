"""The port's CUDA kernels on the card, and its independence from jax.

The tests marked `needs_gpu` compare K1, K2, K3 and K4 with their plain
torch versions on a CUDA device; they skip where there is none (the skip is
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
from cfjax_torch.operators import solve_with_info
from cfjax_torch.operators.sparse_op import sparse_gramian
from cfjax_torch.operators.tile_ell import TileEllOperator
from cfjax_torch.ops import grad_mvm
from cfjax_torch.ops import gramian_mvm as mvm
from cfjax_torch.ops import tile_ell_mvm

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
            " cfjax_torch.derivative, cfjax_torch.utils.linalg, cfjax_torch.barneshut,"
            " cfjax_torch.operators.sparse_op, cfjax_torch.operators.tile_ell;"
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


def _slab_data(B, K, nt, dtype, seed=0):
    """Random slabs: offsets over the whole lane range, ~70% zero values."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (B, K, nt, 128)
    a2 = torch.randn((nt, 128), generator=g, device="cuda", dtype=dtype)
    off = torch.randint(0, 128, shape, generator=g, device="cuda", dtype=torch.int32)
    val = torch.randn(shape, generator=g, device="cuda", dtype=dtype)
    val = val * (torch.rand(shape, generator=g, device="cuda") < 0.3)
    return a2, off, val


@needs_gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("B,K,nt", [(8, 1, 1), (8, 2, 2), (136, 8, 128), (8, 32, 256),
                                    (16, 128, 2), (136, 1, 256), (24, 4, 1)])
def test_tile_ell_kernel_matches_plain(B, K, nt, dtype):
    a2, off, val = _slab_data(B, K, nt, dtype)
    before = mvm.LAUNCHES["tile_ell"]
    out = tile_ell_mvm.slab_matvec(a2, off, val)
    torch.cuda.synchronize()
    assert mvm.LAUNCHES["tile_ell"] == before + 1
    assert out.dtype == dtype and tuple(out.shape) == (B, 128)
    ref = tile_ell_mvm.slab_matvec_plain(a2.double(), off, val.double())
    assert _rel(out, ref) <= (1e-5 if dtype == torch.float32 else 1e-12)
    # the chunks are added in a fixed order: a second launch repeats bit for bit
    assert torch.equal(out, tile_ell_mvm.slab_matvec(a2, off, val))


@needs_gpu
def test_tile_ell_kernel_refuses_wrong_inputs():
    a2, off, val = _slab_data(8, 2, 3, torch.float32)
    with pytest.raises(TypeError):
        tile_ell_mvm.slab_matvec(a2.half(), off, val.half())
    with pytest.raises(TypeError):
        tile_ell_mvm.slab_matvec(a2.double(), off, val)
    with pytest.raises(TypeError):
        tile_ell_mvm.slab_matvec(a2, off.long(), val)
    with pytest.raises(ValueError, match="one CUDA device"):
        tile_ell_mvm.slab_matvec(a2, off.cpu(), val)
    with pytest.raises(ValueError, match="shapes"):
        tile_ell_mvm.slab_matvec(a2[:2].contiguous(), off, val)
    strided = lambda t: torch.stack([t, t], dim=-1)[..., 0]   # same shape, not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        tile_ell_mvm.slab_matvec(a2, strided(off), strided(val))
    with pytest.raises(RuntimeError, match="forward-only"):
        tile_ell_mvm.slab_matvec(a2, off, val.clone().requires_grad_(True))


@needs_gpu
@pytest.mark.parametrize("method", ["scan", "tree"])
def test_sparse_gramian_on_cuda_launches_k4(method):
    """The sparsified Gramian of CUDA points is a TileELL operator whose
    MVM launches K4 once per group (a matrix right-hand side once per group
    and column), agrees with the port's own build on the CPU, and solves
    through MINRES."""
    rng = np.random.default_rng(3)
    xs = rng.uniform(0, 12, (20000, 2))
    k = tk.Lengthscale(tk.EQ(), 0.2)
    x = torch.tensor(xs, dtype=torch.float32, device="cuda")
    S, ratio = sparse_gramian(k, x, tol=1e-6, method=method)
    assert isinstance(S, TileEllOperator) and S.perm.is_cuda
    S_cpu, ratio_cpu = sparse_gramian(k, x.cpu(), tol=1e-6, method=method)
    assert abs(ratio - ratio_cpu) <= 1e-4 * ratio_cpu
    a = torch.tensor(rng.standard_normal(20000), dtype=torch.float32, device="cuda")
    before = mvm.LAUNCHES["tile_ell"]
    out = S @ a
    assert mvm.LAUNCHES["tile_ell"] == before + len(S.groups)
    assert _rel(out, (S_cpu @ a.cpu()).double().cuda()) <= 1e-5
    out2 = S @ torch.stack([a, 2 * a], dim=1)
    assert mvm.LAUNCHES["tile_ell"] == before + 3 * len(S.groups)
    assert torch.equal(out2[:, 0], out)
    op = S.add_diagonal(1e-1)
    b = torch.sin(x[:, 0])
    before = mvm.LAUNCHES["tile_ell"]
    alpha, (it, _) = solve_with_info(op, b, tol=1e-5, maxiter=1000)
    assert 0 < it < 1000 and mvm.LAUNCHES["tile_ell"] - before >= it
    res = torch.linalg.norm((op @ alpha).double() - b.double()) / torch.linalg.norm(b.double())
    assert float(res) <= 1e-4


def _grid(n, dtype=torch.float32, start=0.0):
    from cfjax_torch.utils.grids import UniformGrid

    return UniformGrid(start, 1.0 / n, n, device="cuda", dtype=dtype)


@needs_gpu
def test_toeplitz_grid_gp_on_cuda_launches_k1():
    """A uniform grid placed on the card gives a lazy Toeplitz operator
    whose column and FFT MVM stay on the card in float32; gp_condition
    solves by CG; the posterior mean off the grid launches K1 once; the
    variance agrees with a float64 run."""
    from cfjax_torch.gp import GPPosterior, gp_condition
    from cfjax_torch.operators import ToeplitzOperator

    rng = np.random.default_rng(12)
    n = 20000
    k = tk.Exp()
    g = _grid(n)
    T = gramian(k, g)
    assert isinstance(T, ToeplitzOperator) and callable(T._col_src)
    a = torch.tensor(rng.standard_normal(n), dtype=torch.float32, device="cuda")
    out = T @ a
    assert T.col.is_cuda and T.col.dtype == torch.float32 and out.dtype == torch.float32
    x = g.points()
    ref = mvm.gramian_matvec_direct_plain(k, x[:300, None].double(), x[:, None].double(),
                                          a.double())
    assert _rel(out[:300], ref) <= 1e-5
    y = torch.sin(6 * np.pi * x)
    post = gp_condition(k, g, y, noise=1e-2, tol=1e-5, maxiter=2000)
    assert post.solve_info is not None and post.solve_info[0] < 2000
    xt = torch.tensor(rng.uniform(0, 1, 500), dtype=torch.float32, device="cuda")
    before = mvm.LAUNCHES["direct"]
    mean = post.mean(xt)
    assert mvm.LAUNCHES["direct"] == before + 1 and mean.shape == (500,)
    var = post.variance(xt[:16], tol=1e-6, maxiter=2000)
    var64 = GPPosterior(k, _grid(n, torch.float64), post.alpha.double(), 1e-2).variance(
        xt[:16].double(), tol=1e-10, maxiter=5000)
    assert float((var.double() - var64).abs().max()) <= 1e-4


@needs_gpu
def test_circulant_and_levinson_on_cuda():
    from cfjax_torch.gp import log_marginal_likelihood
    from cfjax_torch.operators import CirculantOperator, ToeplitzOperator, levinson

    rng = np.random.default_rng(13)
    n = 4096
    k = tk.Periodic(tk.EQ())
    C, C64 = gramian(k, _grid(n)), gramian(k, _grid(n, torch.float64))
    assert isinstance(C, CirculantOperator) and C.c.is_cuda
    a = torch.tensor(rng.standard_normal(n), dtype=torch.float32, device="cuda")
    assert _rel(C @ a, C64 @ a.double()) <= 1e-5
    y = torch.cos(4 * np.pi * _grid(n).points())
    lml = log_marginal_likelihood(k, _grid(n), y, noise=1e-2)
    lml64 = log_marginal_likelihood(k, _grid(n, torch.float64), y.double(), noise=1e-2)
    assert abs(float(lml) - float(lml64)) <= 1e-4 * abs(float(lml64))
    col = gramian(tk.Exp(), _grid(512, torch.float64)).col.clone()
    col[0] += 1e-2
    b = torch.tensor(rng.standard_normal(512), device="cuda")
    xs = levinson(col, b)
    res = torch.linalg.norm(ToeplitzOperator(col) @ xs - b) / torch.linalg.norm(b)
    assert xs.is_cuda and float(res) <= 1e-10


@needs_gpu
def test_kronecker_on_cuda():
    from cfjax_torch.derivative import SeparableKernel
    from cfjax_torch.gp import log_marginal_likelihood
    from cfjax_torch.operators import KroneckerOperator
    from cfjax_torch.utils.grids import LazyGrid, UniformGrid

    rng = np.random.default_rng(14)
    k = tk.separable("^", tk.EQ(), d=3)
    grids = [LazyGrid(tuple(UniformGrid(0.0, 1.0 / 32, 32) for _ in range(3)), device="cuda",
                      dtype=dt) for dt in (torch.float32, torch.float64)]
    K, K64 = gramian(k, grids[0]), gramian(k, grids[1])
    assert isinstance(K, KroneckerOperator) and K.factors[0].col.is_cuda
    a = torch.tensor(rng.standard_normal(32 ** 3), dtype=torch.float32, device="cuda")
    assert _rel(K @ a, K64 @ a.double()) <= 1e-5
    y = torch.sin(grids[1].points().sum(1))
    lml = log_marginal_likelihood(k, grids[0], y.float(), noise=1e-2)
    lml64 = log_marginal_likelihood(k, grids[1], y, noise=1e-2)
    assert abs(float(lml) - float(lml64)) <= 1e-4 * abs(float(lml64))
    B = np.array([[2.0, 0.3, 0.0], [0.3, 1.0, 0.2], [0.0, 0.2, 1.5]])
    x = torch.tensor(rng.standard_normal((3000, 3)), dtype=torch.float32, device="cuda")
    v = torch.tensor(rng.standard_normal(9000), dtype=torch.float32, device="cuda")
    G = gramian(SeparableKernel(tk.EQ(), B), x)
    assert isinstance(G, KroneckerOperator)
    assert _rel(G @ v, gramian(SeparableKernel(tk.EQ(), B), x.double()) @ v.double()) <= 1e-5
