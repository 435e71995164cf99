"""The port's CUDA kernels on the card, and its independence from jax.

The tests marked `needs_gpu` compare K1, K2, K3 and K4 with their plain
torch versions on a CUDA device; they skip where there is none (the skip is
decided when the test runs, not when the module is imported). The two
import checks run everywhere: the port package never imports jax."""

import dataclasses
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


# the port's scripts at the repo root, beside its package
PORT_SCRIPTS = ("bench_torch.py", "chip_smoke.py", "kernel_times.py", "bh_chunks.py")


def test_port_source_has_no_jax_import():
    """No module of the port and none of its scripts imports jax or cfjax
    (cfjax_torch, the port itself, is not cfjax)."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|cfjax(?!_torch))\b", re.MULTILINE)
    files = list(PACKAGE.rglob("*.py")) + [PACKAGE.parent / name for name in PORT_SCRIPTS]
    assert all(f.exists() for f in files)
    offenders = [str(p) for p in files if pattern.search(p.read_text())]
    assert offenders == []
    assert pattern.search("import cfjax.kernels as jk\n") and pattern.search("from jax import x")
    assert pattern.search("  from cfjax import gp\n")
    assert not pattern.search("import cfjax_torch\nfrom cfjax_torch.ops import build\n")


def test_port_import_loads_no_jax():
    code = ("import sys, cfjax_torch, cfjax_torch.gp, cfjax_torch.operators, cfjax_torch.ops,"
            " cfjax_torch.derivative, cfjax_torch.utils.linalg, cfjax_torch.barneshut,"
            " cfjax_torch.operators.sparse_op, cfjax_torch.operators.tile_ell,"
            " cfjax_torch.gp.hmc, cfjax_torch.utils.besselk, cfjax_torch.operators.woodbury,"
            " cfjax_torch.parallel, cfjax_torch.parallel.dryrun, cfjax_torch.utils.timing,"
            " cfjax_torch.utils.roofline, cfjax_torch.examples.northstar_demo,"
            " cfjax_torch.benchmarks.run_baseline, cfjax_torch.benchmarks.headline,"
            " cfjax_torch.benchmarks.weak_scaling;"
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


# every K1 family (Exp is MaternP's p = 0), under lengthscales and a
# constant, and one interpreted spec (SumScaled)
K1_KERNELS = {
    "MaternP2": tk.MaternP(2), "Exp": tk.Exp(), "SumScaled": 2.0 * tk.EQ() + 0.5 * tk.MaternP(1),
    "EQ": tk.EQ(), "MaternP0": tk.MaternP(0), "MaternP1": tk.MaternP(1),
    "MaternP3": tk.MaternP(3), "RQ": tk.RQ(1.5), "Cauchy": tk.Cauchy(),
    "IMQ": tk.InverseMultiQuadratic(0.7),
    "LengthscaleScaledMaternP2": 3.0 * tk.Lengthscale(tk.MaternP(2), 0.5),
    "LengthscaleEQ": tk.Lengthscale(tk.Lengthscale(tk.EQ(), 2.0), 0.7)}


@needs_gpu
@pytest.mark.parametrize("d", [1, 3, 5, 16])
@pytest.mark.parametrize("name", list(K1_KERNELS))
def test_direct_kernel_matches_plain(d, name):
    k = K1_KERNELS[name]
    assert (to_spec(k)[0].family == 0) == (name == "SumScaled")
    x, y, a = _cuda_data(1003, 701, d)
    before = mvm.LAUNCHES["direct"]
    out = mvm.gramian_matvec_direct(k, x, y, a)
    torch.cuda.synchronize()
    assert mvm.LAUNCHES["direct"] == before + 1
    ref = mvm.gramian_matvec_direct_plain(k, x.double(), y.double(), a.double())
    assert _rel(out, ref) <= 1e-5
    # the columns are split over blocks and added in a fixed order
    assert torch.equal(out, mvm.gramian_matvec_direct(k, x, y, a))


@needs_gpu
@pytest.mark.parametrize("n,m", [(1, 1), (129, 513), (5000, 3)])
def test_direct_family_and_interpreter_agree(n, m):
    """One spec through its family instance and through the interpreted
    one, at ragged shapes. IMQ with c = 0 at a point x = 0 is finite
    against every real column, but infinite against the zero-filled
    columns past m in a ragged tile, which the kernel must drop."""
    x, y, a = _cuda_data(n, m, 3)
    spec = to_spec(tk.MaternP(2))[0]
    interp = dataclasses.replace(spec, family=0)
    ref = mvm.gramian_matvec_direct_plain(tk.MaternP(2), x.double(), y.double(), a.double())
    for sp in (spec, interp):
        assert _rel(mvm.gramian_matvec_direct(tk.MaternP(2), x, y, a, spec=sp), ref) <= 1e-5
    k0 = tk.InverseMultiQuadratic(0.0)
    x[0] = 0.0
    out = mvm.gramian_matvec_direct(k0, x, y, a)
    assert torch.isfinite(out).all()
    assert _rel(out, mvm.gramian_matvec_direct_plain(k0, x.double(), y.double(),
                                                     a.double())) <= 1e-5


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


def _slab_operator(B, K, nt, dtype, seed=0):
    """The synthetic group as an operator (rows in slab order), its vector,
    and the float64 slab product as the reference."""
    a2, off, val = _slab_data(B, K, nt, dtype, seed)
    S = TileEllOperator([(0, B * 128, off, val)], torch.arange(B * 128, device="cuda"),
                        B * 128, nt * 128, int(torch.count_nonzero(val)))
    ref = tile_ell_mvm.slab_matvec_plain(a2.double(), off, val.double()).reshape(-1)
    return S, a2.reshape(-1), ref


@needs_gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("B,K,nt", [(8, 1, 1), (8, 2, 2), (136, 8, 128), (8, 32, 256),
                                    (16, 128, 2), (136, 1, 256), (24, 4, 1)])
def test_tile_ell_kernel_matches_plain(B, K, nt, dtype):
    """K4 over the row slices of synthetic TileELL groups against the
    float64 slab product; every warps-per-slice count gives the same."""
    S, a, ref = _slab_operator(B, K, nt, dtype)
    before = mvm.LAUNCHES["tile_ell"]
    out = tile_ell_mvm.rows_matvec(S.rows, a)
    torch.cuda.synchronize()
    assert mvm.LAUNCHES["tile_ell"] == before + 1
    assert out.dtype == dtype and tuple(out.shape) == (B * 128,)
    bound = 1e-5 if dtype == torch.float32 else 1e-12
    assert _rel(out, ref) <= bound
    # no atomics: a second launch repeats bit for bit
    assert torch.equal(out, tile_ell_mvm.rows_matvec(S.rows, a))
    for warps in (1, 2, 8):
        assert _rel(tile_ell_mvm.rows_matvec(S.rows, a, warps=warps), ref) <= bound
    assert _rel(tile_ell_mvm.rows_matvec_plain(S.rows, a), ref) <= bound


@needs_gpu
def test_tile_ell_kernel_refuses_wrong_inputs():
    S, a, _ = _slab_operator(8, 2, 3, torch.float32)
    rs = S.rows
    with pytest.raises(TypeError):
        tile_ell_mvm.rows_matvec(rs._replace(val=rs.val.half()), a.half())
    with pytest.raises(TypeError):
        tile_ell_mvm.rows_matvec(rs, a.double())
    with pytest.raises(TypeError):
        tile_ell_mvm.rows_matvec(rs._replace(col=rs.col.long()), a)
    with pytest.raises(ValueError, match="one CUDA device"):
        tile_ell_mvm.rows_matvec(rs._replace(col=rs.col.cpu()), a)
    with pytest.raises(ValueError, match="shapes"):
        tile_ell_mvm.rows_matvec(rs._replace(col=rs.col[:-1]), a)
    strided = lambda t: torch.stack([t, t], dim=-1)[..., 0]   # same shape, not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        tile_ell_mvm.rows_matvec(rs._replace(col=strided(rs.col), val=strided(rs.val)), a)
    with pytest.raises(ValueError, match="warps"):
        tile_ell_mvm.rows_matvec(rs, a, warps=16)
    # a vector shorter or longer than the operator's m: the kernel would
    # gather past its end, so it is refused before the launch
    before = mvm.LAUNCHES["tile_ell"]
    for wrong in (a[:-1].contiguous(), torch.cat([a, a[:5]])):
        with pytest.raises(ValueError, match="operator takes"):
            tile_ell_mvm.rows_matvec(rs, wrong)
        with pytest.raises(ValueError, match="operator takes"):
            S @ wrong
    assert mvm.LAUNCHES["tile_ell"] == before
    with pytest.raises(RuntimeError, match="forward-only"):
        tile_ell_mvm.rows_matvec(rs, a.clone().requires_grad_(True))


@needs_gpu
@pytest.mark.parametrize("method", ["scan", "tree"])
def test_sparse_gramian_on_cuda_launches_k4(method):
    """The sparsified Gramian of CUDA points is a TileELL operator whose
    MVM launches K4 once (a matrix right-hand side once per column),
    agrees with the port's own build on the CPU and, in float64, with the
    slab product to 1e-12, and solves through MINRES."""
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
    assert mvm.LAUNCHES["tile_ell"] == before + 1
    assert _rel(out, (S_cpu @ a.cpu()).double().cuda()) <= 1e-5
    out2 = S @ torch.stack([a, 2 * a], dim=1)
    assert mvm.LAUNCHES["tile_ell"] == before + 3
    assert torch.equal(out2[:, 0], out)
    assert int(S.rows.ptr[-1]) <= 1.15 * S.nnz
    S64, _ = sparse_gramian(k, x.double(), tol=1e-6, method=method)
    a64 = a.double()
    a2 = torch.nn.functional.pad(a64, (0, S64.nt * 128 - 20000)).reshape(S64.nt, 128)
    slabs = torch.cat([tile_ell_mvm.slab_matvec_plain(a2, off[:(r1 - r0) // 128],
                                                      val[:(r1 - r0) // 128]).reshape(-1)
                       for r0, r1, off, val in S64.groups])
    ref = torch.zeros(S64.perm.shape[0] + 1, dtype=torch.float64, device="cuda")
    ref[S64.perm] = slabs[:S64.perm.shape[0]]
    assert _rel(S64 @ a64, ref[:20000]) <= 1e-12
    op = S.add_diagonal(1e-1)
    b = torch.sin(x[:, 0])
    before = mvm.LAUNCHES["tile_ell"]
    alpha, (it, _) = solve_with_info(op, b, tol=1e-5, maxiter=1000)
    assert 0 < it < 1000 and mvm.LAUNCHES["tile_ell"] - before >= it
    res = torch.linalg.norm((op @ alpha).double() - b.double()) / torch.linalg.norm(b.double())
    assert float(res) <= 1e-4


@needs_gpu
def test_input_without_a_device_runs_on_the_card():
    """numpy points, observations and vectors go to the configured device,
    the card: the GP path runs K1 there."""
    from cfjax_torch.gp import gp_condition

    from cfjax_torch import config

    assert config.DEFAULT.device == config.Config.device == "cuda"
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3000, 3)).astype(np.float32)
    y = np.sin(x[:, 0])
    G = gramian(tk.MaternP(2), x)
    before = mvm.LAUNCHES["direct"]
    out = G @ rng.standard_normal(3000).astype(np.float32)
    assert out.is_cuda and mvm.LAUNCHES["direct"] == before + 1
    post = gp_condition(tk.MaternP(2), x, y, noise=1e-2)
    assert post.alpha.is_cuda and post.mean(x[:5]).is_cuda


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


# K2 and K3 at each matmul tier, relative L2: (against the plain version at
# the same tier on the card, tf32 roundings emulated; against float64), the
# limits of chip_smoke.py, 2-6x above the largest reading on the H100. One
# tf32 pass ("default") rounds each input to 11 bits; three ("high",
# "highest") carry about fp32's error. K3's plain version forms s exactly
# at d <= 16, where the kernel's one pass rounds the expansion.
TIER_BOUND = {"K2": ({"highest": 5e-6, "high": 5e-6, "default": 5e-6},
                     {"highest": 5e-6, "high": 5e-6, "default": 1e-3}),
              "K3": ({"highest": 3e-5, "high": 3e-5, "default": 5e-3},
                     {"highest": 3e-5, "high": 3e-5, "default": 1e-2})}


def _near_data(n, m, d, seed=0):
    """Points scaled by 1/sqrt(d); y holds 16 rows of x (coincident) and 16
    rows of x moved by 1e-3 (near-coincident)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)) / np.sqrt(d)
    y = rng.standard_normal((m, d)) / np.sqrt(d)
    y[:16] = x[:16]
    y[16:32] = x[:16] + 1e-3 * rng.standard_normal((16, d)) / np.sqrt(d)
    f = lambda v: torch.tensor(v, dtype=torch.float32, device="cuda")
    return f(x), f(y), f(rng.standard_normal((m, d))), f(rng.standard_normal(m))


@needs_gpu
@pytest.mark.parametrize("prec", ["highest", "high", "default"])
@pytest.mark.parametrize("k,mode", [(tk.EQ(), "iso"), (tk.MaternP(2), "iso"),
                                    (tk.Lengthscale(tk.RQ(1.5), 0.8), "iso"),
                                    (2.0 * tk.EQ() + 0.5 * tk.MaternP(1), "iso"),
                                    (tk.Dot() ** 2, "dot")],
                         ids=["EQ", "MaternP2", "LengthscaleRQ", "SumScaled", "Dot2"])
def test_expand_kernel_at_each_tier(k, mode, prec):
    x, y, _, a = _near_data(1003, 701, 64)
    before = mvm.LAUNCHES["expand"]
    out = mvm.gramian_matvec_expand(k, x, y, a, mode, precision=prec)
    torch.cuda.synchronize()
    assert mvm.LAUNCHES["expand"] == before + 1
    same = mvm.gramian_matvec_expand_plain(k, x, y, a, mode, precision=prec)
    ref = mvm.gramian_matvec_expand_plain(k, x.double(), y.double(), a.double(), mode)
    assert _rel(out, same.double()) <= TIER_BOUND["K2"][0][prec]
    assert _rel(out, ref) <= TIER_BOUND["K2"][1][prec]
    assert torch.equal(out, mvm.gramian_matvec_expand(k, x, y, a, mode, precision=prec))


@needs_gpu
@pytest.mark.parametrize("prec", ["highest", "high", "default"])
@pytest.mark.parametrize("d", [3, 16, 257])
@pytest.mark.parametrize("k,mode", [(tk.EQ(), "iso"), (tk.MaternP(2), "iso"),
                                    (2.0 * tk.EQ() + 0.5 * tk.MaternP(2), "iso"),
                                    (tk.ExponentialDot(), "dot")],
                         ids=["EQ", "MaternP2", "SumScaled", "ExponentialDot"])
def test_grad_kernel_at_each_tier(k, mode, d, prec):
    """K3 at each tier on coincident and near-coincident points (the
    kernel's exact path) against the plain version at the tier and
    float64; the result repeats bit for bit."""
    x, y, A, _ = _near_data(1003, 601, d)
    out = grad_mvm.grad_matvec(k, x, y, A, mode, precision=prec)
    same = grad_mvm.grad_matvec_plain(k, x, y, A, mode, precision=prec)
    ref = grad_mvm.grad_matvec_plain(k, x.double(), y.double(), A.double(), mode)
    assert torch.isfinite(out).all()
    assert _rel(out, same.double()) <= TIER_BOUND["K3"][0][prec]
    assert _rel(out, ref) <= TIER_BOUND["K3"][1][prec]
    assert torch.equal(out, grad_mvm.grad_matvec(k, x, y, A, mode, precision=prec))


@needs_gpu
@pytest.mark.parametrize("prec", ["high", "default"])
def test_explain_names_k2_and_k3_at_tf32_tiers(prec):
    import cfjax_torch

    x, _, _ = _cuda_data(300, 1, 64, scale=64 ** -0.5)
    cfjax_torch.set_config(matmul_precision=prec)
    try:
        how2 = explain(tk.Lengthscale(tk.EQ(), 4.0), x)
        how3 = explain(GradientKernel(tk.EQ()), x)
        G = gramian(GradientKernel(tk.EQ()), x)
        before = mvm.LAUNCHES["grad"]
        G @ torch.ones(G.shape[1], device="cuda")
        launched = mvm.LAUNCHES["grad"] - before
    finally:
        cfjax_torch.set_config(matmul_precision="highest")
    assert "cuda kernel K2" in how2 and f"matmul_precision {prec!r}" in how2
    assert "cuda kernel K3" in how3 and launched == 1


@needs_gpu
def test_float32_solve_with_float64_observations_launches_k1():
    """gp_condition with float32 points and numpy's float64 y, plain CG
    (precondition="never", above a lowered max_cholesky_size): y takes the
    points' dtype, so every CG iteration runs K1."""
    import cfjax_torch
    from cfjax_torch.gp import gp_condition

    rng = np.random.default_rng(3)
    xs = rng.standard_normal((1000, 3))
    x = torch.tensor(xs, dtype=torch.float32, device="cuda")
    y = np.sin(xs[:, 0]) + 0.01 * rng.standard_normal(1000)
    cfjax_torch.set_config(max_cholesky_size=256)
    try:
        before = mvm.LAUNCHES["direct"]
        post = gp_condition(tk.MaternP(2), x, y, noise=1e-2, precondition="never", tol=1e-5,
                            maxiter=1000)
        launches = mvm.LAUNCHES["direct"] - before
    finally:
        cfjax_torch.set_config(max_cholesky_size=cfjax_torch.config.Config.max_cholesky_size)
    assert post.alpha.dtype == torch.float32
    assert launches >= post.solve_info[0] > 0


@needs_gpu
@pytest.mark.parametrize("d", [1, 3, 5, 16])
@pytest.mark.parametrize("name", list(K1_KERNELS))
def test_matmat_kernel_matches_plain(d, name):
    """The many-column K1 against its float64 plain version at p = 1, 2, 7,
    16, 17 and 40 (one chunk, or more), ragged n and m, 16 coincident
    points; one launch a call (one a column for the interpreted spec)."""
    k = K1_KERNELS[name]
    rng = np.random.default_rng(d)
    xs, ys = rng.standard_normal((1003, d)), rng.standard_normal((701, d))
    ys[:16] = xs[:16]
    x, y = (torch.tensor(v, dtype=torch.float32, device="cuda") for v in (xs, ys))
    for p in (1, 2, 7, 16, 17, 40):
        A = torch.tensor(rng.standard_normal((701, p)), dtype=torch.float32, device="cuda")
        before = mvm.LAUNCHES["direct_cols"]
        out = mvm.gramian_matmat_direct(k, x, y, A)
        torch.cuda.synchronize()
        assert mvm.LAUNCHES["direct_cols"] == before + (p if name == "SumScaled" else 1)
        ref = mvm.gramian_matmat_direct_plain(k, x.double(), y.double(), A.double())
        assert out.shape == (1003, p) and _rel(out, ref) <= 1e-5
        assert torch.equal(out, mvm.gramian_matmat_direct(k, x, y, A))


# the many-column K1 at each tier: every K1 kernel above and two real-nu
# Materns (the tabulated family; their float64 reference is the kernels'
# method, `_matern_reference`). Against float64, relative L2: 1e-5 at three
# tf32 passes; one pass rounds f and A to tf32 (2^-12 relative each), so a
# row sum without cancellation misses by about 2^-11.5 = 3.5e-4: "default"
# is held to 2e-3. Against the plain version at the tier (the same tf32
# roundings, emulated), 1e-4 at one pass: f differs from the plain profile
# in its last bits, which moves a few roundings.
K1C_KERNELS = dict(K1_KERNELS, Matern2_3=tk.Lengthscale(tk.Matern(2.3), 0.9),
                   Matern0_5=tk.Matern(0.5))
K1C_BOUND = {"highest": 1e-5, "high": 1e-5, "default": 2e-3}


@needs_gpu
@pytest.mark.parametrize("prec", ["highest", "high", "default"])
@pytest.mark.parametrize("d", [1, 3, 5, 16])
@pytest.mark.parametrize("name", list(K1C_KERNELS))
def test_matmat_kernel_at_each_tier(name, d, prec):
    """The tensor-core many-column K1 against its float64 plain version at
    p = 1, 2, 7, 16, 17 and 40, ragged n and m, 16 coincident points, at
    each tier (K1C_BOUND); equal from run to run; one launch a call of a
    family instance ("matern" for a real-nu Matern). At three passes the
    one-pass product misses float64 by more than the three-pass limit."""
    k = K1C_KERNELS[name]
    kr = tk.Lengthscale(_matern_reference(2.3), 0.9) if name == "Matern2_3" else \
        _matern_reference(0.5) if name == "Matern0_5" else k
    spec = to_spec(k)[0]
    key = "matern" if spec.family == mvm.FAMILY_MATERN_NU else "direct_cols"
    rng = np.random.default_rng(10 + d)
    xs, ys = rng.standard_normal((1003, d)), rng.standard_normal((701, d))
    ys[:16] = xs[:16]
    x, y = (torch.tensor(v, dtype=torch.float32, device="cuda") for v in (xs, ys))
    for p in (1, 2, 7, 16, 17, 40):
        A = torch.tensor(rng.standard_normal((701, p)), dtype=torch.float32, device="cuda")
        before = mvm.LAUNCHES[key]
        out = mvm.gramian_matmat_direct(k, x, y, A, precision=prec)
        torch.cuda.synchronize()
        assert mvm.LAUNCHES[key] == before + (p if name == "SumScaled" else 1)
        ref = mvm.gramian_matmat_direct_plain(kr, x.double(), y.double(), A.double())
        assert out.shape == (1003, p) and _rel(out, ref) <= K1C_BOUND[prec]
        assert torch.equal(out, mvm.gramian_matmat_direct(k, x, y, A, precision=prec))
        if spec.family and prec == "default":
            same = mvm.gramian_matmat_direct_plain(kr, x, y, A, precision=prec)
            assert _rel(out, same.double()) <= 1e-4
        if spec.family and prec == "highest" and p >= 16:
            one = mvm.gramian_matmat_direct(k, x, y, A, precision="default")
            assert _rel(one, ref) > K1C_BOUND["highest"]


@needs_gpu
@pytest.mark.parametrize("nu", [0.3, 0.5, 1.3, 2.3, 2.5, 3.7, 10.2, 25.0])
def test_matern_family_matches_reference(nu):
    """K1's tabulated real-nu Matern family returns the profile itself for
    x = r (N, 1), y = 0, a = 1: 20000 log-spaced r in [1e-6, 80] against
    the float64 reference (`matern_nu_reference`) at every value above
    1e-30, relative 1e-5 (chip_smoke's MATERN_BOUND); the many-column
    family on A of ones, every column the same profile."""
    from cfjax_torch.utils.besselk import matern_nu_reference

    k = tk.Matern(nu)
    spec = to_spec(k)[0]
    assert spec.family == mvm.FAMILY_MATERN_NU
    r = torch.logspace(-6, np.log10(80.0), 20000, dtype=torch.float64, device="cuda")
    x = r.float()[:, None].contiguous()
    y, a = torch.zeros((1, 1), device="cuda"), torch.ones(1, device="cuda")
    ref = matern_nu_reference(nu, x.double()[:, 0] ** 2)[0]
    live = ref > 1e-30
    out = mvm.gramian_matvec_direct(k, x, y, a).double()
    cols = mvm.gramian_matmat_direct(k, x, y, torch.ones((1, 3), device="cuda")).double()
    for o in (out, cols[:, 0], cols[:, 2]):
        assert bool(torch.isfinite(o).all())
        assert float(((o - ref).abs() / ref)[live].max()) <= 1e-5


@needs_gpu
def test_gramians_as_built_capture_in_a_cuda_graph():
    """Kernels built without a device (their hyperparameters on the host):
    a Gramian formed on CUDA points holds them on the card, so its MVMs
    copy nothing from the host and replay from a CUDA graph. The
    composite gradient MVM GradientKernel(MaternP(2) + Line(1)^2 +
    NN(0.1)) (plain torch, "pair" mode), K1 (MaternP(2)) and the
    many-column K1 on the real-nu Matern family (its table copied when
    the Gramian is formed)."""
    from cfjax_torch.kernels.parameters import leaves

    rng = np.random.default_rng(7)
    f32 = lambda *shape: torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                                      device="cuda")
    cases = [(GradientKernel(tk.MaternP(2) + tk.Line(1.0) ** 2 + tk.NN(0.1)), f32(64, 8),
              f32(64 * 8)),
             (tk.MaternP(2), f32(3000, 3), f32(3000)),
             (tk.Lengthscale(tk.Matern(2.3), 0.9), f32(3000, 3), f32(3000, 16))]
    for k, x, v in cases:
        G = gramian(k, x)
        assert all(l.is_cuda and l.dtype == torch.float32 for l in leaves(G.k))
        want = G @ v
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            G @ v   # warm-up off the capture
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = G @ v
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@needs_gpu
def test_kernels_run_under_no_grad_with_leaves_that_require_grad():
    """A kernel whose leaves require grad (an optimizer's iterate) runs K1 and
    the many-column K1 under torch.no_grad(); with grad enabled the same
    Gramian takes the plain path, which autograd records."""
    x, _, a = _cuda_data(500, 500, 3)
    k = tk.Lengthscale(tk.MaternP(2), 0.7)
    k.l.requires_grad_(True)
    G = gramian(k, x)
    V = torch.randn((500, 16), device="cuda")
    with torch.no_grad():
        assert "cuda kernel K1" in explain(k, x)
        before = dict(mvm.LAUNCHES)
        b, B = G @ a, G @ V
        assert mvm.LAUNCHES["direct"] == before["direct"] + 1
        assert mvm.LAUNCHES["direct_cols"] == before["direct_cols"] + 1
    assert "autograd records" in explain(k, x)
    before = dict(mvm.LAUNCHES)
    b2 = G @ a
    assert mvm.LAUNCHES == before and b2.grad_fn is not None
    assert _rel(b, b2.detach().double()) <= 1e-5


@needs_gpu
def test_slq_logml_on_card_matches_float64_plain():
    """The slq logML on the card: float32 through K1 and the many-column K1
    against float64 through the plain path, on the same probes (a
    generator seeded with 0): value and gradient."""
    from cfjax_torch.gp import log_marginal_likelihood

    rng = np.random.default_rng(4)
    xs = rng.standard_normal((2000, 3))
    ys = np.sin(xs[:, 0]) + 0.01 * rng.standard_normal(2000)

    def run(dtype):
        l = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
        x = torch.tensor(xs, dtype=dtype, device="cuda")
        v = log_marginal_likelihood(tk.Lengthscale(tk.MaternP(2), l), x,
                                    torch.tensor(ys, dtype=dtype, device="cuda"), noise=1e-2,
                                    method="slq", solve_maxiter=2000)
        return float(v.detach()), float(torch.autograd.grad(v, l)[0])

    before = dict(mvm.LAUNCHES)
    v32, g32 = run(torch.float32)
    assert mvm.LAUNCHES["direct_cols"] > before["direct_cols"] + 48
    assert mvm.LAUNCHES["direct"] > before["direct"]
    v64, g64 = run(torch.float64)
    assert abs(v32 - v64) <= 1e-3 * abs(v64)
    assert abs(g32 - g64) <= 1e-2 * abs(g64)


@needs_gpu
@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("d,same", [(2, True), (3, True), (5, True), (2, False)],
                         ids=["fused-d2", "fused-d3", "generic-d5", "generic-xy"])
def test_barneshut_on_card_matches_cpu_float64(d, same, order):
    """The Barnes-Hut build and MVM at n = 4096 in float64 on the card and
    on the CPU: identical plans (the card's device tree and its float32
    mirrors are the CPU's), MVMs within 1e-10 relative (the same terms,
    summed by other kernels)."""
    from cfjax_torch.barneshut import BarnesHutFactorization

    rng = np.random.default_rng(d + 10 * same)
    x = rng.standard_normal((4096, d))
    y = None if same else rng.standard_normal((3000, d))
    w = rng.standard_normal(4096 if same else 3000)
    built = {}
    for dev in ("cpu", "cuda"):
        t = lambda a: None if a is None else torch.tensor(a, device=dev)
        F = BarnesHutFactorization(tk.EQ(), t(x), t(y), theta=0.5, group_size=32, order=order)
        built[dev] = (F, F @ t(w), F.matvec_linear(t(w)))
    (Fc, bc, lc), (Fg, bg, lg) = built["cpu"], built["cuda"]
    assert bg.device.type == "cuda" and bg.dtype == torch.float64
    for pc, pg in zip(Fc.plans, Fg.plans, strict=True):
        assert pc[0] == pg[0] and np.array_equal(pc[2], pg[2])
        assert all(np.array_equal(a, b) for a, b in zip(pc[1], pg[1], strict=True))
    assert _rel(bg.cpu(), bc) <= 1e-10 and _rel(lg.cpu(), lc) <= 1e-10


@needs_gpu
def test_refined_solve_with_k1_on_card():
    """refined_solve on the card: K1 + sigma^2 I in float32 inside, the
    float64 Gramian (plain path) for the residuals; cfjax's
    test_refined_solve_beats_f32_cg system at n = 1024, sigma^2 = 1e-3
    reaches a float64 relres of 1e-9."""
    from cfjax_torch.operators import nystrom_preconditioner, refined_solve

    rng = np.random.default_rng(42)
    n, s2 = 1024, 1e-3
    x = torch.tensor(rng.uniform(-5, 5, (n, 2)), device="cuda")
    k = tk.Lengthscale(tk.EQ(), 1.5)
    G32, G64 = gramian(k, x.float()), gramian(k, x)
    a = torch.tensor(rng.standard_normal(n), device="cuda")
    b = G64 @ a + s2 * a
    M = nystrom_preconditioner(k, x.float(), s2, rank=256)
    before = mvm.LAUNCHES["direct"]
    xr, (outer, res) = refined_solve(lambda v: G64 @ v + s2 * v, lambda v: G32 @ v + s2 * v, b,
                                     M=M, tol=1e-9, inner_tol=1e-3, inner_maxiter=100,
                                     refinements=8)
    assert mvm.LAUNCHES["direct"] > before + outer
    bn = torch.linalg.norm(b)
    assert float(res / bn) < 1e-9
    true = torch.linalg.norm(b - mvm.gramian_matvec_direct_plain(k, x, x, xr) - s2 * xr) / bn
    assert abs(float(true) - float(res / bn)) <= 1e-3 * float(true)


def _matern_reference(nu):
    """Matern(nu) whose profile is the kernels' method in float64
    (`matern_nu_reference`), for the references of the Matern kernels:
    cfjax's quadrature loses accuracy at small s."""
    from cfjax_torch.utils.besselk import matern_nu_reference

    class Reference(tk.Matern):
        def profile(self, s):
            return matern_nu_reference(float(self.nu), s.double())[0].to(s.dtype)

    return Reference(nu)


@needs_gpu
@pytest.mark.parametrize("nu", [0.5, 1.3, 2.3, 3.7, 25.0])
def test_matern_kernels_match_reference(nu):
    """Real-nu Matern through K1 (d = 1, 3), K2 (d = 64) and K3 (d = 3, 16,
    nu > 1) against float64 references built from the kernels' method, with
    coincident and near-coincident points; explain() names the kernel."""
    from cfjax_torch.utils.besselk import matern_nu_reference

    k, kr = tk.Lengthscale(tk.Matern(nu), 0.9), tk.Lengthscale(_matern_reference(nu), 0.9)
    for d in (1, 3, 64):
        x, y, a = _cuda_data(700, 500, d, scale=1 / np.sqrt(d), seed=d)
        y[:16] = x[:16]
        y[16:32] = x[:16] + 1e-3 / np.sqrt(d)
        kern = mvm.gramian_matvec_direct if d <= 16 else mvm.gramian_matvec_expand
        ref = mvm.gramian_matvec_direct_plain(kr, x.double(), y.double(), a.double())
        assert _rel(kern(k, x, y, a), ref) <= (1e-5 if d <= 16 else 1e-4)
    x, _, _ = _cuda_data(300, 1, 3, seed=5)
    assert "cuda kernel K1" in explain(k, x)
    if nu <= 1:
        assert "nu <= 1" in explain(GradientKernel(tk.Matern(nu)), x)
        return
    for d in (3, 16):
        x, y, _ = _cuda_data(400, 300, d, scale=1 / np.sqrt(d), seed=10 + d)
        y[:16] = x[:16]
        y[16:32] = x[:16] + 1e-3 / np.sqrt(d)
        A = torch.randn((300, d), device="cuda", generator=torch.Generator("cuda").manual_seed(d))
        xd, yd, Ad = x.double(), y.double(), A.double()
        s = torch.cdist(xd, yd) ** 2 / 0.81
        _, f1, f2 = matern_nu_reference(nu, s)
        f1, f2 = f1 / 0.81, f2 / 0.81 ** 2
        r = xd[:, None, :] - yd[None, :, :]
        ref = -2 * f1 @ Ad - 4 * torch.einsum("ij,ijk->ik", f2 * torch.einsum("ijk,jk->ij", r, Ad), r)
        assert _rel(grad_mvm.grad_matvec(k, x, y, A), ref) <= 1e-4


@needs_gpu
def test_nuts_host_step_on_card():
    """One host-NUTS transition over the slq logML on the card (n = 2048 >
    a lowered max_cholesky_size): finite, the K1 kernels launched."""
    import cfjax_torch
    from cfjax_torch.gp import log_marginal_likelihood
    from cfjax_torch.gp.hmc import nuts_sample_host

    rng = np.random.default_rng(9)
    x = torch.tensor(rng.uniform(-3, 3, (2048, 2)), dtype=torch.float32, device="cuda")
    y = torch.sin(x[:, 0]) + 0.1 * torch.randn(2048, device="cuda")

    def logpost(th):
        k = tk.Lengthscale(tk.EQ(), torch.exp(th[0])) * torch.exp(th[1])
        v = log_marginal_likelihood(k, x, y, noise=0.01, probes=2, lanczos_iters=10,
                                    solve_tol=3e-2, solve_maxiter=15)
        return v.double().cpu() - 0.5 * torch.sum(th ** 2)

    shipped = cfjax_torch.config.DEFAULT.max_cholesky_size
    cfjax_torch.set_config(max_cholesky_size=1024)
    try:
        before = dict(mvm.LAUNCHES)
        s, a = nuts_sample_host(logpost, torch.zeros(2, dtype=torch.float64), 3,
                                num_samples=1, num_warmup=0, max_tree_depth=2, init_step=0.02)
    finally:
        cfjax_torch.set_config(max_cholesky_size=shipped)
    assert s.shape == (1, 2) and bool(torch.isfinite(s).all()) and 0.0 <= float(a) <= 1.0
    assert mvm.LAUNCHES["direct_cols"] > before["direct_cols"]
    assert mvm.LAUNCHES["direct"] > before["direct"]


@needs_gpu
def test_sharded_shards_run_k1_and_k3_at_world_one():
    """A one-rank NCCL group on the card: the local operators of
    ShardedGramian and ShardedGradientGramian take K1 and K3, launch once
    an MVM, and agree with the single-GPU operators."""
    import torch.distributed as dist
    from cfjax_torch.parallel import ShardedGradientGramian, ShardedGramian, default_mesh

    mesh = default_mesh()
    try:
        assert dist.get_backend() == "nccl"
        x, _, a = _cuda_data(1000, 1000, 3)
        G = ShardedGramian(tk.MaternP(2), x, mesh=mesh)
        assert G.kernel_reason is None and G.kernel == "direct"
        before = mvm.LAUNCHES["direct"]
        b = G @ a
        assert mvm.LAUNCHES["direct"] == before + 1
        assert torch.equal(b, gramian(tk.MaternP(2), x) @ a)
        xg, _, _ = _cuda_data(300, 300, 16, scale=0.5, seed=1)
        A = torch.randn(300 * 16, device="cuda")
        Gg = ShardedGradientGramian(tk.EQ(), xg, mesh=mesh)
        assert Gg.kernel_reason is None
        before = mvm.LAUNCHES["grad"]
        bg = Gg @ A
        assert mvm.LAUNCHES["grad"] == before + 1
        assert _rel(bg, gramian(GradientKernel(tk.EQ()), xg.double()) @ A.double()) <= 1e-5
    finally:
        dist.destroy_process_group()


@needs_gpu
def test_sharded_shards_run_k1_and_k3_on_four_ranks():
    """Four ranks sharing the card over gloo, a 2 x 2 mesh: every rank's
    dense and gradient shards take K1 and K3 (kernel_reason None) and
    launch them; the products agree with the single-GPU operators."""
    import torch_parallel_cases as cases
    from cfjax_torch.utils.testing import run_world

    out = run_world(cases.shard_kernels, 4, backend="gloo", device="cuda")
    for rank in out["ranks"]:
        assert rank["reasons"] == [None, None]
        assert rank["launches"]["direct"] == 2 and rank["launches"]["grad"] == 1
    assert max(out["errors"]) <= 1e-5


@needs_gpu
def test_timing_on_a_cuda_matvec():
    """graph_ms and time_chained on a CUDA matvec: positive device times,
    a slope of the order of one call's device time."""
    from cfjax_torch.utils.timing import graph_ms, time_chained

    A = torch.randn(4096, 4096, device="cuda")
    v = torch.randn(4096, device="cuda")
    dev = float(np.median(graph_ms(lambda: A @ v, 20, 5)))
    slope = time_chained(lambda w: A @ w, v, repeats=3, time_budget=30.0)
    assert dev > 0 and slope > 0
    assert slope < 100 * dev * 1e-3


@needs_gpu
def test_northstar_demo_on_the_card():
    """The demo's quick pipeline at n = 2^14 on the card: the Gramian takes
    K1 and the PCG launches it, and the exact mean's RMSE is below the
    noise."""
    from cfjax_torch.examples import northstar_demo as demo

    before = mvm.LAUNCHES["direct"]
    rmse, walls, parts = demo.main(1 << 14, quick=True, device="cuda")
    sol = parts["solve"]
    assert sol["G"].kernel_reason is None
    assert mvm.LAUNCHES["direct"] - before >= sol["iters"] + 1
    assert rmse < demo.NOISE and parts["mean"].is_cuda
    assert 0.5 <= parts["chain"]["astat"] <= 1.0 and all(t > 0 for t in walls.values())


@needs_gpu
def test_slq_logdet_without_a_device_draws_on_the_operators_card():
    """slq_logdet with a CUDA operator, no device and no parameters: the
    probes go to the configured device, the card, and the estimate is the
    logdet's."""
    from cfjax_torch.operators.slq import slq_logdet

    K = (2.0 * torch.eye(64, device="cuda")).double()
    est = slq_logdet(lambda params, V: K @ V, 64, 4, 8, 1e-6, 50, (), dtype=torch.float64)
    assert est.is_cuda and abs(float(est) - 64 * np.log(2.0)) <= 1e-10
    l = torch.tensor(1.0, dtype=torch.float64, device="cuda")
    est = slq_logdet(lambda params, V: params[0] * (K @ V), 64, 4, 8, 1e-6, 50, (l,),
                     dtype=torch.float64)
    assert est.is_cuda


@needs_gpu
def test_headline_row_check_on_the_card():
    """The headline (bench_torch.py) on the card at n = 4096: K1 launched,
    the row check within its bound, a device time from a CUDA graph."""
    from cfjax_torch import set_config
    from cfjax_torch.benchmarks import headline

    set_config(device="cuda")
    out = headline.measure(4096)
    assert headline.failures(out) == [] and out["k1_launches"] > 0
    assert out["row_check_rel_err"] <= headline.ROW_BOUND and out["device_ms"] > 0


@needs_gpu
def test_sweep_row_through_k2_holds_its_tier_error():
    """One row of the BASELINE table's EQ sweep on the card at a small n:
    K2 at d = 64 at each tier, valid, its float64 error within the tier's
    limit, K2 launched."""
    from cfjax_torch.benchmarks import run_baseline as rb

    rb.SIZES["card_small"] = dict(rb.SIZES["full"], sweep_n=2048, sweep_d=(3, 64, 256, 1024))
    try:
        rows = rb.run(["dense_sweep"], device="cuda", scale="card_small", echo=False,
                      rows=["northstar_dense_mvm_eq_n16384_d64",
                            "northstar_dense_mvm_eq_n16384_d64_bf16"])
    finally:
        del rb.SIZES["card_small"]
    assert [r["config"] for r in rows] == ["northstar_dense_mvm_eq_n16384_d64",
                                           "northstar_dense_mvm_eq_n16384_d64_tf32"]
    for r, tier in zip(rows, ("highest", "default")):
        assert r["valid"], r["why"]
        assert r["route"] == "K2" and r["rel_err_f64"] <= rb.TIER_BOUND["K2"][tier]



@needs_gpu
@pytest.mark.parametrize("tier", ["highest", "high", "default"])
def test_k2_matern_family_matches_plain(tier):
    """K2's tabulated real-nu Matern family (Lengthscale(Matern(1.3), 4) at
    d = 64, coincident rows included) at each tier, counted under
    "expand_matern": against its plain version on the reference's profile
    at the same tier (5e-6) and against float64 (phase 21b's limits)."""
    k, kr = tk.Lengthscale(tk.Matern(1.3), 4.0), tk.Lengthscale(_matern_reference(1.3), 4.0)
    x, y, a = _cuda_data(700, 500, 64, seed=3)
    y[:16] = x[:16]
    before = dict(mvm.LAUNCHES)
    out = mvm.gramian_matvec_expand(k, x, y, a, precision=tier)
    assert mvm.LAUNCHES["expand_matern"] == before["expand_matern"] + 1
    assert mvm.LAUNCHES["expand"] == before["expand"]
    plain = mvm.gramian_matvec_expand_plain(kr, x, y, a, precision=tier)
    ref = mvm.gramian_matvec_direct_plain(kr, x.double(), y.double(), a.double())
    assert _rel(out, plain.double()) <= 5e-6
    assert _rel(out, ref) <= {"highest": 5e-6, "high": 5e-6, "default": 1e-3}[tier]


@needs_gpu
@pytest.mark.parametrize("nu", [1.2, 1.5, 2.7, 7.2])
def test_k3_matern_family_matches_reference(nu):
    """K3's tabulated real-nu Matern jet family (d = 16, coincident and
    near-coincident pairs), counted under "grad_matern", against the
    float64 reference built from the kernels' method (3e-5, phase 21c's
    "highest" limit); the interpreted instance on the same inputs too."""
    from cfjax_torch.utils.besselk import matern_nu_reference

    k = tk.Matern(nu)
    x, y, _ = _cuda_data(400, 300, 16, scale=0.25, seed=7)
    y[:16] = x[:16]
    y[16:32] = x[:16] + 1e-3 / 4
    A = torch.randn((300, 16), device="cuda", generator=torch.Generator("cuda").manual_seed(7))
    xd, yd, Ad = x.double(), y.double(), A.double()
    # s in difference form: cdist's expansion leaves ~1e-16 at the coincident
    # pairs, where f' of nu near 1 moves like s^(nu - 1) (1e-3 at nu = 1.2)
    r = xd[:, None, :] - yd[None, :, :]
    _, f1, f2 = matern_nu_reference(nu, torch.sum(r * r, dim=-1))
    ref = -2 * f1 @ Ad - 4 * torch.einsum("ij,ijk->ik", f2 * torch.einsum("ijk,jk->ij", r, Ad), r)
    before = dict(mvm.LAUNCHES)
    out = grad_mvm.grad_matvec(k, x, y, A)
    assert mvm.LAUNCHES["grad_matern"] == before["grad_matern"] + 1
    assert mvm.LAUNCHES["grad"] == before["grad"]
    assert _rel(out, ref) <= 3e-5
    itp = dataclasses.replace(to_spec(k, derivative=True)[0], family=0)
    assert _rel(grad_mvm.grad_matvec(k, x, y, A, spec=itp), ref) <= 3e-5


@needs_gpu
def test_highest_tier_ignores_global_tf32():
    """matmul_p at "highest" stays full fp32 with TF32 allowed globally,
    where a plain product rounds to tf32; the caller's setting survives."""
    from cfjax_torch.ops import tiles

    g = torch.Generator("cuda").manual_seed(11)
    a, b = (torch.randn((512, 512), device="cuda", generator=g) for _ in range(2))
    exact = a.double() @ b.double()
    m = torch.backends.cuda.matmul
    saved = m.fp32_precision
    try:
        m.fp32_precision = "tf32"
        rounded = a @ b
        out = tiles.matmul_p(a, b, precision="highest")
        assert m.fp32_precision == "tf32"
    finally:
        m.fp32_precision = saved
    assert _rel(out, exact) <= 1e-6 < _rel(rounded, exact)


@needs_gpu
def test_config5_pcg_converges_on_cfjax_points():
    """BASELINE config 5's solve on cfjax's own points (n = 10^6, rank 2048,
    sigma^2 = 1e-2, tol 1e-4): the float64 build of the preconditioner
    converges within 55 PCG iterations (the float32 build stalled at 5.2e-3
    after 60 on an H100, PERF.md), the float64 residual on 4096 rows within
    2e-4."""
    from cfjax_torch.benchmarks.config5_probe import eq_matvec_f64
    from cfjax_torch.benchmarks.run_baseline import SIZES, barneshut_draws, check_rows
    from cfjax_torch.operators import cg, nystrom_preconditioner

    dr = barneshut_draws(SIZES["full"])
    x = torch.tensor(dr["x5"], dtype=torch.float32, device="cuda")
    y = torch.sin(x[:, 0]) + 0.1 * torch.tensor(dr["w3"], dtype=torch.float32, device="cuda")
    k = tk.Lengthscale(tk.EQ(), 1.0)
    G = gramian(k, x)
    M = nystrom_preconditioner(k, x, 1e-2, rank=2048)
    alpha, (it, res) = cg(lambda v: G._matvec(v) + 1e-2 * v, y, tol=1e-4, maxiter=60, M=M)
    assert it <= 55 and float(res) <= 1e-4 * float(torch.linalg.norm(y))
    rows = torch.as_tensor(check_rows(x.shape[0], 4096), device="cuda")
    yr = y[rows].double()
    r = yr - eq_matvec_f64(x[rows], x, alpha) - 1e-2 * alpha[rows].double()
    assert float(torch.linalg.norm(r) / torch.linalg.norm(yr)) <= 2e-4
