"""Parity of K3's plain torch version (`cfjax_torch.ops.grad_mvm`) with
cfjax on the CPU, and of the pieces around the CUDA kernel that the CPU
reaches.

`grad_matvec_plain` is held against the Pallas kernel it replaces,
`pallas_grad_matvec` in interpret mode at the shapes and tolerance of
tests/test_pallas.py (float32, rtol 3e-4, atol 3e-5), and against cfjax's
blocked `grad_matvec_iso` / `grad_matvec_dot` in float64 (rtol 1e-12:
the same closed form, summed in another order), with points of y
coincident with points of x so that s = 0 occurs exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfjax.kernels as jk
import cfjax_torch
import cfjax_torch.kernels as tk
from cfjax.derivative.gradient import grad_matvec_dot, grad_matvec_iso
from cfjax.ops.pallas_mvm import pallas_grad_matvec
from cfjax_torch.derivative import GradientKernel
from cfjax_torch.operators.dispatch import gramian as t_gramian
from cfjax_torch.ops import build
from cfjax_torch.ops import gramian_mvm as mvm
from cfjax_torch.ops.grad_mvm import grad_matvec, grad_matvec_plain

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """Input without a device goes to the CPU in this module's tests; the
    configured device is restored after them."""
    shipped = cfjax_torch.config.DEFAULT.device
    cfjax_torch.set_config(device="cpu")
    yield
    cfjax_torch.set_config(device=shipped)


@pytest.mark.parametrize("name,mode", [("EQ", "iso"), ("MaternP2", "iso"), ("Dot2", "dot")])
def test_plain_matches_pallas_interpret(name, mode, rng):
    kj = {"EQ": jk.EQ(), "MaternP2": jk.MaternP(2), "Dot2": jk.Dot() ** 2}[name]
    n, m, d = 200, 170, 5
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = rng.standard_normal((m, d)).astype(np.float32)
    A = rng.standard_normal((m, d)).astype(np.float32)
    ref = pallas_grad_matvec(kj, jnp.asarray(x), jnp.asarray(y), jnp.asarray(A), mode,
                             tm=128, tn=128, interpret=True)
    out = grad_matvec_plain(tk.from_reference(kj), torch.tensor(x), torch.tensor(y),
                            torch.tensor(A), mode)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=3e-4, atol=3e-5)


F64_KERNELS = {
    "EQ": (lambda: jk.EQ(), "iso"),
    "MaternP2": (lambda: jk.MaternP(2), "iso"),
    "MaternP3": (lambda: jk.MaternP(3), "iso"),
    "Lengthscale": (lambda: jk.Lengthscale(jk.MaternP(2), 0.5), "iso"),
    "SumScaled": (lambda: 2.0 * jk.EQ() + 0.5 * jk.MaternP(2), "iso"),
    "RQ": (lambda: jk.RQ(1.5), "iso"),
    "Dot2": (lambda: jk.Dot() ** 2, "dot"),
    "ExponentialDot": (lambda: jk.ExponentialDot(), "dot"),
}


@pytest.mark.parametrize("d", [1, 3, 17, 40])
@pytest.mark.parametrize("name", sorted(F64_KERNELS))
def test_plain_matches_reference_f64(name, d, rng):
    make, mode = F64_KERNELS[name]
    kj = make()
    x = rng.standard_normal((50, d)) / np.sqrt(d)
    y = rng.standard_normal((37, d)) / np.sqrt(d)
    y[:5] = x[:5]   # s = 0 exactly
    A = rng.standard_normal((37, d))
    fast = grad_matvec_iso if mode == "iso" else grad_matvec_dot
    ref = fast(kj, jnp.asarray(x), jnp.asarray(y), jnp.asarray(A), block=16)
    out = grad_matvec_plain(tk.from_reference(kj), torch.tensor(x), torch.tensor(y),
                            torch.tensor(A), mode, block=16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-13)


def test_wrapper_takes_plain_version_on_cpu(rng):
    x, y, A = (torch.tensor(rng.standard_normal(s)) for s in ((30, 4), (20, 4), (20, 4)))
    before = dict(mvm.LAUNCHES)
    k = tk.MaternP(2)
    np.testing.assert_array_equal(grad_matvec(k, x, y, A).numpy(),
                                  grad_matvec_plain(k, x, y, A).numpy())
    G = t_gramian(GradientKernel(k), x.float())
    G @ torch.ones(G.shape[1])
    assert mvm.LAUNCHES == before
    with pytest.raises(ValueError, match="iso and dot"):
        grad_matvec_plain(tk.Cosine(1.0), x, y, A, "slf")


def test_plain_row_blocks_and_empty_inputs(rng):
    k = tk.MaternP(2)
    x, y, A = (torch.tensor(rng.standard_normal(s)) for s in ((37, 3), (20, 3), (20, 3)))
    ref = grad_matvec_plain(k, x, y, A, block=256)
    for block in (1, 7, 36):
        np.testing.assert_allclose(grad_matvec_plain(k, x, y, A, block=block).numpy(),
                                   ref.numpy(), rtol=1e-13, atol=1e-14)
    assert tuple(grad_matvec_plain(k, x[:0], y, A).shape) == (0, 3)


@pytest.mark.parametrize("d", [1, 17])
def test_difference_and_expansion_forms_agree(d, rng):
    """The squared distance by difference form and by expansion (the two
    forms `sqdist_tile` chooses between by config) give the same MVM."""
    import cfjax_torch

    k = tk.MaternP(2)
    x = torch.tensor(rng.standard_normal((40, d)))
    y = torch.cat([x[:6], torch.tensor(rng.standard_normal((20, d)))])
    A = torch.tensor(rng.standard_normal((26, d)))
    ref = grad_matvec_plain(k, x, y, A)
    cfjax_torch.set_config(direct_sqdist_max_d=0 if d <= 16 else 64)
    try:
        other = grad_matvec_plain(k, x, y, A)
    finally:
        cfjax_torch.set_config(direct_sqdist_max_d=cfjax_torch.config.Config.direct_sqdist_max_d)
    np.testing.assert_allclose(other.numpy(), ref.numpy(), rtol=1e-10, atol=1e-12)


def test_library_digest_covers_every_source(tmp_path, monkeypatch):
    """A change to any file under csrc/ (a shared header included) names
    a new library, so a stale build is never loaded."""
    for f in ("a.cu", "b.cu", "shared.cuh"):
        (tmp_path / f).write_text(f"// {f}\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build.library_path("a")
    (tmp_path / "shared.cuh").write_text("// changed\n")
    assert build.library_path("a") != first
    assert build.library_path("a").name.startswith("liba_")
    assert set(build.LIBRARIES) == {"gramian_mvm", "expand_mvm", "grad_mvm", "tile_ell_mvm"}


def test_csrc_sources_declare_every_opcode():
    """The opcode numbers of the profile programs agree between Python and
    the shared CUDA header."""
    import re

    from cfjax_torch.kernels import profile_spec as ps

    header = (build.CSRC / "profile_spec.cuh").read_text()
    defined = {m.group(1): int(m.group(2))
               for m in re.finditer(r"#define OP_(\w+) (\d+)", header)}
    for name, value in defined.items():
        assert getattr(ps, name) == value
    assert len(defined) == 15
    for limit in ("MAX_OPS", "MAX_CONSTS", "MAX_STACK"):
        assert f"#define {limit} {getattr(ps, limit)}" in header


@pytest.mark.parametrize("prec", ["default", "high", "highest"])
@pytest.mark.parametrize("name", ["EQ", "MaternP2", "Dot2"])
def test_plain_matches_reference_at_each_tier(name, prec, rng):
    """K3's plain version at each matmul tier (its `precision`, or the
    configured one) against cfjax's blocked MVM under the same
    `matmul_precision`. On the CPU every tier is exact in both packages
    (float64), so they agree to rtol 1e-12; d = 20 takes the expansion."""
    import cfjax

    make, mode = F64_KERNELS[name]
    kj = make()
    d = 20
    x = rng.standard_normal((40, d)) / np.sqrt(d)
    y = rng.standard_normal((31, d)) / np.sqrt(d)
    y[:5] = x[:5]
    A = rng.standard_normal((31, d))
    fast = grad_matvec_iso if mode == "iso" else grad_matvec_dot
    cfjax.set_config(matmul_precision=prec)
    try:
        ref = fast(kj, jnp.asarray(x), jnp.asarray(y), jnp.asarray(A), block=16)
    finally:
        cfjax.set_config(matmul_precision=cfjax.config.Config.matmul_precision)
    kt = tk.from_reference(kj)
    xt, yt, At = torch.tensor(x), torch.tensor(y), torch.tensor(A)
    out = grad_matvec_plain(kt, xt, yt, At, mode, block=16, precision=prec)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-13)
    cfjax_torch.set_config(matmul_precision=prec)
    try:
        configured = grad_matvec(kt, xt, yt, At, mode)
    finally:
        cfjax_torch.set_config(matmul_precision=cfjax_torch.config.Config.matmul_precision)
    np.testing.assert_array_equal(configured.numpy(), out.numpy())


def test_near_threshold_matches_the_kernel_source():
    """The near-coincident threshold the wrapper documents is the kernel's."""
    import re

    from cfjax_torch.ops import grad_mvm

    src = (build.CSRC / "grad_mvm.cu").read_text()
    tau = re.search(r"constexpr float K3_TAU = ([0-9.]+)f / ([0-9.]+)f;", src)
    assert tau is not None
    assert float(tau.group(1)) / float(tau.group(2)) == grad_mvm.NEAR_TAU
