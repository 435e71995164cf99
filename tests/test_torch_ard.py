"""ARD kernels under an outputscale: GPyTorch's `ScaleKernel(MaternKernel(
nu=2.5, ard_num_dims=d))`, in the port `c * ARDKernel(MaternP(2), l)`.

The dispatcher folds the constant factors through the ARD (`ard_fold`): the
lazy Gramian is the isotropic `c * MaternP(2)` on the points divided by l,
so its products can take K1 (d <= 16) or K2 (larger d) on the card. Here on
the CPU, at d = 90 and d = 5: the product, the cross product, `gp_condition`'s
alpha (dense Cholesky and Nystrom PCG), the posterior mean and the dense
logML with its gradient in (l, c) against cfjax on the same inputs (cfjax
has no fold: its Gramian of c * ARD is the generic pairwise one), and
against a second witness, the plain float64 reference
(`tests/plain_ref/ard_matern.py`); the route of each spelling; the logML's
gradient through the fold against the unfolded generic path; the Nystrom
build on the fold, and an ARD around a dot-product kernel, whose build
takes the kernel the operator takes; the trace's `gramian.prescale` span
and `mvm.plain` counter. The test marked `needs_gpu` checks the kernel that
`explain` names on a card."""

import math

import numpy as np
import pytest
import torch

import cfjax_torch
import cfjax_torch.kernels as tk
import cfjax_torch.operators.preconditioner as precond
from cfjax_torch.gp import gp_condition
from cfjax_torch.gp.regression import log_marginal_likelihood
from cfjax_torch.kernels.transforms import ARDKernel
from cfjax_torch.operators.dispatch import LambdaKernel, ard_fold, explain, gramian
from cfjax_torch.operators.gramian import Gramian
from cfjax_torch.utils import trace
from plain_ref import ard_matern as ref

try:    # the reference package, in float64 on the CPU (tests/conftest.py)
    import jax
    import jax.numpy as jnp

    import cfjax
    import cfjax.kernels as jk
    from cfjax.gp import gp_condition as j_condition
    from cfjax.gp import log_marginal_likelihood as j_lml
    from cfjax.operators.dispatch import gramian as j_gramian
except ImportError:
    jax = cfjax = None

# cfjax is the float64 reference: without jax, or without the float64 mode
# that tests/conftest.py turns on (a card run takes --noconftest), its
# comparisons skip
needs_cfjax = pytest.mark.skipif(cfjax is None or not jax.config.jax_enable_x64,
                                 reason="needs jax in float64: cfjax is the reference")

needs_gpu = pytest.mark.skipif(
    "not torch.cuda.is_available()",
    reason="needs a CUDA device: K1 and K2 have no CPU mode")

SPELLINGS = {
    "c*ard": lambda c, l: c * ARDKernel(tk.MaternP(2), l),
    "ard*c": lambda c, l: ARDKernel(tk.MaternP(2), l) * c,
    "ard(c*k)": lambda c, l: ARDKernel(c * tk.MaternP(2), l),
    "Constant(c)*ard": lambda c, l: tk.Constant(c) * ARDKernel(tk.MaternP(2), l),
}

# the same spellings in cfjax
J_SPELLINGS = {
    "c*ard": lambda c, l: c * jk.ARDKernel(jk.MaternP(2), l),
    "ard*c": lambda c, l: jk.ARDKernel(jk.MaternP(2), l) * c,
    "ard(c*k)": lambda c, l: jk.ARDKernel(c * jk.MaternP(2), l),
    "Constant(c)*ard": lambda c, l: jk.Constant(c) * jk.ARDKernel(jk.MaternP(2), l),
}


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """Input without a device goes to the CPU in this module's tests; the
    configured device is restored after them."""
    shipped = cfjax_torch.config.DEFAULT.device
    cfjax_torch.set_config(device="cpu")
    yield
    cfjax_torch.set_config(device=shipped)


@pytest.fixture
def small_cholesky_size():
    """max_cholesky_size 128 in the port and, where it is here, in cfjax."""
    for pkg in (cfjax_torch, cfjax):
        if pkg is not None:
            pkg.set_config(max_cholesky_size=128)
    yield
    for pkg in (cfjax_torch, cfjax):
        if pkg is not None:
            pkg.set_config(max_cholesky_size=pkg.config.Config.max_cholesky_size)


def problem(n, d, seed=0, n_test=64):
    """Seeded points (N(0, I), as standardized features), lengthscales from
    the dimension-scaled LogNormal(sqrt 2 + ln(d) / 2, sqrt 3), an
    outputscale in [0.5, 8], observations sin(x_0) + noise, test points."""
    g = torch.Generator().manual_seed(seed)
    f = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64)
    x = f(n, d)
    ell = torch.exp(math.sqrt(2) + 0.5 * math.log(d) + math.sqrt(3) * f(d))
    c = float(0.5 + 7.5 * torch.rand((), generator=g, dtype=torch.float64))
    y = torch.sin(x[:, 0]) + 0.01 * f(n)
    return x, ell, c, y, f(n_test, d)


def rel(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


@pytest.mark.parametrize("d", [90, 5])
@pytest.mark.parametrize("spelling", list(SPELLINGS))
def test_product_matches_reference(d, spelling):
    """K v and K(x*, x) v within 1e-12 of the reference: both float64; the
    port's distances at d > 16 come from the expansion |a|^2 + |b|^2 - 2 a.b,
    which cancels to ~1e-16 |x / l|^2 an entry."""
    x, ell, c, _, xt = problem(512, d, seed=d)
    v = torch.randn(512, generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    k = SPELLINGS[spelling](c, ell)
    assert rel(gramian(k, x) @ v, ref.matvec(x, x, ell, c, v)) < 1e-12
    assert rel(gramian(k, xt, x) @ v, ref.matvec(xt, x, ell, c, v)) < 1e-12


@pytest.mark.parametrize("path", ["cholesky", "pcg"])
@pytest.mark.parametrize("d", [90, 5])
def test_gp_condition_matches_reference(small_cholesky_size, d, path):
    """alpha and the posterior mean against the reference's dense Cholesky:
    the port's Cholesky within 1e-9 (float64, cond(K + 1e-2 I) <= 1e5 here);
    its Nystrom PCG (n = 512 above the lowered max_cholesky_size) at tol 1e-10
    within 1e-6 of alpha (cond times tol) and its residual under 1e-9."""
    n, noise = 512, 1e-2
    x, ell, c, y, xt = problem(n, d, seed=10 + d)
    k = c * ARDKernel(tk.MaternP(2), ell)
    if path == "cholesky":
        cfjax_torch.set_config(max_cholesky_size=n)
    post = gp_condition(k, x, y, noise=noise, precond_rank=64, tol=1e-10, maxiter=500)
    alpha = ref.solve(x, y, ell, c, noise)
    tol = 1e-9 if path == "cholesky" else 1e-6
    assert rel(post.alpha, alpha) < tol
    res = ref.matvec(x, x, ell, c, post.alpha) + noise * post.alpha - y
    assert float(torch.linalg.norm(res) / torch.linalg.norm(y)) < 1e-9
    assert rel(post.mean(xt), ref.posterior_mean(xt, x, alpha, ell, c)) < tol
    if path == "pcg":
        assert post.solve_info is not None and post.solve_info[0] > 0


def jx(t):
    return jnp.asarray(t.numpy())


@needs_cfjax
@pytest.mark.parametrize("d", [90, 5])
@pytest.mark.parametrize("spelling", list(SPELLINGS))
def test_product_matches_cfjax(d, spelling):
    """K v and K(x*, x) v against cfjax's Gramian of the same spelling on the
    same inputs within 1e-12: both float64; cfjax evaluates the ARD product
    pair by pair on the differences, the port through the fold's expansion
    at d > 16 (rounding ~1e-16 |x / l|^2 an entry)."""
    x, ell, c, _, xt = problem(512, d, seed=d)
    v = torch.randn(512, generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    k, kj = SPELLINGS[spelling](c, ell), J_SPELLINGS[spelling](c, jx(ell))
    for a in (x, xt):
        want = np.asarray(j_gramian(kj, jx(a), jx(x)).todense()) @ v.numpy()
        got = (gramian(k, a, x) @ v).numpy()
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-12


@needs_cfjax
@pytest.mark.parametrize("path", ["cholesky", "pcg"])
@pytest.mark.parametrize("d", [90, 5])
def test_gp_condition_matches_cfjax(small_cholesky_size, d, path):
    """alpha and the posterior mean against cfjax's gp_condition on the same
    inputs and regime: on the Cholesky branch within 1e-9 (both float64
    Cholesky factors of one matrix, cond(K + 1e-2 I) <= 1e5 here); on the
    Nystrom-PCG branch (n = 512 above the lowered max_cholesky_size, tol
    1e-10, each alpha within cond times tol of the exact one) within 2e-6."""
    n, noise = 512, 1e-2
    x, ell, c, y, xt = problem(n, d, seed=10 + d)
    if path == "cholesky":
        cfjax.set_config(max_cholesky_size=n)
        cfjax_torch.set_config(max_cholesky_size=n)
    opts = dict(noise=noise, precond_rank=64, tol=1e-10, maxiter=500)
    post = gp_condition(c * ARDKernel(tk.MaternP(2), ell), x, y, **opts)
    pj = j_condition(c * jk.ARDKernel(jk.MaternP(2), jx(ell)), jx(x), jx(y), **opts)
    tol = 1e-9 if path == "cholesky" else 2e-6
    assert rel(post.alpha, torch.from_numpy(np.array(pj.alpha))) < tol
    assert rel(post.mean(xt), torch.from_numpy(np.array(pj.mean(jx(xt))))) < tol
    assert (post.solve_info is not None) == (path == "pcg")


@needs_cfjax
@pytest.mark.parametrize("d", [90, 5])
@pytest.mark.parametrize("spelling", list(SPELLINGS))
def test_logml_gradient_matches_cfjax(d, spelling):
    """The dense logML and its gradient in (l, c) through the fold against
    jax.grad of cfjax's logML of c * ARD(MaternP(2), l) (no fold there; its
    dispatch cannot trace a Constant inside the ARD, so every spelling is
    held to this one): value within 1e-12 and gradient within 1e-9, both
    float64 (the gradient through a Cholesky of cond <= 1e5 at n = 512)."""
    x, ell0, c0, y, _ = problem(512, d, seed=20 + d)
    ell = ell0.clone().requires_grad_(True)
    c = torch.tensor(c0, dtype=torch.float64, requires_grad=True)
    v = log_marginal_likelihood(SPELLINGS[spelling](c, ell), x, y, noise=1e-2)
    g_ell, g_c = torch.autograd.grad(v, (ell, c))
    f = lambda l, cj: j_lml(J_SPELLINGS["c*ard"](cj, l), jx(x), jx(y), 1e-2)
    vj, (gj_ell, gj_c) = jax.value_and_grad(f, argnums=(0, 1))(jx(ell0), jnp.float64(c0))
    assert float(v.detach()) == pytest.approx(float(vj), rel=1e-12)
    assert rel(g_ell, torch.from_numpy(np.array(gj_ell))) < 1e-9
    assert float(g_c) == pytest.approx(float(gj_c), rel=1e-9)


@needs_cfjax
def test_pcg_on_an_ard_dot_kernel(small_cholesky_size, monkeypatch):
    """ARD around a dot-product kernel, (x.y + 1)^2 at d = 5: the operator is
    the dot kernel on x / l, as cfjax's (both prescale a bare ARD), and the
    Nystrom build reads that Gramian: the same kernel in the dot mode on the
    same points (never its profile on distances). At rank 32, above the kernel's 21 features, the
    sketch is the operator to the float32 rounding of the stored factors,
    so PCG stops within 12 iterations (8 here; a build from the profile on
    distances takes 160), and alpha is the dense solve's to 1e-8 (tol 1e-10
    times cond(K + 1e-2 I) ~ 1e6)."""
    x, ell, _, y, _ = problem(512, 5, seed=7)
    k = ARDKernel(tk.Polynomial(2, 1.0), ell)
    op = gramian(k, x)
    assert isinstance(op, Gramian) and op.mode == "dot"
    K = op.todense()
    Kj = np.asarray(j_gramian(jk.ARDKernel(jk.Polynomial(2, 1.0), jx(ell)), jx(x)).todense())
    assert rel(K, torch.from_numpy(Kj.copy())) < 1e-12
    built = []
    monkeypatch.setattr(precond, "build_tile",
                        lambda g, f=precond.build_tile: built.append(g) or f(g))
    post = gp_condition(k, x, y, noise=1e-2, precond_rank=32, tol=1e-10, maxiter=500)
    (g,) = built
    assert g.mode == "dot" and g.k_given is k.k and torch.equal(g.x, x / ell)
    alpha = torch.linalg.solve(K + 1e-2 * torch.eye(512, dtype=K.dtype), y)
    assert post.solve_info[0] <= 12
    assert rel(post.alpha, alpha) < 1e-8


@pytest.mark.parametrize("spelling", list(SPELLINGS))
def test_every_spelling_routes_iso(spelling):
    """The operator and the mean's cross Gramian are iso-mode Gramians of the
    isotropic c * MaternP(2) (one Constant factor) on the points over l."""
    x, ell, c, _, xt = problem(64, 90)
    k = SPELLINGS[spelling](c, ell)
    for op in (gramian(k, x), gramian(k, xt, x)):
        assert isinstance(op, Gramian) and op.mode == "iso"
        assert isinstance(op.k, tk.Product) and len(op.k.args) == 2
        assert float(op.k.args[0].c) == pytest.approx(c, rel=1e-15)
        assert torch.allclose(op.y, x / ell, rtol=0, atol=0)
    assert "mvm mode = iso" in explain(k, x) and "mvm mode = iso" in explain(k, xt, x)


@needs_cfjax
def test_constants_fold_into_one():
    """Constants outside and inside the ARD, in any nesting, multiply into
    one Constant factor; a bare ARD folds to its kernel. Around a kernel that
    is not isotropic a bare ARD keeps its kernel as it stands, and one under
    an outputscale does not fold: it stays generic, with cfjax's values."""
    l = torch.full((4,), 2.0, dtype=torch.float64)
    kc, lf = ard_fold(3.0 * (2.0 * ARDKernel(4.0 * tk.MaternP(2), l)))
    assert lf is l and isinstance(kc, tk.Product) and len(kc.args) == 2
    assert float(kc.args[0].c) == 24.0 and isinstance(kc.args[1], tk.MaternP)
    kc, _ = ard_fold(ARDKernel(tk.MaternP(2), l))
    assert isinstance(kc, tk.MaternP)
    assert ard_fold(tk.MaternP(2)) is None
    assert ard_fold(2.0 * tk.MaternP(2)) is None
    poly, dot2 = tk.Polynomial(2, 1.0), 2.0 * tk.Dot()
    for k0 in (poly, dot2):
        kc, lf = ard_fold(ARDKernel(k0, l))
        assert kc is k0 and lf is l
        assert ard_fold(3.0 * ARDKernel(k0, l)) is None
    x, ell, c, _, _ = problem(48, 5)
    op = gramian(c * ARDKernel(poly, ell), x)
    assert isinstance(op, Gramian) and op.mode == "generic"
    want = j_gramian(c * jk.ARDKernel(jk.Polynomial(2, 1.0), jx(ell)), jx(x)).todense()
    assert rel(op.todense(), torch.from_numpy(np.array(want))) < 1e-12


def test_different_ard_kernels_stay_generic():
    """A Sum or a Product of two ARD kernels with different l has no common
    pre-scaling: it stays on the generic path, and its values are right."""
    x, ell, c, _, _ = problem(48, 5)
    a, b = ARDKernel(tk.MaternP(2), ell), ARDKernel(tk.MaternP(2), 2 * ell)
    for k in (a + b, c * a + b, a * b):
        op = gramian(k, x)
        assert isinstance(op, Gramian) and op.mode == "generic"
    v = torch.ones(48, dtype=torch.float64)
    want = ref.matvec(x, x, ell, c, v) + ref.matvec(x, x, 2 * ell, 1.0, v)
    assert rel(gramian(c * a + b, x) @ v, want) < 1e-12


@pytest.mark.parametrize("spelling", list(SPELLINGS))
def test_logml_gradient_through_the_fold(spelling):
    """The dense logML and its gradient in (l, c) through the fold equal the
    unfolded kernel's on the generic path (a `LambdaKernel` hides the
    structure) to 1e-10: both float64, the fold only reorders the
    arithmetic."""
    x, ell0, c0, y, _ = problem(64, 7, seed=3)
    grads = []
    for folded in (True, False):
        ell = ell0.clone().requires_grad_(True)
        c = torch.tensor(c0, dtype=torch.float64, requires_grad=True)
        k = SPELLINGS[spelling](c, ell)
        if not folded:
            k = LambdaKernel(lambda a, b, k=k: k(a, b))
            assert gramian(k, x).mode == "generic"
        else:
            assert gramian(k, x).mode == "iso"
        v = log_marginal_likelihood(k, x, y, noise=1e-2)
        g_ell, g_c = torch.autograd.grad(v, (ell, c))
        grads.append((float(v.detach()), g_ell, g_c))
    (v1, l1, c1), (v2, l2, c2) = grads
    assert v1 == pytest.approx(v2, rel=1e-12)
    assert rel(l1, l2) < 1e-10 and float(c1) == pytest.approx(float(c2), rel=1e-10)
    assert float(torch.linalg.norm(l1)) > 0 and float(c1) != 0


def test_nystrom_build_takes_the_fold():
    """The build from gramian(c * ARD(MaternP(2), l), x) is the build from
    gramian(c * MaternP(2), x / l), bit for bit, and neither evaluates its
    kernel pairwise (a (block, rank, d) difference tensor): the fold hands
    the build an isotropic kernel, whose entries are its profile on the
    distance tile."""
    x, ell, c, _, _ = problem(300, 90)
    Gs = (gramian(c * ARDKernel(tk.MaternP(2), ell), x), gramian(c * tk.MaternP(2), x / ell))
    assert all(isinstance(G, Gramian) and G.mode == "iso" for G in Gs)
    got, want = (precond.nystrom_factors(G, 1e-2, rank=32, seed=5) for G in Gs)
    assert got[0].shape == (300, 32)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_prescale_span_and_plain_counter():
    """Under `recording()` the fold opens one `gramian.prescale` span a
    Gramian (rows of x and y, d); `mvm.plain` counts only plain products of
    CUDA tensors (none here on the CPU) and only while spans are recorded."""
    x, ell, c, _, xt = problem(40, 90)
    trace.clear()
    before = trace.counters()["mvm.plain"]
    with trace.recording():
        op = gramian(c * ARDKernel(tk.MaternP(2), ell), xt, x)
        op @ torch.ones(40, dtype=torch.float64)
    (sp,) = [s for s in trace.spans() if s["name"] == "gramian.prescale"]
    assert sp["attrs"]["rows"] == 64 + 40 and sp["attrs"]["d"] == 90
    assert trace.counters()["mvm.plain"] == before
    trace.count("mvm.plain")
    assert trace.counters()["mvm.plain"] == before
    with trace.recording():
        trace.count("mvm.plain")
    assert trace.counters()["mvm.plain"] == before + 1
    trace.clear()


@needs_gpu
@pytest.mark.parametrize("d,kernel", [(90, "K2 gramian_matvec_expand (family instance"),
                                      (16, "K1 gramian_matvec_direct (family instance")])
def test_explain_names_the_kernel_on_the_card(d, kernel):
    """On float32 CUDA points the operator and the mean of c * ARD(MaternP(2),
    l) name K2 at d = 90 and K1 at d = 16, and a PCG solve with its mean
    makes no plain product (`mvm.plain`); the product matches the reference
    to the fp32-class tier's rounding."""
    x, ell, c, y, xt = problem(4096, d, seed=d)
    dev = dict(device="cuda", dtype=torch.float32)
    k = c * ARDKernel(tk.MaternP(2), ell.to(**dev))
    xc, xtc, yc = x.to(**dev), xt.to(**dev), y.to(**dev)
    assert kernel in explain(k, xc) and kernel in explain(k, xtc, xc)
    cfjax_torch.set_config(device="cuda", max_cholesky_size=1024)
    try:
        with trace.recording():
            before = trace.counters()["mvm.plain"]
            post = gp_condition(k, xc, yc, noise=1e-2, precond_rank=256, tol=1e-5)
            post.mean(xtc)
            assert trace.counters()["mvm.plain"] == before
    finally:
        cfjax_torch.set_config(device="cpu",
                               max_cholesky_size=cfjax_torch.config.Config.max_cholesky_size)
    v = torch.randn(4096, generator=torch.Generator().manual_seed(2), dtype=torch.float64)
    out = gramian(k, xc) @ v.to(**dev)
    assert rel(out.double().cpu(), ref.matvec(x.float().double(), x.float().double(), ell, c,
                                              v)) < 1e-5
