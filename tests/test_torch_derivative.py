"""Parity of the port's derivative-kernel layer (cfjax_torch.derivative,
kernels/derivatives.py, the derivative profile specs) with cfjax on the
CPU.

The same numpy inputs go to both packages: cfjax in x64 (tests/conftest.py),
the port in float64. Tolerances:
  * profile derivatives by autodiff, both packages: rtol 1e-9 (the same
    formulas through jax.grad and torch.func.grad);
  * the jet of a derivative spec (`ProfileSpec.evaluate_jet`) against
    jax.grad of cfjax's `profile`: rtol 1e-9 at s = 0, 1e-20, just below
    the MaternP Taylor bound and at ordinary s. Just above the bound,
    nested autodiff of the closed form cancels (about eps / rho^3
    relative in f'', up to 3e-2 for MaternP(1) in float64), so there the
    jet is held against the exact derivatives (mpmath, 50 digits) at
    rtol 1e-12;
  * gradient, value+gradient and Hessian operator MVMs: rtol 1e-9,
    atol 1e-12 (the two packages sum the same products in other orders);
  * gp_condition: alpha and the posterior mean at rtol 1e-9 (Cholesky)
    and atol 1e-7 (CG at tol 1e-10, CG iterations within 1)."""

import math

import jax
import jax.numpy as jnp
import mpmath
import numpy as np
import pytest
import torch

import cfjax
import cfjax.kernels as jk
import cfjax_torch
import cfjax_torch.kernels as tk
from cfjax.derivative import GradientKernel as JGradientKernel
from cfjax.derivative import HessianKernel as JHessianKernel
from cfjax.derivative import ValueGradientHessianKernel as JVGHKernel
from cfjax.derivative import ValueGradientKernel as JValueGradientKernel
from cfjax.gp import gp_condition as j_condition
from cfjax.operators.dispatch import LambdaKernel as JLambdaKernel
from cfjax.operators.dispatch import explain as j_explain
from cfjax.operators.dispatch import gramian as j_gramian
from cfjax_torch.derivative import (DerivativeKernel, GradientKernel, HessianKernel,
                                    SeparableKernel, ValueDerivativeKernel,
                                    ValueGradientHessianKernel, ValueGradientKernel)
from cfjax_torch.derivative.gradient import select_grad_kernel
from cfjax_torch.gp import gp_condition as t_condition
from cfjax_torch.kernels.derivatives import elementwise_derivatives
from cfjax_torch.kernels.profile_spec import to_spec
from cfjax_torch.operators.dispatch import LambdaKernel
from cfjax_torch.operators.dispatch import explain as t_explain
from cfjax_torch.operators.dispatch import gramian as t_gramian
from cfjax_torch.utils.linalg import nth_derivatives

torch.set_num_threads(2)
mpmath.mp.dps = 50

RTOL, ATOL = 1e-9, 1e-12

# the kernels of the profile check: f, f', f'' of each profile
PROFILES = {
    "EQ": lambda: jk.EQ(),
    "Exp": lambda: jk.Exp(),
    "GammaExp": lambda: jk.GammaExp(1.5),
    "MaternP1": lambda: jk.MaternP(1),
    "MaternP2": lambda: jk.MaternP(2),
    "MaternP3": lambda: jk.MaternP(3),
    "RQ": lambda: jk.RQ(1.5),
    "Cauchy": lambda: jk.Cauchy(),
    "IMQ": lambda: jk.IMQ(1.0),
    "Lengthscale": lambda: jk.Lengthscale(jk.MaternP(2), 0.5),
    "SumScaled": lambda: 2.0 * jk.EQ() + 0.5 * jk.MaternP(2),
    "EQ2": lambda: jk.EQ() ** 2,
    "Dot2": lambda: jk.Dot() ** 2,
    "ExponentialDot": lambda: jk.ExponentialDot(),
}
DECLINED = {"Exp", "GammaExp"}  # no finite f' or f'' at s = 0
S = [0.0, 1e-20, 1e-9, 3e-4, 0.3, 2.0, 30.0]


def _f64(v):
    return torch.tensor(v, dtype=torch.float64)


def _jax_derivs(kj, s, profile="profile"):
    f0 = getattr(kj, profile)
    f1 = jax.grad(f0)
    f2 = jax.grad(f1)
    return [np.array([float(f(float(v))) for v in s]) for f in (f0, f1, f2)]


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_profile_derivatives_match_reference(name):
    kj = PROFILES[name]()
    kt = tk.from_reference(kj)
    ref = _jax_derivs(kj, S)
    out = elementwise_derivatives(kt.profile, _f64(S), 2)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), r, rtol=RTOL)


@pytest.mark.parametrize("name", sorted(set(PROFILES) - DECLINED))
def test_derivative_spec_jet_matches_reference(name):
    kj = PROFILES[name]()
    spec, why = to_spec(tk.from_reference(kj), derivative=True)
    assert why is None and spec.jet
    s = [0.0, 1e-20, 1e-3, 0.3, 2.0, 30.0]
    for o, r in zip(spec.evaluate_jet(_f64(s)), _jax_derivs(kj, s)):
        np.testing.assert_allclose(o.numpy(), r, rtol=RTOL)


def _maternp_exact(p, s):
    """f, f', f'' of the Matern-(p+1/2) closed form at s, in mpmath."""
    kj = jk.MaternP(p)
    c = 2 * p + 1

    def f(t):
        r = mpmath.sqrt(c * t)
        return mpmath.exp(-r) * sum(mpmath.mpf(kj._poly[j]) * (2 * r) ** j
                                    for j in range(p + 1))

    return [float(mpmath.diff(f, mpmath.mpf(s), n)) for n in range(3)]


@pytest.mark.parametrize("p", [1, 2, 3])
def test_maternp_jet_on_both_sides_of_taylor_bound(p):
    spec, _ = to_spec(tk.MaternP(p), derivative=True)
    bound = np.finfo(np.float64).eps ** (1.0 / p)
    below, above = bound * (1 - 1e-6), bound * (1 + 1e-6)
    # below: the Taylor branch of cfjax's profile, exact under autodiff
    jet = [v.numpy() for v in spec.evaluate_jet(_f64([0.0, 1e-20, below]))]
    ref = _jax_derivs(jk.MaternP(p), [0.0, 1e-20, below])
    for o, r in zip(jet, ref):
        np.testing.assert_allclose(o, r, rtol=RTOL)
    # above: the closed form, against its exact derivatives
    for s in (above, 2 * bound, 1e-3, 0.3):
        jet = [float(v) for v in spec.evaluate_jet(_f64([s]))]
        np.testing.assert_allclose(jet, _maternp_exact(p, s), rtol=1e-12)


def test_derivative_spec_declines_with_reason():
    for k in (tk.Exp(), tk.MaternP(0), tk.GammaExp(1.5), tk.GammaExp(2.0),
              tk.Lengthscale(tk.Exp(), 2.0), tk.NN(0.3)):
        spec, why = to_spec(k, derivative=True)
        assert spec is None and isinstance(why, str) and why
    # the value spec of the same kernels is unchanged
    assert to_spec(tk.Exp())[0] is not None and not to_spec(tk.Exp())[0].jet


VALUE_SPECS = ["EQ", "Exp", "GammaExp", "MaternP1", "MaternP2", "MaternP3", "RQ",
               "Cauchy", "IMQ", "Lengthscale", "SumScaled", "EQ2", "Dot2"]


@pytest.mark.parametrize("name", VALUE_SPECS)
def test_value_spec_jet_matches_autodiff_of_profile_value(name):
    """Every opcode's jet rule, on the programs compiled from profile_value
    (ROOT, POWC, MATERNP clamp: their derivatives vanish below 1e-18). Not
    at s = 0, where GammaExp's f'' is infinite, nor between 1e-18 and
    1e-3, where both sides differentiate a cancelling closed form."""
    kt = tk.from_reference(PROFILES[name]())
    spec, _ = to_spec(kt)
    s = _f64([1e-20, 1e-3, 0.3, 2.0, 30.0])
    ref = elementwise_derivatives(kt.profile_value, s, 2)
    for o, r in zip(spec.evaluate_jet(s), ref):
        np.testing.assert_allclose(o.numpy(), r.numpy(), rtol=1e-8, atol=1e-300)


def test_nth_derivatives_matches_reference():
    from cfjax.utils.linalg import nth_derivatives as j_nth

    ref = j_nth(lambda v: jnp.exp(v) - 0.5 * v ** 3, 0.7, 3)
    out = nth_derivatives(lambda v: torch.exp(v) - 0.5 * v ** 3, _f64(0.7), 3)
    np.testing.assert_allclose([float(v) for v in out], [float(v) for v in ref], rtol=1e-14)


# --------------------------------------------------------------------------
# operators
# --------------------------------------------------------------------------


def _pts(rng, n, d):
    return rng.standard_normal((n, d))


def _check_mvm(kind_j, kind_t, x, y, rng, dense=False):
    """gramian(kind(k)) in both packages: same class, same MVM."""
    Gj = j_gramian(kind_j, jnp.asarray(x), None if y is None else jnp.asarray(y))
    Gt = t_gramian(kind_t, torch.tensor(x), None if y is None else torch.tensor(y))
    assert type(Gt).__name__ == type(Gj).__name__
    assert tuple(Gt.shape) == tuple(Gj.shape)
    v = rng.standard_normal(Gt.shape[1])
    np.testing.assert_allclose((Gt @ torch.tensor(v)).numpy(), np.asarray(Gj @ jnp.asarray(v)),
                               rtol=RTOL, atol=ATOL)
    if dense:
        np.testing.assert_allclose(Gt.todense().numpy(), np.asarray(Gj.todense()),
                                   rtol=RTOL, atol=ATOL)
    return Gt


GRADIENT_CASES = {
    # trait mode -> kernel (cfjax side; the port's by from_reference)
    "iso_EQ": lambda: jk.EQ(),
    "iso_MaternP2": lambda: jk.MaternP(2),
    "iso_composite": lambda: jk.EQ() * jk.RQ(2.0) + 0.5,
    "iso_Lengthscale": lambda: jk.Lengthscale(jk.MaternP(3), 0.7),
    "dot_Dot2": lambda: jk.Dot() ** 2,
    "dot_ExponentialDot": lambda: jk.ExponentialDot(),
    "slf_Cosine": lambda: jk.Cosine(np.array([0.4, 1.1, 0.3])),
    "pair_NN": lambda: jk.NN(0.3),
    "pair_product": lambda: jk.MaternP(2) * (jk.Dot() ** 2 + 0.5),
    "pair_readme": lambda: jk.MaternP(2) + jk.Line(1.0) ** 2 + jk.NN(0.1),
}


@pytest.mark.parametrize("rect", [False, True], ids=["square", "rect"])
@pytest.mark.parametrize("name", sorted(GRADIENT_CASES))
def test_gradient_gramian_modes_match_reference(name, rect, rng):
    kj = GRADIENT_CASES[name]()
    x = _pts(rng, 9, 3)
    y = _pts(rng, 7, 3) if rect else None
    G = _check_mvm(JGradientKernel(kj), GradientKernel(tk.from_reference(kj)), x, y, rng)
    assert G.mode == name.split("_")[0]


def test_gradient_generic_matches_reference(rng):
    x = _pts(rng, 8, 3)
    kj = JLambdaKernel(lambda a, b: jk.EQ()(a, b))
    kt = LambdaKernel(lambda a, b: tk.EQ()(a, b))
    G = _check_mvm(JGradientKernel(kj), GradientKernel(kt), x, None, rng)
    assert G.mode == "generic"


def _callable_pair(case, rng, d=3):
    """(cfjax kernel, port kernel) for kernels holding callables."""
    U = rng.standard_normal((d, d))
    return {
        "warped": (jk.Warped(jk.EQ(), lambda z: jnp.tanh(z) + 0.1 * z),
                   tk.Warped(tk.EQ(), lambda z: torch.tanh(z) + 0.1 * z)),
        "scaled_input": (jk.ScaledInputKernel(jk.MaternP(2), U), None),
        "vertical": (jk.VerticalRescaling(jk.MaternP(2), lambda z: 1.0 + 0.3 * jnp.sum(jnp.tanh(z))),
                     tk.VerticalRescaling(tk.MaternP(2), lambda z: 1.0 + 0.3 * torch.sum(torch.tanh(z)))),
        "normalized": (jk.normalize(jk.RQ(1.5) + 0.2), tk.normalize(tk.RQ(1.5) + 0.2)),
        "chained_generic": (
            jk.Chained(lambda s: jnp.exp(s) - 0.5 * s, jk.Warped(jk.EQ(), lambda z: jnp.tanh(z) + 0.1 * z)),
            tk.Chained(lambda s: torch.exp(s) - 0.5 * s,
                       tk.Warped(tk.EQ(), lambda z: torch.tanh(z) + 0.1 * z))),
        "chained_iso": (jk.Chained(lambda s: s ** 2 + s, jk.EQ()),
                        tk.Chained(lambda s: s ** 2 + s, tk.EQ())),
        "constant": (jk.Constant(0.7), None),
        "hetero_sum": (jk.MaternP(2) + jk.Cosine(np.ones(d)), None),
        "hetero_sum_const": (jk.Cosine(np.ones(d)) + jk.Cosine(np.array([0.5, 1.0, 0.2])) + 0.3,
                             None),
        "separable_product": (jk.SeparableProduct((jk.EQ(), jk.RQ(1.5), jk.Cauchy())), None),
        "separable_sum": (jk.SeparableSum((jk.EQ(), jk.RQ(1.5), jk.Cauchy())), None),
    }[case]


GRADIENT_OPERATOR_CASES = ["warped", "scaled_input", "vertical", "normalized",
                           "chained_generic", "chained_iso", "constant", "hetero_sum",
                           "hetero_sum_const", "separable_product", "separable_sum"]


@pytest.mark.parametrize("rect", [False, True], ids=["square", "rect"])
@pytest.mark.parametrize("case", GRADIENT_OPERATOR_CASES)
def test_gradient_operators_match_reference(case, rect, rng):
    kj, kt = _callable_pair(case, rng)
    kt = tk.from_reference(kj) if kt is None else kt
    x = _pts(rng, 8, 3)
    y = _pts(rng, 6, 3) if rect else None
    _check_mvm(JGradientKernel(kj), GradientKernel(kt), x, y, rng, dense=not rect)


VALUE_GRADIENT_CASES = {
    "iso": lambda: (jk.EQ(), None),
    "iso_MaternP3": lambda: (jk.MaternP(3), None),
    "dot": lambda: (jk.Dot() ** 2, None),
    "pair": lambda: (jk.NN(0.2) + jk.MaternP(2), None),
    "pair_iso_dot": lambda: (jk.EQ() + jk.Dot(), None),
    "generic": lambda: (JLambdaKernel(lambda a, b: jk.EQ()(a, b)),
                        LambdaKernel(lambda a, b: tk.EQ()(a, b))),
}


@pytest.mark.parametrize("rect", [False, True], ids=["square", "rect"])
@pytest.mark.parametrize("case", sorted(VALUE_GRADIENT_CASES))
def test_value_gradient_modes_match_reference(case, rect, rng):
    kj, kt = VALUE_GRADIENT_CASES[case]()
    kt = tk.from_reference(kj) if kt is None else kt
    x = _pts(rng, 7, 3)
    y = _pts(rng, 6, 3) if rect else None
    G = _check_mvm(JValueGradientKernel(kj), ValueGradientKernel(kt), x, y, rng)
    assert G.mode == case.split("_")[0]


@pytest.mark.parametrize("case", ["warped", "scaled_input", "vertical", "constant",
                                  "hetero_sum_generic"])
def test_value_gradient_operators_match_reference(case, rng):
    if case == "hetero_sum_generic":
        kj = jk.EQ() + jk.Warped(jk.Dot(), lambda z: jnp.tanh(z))
        kt = tk.EQ() + tk.Warped(tk.Dot(), lambda z: torch.tanh(z))
    else:
        kj, kt = _callable_pair(case, rng)
        kt = tk.from_reference(kj) if kt is None else kt
    _check_mvm(JValueGradientKernel(kj), ValueGradientKernel(kt), _pts(rng, 6, 3), None, rng,
               dense=True)


@pytest.mark.parametrize("name", ["EQ", "RQ", "Dot3", "generic"])
def test_hessian_matches_reference(name, rng):
    kj = {"EQ": jk.EQ(), "RQ": jk.RQ(2.0), "Dot3": jk.Dot() ** 3,
          "generic": JLambdaKernel(lambda a, b: jk.EQ()(a, b))}[name]
    kt = (LambdaKernel(lambda a, b: tk.EQ()(a, b)) if name == "generic"
          else tk.from_reference(kj))
    x, y = _pts(rng, 4, 2), _pts(rng, 3, 2)
    _check_mvm(JHessianKernel(kj), HessianKernel(kt), x, y, rng)


@pytest.mark.parametrize("name", ["iso", "generic"])
def test_value_gradient_hessian_matches_reference(name, rng):
    rj, rt = jk.RQ(1.5), tk.RQ(1.5)
    kj = jk.EQ() if name == "iso" else JLambdaKernel(lambda a, b: rj(a, b))
    kt = tk.EQ() if name == "iso" else LambdaKernel(lambda a, b: rt(a, b))
    x, y = _pts(rng, 3, 2), _pts(rng, 3, 2)
    G = _check_mvm(JVGHKernel(kj), ValueGradientHessianKernel(kt), x, y, rng)
    assert G.mode == name


def test_multikernel_blocks_match_reference(rng):
    """The per-pair blocks of each matrix-valued kernel (its __call__)."""
    x, y = _pts(rng, 1, 3)[0], _pts(rng, 1, 3)[0]
    for jcls, tcls in ((JGradientKernel, GradientKernel),
                       (JValueGradientKernel, ValueGradientKernel),
                       (JHessianKernel, HessianKernel), (JVGHKernel, ValueGradientHessianKernel)):
        ref = np.asarray(jcls(jk.MaternP(2))(jnp.asarray(x), jnp.asarray(y)))
        out = tcls(tk.MaternP(2))(torch.tensor(x), torch.tensor(y)).numpy()
        np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    from cfjax.derivative.gradient import DerivativeKernel as JD, ValueDerivativeKernel as JVD

    for jcls, tcls in ((JD, DerivativeKernel), (JVD, ValueDerivativeKernel)):
        ref = np.asarray(jcls(jk.EQ())(0.3, -0.4))
        np.testing.assert_allclose(tcls(tk.EQ())(_f64(0.3), _f64(-0.4)).numpy(),
                                   ref, rtol=RTOL)
        xs = rng.standard_normal(5)
        Gj = jcls(jk.EQ()).gramian(jnp.asarray(xs))
        Gt = tcls(tk.EQ()).gramian(torch.tensor(xs))
        assert type(Gt).__name__ == type(Gj).__name__
        v = rng.standard_normal(Gt.shape[1])
        np.testing.assert_allclose((Gt @ torch.tensor(v)).numpy(), np.asarray(Gj @ jnp.asarray(v)),
                                   rtol=RTOL, atol=ATOL)


def test_from_reference_converts_multikernels():
    from cfjax.derivative import SeparableKernel as JSeparableKernel
    from cfjax.derivative.gradient import DerivativeKernel as JD

    for kj, cls in ((JGradientKernel(jk.MaternP(2)), GradientKernel),
                    (JValueGradientKernel(jk.EQ()), ValueGradientKernel),
                    (JHessianKernel(jk.RQ(1.5)), HessianKernel),
                    (JVGHKernel(jk.EQ()), ValueGradientHessianKernel)):
        kt = tk.from_reference(kj)
        assert type(kt) is cls and type(kt.k).__name__ == type(kj.k).__name__
    kt = tk.from_reference(JD(jk.Lengthscale(jk.EQ(), 0.5)))
    assert isinstance(kt, DerivativeKernel) and float(kt.k.k.l) == 0.5
    kt = tk.from_reference(JSeparableKernel(jk.EQ(), np.eye(2)))
    assert isinstance(kt, SeparableKernel)
    np.testing.assert_array_equal(np.asarray(kt.B), np.eye(2))


def test_separable_kernel_gramian_not_ported(rng):
    """The SeparableKernel's gramian is now ported: gramian(k, x) ⊗ B as a
    KroneckerOperator, with cfjax's MVM."""
    from cfjax.derivative import SeparableKernel as JSeparableKernel

    B = np.array([[2.0, 0.3], [0.3, 1.0]])
    x = _pts(rng, 5, 3)
    Gt = t_gramian(SeparableKernel(tk.EQ(), B), torch.tensor(x))
    Gj = j_gramian(JSeparableKernel(jk.EQ(), jnp.asarray(B)), jnp.asarray(x))
    assert type(Gt).__name__ == type(Gj).__name__ == "KroneckerOperator"
    v = rng.standard_normal(10)
    np.testing.assert_allclose((Gt @ torch.tensor(v)).numpy(), np.asarray(Gj @ jnp.asarray(v)),
                               rtol=RTOL, atol=ATOL)


def test_explain_derivative_gramians_on_cpu(rng):
    x = torch.tensor(_pts(rng, 6, 3))
    xj = jnp.asarray(x.numpy())
    for kt, kj in ((GradientKernel(tk.MaternP(2)), JGradientKernel(jk.MaternP(2))),
                   (GradientKernel(tk.NN(0.3)), JGradientKernel(jk.NN(0.3))),
                   (ValueGradientKernel(tk.EQ()), JValueGradientKernel(jk.EQ()))):
        assert t_explain(kt, x).split(" | ")[0] == j_explain(kj, xj).split(" | ")[0]
    how = t_explain(GradientKernel(tk.MaternP(2)), x)
    assert "gradient mode = iso" in how and "cuda kernel declined: tensors on cpu" in how
    assert "trait mode" not in how
    how = t_explain(GradientKernel(tk.NN(0.3)), x)
    assert "gradient mode = pair" in how and "K3 covers iso/dot" in how
    how = t_explain(GradientKernel(tk.Warped(tk.EQ(), torch.tanh)), x)
    assert how.startswith("JacobianConjugatedGradientGramian") and "gradient mode = iso" in how


def test_select_grad_kernel_reasons(rng):
    x = torch.tensor(_pts(rng, 6, 3))
    for k, expect in ((tk.MaternP(2), "CUDA device"), (tk.Cosine(np.ones(3)), "K3 covers"),
                      (tk.Exp(), "CUDA device")):
        G = t_gramian(GradientKernel(k), x)
        assert G._spec is None and expect in G.kernel_reason
        assert select_grad_kernel(G) == (None, G.kernel_reason)


# --------------------------------------------------------------------------
# GP conditioning on gradient observations
# --------------------------------------------------------------------------


@pytest.fixture
def gradient_problem(rng):
    n, d = 20, 3
    x = 0.5 * rng.standard_normal((n, d))
    Y = np.cos(x) + 0.01 * rng.standard_normal((n, d))   # gradients of sum(sin)
    xt = 0.5 * rng.standard_normal((6, d))
    return x, Y.reshape(-1), xt


@pytest.fixture
def small_cholesky_size():
    cfjax.set_config(max_cholesky_size=32)
    cfjax_torch.set_config(max_cholesky_size=32)
    yield
    cfjax.set_config(max_cholesky_size=cfjax.config.Config.max_cholesky_size)
    cfjax_torch.set_config(max_cholesky_size=cfjax_torch.config.Config.max_cholesky_size)


@pytest.mark.parametrize("name", ["EQ", "MaternP2", "Dot2"])
def test_gp_condition_gradient_cholesky(name, gradient_problem):
    x, y, xt = gradient_problem
    kj = {"EQ": jk.EQ(), "MaternP2": jk.MaternP(2), "Dot2": jk.Dot() ** 2 + 1.0}[name]
    kt = tk.from_reference(kj)
    pj = j_condition(JGradientKernel(kj), jnp.asarray(x), jnp.asarray(y), noise=1e-2)
    pt = t_condition(GradientKernel(kt), torch.tensor(x), torch.tensor(y), noise=1e-2)
    assert pt.solve_info is None
    np.testing.assert_allclose(pt.alpha.numpy(), np.asarray(pj.alpha), rtol=RTOL)
    mean = pt.mean(torch.tensor(xt))
    assert tuple(mean.shape) == (xt.size,)
    np.testing.assert_allclose(mean.numpy(), np.asarray(pj.mean(jnp.asarray(xt))),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["EQ", "MaternP2"])
def test_gp_condition_gradient_cg(name, gradient_problem, small_cholesky_size):
    from cfjax.operators.solvers import cg as j_cg

    x, y, xt = gradient_problem
    kj = {"EQ": jk.EQ(), "MaternP2": jk.MaternP(2)}[name]
    kt = tk.from_reference(kj)
    opts = dict(noise=1e-2, tol=1e-10, maxiter=1000)
    pj = j_condition(JGradientKernel(kj), jnp.asarray(x), jnp.asarray(y), **opts)
    pt = t_condition(GradientKernel(kt), torch.tensor(x), torch.tensor(y), **opts)
    np.testing.assert_allclose(pt.alpha.numpy(), np.asarray(pj.alpha), atol=1e-7)
    np.testing.assert_allclose(pt.mean(torch.tensor(xt)).numpy(),
                               np.asarray(pj.mean(jnp.asarray(xt))), atol=1e-7)
    # cfjax's gp_condition keeps no CG info: rerun its CG
    Kj = j_gramian(JGradientKernel(kj), jnp.asarray(x)).add_diagonal(1e-2)
    _, (it_j, _) = j_cg(Kj._matvec, jnp.asarray(y), tol=1e-10, maxiter=1000)
    it, res = pt.solve_info
    assert abs(it - int(it_j)) <= 1 and float(res) <= 1e-10 * np.linalg.norm(y)
