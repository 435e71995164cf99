"""Parity of the port's WoodburyOperator (A + U C V) with cfjax's on the
CPU (x64, float64 in both packages): MVM, matmat, todense, diagonal and
the Woodbury-identity solve, for a diagonal A given as an array and as an
operator, symmetric (V = U^T) and not."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfjax_torch
from cfjax.operators import DiagonalOperator as JDiag
from cfjax.operators import WoodburyOperator as JWoodbury
from cfjax_torch.operators import DiagonalOperator as TDiag
from cfjax_torch.operators import WoodburyOperator as TWoodbury

RTOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """Input without a device goes to the CPU in this module's tests; the
    configured device is restored after them."""
    shipped = cfjax_torch.config.DEFAULT.device
    cfjax_torch.set_config(device="cpu")
    yield
    cfjax_torch.set_config(device=shipped)


def _pair(rng, n, r, symmetric, as_operator):
    a = rng.uniform(1.0, 2.0, n)
    U = rng.standard_normal((n, r))
    C = rng.standard_normal((r, r))
    C = C @ C.T + r * np.eye(r)
    V = None if symmetric else rng.standard_normal((r, n))
    Aj = JDiag(jnp.asarray(a)) if as_operator else jnp.asarray(a)
    At = TDiag(torch.tensor(a)) if as_operator else a
    Wj = JWoodbury(Aj, jnp.asarray(U), jnp.asarray(C), None if V is None else jnp.asarray(V))
    Wt = TWoodbury(At, U, C, V)
    return Wj, Wt


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("as_operator", [True, False])
def test_woodbury_matches_reference(rng, symmetric, as_operator):
    n, r = 30, 4
    Wj, Wt = _pair(rng, n, r, symmetric, as_operator)
    assert Wt.is_symmetric == Wj.is_symmetric == symmetric
    assert Wt.rank == Wj.rank == r and Wt.shape == Wj.shape
    assert Wt.device == torch.device("cpu") and Wt.dtype == torch.float64
    v, M = rng.standard_normal(n), rng.standard_normal((n, 3))
    np.testing.assert_allclose((Wt @ torch.tensor(v)).numpy(), np.asarray(Wj @ jnp.asarray(v)),
                               rtol=RTOL)
    np.testing.assert_allclose((Wt @ torch.tensor(M)).numpy(), np.asarray(Wj @ jnp.asarray(M)),
                               rtol=RTOL)
    np.testing.assert_allclose(Wt.todense().numpy(), np.asarray(Wj.todense()), rtol=RTOL)
    np.testing.assert_allclose(Wt.diagonal().numpy(), np.asarray(Wj.diagonal()), rtol=RTOL)
    for b in (v, M):
        x = Wt.solve(torch.tensor(b))
        np.testing.assert_allclose(x.numpy(), np.asarray(Wj.solve(jnp.asarray(b))), rtol=1e-10)
        np.testing.assert_allclose((Wt @ x).numpy(), b, rtol=1e-10, atol=1e-12)
