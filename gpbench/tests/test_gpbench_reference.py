"""The float64 reference against closed forms at tiny n."""

import math

import pytest
import torch

from gpbench.reference import gp as ref
from gpbench.reference import kernels

MATERN = {"name": "MaternP", "args": [2]}
EQ = {"name": "EQ"}


def test_profiles_closed_form():
    rho = torch.tensor([0.0, 0.3, 1.0, 2.5], dtype=torch.float64)
    r = math.sqrt(5) * rho
    assert torch.allclose(kernels.profile(MATERN, rho), (1 + r + r * r / 3) * torch.exp(-r),
                          rtol=1e-15, atol=0)
    assert torch.allclose(kernels.profile(EQ, rho), torch.exp(-rho * rho / 2), rtol=1e-15)
    r1 = math.sqrt(3) * rho       # MaternP(1): (1 + r) exp(-r)
    assert torch.allclose(kernels.profile({"name": "MaternP", "args": [1]}, rho),
                          (1 + r1) * torch.exp(-r1), rtol=1e-15)
    assert torch.allclose(kernels.profile({"name": "MaternP", "args": [0]}, rho),
                          torch.exp(-rho), rtol=1e-15)


def test_products_two_points():
    x = torch.tensor([[0.0, 0.0, 0.0], [0.6, 0.0, 0.8]], dtype=torch.float64)   # distance 1
    k = (1 + math.sqrt(5) + 5 / 3) * math.exp(-math.sqrt(5))
    A = torch.tensor([[1.0, 2.0], [3.0, -1.0]], dtype=torch.float64)
    K = torch.tensor([[1.0, k], [k, 1.0]], dtype=torch.float64)
    assert torch.allclose(ref.products(MATERN, x, x, A), K @ A, rtol=1e-14)
    # row blocks of one row give the same
    assert torch.allclose(ref.products(MATERN, x, x, A, ell=2.0),
                          kernels.profile(MATERN, torch.tensor([[0, .5], [.5, 0]],
                                                               dtype=torch.float64)) @ A)


def test_products_blocked(monkeypatch):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(37, 3, generator=g, dtype=torch.float64)
    A = torch.randn(37, 4, generator=g, dtype=torch.float64)
    full = ref.products(MATERN, x, x, A)
    monkeypatch.setattr(ref, "TILE_ELEMENTS", 37 * 5)
    assert torch.allclose(ref.products(MATERN, x, x, A), full, rtol=1e-14)


def test_grad_products_closed_form():
    """EQ's gradient block: B(x, y) = f I - f r r^T with f = exp(-|r|^2 / 2)."""
    g = torch.Generator().manual_seed(4)
    n, d = 5, 3
    x = 0.7 * torch.randn(n, d, generator=g, dtype=torch.float64)
    A = torch.randn(2, n, d, generator=g, dtype=torch.float64)
    B = torch.zeros(n * d, n * d, dtype=torch.float64)
    for i in range(n):
        for j in range(n):
            r = x[i] - x[j]
            f = math.exp(-float(r @ r) / 2)
            block = f * torch.eye(d, dtype=torch.float64) - f * torch.outer(r, r)
            B[i * d:(i + 1) * d, j * d:(j + 1) * d] = block
    want = (B @ A.reshape(2, -1).T).T.reshape(2, n, d)
    assert torch.allclose(ref.grad_products(EQ, x, x, A), want, rtol=1e-13, atol=1e-15)
    assert torch.allclose(ref.grad_products(EQ, x, x, A, jobs_per_block=1), want, rtol=1e-13,
                          atol=1e-15)


@pytest.mark.parametrize("theta", [-0.4, 0.0, 0.3])
def test_logml_two_points(theta):
    x = torch.tensor([[0.0, 0.0, 0.0], [0.0, 1.0, 0.0]], dtype=torch.float64)
    y = torch.tensor([0.5, -0.2], dtype=torch.float64)
    noise = 0.1

    def closed(t):
        r = math.sqrt(5) * math.exp(-t)
        k = (1 + r + r * r / 3) * math.exp(-r)
        a, b = 1 + noise, k
        det = a * a - b * b
        quad = (a * (y[0] ** 2 + y[1] ** 2) - 2 * b * y[0] * y[1]) / det
        return float(-0.5 * (quad + math.log(det) + 2 * math.log(2 * math.pi)))

    v, g = ref.logml(MATERN, x, y, noise, theta)
    assert v == pytest.approx(closed(theta), rel=1e-13)
    h = 1e-6
    assert g == pytest.approx((closed(theta + h) - closed(theta - h)) / (2 * h), rel=1e-6)
