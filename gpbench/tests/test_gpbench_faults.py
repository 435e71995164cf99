"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped and the rest of a run is driven at a
tiny size on the CPU, once for each fault that a cell can have. The cells
run on one card, so no exchange between chips exists to leave out.

- a step that returns its state unchanged: the solver returns its start;
- half of the batch left out, the mean taken over the rest: a solve
  conditions on half of the points and scales what it finds, a fit step
  takes the logML of half of the points twice;
- an answer altered where it is produced: one coefficient of alpha, one
  entry of the posterior mean, the logML's value, or its derivative."""

import pytest
import torch

import cfjax_torch.gp
import cfjax_torch.gp.regression as regression
from gpbench.harness import runner
from gpbench.tests.tiny import tiny_cell

SOLVES = ["maternp2_d3.pcg_n131072", "grad_eq_d16.cg_n4096"]
FIT = "maternp2_d3.fit_n16384"


def run(workload, seed=2**31 + 1234):
    cell, control = tiny_cell(workload)
    return runner.run(cell, seed, 0.3, False, torch.device("cpu"), 0.0, log=lambda s: None,
                      control=control)


@pytest.mark.parametrize("workload", SOLVES + [FIT])
def test_sound_run_is_correct(workload):
    assert run(workload)["correct"] is True


@pytest.mark.parametrize("workload", SOLVES)
def test_solver_returns_its_start(monkeypatch, workload):
    def unchanged(matvec, b, x0=None, **kw):
        return torch.zeros_like(b), (1, torch.linalg.norm(b))

    monkeypatch.setattr(regression, "cg", unchanged)
    monkeypatch.setattr(regression, "solve_with_info", lambda op, b, **kw: unchanged(None, b))
    assert run(workload)["correct"] is False


@pytest.mark.parametrize("workload", SOLVES)
def test_solve_leaves_out_half_the_points(monkeypatch, workload):
    whole = cfjax_torch.gp.gp_condition

    def half(kernel, x, y, **kw):
        h = x.shape[0] // 2
        post = whole(kernel, x[:h], y[:y.shape[0] * h // x.shape[0]], **kw)
        post.alpha = torch.cat([2 * post.alpha, torch.zeros_like(post.alpha)])
        post.x_train = x
        return post

    monkeypatch.setattr(cfjax_torch.gp, "gp_condition", half)
    assert run(workload)["correct"] is False


@pytest.mark.parametrize("workload", SOLVES)
@pytest.mark.parametrize("where", ["alpha", "mean"])
def test_solve_answer_altered(monkeypatch, workload, where):
    whole, mean = cfjax_torch.gp.gp_condition, regression.GPPosterior.mean

    def altered_alpha(*a, **kw):
        post = whole(*a, **kw)
        post.alpha = post.alpha.clone()
        post.alpha[0] += 0.1 * torch.linalg.norm(post.alpha) / post.alpha.numel() ** 0.5
        return post

    def altered_mean(self, xt):
        m = mean(self, xt).clone()
        m[0] += 1e-2 * torch.linalg.norm(m)
        return m

    if where == "alpha":
        monkeypatch.setattr(cfjax_torch.gp, "gp_condition", altered_alpha)
    else:
        monkeypatch.setattr(regression.GPPosterior, "mean", altered_mean)
    assert run(workload)["correct"] is False


def test_fit_leaves_out_half_the_points(monkeypatch):
    whole = regression.log_marginal_likelihood

    def half(kernel, x, y, **kw):
        h = x.shape[0] // 2
        return 2 * whole(kernel, x[:h], y[:h], **kw)

    monkeypatch.setattr(regression, "log_marginal_likelihood", half)
    assert run(FIT)["correct"] is False


@pytest.mark.parametrize("what", ["value", "derivative"])
def test_fit_answer_altered(monkeypatch, what):
    whole = regression.log_marginal_likelihood

    class Scale(torch.autograd.Function):
        """The value times 1 + 2e-3 (twice its limit) forward, the derivative
        negated backward."""

        @staticmethod
        def forward(ctx, v):
            return v * (1 + 2e-3) if what == "value" else v.clone()

        @staticmethod
        def backward(ctx, g):
            return g if what == "value" else -g

    monkeypatch.setattr(regression, "log_marginal_likelihood",
                        lambda *a, **kw: Scale.apply(whole(*a, **kw)))
    assert run(FIT)["correct"] is False


def test_fit_step_without_answer(monkeypatch):
    """A factorization that breaks down on one step: no answer, not correct."""
    whole, calls = regression.log_marginal_likelihood, []

    def breaks(*a, **kw):
        calls.append(1)
        if len(calls) == 3:
            raise torch.linalg.LinAlgError("linalg.cholesky: not positive-definite")
        return whole(*a, **kw)

    monkeypatch.setattr(regression, "log_marginal_likelihood", breaks)
    result = run(FIT)
    assert result["correct"] is False and result["failed"] == 1
