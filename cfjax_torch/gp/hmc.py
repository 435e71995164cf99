"""HMC and NUTS over GP hyperparameters (counterpart of `cfjax.gp.hmc`,
the north-star demo's layer, BASELINE.json config 5).

`hmc_sample`: leapfrog HMC with dual-averaging step-size adaptation.
`nuts_sample`: the same recursion-free NUTS as cfjax's (dynamic doubling,
binary-checkpointed U-turn checks, Gumbel-max multinomial proposals within
a subtree, biased progressive sampling across subtrees), with the
`lax.while_loop` / `scan` control flow run as eager Python loops.
`nuts_sample_host`: the same algorithm by host recursion, one
value-and-gradient call per leapfrog, drawing from
`np.random.default_rng(seed)` as cfjax does after deriving its seed from
the key, so that its stream is cfjax's draw for draw.

theta is a float64 vector on the host; the log density may build its
kernel on the card and return a float32 scalar there, and its gradient
comes from torch autograd (through the logML's own backward, e.g. the
slq branch's Hutchinson / CG backward). Value-only evaluations run under
`torch.no_grad()`, where the Gramian MVMs may take the CUDA kernels.
"""

from __future__ import annotations

import math

import numpy as np
import torch


# the draws of hmc_sample and nuts_sample, one helper per kind, so that a
# test can feed another sampler's draws in their place
def _normal(generator, dim: int):
    """Standard normal momenta, float64 (dim,)."""
    return torch.randn(dim, generator=generator, dtype=torch.float64)


def _uniform(generator, low: float = 0.0) -> float:
    """A uniform draw on [low, 1)."""
    u = float(torch.rand((), generator=generator, dtype=torch.float64))
    return low + (1.0 - low) * u


def _direction(generator) -> bool:
    """NUTS's doubling direction: True for forward (a fair coin)."""
    return _uniform(generator) < 0.5


def _theta(theta0):
    return torch.as_tensor(theta0).detach().to(device="cpu", dtype=torch.float64).clone()


# A log density that cannot be evaluated because a factorization fails (a
# covariance that is not positive definite at a far leapfrog step) reads
# as NaN, and so does one at a non-finite theta, which such a NaN gradient
# leads to: the samplers reject the trajectory, as cfjax's do, whose
# Cholesky returns NaN where torch's raises.
def _value(logdensity, theta) -> float:
    if not bool(torch.isfinite(theta).all()):
        return math.nan
    try:
        with torch.no_grad():
            return float(logdensity(theta))
    except torch.linalg.LinAlgError:
        return math.nan


def _value_and_grad(logdensity, theta):
    th = theta.detach().clone().requires_grad_(True)
    if not bool(torch.isfinite(th).all()):
        return math.nan, torch.full_like(th, math.nan).detach()
    try:
        ld = logdensity(th)
        (g,) = torch.autograd.grad(ld, th)
    except torch.linalg.LinAlgError:
        return math.nan, torch.full_like(th, math.nan).detach()
    return float(ld.detach()), g.detach().to(device="cpu", dtype=torch.float64)


def _dual_averaging_update(h_bar, log_eps_bar, accept_stat, i, init_step, target_accept):
    """Nesterov dual averaging (one step), Stan's parameterization."""
    t = i + 1.0
    kappa, gamma, t0 = 0.75, 0.05, 10.0
    mu = math.log(10.0 * init_step)
    h_bar = (1 - 1 / (t + t0)) * h_bar + (target_accept - accept_stat) / (t + t0)
    log_eps = mu - math.sqrt(t) / gamma * h_bar
    log_eps_bar = t ** (-kappa) * log_eps + (1 - t ** (-kappa)) * log_eps_bar
    return h_bar, log_eps_bar, log_eps


def hmc_sample(logdensity, theta0, generator, num_samples: int = 500,
               num_warmup: int = 200, num_leapfrog: int = 16, init_step: float = 0.1,
               target_accept: float = 0.8):
    """Sample from logdensity(theta) (theta: a flat vector) by HMC with
    `num_leapfrog` steps a proposal, the step size adapted during the
    warmup. Draws come from the torch.Generator `generator`. Returns
    (samples (num_samples, dim) float64, mean acceptance probability)."""
    theta = _theta(theta0)
    dim = theta.shape[0]
    grad = lambda th: _value_and_grad(logdensity, th)[1]

    def leapfrog(th, p, eps):
        p = p + 0.5 * eps * grad(th)
        for _ in range(num_leapfrog - 1):
            th = th + eps * p
            p = p + eps * grad(th)
        th = th + eps * p
        return th, p + 0.5 * eps * grad(th)

    eps, h_bar, log_eps_bar = float(init_step), 0.0, math.log(init_step)
    thetas, aprobs = [], []
    for i in range(num_warmup + num_samples):
        p0 = _normal(generator, dim)
        ld0 = _value(logdensity, theta)
        theta_new, p_new = leapfrog(theta, p0, eps)
        ld1 = _value(logdensity, theta_new)
        log_accept = (ld1 - 0.5 * float(p_new @ p_new)) - (ld0 - 0.5 * float(p0 @ p0))
        if not math.isfinite(log_accept):
            log_accept = -math.inf
        accept_prob = math.exp(min(0.0, log_accept))
        if _uniform(generator) < accept_prob:
            theta = theta_new
        if i < num_warmup:
            h_bar, log_eps_bar, log_eps = _dual_averaging_update(
                h_bar, log_eps_bar, accept_prob, float(i), init_step, target_accept)
            eps = math.exp(log_eps)
        else:
            eps = math.exp(log_eps_bar)
        thetas.append(theta)
        aprobs.append(accept_prob)
    return (torch.stack(thetas[num_warmup:]) if num_samples else theta.new_zeros((0, dim)),
            torch.tensor(float(np.mean(aprobs[num_warmup:])) if num_samples else math.nan,
                         dtype=torch.float64))


def _popcount(i: int) -> int:
    return bin(i).count("1")


def _trailing_ones(i: int) -> int:
    c = 0
    while i & 1:
        c += 1
        i >>= 1
    return c


def _logaddexp(a: float, b: float) -> float:
    return float(np.logaddexp(a, b))


def nuts_sample(logdensity, theta0, generator, num_samples: int = 500,
                num_warmup: int = 200, max_tree_depth: int = 8, init_step: float = 0.1,
                target_accept: float = 0.8, max_delta_energy: float = 1000.0):
    """No-U-Turn sampler: dynamic doubling, multinomial state sampling,
    dual-averaging step adaptation, recursion-free. A subtree of 2^j
    leaves is built leaf by leaf with the binary-checkpoint U-turn test:
    only max_tree_depth + 1 states are stored, and leaf n is compared with
    the stored left ends of every power-of-two block that closes at n.
    Draws come from the torch.Generator `generator`.

    Returns (samples (num_samples, dim) float64, mean accept statistic)."""
    theta = _theta(theta0)
    dim = theta.shape[0]
    D = max_tree_depth
    vg = lambda th: _value_and_grad(logdensity, th)

    def leapfrog(th, p, g, eps):
        p_half = p + 0.5 * eps * g
        th_new = th + eps * p_half
        ld, g_new = vg(th_new)
        return th_new, p_half + 0.5 * eps * g_new, g_new, ld

    def turning(dth, p_left, p_right):
        return float(dth @ p_left) <= 0.0 or float(dth @ p_right) <= 0.0

    def build_subtree(edge, depth, direction, eps, H0):
        """Grow 2^depth leaves from edge = (theta, p, grad) in `direction`:
        (new edge, proposal, log weight, turning, diverging, sum of
        acceptance probabilities, leaves built)."""
        th, p, g = edge
        ck_th = torch.zeros((D + 1, dim), dtype=torch.float64)
        ck_p = torch.zeros((D + 1, dim), dtype=torch.float64)
        prop, best, logw, turn, div, alpha_sum = th, -math.inf, -math.inf, False, False, 0.0
        i = 0
        while i < 2 ** depth and not turn and not div:
            th, p, g, ld = leapfrog(th, p, g, direction * eps)
            dE = (-ld + 0.5 * float(p @ p)) - H0
            finite = math.isfinite(dE)
            div = div or dE > max_delta_energy or not finite
            lw = -dE if finite else -math.inf
            if not math.isnan(dE):
                alpha_sum += math.exp(min(0.0, -dE))
            # streaming multinomial draw within the subtree (Gumbel-max)
            score = lw - math.log(-math.log(_uniform(generator, 1e-12)))
            if score > best:
                prop, best = th, score
            logw = _logaddexp(logw, lw)
            if i % 2 == 0:
                ck_th[_popcount(i)], ck_p[_popcount(i)] = th, p
            else:
                # the momenta are the trajectory's: th_right - th_left is
                # direction * (th - checkpoint)
                hi = _popcount(i >> 1)
                for jj in range(hi - _trailing_ones(i) + 1, hi + 1):
                    turn = turn or turning(direction * (th - ck_th[jj]), ck_p[jj], p)
            i += 1
        return (th, p, g), prop, logw, turn, div, alpha_sum, float(i)

    def transition(th, eps):
        p0 = _normal(generator, dim)
        ld0, g0 = vg(th)
        H0 = -ld0 + 0.5 * float(p0 @ p0)
        z_minus = z_plus = (th, p0, g0)
        prop, logw, turn, div, depth, alpha_sum, n_alpha = th, 0.0, False, False, 0, 0.0, 0.0
        while depth < D and not turn and not div:
            direction = 1.0 if _direction(generator) else -1.0
            z_new, prop_sub, logw_sub, turn_sub, div_sub, a_sum, n_a = build_subtree(
                z_plus if direction > 0 else z_minus, depth, direction, eps, H0)
            ok = not turn_sub and not div_sub
            # biased progressive sampling: the new subtree's proposal with
            # probability min(1, w_sub / w_old)
            accept_new = math.log(_uniform(generator, 1e-38)) < logw_sub - logw
            if ok:
                if accept_new:
                    prop = prop_sub
                logw = _logaddexp(logw, logw_sub)
                if direction > 0:
                    z_plus = z_new
                else:
                    z_minus = z_new
            turn = turn or turn_sub or turning(z_plus[0] - z_minus[0], z_minus[1], z_plus[1])
            div = div or div_sub
            depth += 1
            alpha_sum += a_sum
            n_alpha += n_a
        return prop, alpha_sum / max(n_alpha, 1.0)

    eps, h_bar, log_eps_bar = float(init_step), 0.0, math.log(init_step)
    thetas, astats = [], []
    for i in range(num_warmup + num_samples):
        theta, accept_stat = transition(theta, eps)
        if i < num_warmup:
            h_bar, log_eps_bar, log_eps = _dual_averaging_update(
                h_bar, log_eps_bar, accept_stat, float(i), init_step, target_accept)
            eps = math.exp(log_eps)
        else:
            eps = math.exp(log_eps_bar)
        thetas.append(theta)
        astats.append(accept_stat)
    return (torch.stack(thetas[num_warmup:]) if num_samples else theta.new_zeros((0, dim)),
            torch.tensor(float(np.mean(astats[num_warmup:])) if num_samples else math.nan,
                         dtype=torch.float64))


def nuts_sample_host(logdensity, theta0, seed: int, num_samples: int = 100,
                     num_warmup: int = 50, max_tree_depth: int = 6, init_step: float = 0.1,
                     target_accept: float = 0.8, max_delta_energy: float = 1000.0,
                     verbose: bool = False):
    """NUTS by host recursion: the algorithm of `nuts_sample` (dynamic
    doubling, multinomial state sampling, dual-averaging warmup), the tree
    built recursively, each leapfrog one value-and-gradient call of the
    log density. For log densities whose one evaluation takes seconds (the
    lazy slq logML at large n). Draws come from
    `np.random.default_rng(seed)`: cfjax's `nuts_sample_host` draws the
    same stream from the seed it derives from its key.

    Returns (samples (num_samples, dim) float64, mean accept statistic)."""
    theta0 = _theta(theta0).numpy()
    dim = theta0.shape[0]

    def vg(th):
        ld, g = _value_and_grad(logdensity, torch.from_numpy(th))
        return ld, g.numpy()

    rng = np.random.default_rng(seed)

    def leapfrog(th, p, g, eps):
        ph = p + 0.5 * eps * g
        th2 = th + eps * ph
        ld2, g2 = vg(th2)
        return th2, ph + 0.5 * eps * g2, g2, ld2

    def build(th, p, g, depth, v, eps, H0):
        """Subtree of 2^depth leaves from (th, p, g) in direction v:
        (minus state, plus state, proposal, log weight, ok, sum of
        acceptance probabilities, leaves); states are (th, p, g)."""
        if depth == 0:
            th2, p2, g2, ld2 = leapfrog(th, p, g, v * eps)
            H = ld2 - 0.5 * float(np.sum(p2 * p2))
            div = not np.isfinite(H) or (H0 - H) > max_delta_energy
            a = min(1.0, float(np.exp(min(H - H0, 0.0)))) if np.isfinite(H) else 0.0
            st = (th2, p2, g2)
            return st, st, th2, (H if not div else -np.inf), (not div), a, 1
        m1, p1_, prop1, lw1, ok1, a1, n1 = build(th, p, g, depth - 1, v, eps, H0)
        if not ok1:
            return m1, p1_, prop1, lw1, False, a1, n1
        edge = p1_ if v > 0 else m1
        m2, p2_, prop2, lw2, ok2, a2, n2 = build(edge[0], edge[1], edge[2], depth - 1, v,
                                                 eps, H0)
        minus = m1 if v > 0 else m2
        plus = p2_ if v > 0 else p1_
        lw = np.logaddexp(lw1, lw2)
        prop = prop2 if (np.log(rng.uniform() + 1e-300) < lw2 - lw) else prop1
        dth = plus[0] - minus[0]
        uturn = (np.dot(dth, minus[1]) < 0) or (np.dot(dth, plus[1]) < 0)
        return minus, plus, prop, lw, (ok2 and not uturn), a1 + a2, n1 + n2

    th = theta0
    ld, g = vg(theta0)
    eps = float(init_step)
    h_bar, log_eps_bar = 0.0, float(np.log(init_step))
    samples = np.empty((num_samples, dim))
    astats = []
    for i in range(num_warmup + num_samples):
        p0 = rng.standard_normal(dim)
        H0 = ld - 0.5 * float(np.sum(p0 * p0))
        minus = plus = (th, p0, g)
        prop, lw = th, H0
        asum, aleaves = 0.0, 0
        for depth in range(max_tree_depth):
            v = 1 if rng.uniform() < 0.5 else -1
            edge = plus if v > 0 else minus
            m2, p2_, prop2, lw2, ok, a2, n2 = build(edge[0], edge[1], edge[2], depth, v,
                                                    eps, H0)
            asum += a2
            aleaves += n2
            if not ok:
                break
            # biased progressive sampling (favours the new subtree)
            if np.log(rng.uniform() + 1e-300) < lw2 - lw:
                prop = prop2
            lw = np.logaddexp(lw, lw2)
            minus = m2 if v < 0 else minus
            plus = p2_ if v > 0 else plus
            dth = plus[0] - minus[0]
            if (np.dot(dth, minus[1]) < 0) or (np.dot(dth, plus[1]) < 0):
                break
        if prop is not th:
            th = prop
            ld, g = vg(th)
        accept_stat = asum / max(aleaves, 1)
        if i < num_warmup:
            h_bar, log_eps_bar, log_eps = _dual_averaging_update(
                h_bar, log_eps_bar, accept_stat, i, init_step, target_accept)
            eps = math.exp(log_eps)
        else:
            eps = math.exp(log_eps_bar) if num_warmup else eps
            samples[i - num_warmup] = th
            astats.append(accept_stat)
        if verbose:
            print(f"  nuts_host step {i + 1}/{num_warmup + num_samples}: eps={eps:.4f} "
                  f"accept_stat={accept_stat:.2f} leaves={aleaves}", flush=True)
    return (torch.from_numpy(samples),
            torch.tensor(float(np.mean(astats)) if astats else 0.0, dtype=torch.float64))
