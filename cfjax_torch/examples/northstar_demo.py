"""North-star demo (BASELINE config 5) on the port: GP regression at
n = 2^20 (~10^6) 2-D points, exact lazy MVMs feeding preconditioned CG,
NUTS over the lengthscale and variance (counterpart of
`examples/northstar_demo.py`).

    python -m cfjax_torch.examples.northstar_demo [n] [--quick] [--device cpu]

Pipeline, one function a stage:
  0. `warm_up`: the process's one-off cost, timed as its own stage so the
     others time their own work: torch.func's first `grad` imports
     torch._dynamo (seconds), which the Barnes-Hut far field's profile
     derivatives would otherwise pay inside the first MVM;
  1. `synthesize`: n points uniform on [-10, 10]^2, y = sin(x_0) cos(x_1 / 2)
     + 0.1 N(0, 1), the subset and the RMSE's probe rows; the same numpy
     draws, in the same order, as cfjax's demo;
  2. `subset_chain`: NUTS over (log l, log v) on the exact (Cholesky) logML
     of a 4096-point subset; 24 + 24 transitions with --quick, else 128 +
     128;
  3. `full_n_checks` (not with --quick): at the full n through the lazy
     stack, one slq logML value and gradient, then a short host NUTS chain
     over the slq logML with cut knobs (pseudo-marginal flavoured: the
     estimate is stochastic);
  4. `solve`: (v K + sigma^2 I) alpha = y by CG with a rank-1024 Nystrom
     preconditioner through the exact lazy Gramian's MVM (K1 on the card);
  5. `posterior_mean`: one linear (fixed-center) Barnes-Hut MVM, v K alpha,
     and its RMSE against the true field on 4096 rows (cfjax's stage);
  6. `exact_mean`: the same v K alpha through the exact lazy Gramian (one
     K1 launch on the card), and its RMSE: the demo's answer.

Stage 6 is the port's own. alpha cancels in K alpha (||K |alpha||| is
thousands of times ||K alpha||, more as the points grow denser), so the
treecode's error, small against K |alpha|, is large against the mean: at
n = 4096 cfjax's pipeline and the port's give the same Barnes-Hut RMSE,
several times the noise, where the exact MVM's is a fraction of it
(tests/test_torch_northstar.py). Both are printed; `main` returns the
exact one.

The card is the default device; --device cpu runs the same pipeline on
the CPU (the kernels' plain versions). The chains' draws differ from
cfjax's: its NUTS draws from a JAX PRNGKey, the port's from a
torch.Generator; the host chain draws from the seed cfjax derives from its
key. So (l, v) and the RMSE agree with cfjax's in distribution, not digit
for digit.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import config as _config
from ..barneshut import BarnesHutFactorization
from ..gp import log_marginal_likelihood, nuts_sample
from ..gp.hmc import nuts_sample_host
from ..kernels import EQ, Lengthscale
from ..kernels.derivatives import elementwise_derivatives
from ..operators import cg, gramian, nystrom_preconditioner
from ..utils.timing import sync_time

NOISE = 0.1          # the observations' noise standard deviation
SUBSET = 4096        # the exact-subset chain's points
PROBE_ROWS = 4096    # rows of the RMSE
# the seed cfjax's nuts_sample_host derives from its demo's PRNGKey(3)
# (jax.random.randint(key, (), 0, 2^31 - 1), 64-bit mode off)
HOST_SEED = 111646283
# the full-n host chain's slq knobs (cfjax's demo)
HOST_KNOBS = dict(probes=2, iters=10, tol=3e-2, maxiter=15)


def f_true(p):
    return torch.sin(p[:, 0]) * torch.cos(0.5 * p[:, 1])


def warm_up(device) -> None:
    """One profile derivative through torch.func on `device`: its first
    `grad` call in a process imports torch._dynamo."""
    elementwise_derivatives(EQ().profile, torch.zeros(1, device=device), 1)


def synthesize(n: int, seed: int = 0, dtype=torch.float32, device=None):
    """(x (n, 2), y (n,), subset rows, probe rows) in `dtype` on `device`
    (default the configured one) from `np.random.default_rng(seed)`: the
    uniform points, the standard normal noise, the subset (min(4096, n)
    rows) and the probe rows (min(4096, n)), drawn in cfjax's order."""
    device = _config.default_device(device)
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.uniform(-10, 10, (n, 2)), dtype=dtype, device=device)
    eps = torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=device)
    y = f_true(x) + NOISE * eps
    sub = rng.choice(n, min(SUBSET, n), replace=False)
    probe = rng.choice(n, min(PROBE_ROWS, n), replace=False)
    to = lambda idx: torch.as_tensor(idx, device=device)
    return x, y, to(sub), to(probe)


def _kernel(theta):
    """exp(log v) Lengthscale(EQ, exp(log l)) at theta = (log l, log v)."""
    return Lengthscale(EQ(), torch.exp(theta[0])) * torch.exp(theta[1])


def subset_chain(x, y, sub, quick: bool = False):
    """NUTS over theta = (log l, log v) under a N(0, I) prior on the exact
    logML of the subset rows: 24 + 24 transitions (quick) or 128 + 128,
    tree depth 6, from 0, a torch.Generator seeded with 1. Returns a dict:
    samples, accept-stat, l_hat = exp(mean log l), v_hat, the sd of log l,
    the log density's evaluations."""
    xs, ys = x[sub], y[sub]
    evals = [0]

    def logpost(theta):
        evals[0] += 1
        lp = log_marginal_likelihood(_kernel(theta), xs, ys, noise=NOISE ** 2)
        return lp.double().cpu() - 0.5 * torch.sum(theta ** 2)

    ns, nw = (24, 24) if quick else (128, 128)
    samples, astat = nuts_sample(logpost, torch.zeros(2, dtype=torch.float64),
                                 torch.Generator().manual_seed(1), num_samples=ns,
                                 num_warmup=nw, max_tree_depth=6)
    mean = samples.mean(0)
    return dict(samples=samples, astat=float(astat), l_hat=float(torch.exp(mean[0])),
                v_hat=float(torch.exp(mean[1])),
                l_sd=float(samples[:, 0].std(correction=0)), evals=evals[0], m=xs.shape[0])


def full_n_checks(x, y, l_hat: float, v_hat: float):
    """The full-n likelihood through the lazy stack, no subsampling: one
    slq logML value and gradient at (log l_hat, log v_hat) (4 probes, 24
    Lanczos steps, solves to 1e-3 in at most 60 iterations), then host NUTS
    over the slq logML with HOST_KNOBS (3 warm-up, 8 samples, depth 2,
    initial step 0.02). Returns a dict: value, gradient, samples,
    accept-stat, and the two walls."""
    def logml(theta, probes, iters, tol, maxiter):
        return log_marginal_likelihood(_kernel(theta), x, y, noise=NOISE ** 2, probes=probes,
                                       lanczos_iters=iters, solve_tol=tol,
                                       solve_maxiter=maxiter)

    th0 = torch.log(torch.tensor([l_hat, v_hat], dtype=torch.float64))

    def value_and_grad():
        th = th0.clone().requires_grad_(True)
        val = logml(th, 4, 24, 1e-3, 60)
        return float(val.detach()), torch.autograd.grad(val, th)[0]

    (val, grad), t_grad = sync_time(value_and_grad, x.device)

    def logpost(theta):
        kn = HOST_KNOBS
        lp = logml(theta, kn["probes"], kn["iters"], kn["tol"], kn["maxiter"])
        return lp.double().cpu() - 0.5 * torch.sum(theta ** 2)

    (s, a), t_chain = sync_time(lambda: nuts_sample_host(
        logpost, th0, HOST_SEED, num_samples=8, num_warmup=3, max_tree_depth=2,
        init_step=0.02, verbose=True), x.device)
    return dict(value=val, grad=grad, samples=s, astat=float(a), grad_s=t_grad,
                chain_s=t_chain)


def solve(x, y, l_hat: float, v_hat: float):
    """alpha = (v K + sigma^2 I)^-1 y for K = Lengthscale(EQ, l_hat) on x: CG
    to 1e-4 in at most 100 iterations through the lazy Gramian's exact MVM
    (K1 on the card), preconditioned by the rank-1024 Nystrom approximation
    of (K + sigma^2 / v I)^-1 / v.
    Returns a dict: alpha, iterations, residual norm, the Gramian, and
    the walls of the Nystrom build and of the PCG."""
    k = Lengthscale(EQ(), l_hat)
    G = gramian(k, x)
    sigma2 = NOISE ** 2
    M, t_nys = sync_time(lambda: nystrom_preconditioner(k, x, sigma2 / v_hat, rank=1024),
                         x.device)
    Kmv = lambda v: v_hat * G._matvec(v) + sigma2 * v
    Mv = lambda v: M(v) / v_hat    # ~ (v (K + sigma^2 / v I))^-1
    (alpha, (iters, res)), t_pcg = sync_time(lambda: cg(Kmv, y, tol=1e-4, maxiter=100, M=Mv),
                                             x.device)
    return dict(alpha=alpha, iters=int(iters), res=float(res), G=G, k=k, nystrom_s=t_nys,
                pcg_s=t_pcg)


def posterior_mean(k, x, alpha, v_hat: float):
    """The posterior mean at the training points, v K alpha, by one linear
    (fixed-center) Barnes-Hut MVM at theta 1/2 (cfjax's stage, which it
    calls sound for one forward application; alpha's cancellation makes it
    not: the module's docstring). Returns
    a dict: mean, the factorization, and the walls of its build, of its
    interaction plans (made at first use) and of the MVM."""
    F, t_build = sync_time(lambda: BarnesHutFactorization(k, x, theta=0.5), x.device)
    _, t_plan = sync_time(lambda: F.plans, x.device)
    mean, t_mvm = sync_time(lambda: v_hat * F.matvec_linear(alpha), x.device)
    return dict(mean=mean, F=F, build_s=t_build, plan_s=t_plan, mvm_s=t_mvm)


def exact_mean(G, alpha, v_hat: float):
    """The posterior mean at the training points, v K alpha, through the
    exact lazy Gramian's MVM (K1 on the card). Returns (mean, wall)."""
    return sync_time(lambda: v_hat * (G @ alpha), alpha.device)


def rmse(mean, x, probe) -> float:
    """RMSE of the posterior mean against the true field on the probe rows."""
    return float(torch.sqrt(torch.mean((mean[probe] - f_true(x)[probe]) ** 2)))


def main(n: int = 1 << 20, quick: bool = False, device=None):
    """The whole pipeline on `device` (default the configured one: the
    card), printing cfjax's lines and the exact mean's. Returns (the exact
    mean's RMSE, the walls of each stage in seconds (`warm_up`'s first), what each stage made:
    the data, the chain's, full-n checks' (None with quick), solve's and
    the Barnes-Hut mean's dicts, the exact mean and both RMSEs)."""
    device = _config.default_device(device)
    _, t_setup = sync_time(lambda: warm_up(device), device)
    print(f"setup (torch.func's first grad imports torch._dynamo): {t_setup:.2f}s", flush=True)
    x, y, sub, probe = synthesize(n, device=device)

    chain, t = sync_time(lambda: subset_chain(x, y, sub, quick), device)
    walls = {"setup_s": t_setup, "chain_s": t}
    print(f"NUTS ({t:.1f}s, subset m={chain['m']}): accept-stat={chain['astat']:.2f}, "
          f"lengthscale={chain['l_hat']:.3f} (post sd of log l {chain['l_sd']:.3f}), "
          f"variance={chain['v_hat']:.3f}", flush=True)
    l_hat, v_hat = chain["l_hat"], chain["v_hat"]

    full = None
    if not quick:
        full = full_n_checks(x, y, l_hat, v_hat)
        walls.update(full_grad_s=full["grad_s"], full_chain_s=full["chain_s"])
        print(f"SLQ logML+grad at FULL n={n} (lazy stack): {full['grad_s']:.1f}s, "
              f"logML={full['value']:.4g}, grad={full['grad'].numpy()}", flush=True)
        s = full["samples"]
        print(f"full-n NUTS ({full['chain_s']:.1f}s, n={n}, 8 samples after 3 warmup, SLQ "
              f"knobs {HOST_KNOBS}): accept-stat={full['astat']:.2f}, post "
              f"log-lengthscale={float(s[:, 0].mean()):.3f}+-"
              f"{float(s[:, 0].std(correction=0)):.3f} (subset chain: "
              f"{float(chain['samples'][:, 0].mean()):.3f}+-{chain['l_sd']:.3f}), post "
              f"log-variance={float(s[:, 1].mean()):.3f}", flush=True)

    sol = solve(x, y, l_hat, v_hat)
    walls.update(nystrom_s=sol["nystrom_s"], pcg_s=sol["pcg_s"])
    print(f"Nystrom preconditioner (rank 1024, {x.dtype} build on {device}): "
          f"{sol['nystrom_s']:.1f}s", flush=True)
    print(f"PCG (n={n}, exact lazy MVM): {sol['pcg_s']:.1f}s, {sol['iters']} iters, rel res "
          f"{sol['res'] / float(torch.linalg.norm(y)):.2e}", flush=True)

    pm = posterior_mean(sol["k"], x, sol["alpha"], v_hat)
    walls.update(bh_build_s=pm["build_s"], bh_plan_s=pm["plan_s"], bh_mvm_s=pm["mvm_s"])
    print(f"BH build: {pm['build_s']:.1f}s (max_open={pm['F'].max_open}), plans "
          f"{pm['plan_s']:.1f}s", flush=True)
    print(f"posterior-mean BH MVM: {pm['mvm_s']:.2f}s", flush=True)
    err_bh = rmse(pm["mean"], x, probe)
    print(f"posterior mean RMSE vs true field (n={n}): {err_bh:.4f} (noise={NOISE})", flush=True)
    mean, walls["exact_mvm_s"] = exact_mean(sol["G"], sol["alpha"], v_hat)
    err = rmse(mean, x, probe)
    print(f"posterior mean through the exact lazy MVM: {walls['exact_mvm_s']:.2f}s, RMSE vs "
          f"true field {err:.4f} (noise={NOISE})", flush=True)
    return err, walls, dict(data=(x, y, sub, probe), chain=chain, full=full, solve=sol,
                            bh=pm, mean=mean, rmse_bh=err_bh, rmse=err)


if __name__ == "__main__":
    args = sys.argv[1:]
    device = args[args.index("--device") + 1] if "--device" in args else None
    pos = [a for i, a in enumerate(args)
           if not a.startswith("--") and (i == 0 or args[i - 1] != "--device")]
    main(int(pos[0]) if pos else 1 << 20, quick="--quick" in args, device=device)
