"""The BASELINE table on the card: the port's twin of cfjax's
`benchmarks/run_baseline.py`, one row for each of its 44 configurations.

    python3 -m cfjax_torch.benchmarks.run_baseline [group ...] [--write]
        [--device cpu] [--scale tiny] [--skip-heavy] [--rows NAME,...]
        [--row-timeout SECONDS] [--commit SHA] [--out PATH]

Groups, in cfjax's order: dense_mvm, dense_sweep, toeplitz, kronecker,
gradient, hessian, barneshut, sparse, logml, refined (all by default).
Each builds what cfjax's group builds, with the same seeds, shapes,
kernels, tolerances and iteration caps, through the port's public API,
float32 on the card. A row:

  * `config`: cfjax's name, the one-pass tier's `_bf16` suffix written
    `_tf32` (tf32 is this card's one-pass tier); `cfjax_config`: cfjax's;
  * `seconds`: slope timing (`time_chained`) for an operation that can be
    chained, `time_dispatch` for one that cannot and for the two
    host-bound derivative MVMs (their slope hides in the host's spread),
    a wall for a build; `device_ms` from a CUDA graph where the call can
    be captured;
  * `ref_seconds` (BASELINE.md's reference number on its CPU, or null) and
    `speedup`;
  * `bound_ms` and `bound_by` (the operation's least work over the card's
    peaks, `utils/roofline.py`: each work model sits beside what it
    measures), `share` and `share_device` from `summarize`; null where no
    work model is counted (construction, builds, plans);
  * `rel_err_f64` and `err_bound`: the row's vector or residual against
    float64 on sampled rows, and the limit the row states;
  * `route`: the kernels whose launch counters moved while the row was
    timed (K1, "K1 many-column", "K1 Matern", K2, K3, K4), else "plain";
    `expect`: the kernel the row is there to run, or null;
  * `valid` and `why`: a row that raises, cannot be told from the timing
    spread (a chained row: in none of `CHAINED_ATTEMPTS` timings), reads
    above 105% of a peak, misses its error limit or, on the
    card, did not launch its kernel, is invalid with the reason; the run
    goes on, and exits non-zero at its end.

Heavy rows (`HEAVY`: the n = 10^6 Barnes-Hut and Nystrom / PCG rows, both
2^20 SLQ logML rows, `refined_solve_clustered_n1e5`) run unless
`--skip-heavy`; `--row-timeout` stops a row at that wall, written
invalid with `why: "not run: ..."`. `--scale tiny` shrinks every n (and
each d that sets a row's cost) to a few hundred points, keeping each
row's kernel, structure and knobs: for the CPU tests. `--write` (the card
at full scale only) merges the rows into `results_h100.json` beside this
file (written to `--out` when given), a header with the card's name,
power limit, commit and date for each run; the markdown table is printed; cfjax's BENCHMARKS.md and `benchmarks/` are
never touched. The v5e slot calibration of cfjax's script describes a TPU
and is not ported.
"""

from __future__ import annotations

import argparse
import json
import math
import signal
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

from .. import config as _config
from ..ops import gramian_mvm as mvm
from ..utils.roofline import Work, summarize
from ..utils.testing import kernel_runs
from ..utils.timing import MeasurementError, graph_ms, sync_time, time_chained, time_dispatch
from .common import DEVICES, card, commit, take_device

RESULTS = Path(__file__).resolve().parent / "results_h100.json"

# cfjax's configurations by group, in its order (benchmarks/results.json)
GROUPS = {
    "dense_mvm": ["dense_mvm_maternp2_n16384_d3", "dense_mvm_maternp2_n16384_d3_pallas"],
    "dense_sweep": ["northstar_dense_mvm_eq_n16384_d3", "northstar_dense_mvm_eq_n16384_d64",
                    "northstar_dense_mvm_eq_n16384_d64_bf16",
                    "northstar_dense_mvm_eq_n16384_d256",
                    "northstar_dense_mvm_eq_n16384_d256_bf16",
                    "northstar_dense_mvm_eq_n16384_d1024",
                    "northstar_dense_mvm_eq_n16384_d1024_bf16"],
    "toeplitz": ["toeplitz_construct_exp_n65536", "toeplitz_fft_mvm_n65536",
                 "toeplitz_solve_pcg_noisy_n65536", "toeplitz_levinson_n16384"],
    "kronecker": ["kronecker_construct_eq3_128cubed", "kronecker_factor_col_eval_128",
                  "kronecker_mvm_eq3_128cubed", "kronecker_cholesky_eq3_128cubed",
                  "kronecker_solve_eq3_128cubed"],
    "gradient": ["gradient_mvm_maternp2_n1024_d1024", "gradient_solve_maternp2_n1024_d1024",
                 "gradient_mvm_eq_n4096_d16", "gradient_mvm_eq_n4096_d16_bf16",
                 "gradient_mvm_composite_n1024_d1024"],
    "hessian": ["hessian_mvm_eq_n128_d16"],
    "barneshut": ["barneshut_build_n65536_d2", "barneshut_plan_build_n65536",
                  "barneshut_mvm_theta0.5_n65536", "barneshut_mvm_theta0.25_n65536",
                  "barneshut_build_n1e6_d2", "barneshut_plan_build_n1e6",
                  "barneshut_mvm_theta0.5_n1e6", "nystrom_precond_build_rank1024_n1e6",
                  "gp_solve_nystrom_pcg_exact_n1e6_box20_rank1024",
                  "nystrom_precond_build_rank2048_n1e6",
                  "gp_solve_nystrom_pcg_exact_n1e6_box20_rank2048"],
    "sparse": ["sparsify_build_eq_n16384_d32", "sparse_mvm_eq_n16384_d32",
               "sparsify_tree_build_n250k_d2", "sparse_lazy_mvm_n250k_d2"],
    "logml": ["logml_kronecker_eq3_64cubed", "logml_slq_eq_n65536_d3",
              "logml_slq_eq_n2pow20_d2", "logml_slq_eq_n2pow20_d2_grad"],
    "refined": ["refined_solve_clustered_n1e5"],
}
HEAVY = frozenset(GROUPS["barneshut"][4:] + GROUPS["logml"][2:] + GROUPS["refined"])

# the reference's numbers (BASELINE.md, on its CPU) as cfjax's table states
# them, seconds; NaN where it has none
REF = {
    "dense_mvm_maternp2_n16384_d3": 0.585, "dense_mvm_maternp2_n16384_d3_pallas": 0.585,
    "toeplitz_construct_exp_n65536": 0.572e-3 * 4, "toeplitz_fft_mvm_n65536": 1.068e-3 * 4,
    "toeplitz_solve_pcg_noisy_n65536": 0.173 * 16, "toeplitz_levinson_n16384": 0.173,
    "kronecker_construct_eq3_128cubed": 23e-6, "kronecker_mvm_eq3_128cubed": 22.6e-3,
    "kronecker_cholesky_eq3_128cubed": 3.13e-3, "kronecker_solve_eq3_128cubed": 62.5e-3,
    "gradient_mvm_maternp2_n1024_d1024": 0.394, "gradient_solve_maternp2_n1024_d1024": 0.817,
    "gradient_mvm_composite_n1024_d1024": 3.14, "hessian_mvm_eq_n128_d16": 0.077,
    "barneshut_build_n65536_d2": 0.077, "barneshut_mvm_theta0.5_n65536": 0.083,
    "barneshut_mvm_theta0.25_n65536": 0.223, "sparsify_build_eq_n16384_d32": 7.21,
    "sparse_mvm_eq_n16384_d32": 0.45e-3,
}

# error limits (relative L2 against float64 unless said), each the limit
# of the chip_smoke.py check of the same path
K1_BOUND = 1e-5                                    # K1, and the FFT / mode-product MVMs
TIER_BOUND = {"K2": {"highest": 1e-5, "default": 2e-3},
              "K3": {"highest": 3e-5, "default": 1e-2}}
DERIV_BOUND = 2e-6        # the plain Hessian and composite gradient MVMs (phase 26)
K4_BOUND = 1e-5           # K4 against its float64 plain version
SOLVE_BOUND = 1e-4        # a float32 solve's float64 residual at tol <= 1e-5 (phase 12)
BH_REF_ERR = {0.5: 1.17e-2, 0.25: 4.29e-3}   # the reference README's treecode errors
BH_N6_ERR = 2e-2          # the treecode at 10^6 against 16 exact rows (phase 18)
BACKWARD_BOUND = 1e-12    # the float64 Kronecker solve's backward error (phase 14)
LEVINSON_BOUND = 1e-8     # the float64 Levinson solve's residual (phase 12)

SIZES = {
    "full": dict(dense_n=16384, sweep_n=16384, sweep_d=(3, 64, 256, 1024), sweep_rows=128,
                 toe_n=65536, lev_n=16384, kron_m=128, kron_reps=50, readme_n=1024,
                 readme_d=1024, drv_n=4096, drv_d=16, drv_rows=32, hess_n=128, hess_d=16,
                 bh_n=65536, bh_rows=256, bh_n3=1_000_000, bh_rows3=16, ranks=(1024, 2048),
                 resid_rows=16384, sp_n=16384, sp_d=32, tree_n=250_000, lml_m=64,
                 slq_n=65536, n20=1 << 20, ref_n=100_000, ref_rank=768,
                 timing=dict(repeats=5, time_budget=20.0)),
    "tiny": dict(dense_n=256, sweep_n=256, sweep_d=(3, 17, 24, 32), sweep_rows=32,
                 toe_n=512, lev_n=256, kron_m=8, kron_reps=5, readme_n=24, readme_d=24,
                 drv_n=64, drv_d=8, drv_rows=8, hess_n=16, hess_d=4, bh_n=512, bh_rows=64,
                 bh_n3=1024, bh_rows3=16, ranks=(256, 512), resid_rows=256, sp_n=256, sp_d=32,
                 tree_n=512, lml_m=6, slq_n=512, n20=1024, ref_n=512, ref_rank=32,
                 timing=dict(repeats=3, time_budget=2.0)),
}

# a chained row is timed at most this many times before it reads invalid
CHAINED_ATTEMPTS = 3

KERNEL_NAMES = {"direct": "K1", "direct_cols": "K1 many-column", "matern": "K1 Matern",
                "expand": "K2", "expand_matern": "K2 Matern", "grad": "K3",
                "grad_matern": "K3 Matern", "tile_ell": "K4"}


def port_name(cfjax_config: str) -> str:
    """The port's name of a cfjax configuration: its one-pass tier is tf32."""
    return cfjax_config[:-5] + "_tf32" if cfjax_config.endswith("_bf16") else cfjax_config


class RowTimeout(Exception):
    pass


def judge(seconds, work=None, device_ms=None) -> dict:
    """Validity and shares of a reading: invalid when it could not be told
    from the spread (a MeasurementError), is not positive, or implies more
    than 105% of a peak (`summarize`, on the call and on the device time)."""
    if isinstance(seconds, MeasurementError):
        return {"valid": False, "seconds": None,
                "why": f"not separable from the timing spread; upper bound "
                       f"{seconds.upper_bound:.2e} s"}
    out = {"valid": True, "seconds": seconds}
    if not seconds > 0:
        return dict(out, valid=False, why=f"non-positive measurement {seconds}")
    if work is not None:
        out.update(bound_ms=work.roofline_seconds() * 1e3, bound_by=work.bound())
        for key, t in (("share", seconds), ("share_device", device_ms and device_ms / 1e3)):
            if t is None:
                continue
            s = summarize(work, t)
            if not s["valid"]:
                return dict(out, valid=False, why=s["why"])
            out[key] = s["roofline_pct"]
    return out


class Run:
    """One run of the table: the device, the scale, the rows so far."""

    def __init__(self, device="cuda", scale="full", dtype=torch.float32, skip_heavy=False,
                 rows=None, row_timeout=None, keep=None, echo=True):
        self.device = torch.device(device)
        self.size = SIZES[scale]
        self.scale = scale
        self.dtype = dtype
        self.skip_heavy = skip_heavy
        self.only = None if rows is None else set(rows)
        self.row_timeout = row_timeout
        self.rows = []
        self.keep = keep   # a dict: each row's operands and outputs as numpy arrays
        self.echo = echo   # print each row as a JSON line

    def t(self, arr, dtype=None):
        return torch.tensor(np.asarray(arr), dtype=dtype or self.dtype, device=self.device)

    def wants(self, config: str) -> bool:
        return ((self.only is None or config in self.only or port_name(config) in self.only)
                and not (self.skip_heavy and config in HEAVY))

    def hold(self, config, **arrays):
        """Keep a row's operands and outputs for the parity tests."""
        if self.keep is not None:
            self.keep[config] = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                                     else v) for k, v in arrays.items()}

    @contextmanager
    def _deadline(self):
        if not self.row_timeout:
            yield
            return

        def stop(signum, frame):
            raise RowTimeout(f"not run: stopped at the row's wall of {self.row_timeout:.0f} s")

        old = signal.signal(signal.SIGALRM, stop)
        signal.alarm(int(math.ceil(self.row_timeout)))
        try:
            yield
        finally:
            signal.alarm(0)
            signal.signal(signal.SIGALRM, old)

    def row(self, config, fn, expect=None, err_bound=None, note=""):
        """Run fn() -> {"seconds", and any of "work", "device_ms", "err",
        "note", "spread", "retimed"} as the row `config`; launches are counted over
        fn's run, its float64 check included only where it runs under
        `mvm.uncounted()`."""
        if not self.wants(config):
            return None
        before = dict(mvm.LAUNCHES)
        t0 = time.perf_counter()
        try:
            with self._deadline():
                out = fn()
        except RowTimeout as e:
            out = {"error": str(e)}
        except Exception as e:   # a row that raises is reported, and the run goes on
            out = {"error": f"{type(e).__name__}: {e}"}
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {key: mvm.LAUNCHES[key] - before[key] for key in before
                    if mvm.LAUNCHES[key] > before[key]}
        row = {"config": port_name(config), "cfjax_config": config, "heavy": config in HEAVY}
        if "error" in out:
            row.update(valid=False, why=out["error"], seconds=None)
        else:
            row.update(judge(out["seconds"], out.get("work"), out.get("device_ms")))
        ref = REF.get(config, math.nan)
        err = out.get("err")
        row.update(device_ms=out.get("device_ms"), ref_seconds=None if math.isnan(ref) else ref,
                   rel_err_f64=err, err_bound=err_bound,
                   route=" + ".join(KERNEL_NAMES[k] for k in launches) or "plain",
                   expect=expect, launches=launches, wall_s=wall,
                   note="; ".join(s for s in (note, out.get("note", ""), out.get("retimed", ""))
                                  if s))
        for key in ("bound_ms", "bound_by", "share", "share_device", "why"):
            row.setdefault(key, None)
        if row["valid"]:
            spread = out.get("spread")
            if spread is not None and row["seconds"] < 2 * spread:
                row["note"] += (f" [below the launch floor's spread ±{spread * 1e3:.3f} ms: "
                                "approximate]")
            if ref == ref:
                row["speedup"] = ref / row["seconds"]
            if err_bound is not None and not (err is not None and err <= err_bound):
                row.update(valid=False, why=f"float64 error {err} above the row's limit "
                                            f"{err_bound:.0e}")
            elif (expect and self.device.type == "cuda"
                  and not any(KERNEL_NAMES[k] == expect for k in launches)):
                row.update(valid=False, why=f"{expect} was not launched (route {row['route']})")
        row.setdefault("speedup", None)
        self.rows.append(row)
        if self.echo:
            print(json.dumps(row), flush=True)
        return row

    # ---- timers ----
    def chained(self, step, v0, iters=(4, 36), work=None, repeats=None):
        """A chained row's reading: slope seconds, device ms from a CUDA graph.
        A slope that a burst of host load hides is timed afresh, up to
        `CHAINED_ATTEMPTS` times in all; the reading kept is one that
        separated on its own, and the note names the attempts that did not."""
        timing = dict(self.size["timing"])
        if repeats and self.scale == "full":
            timing["repeats"] = repeats
        missed = []
        for _ in range(CHAINED_ATTEMPTS):
            try:
                s = time_chained(step, v0, iters=iters, **timing)
                break
            except MeasurementError as e:
                s = e
                missed.append(f"{e.upper_bound:.2e} s")
        dev = None
        if self.device.type == "cuda" and not isinstance(s, MeasurementError):
            dev = float(np.median(graph_ms(lambda: step(v0), 10, 3)))
        out = {"seconds": s, "device_ms": dev, "work": work}
        if missed and not isinstance(s, MeasurementError):
            out["retimed"] = (f"timed at attempt {len(missed) + 1}: the slope did not "
                              f"separate from the spread before (upper bounds "
                              f"{', '.join(missed)})")
        return out

    def per_call(self, step, v0, work=None):
        """A host-bound call's reading: the median of 9 calls, each to a
        synchronize, less the launch floor (`time_dispatch`), and device ms
        from a CUDA graph. For calls of tens of milliseconds of Python whose
        slope the host's spread hides."""
        s, spread = time_dispatch(step, v0, iters=9)
        dev = (float(np.median(graph_ms(lambda: step(v0), 10, 3)))
               if self.device.type == "cuda" else None)
        return {"seconds": s, "spread": spread, "device_ms": dev, "work": work}

    def dispatch(self, fn, *args, iters=5, repeats=2):
        """(seconds, the launch floor's spread) of a call that cannot be chained."""
        if not args:
            anchor = torch.zeros(1, device=self.device)
            return time_dispatch(lambda _: fn(), anchor, iters=iters, repeats=repeats)
        return time_dispatch(fn, *args, iters=iters, repeats=repeats)

    def wall(self, fn):
        return sync_time(fn, self.device)


def check_rows(n, count, seed=1):
    """Sorted rows for a float64 check, from a generator of their own, so
    that the groups draw their data in cfjax's order."""
    return np.sort(np.random.default_rng(seed).choice(n, min(n, count), replace=False))


def rel(out, ref) -> float:
    return float(torch.linalg.norm(out.double() - ref) / torch.linalg.norm(ref))


def resid(r, b) -> float:
    """||r|| / ||b||: a residual's size relative to its right-hand side."""
    return float(torch.linalg.norm(r.double()) / torch.linalg.norm(b.double()))


def rows64(k, x, v, idx):
    """(K v)[idx] summed directly in float64 (K1's plain version)."""
    xd = x.double()
    return mvm.gramian_matvec_direct_plain(k, xd[idx], xd, v.double())


# --------------------------------------------------------------------------- groups


def bench_dense_mvm(run: Run):
    from ..kernels import MaternP
    from ..kernels.profile_spec import to_spec
    from ..operators import Gramian, explain

    z = run.size
    rng = np.random.default_rng(0)
    n, d = z["dense_n"], 3
    x = run.t(rng.standard_normal((n, d)))
    a = run.t(rng.standard_normal(n))
    k = MaternP(2)
    G = Gramian(k, x)
    prof = mvm.profile_ops(to_spec(k)[0])
    idx = torch.as_tensor(check_rows(n, 256), device=run.device)
    ref = rows64(k, x, a, idx)

    def auto():
        out = run.chained(G._matvec, a, work=mvm.work_direct(n, n, d, prof))
        with mvm.uncounted():
            b = G @ a
        run.hold("dense_mvm_maternp2_n16384_d3", x=x, a=a, out=b)
        return dict(out, err=rel(b[idx], ref), note=explain(k, x))

    run.row("dense_mvm_maternp2_n16384_d3", auto, expect="K1", err_bound=K1_BOUND,
            note="the Gramian's route at d = 3: K1's difference form")

    # cfjax forces its expansion kernel here (use_pallas="always"); the port
    # times the same operands through its expansion kernel's wrapper
    step = lambda v: mvm.gramian_matvec_expand(k, x, x, v)

    def forced():
        out = run.chained(step, a, work=mvm.work_expand(n, n, d, prof, passes=3))
        with mvm.uncounted():
            b = step(a)
        run.hold("dense_mvm_maternp2_n16384_d3_pallas", x=x, a=a, out=b)
        return dict(out, err=rel(b[idx], ref))

    run.row("dense_mvm_maternp2_n16384_d3_pallas", forced, expect="K2",
            err_bound=TIER_BOUND["K2"]["highest"],
            note="gramian_matvec_expand (K2) on the same operands, three tf32 passes")


def bench_dense_sweep(run: Run):
    """EQ at n = 16384, d = 3, 64, 256, 1024; each d > 16 at the three-pass
    ("highest") and one-pass ("default", tf32) tiers, each judged against the
    bound of its passes; the error on 128 rows of Lengthscale(EQ, sqrt(d))
    (whose off-diagonal mass is not negligible) against float64."""
    from ..kernels import EQ, Lengthscale
    from ..kernels.profile_spec import to_spec
    from ..operators import Gramian, explain
    from ..ops.tiles import tier_passes

    z = run.size
    rng = np.random.default_rng(0)
    n = z["sweep_n"]
    prof = mvm.profile_ops(to_spec(EQ())[0])
    shipped = _config.DEFAULT.matmul_precision
    try:
        for d in z["sweep_d"]:
            xn, an = rng.standard_normal((n, d)), rng.standard_normal(n)
            idx = rng.integers(0, n, z["sweep_rows"])
            x, a = run.t(xn), run.t(an)
            k_acc = Lengthscale(EQ(), float(np.sqrt(d)))
            xh = x.double()
            ii = torch.as_tensor(idx, device=run.device)
            x2h = (xh * xh).sum(1)
            Dx = torch.clamp(x2h[ii, None] + x2h[None, :] - 2.0 * (xh[ii] @ xh.T), min=0.0)
            exact = torch.exp(-Dx / (2 * d)) @ a.double()
            del Dx
            small = d <= _config.DEFAULT.direct_sqdist_max_d
            for prec, suffix in (("highest", ""), ("default", "_bf16")):
                if small and prec == "default":
                    continue   # d = 3 runs K1's difference form: no tensor-core product
                config = _sweep_name(d, z["sweep_d"]) + suffix
                _config.set_config(matmul_precision=prec)
                passes = tier_passes(prec)
                work = (mvm.work_direct(n, n, d, prof) if small
                        else mvm.work_expand(n, n, d, prof, passes=passes))
                G = Gramian(EQ(), x)
                Ga = Gramian(k_acc, x)

                def one(G=G, Ga=Ga, work=work, prec=prec, config=config, x=x, a=a):
                    out = run.chained(G._matvec, a, work=work)
                    with mvm.uncounted():
                        b = Ga @ a
                        run.hold(config, x=x, a=a, out=G @ a, out_acc=b, idx=idx)
                    return dict(out, err=rel(b[ii], exact),
                                note=f"matmul_precision={prec}; {explain(EQ(), x)}")

                run.row(config, one, expect="K1" if small else "K2",
                        err_bound=K1_BOUND if small else TIER_BOUND["K2"][prec],
                        note=f"{passes} tf32 pass{'es' if passes > 1 else ''}" if not small
                        else "")
    finally:
        _config.set_config(matmul_precision=shipped)


def _sweep_name(d, ds):
    """cfjax's name of the sweep row at this scale's d (the full-scale d at
    the same place in the sweep)."""
    return f"northstar_dense_mvm_eq_n16384_d{SIZES['full']['sweep_d'][list(ds).index(d)]}"


def bench_toeplitz(run: Run):
    from ..kernels import Exp
    from ..operators import cg, gramian, levinson
    from ..operators.toeplitz import work_fft_mvm, work_levinson
    from ..utils.grids import UniformGrid

    z = run.size
    rng = np.random.default_rng(0)
    n = z["toe_n"]
    k = Exp()
    grid = lambda num, dt=None: UniformGrid(0.0, 1.0 / num, num, device=run.device,
                                            dtype=dt or run.dtype)
    g = grid(n)
    T = gramian(k, g)
    T.col   # the lazy column's first evaluation

    def construct():
        s, spread = run.dispatch(lambda: gramian(k, g).col)
        return {"seconds": s, "spread": spread}

    run.row("toeplitz_construct_exp_n65536", construct,
            note="lazy gramian and its column's evaluation; ref scaled from n = 16384")
    a = run.t(rng.standard_normal(n))
    x = g.points()
    idx = torch.as_tensor(check_rows(n, 256), device=run.device)

    def fft_mvm():
        out = run.chained(T._matvec, a, work=work_fft_mvm(n, a.element_size()))
        b = T @ a
        run.hold("toeplitz_fft_mvm_n65536", a=a, out=b)
        return dict(out, err=rel(b[idx], rows64(k, x[:, None], a, idx)))

    run.row("toeplitz_fft_mvm_n65536", fft_mvm, err_bound=K1_BOUND,
            note="cuFFT through the 2n circulant embedding; ref scaled from n = 16384")
    Tn = T.add_diagonal(1e-2)
    b = Tn @ a
    Minv = T.strang_preconditioner()
    solve = lambda bb: cg(Tn._matvec, bb, tol=1e-5, maxiter=600, M=Minv)
    T64 = gramian(k, grid(n, torch.float64))

    def pcg():
        s, spread = run.dispatch(solve, b, iters=2)
        xs, (it, _) = solve(b)
        res = resid(T64 @ xs.double() + 1e-2 * xs.double() - b.double(), b)
        run.hold("toeplitz_solve_pcg_noisy_n65536", b=b, out=xs, iters=it)
        return {"seconds": s, "spread": spread, "err": res,
                "work": it * work_fft_mvm(n, a.element_size()),
                "note": f"{it} Strang-PCG iterations (the bound counts the operator's FFT "
                        "MVMs only); err: float64 residual"}

    run.row("toeplitz_solve_pcg_noisy_n65536", pcg, err_bound=SOLVE_BOUND,
            note="T + 1e-2 I, tol 1e-5, maxiter 600; ref Levinson scaled from n = 16384")
    n2 = z["lev_n"]
    T2 = gramian(k, grid(n2, torch.float64))
    b2 = T2 @ run.t(rng.standard_normal(n2), torch.float64)

    def lev():
        s, spread = run.dispatch(lambda: levinson(T2.col, b2), iters=2)
        xs = levinson(T2.col, b2)
        run.hold("toeplitz_levinson_n16384", b=b2, out=xs)
        return {"seconds": s, "spread": spread, "work": work_levinson(n2, 8),
                "err": resid(T2 @ xs - b2, b2), "note": "err: float64 residual"}

    run.row("toeplitz_levinson_n16384", lev, err_bound=LEVINSON_BOUND,
            note="float64: the float32 recurrence on this system (no noise, kappa ~ 2n) "
                 "returned NaN on the card, as cfjax's float32 one does on its CPU backend; "
                 "one Python step per k: latency-bound")


def bench_kronecker(run: Run):
    """separable("^", EQ(), d=3) on a 128^3 LazyGrid. The Cholesky and its
    solve run in float64: the factors are numerically singular (the EQ's
    eigenvalues fall below float32's eps), so a float32 Cholesky fails;
    cfjax's float32 factors are NaN (measured on its CPU backend)."""
    from ..kernels import EQ, separable
    from ..operators import DenseOperator, KroneckerOperator, gramian
    from ..operators.kronecker import work_kron_mvm, work_kron_solve
    from ..utils.grids import LazyGrid, UniformGrid

    z = run.size
    rng = np.random.default_rng(0)
    m = z["kron_m"]
    k = separable("^", EQ(), d=3)
    mk = lambda dt: LazyGrid(tuple(UniformGrid(0.0, 1.0 / m, m) for _ in range(3)),
                             device=run.device, dtype=dt)
    grid = mk(run.dtype)
    K = gramian(k, grid)

    def construct():
        reps = z["kron_reps"]
        t0 = time.perf_counter()
        for _ in range(reps):
            gramian(k, grid)
        return {"seconds": (time.perf_counter() - t0) / reps,
                "note": f"mean of {reps} host walls"}

    run.row("kronecker_construct_eq3_128cubed", construct,
            note="lazy construction (no kernel evaluation; the reference's is lazy too)")
    K.factors[0].col   # the column's first evaluation

    def col_eval():
        s, spread = run.dispatch(lambda: gramian(k, grid).factors[0].col)
        return {"seconds": s, "spread": spread}

    run.row("kronecker_factor_col_eval_128", col_eval,
            note="a fresh gramian's first factor column")
    n = m ** 3
    a = run.t(rng.standard_normal(n))
    grid64 = mk(torch.float64)
    K64 = gramian(k, grid64)

    def mvm_row():
        out = run.chained(K._matvec, a, iters=(2, 18), work=work_kron_mvm([m] * 3,
                                                                          a.element_size()))
        b = K @ a
        run.hold("kronecker_mvm_eq3_128cubed", a=a, out=b)
        return dict(out, err=rel(b, K64 @ a.double()))

    run.row("kronecker_mvm_eq3_128cubed", mvm_row, err_bound=K1_BOUND)

    def chol():
        K64.cholesky()
        s, spread = run.dispatch(lambda: K64.cholesky().Ls[0])
        return {"seconds": s, "spread": spread}

    run.row("kronecker_cholesky_eq3_128cubed", chol,
            note="float64: a float32 Cholesky of the singular factors fails")
    F = K64.cholesky()
    a64 = a.double()
    mats = [f.todense() + 1e-10 * torch.mean(torch.diagonal(f.todense()))
            * torch.eye(m, dtype=torch.float64, device=run.device) for f in K64.factors]
    KJ = KroneckerOperator([DenseOperator(M) for M in mats])
    norm = float(np.prod([float(torch.linalg.matrix_norm(M, 2)) for M in mats]))

    def solve_row():
        out = run.chained(F.solve, a64, iters=(2, 18), work=work_kron_solve([m] * 3, 8))
        xs = F.solve(a64)
        run.hold("kronecker_solve_eq3_128cubed", a=a64, out=xs)
        bwd = float(torch.linalg.norm(KJ @ xs - a64)
                    / (norm * torch.linalg.norm(xs) + torch.linalg.norm(a64)))
        return dict(out, err=bwd, note="err: backward error of the jittered system")

    run.row("kronecker_solve_eq3_128cubed", solve_row, err_bound=BACKWARD_BOUND,
            note="float64 per-factor Cholesky solve")


def bench_gradient(run: Run):
    from ..derivative import GradientKernel
    from ..derivative.gradient import work_gradient_mvm
    from ..kernels import EQ, Line, MaternP, NN
    from ..kernels.profile_spec import to_spec
    from ..operators import explain, gramian, solve_with_info
    from ..ops import grad_mvm as gmvm
    from ..ops.tiles import tier_passes

    z = run.size
    rng = np.random.default_rng(0)

    def block_rows64(k, x, v, idx):
        n, d = x.shape
        xd = x.double()
        return gmvm.grad_matvec_plain(k, xd[idx], xd, v.double().reshape(n, d))

    n, d = z["readme_n"], z["readme_d"]
    x = run.t(rng.standard_normal((n, d)))
    km = MaternP(2)
    G = gramian(GradientKernel(km), x)
    v = run.t(rng.standard_normal(n * d))
    jet = gmvm.jet_ops(to_spec(km, derivative=True)[0])
    idx = torch.as_tensor(check_rows(n, 32), device=run.device)

    def readme():
        out = run.chained(G._matvec, v, iters=(2, 18),
                          work=gmvm.work_grad(n, n, d, jet, tier_passes("highest")))
        with mvm.uncounted():
            b = G @ v
        run.hold("gradient_mvm_maternp2_n1024_d1024", x=x, v=v, out=b)
        return dict(out, err=rel(b.reshape(n, d)[idx], block_rows64(km, x, v, idx)),
                    note=explain(GradientKernel(km), x))

    run.row("gradient_mvm_maternp2_n1024_d1024", readme, expect="K3",
            err_bound=TIER_BOUND["K3"]["highest"])
    op = G.add_diagonal(1e-3)
    G64 = gramian(GradientKernel(km), x.double())

    def solve_row():
        # method="cg" is the route the automatic choice takes at n d = 2^20;
        # named, it stays the route at --scale tiny
        sv = lambda: solve_with_info(op, v, tol=1e-6, maxiter=200, method="cg")
        s, spread = run.dispatch(sv, iters=3, repeats=3)
        xs, (it, _) = sv()
        res = resid(G64 @ xs.double() + 1e-3 * xs.double() - v.double(), v)
        return {"seconds": s, "spread": spread, "err": res,
                "work": it * gmvm.work_grad(n, n, d, jet, tier_passes("highest")),
                "note": f"{it} CG iterations (the bound counts their K3 products); err: "
                        "float64 residual"}

    run.row("gradient_solve_maternp2_n1024_d1024", solve_row, expect="K3", err_bound=SOLVE_BOUND,
            note="K + 1e-3 I, CG tol 1e-6, maxiter 200")
    n, d = z["drv_n"], z["drv_d"]
    x = run.t(rng.standard_normal((n, d)))
    v = run.t(rng.standard_normal(n * d))
    idx = rng.integers(0, n, z["drv_rows"])
    ii = torch.as_tensor(idx, device=run.device)
    exact = block_rows64(EQ(), x, v, ii)
    jet = gmvm.jet_ops(to_spec(EQ(), derivative=True)[0])
    shipped = _config.DEFAULT.matmul_precision
    try:
        for prec, suffix in (("highest", ""), ("default", "_bf16")):
            _config.set_config(matmul_precision=prec)
            Gd = gramian(GradientKernel(EQ()), x)
            config = "gradient_mvm_eq_n4096_d16" + suffix

            def driver(Gd=Gd, prec=prec, config=config):
                out = run.chained(Gd._matvec, v, iters=(2, 18),
                                  work=gmvm.work_grad(n, n, d, jet, tier_passes(prec)))
                with mvm.uncounted():
                    b = Gd @ v
                run.hold(config, x=x, v=v, out=b)
                return dict(out, err=rel(b.reshape(n, d)[ii], exact),
                            note=f"matmul_precision={prec}")

            run.row(config, driver, expect="K3", err_bound=TIER_BOUND["K3"][prec],
                    note=f"BASELINE config 4, {tier_passes(prec)} tf32 pass"
                         f"{'es' if tier_passes(prec) > 1 else ''}")
    finally:
        _config.set_config(matmul_precision=shipped)
    n, d = z["readme_n"], z["readme_d"]
    x = run.t(rng.standard_normal((n, d)))
    kc = MaternP(2) + Line(1.0) ** 2 + NN(0.1)
    Gc = gramian(GradientKernel(kc), x)
    v = run.t(rng.standard_normal(n * d))

    def composite():
        out = run.per_call(Gc._matvec, v, work=work_gradient_mvm(n, d))
        b = Gc @ v
        run.hold("gradient_mvm_composite_n1024_d1024", x=x, v=v, out=b)
        ref = gramian(GradientKernel(kc), x.double()) @ v.double()
        return dict(out, err=rel(b, ref), note=f"mode {Gc.mode}")

    run.row("gradient_mvm_composite_n1024_d1024", composite, err_bound=DERIV_BOUND,
            note="the \"pair\" mode: one shared tile for the three terms, plain torch; "
                 "host-bound, timed a call at a time")


def bench_hessian(run: Run):
    from ..derivative import HessianKernel
    from ..derivative.hessian import work_hessian_mvm
    from ..kernels import EQ
    from ..operators import gramian

    z = run.size
    rng = np.random.default_rng(0)
    n, d = z["hess_n"], z["hess_d"]
    x = run.t(rng.standard_normal((n, d)))
    G = HessianKernel(EQ()).gramian(x)
    v = run.t(rng.standard_normal(n * d * d))

    def one():
        out = run.per_call(G._matvec, v, work=work_hessian_mvm(n, d))
        b = G @ v
        run.hold("hessian_mvm_eq_n128_d16", x=x, v=v, out=b)
        ref = gramian(HessianKernel(EQ()), x.double()) @ v.double()
        return dict(out, err=rel(b, ref))

    run.row("hessian_mvm_eq_n128_d16", one, err_bound=DERIV_BOUND,
            note="plain torch; host-bound, timed a call at a time")


def barneshut_draws(z, heavy: bool = True) -> dict:
    """The barneshut group's data as numpy arrays, drawn from seed 0 in
    cfjax's order (benchmarks/run_baseline.py:402-509): the README's points
    x, weights w, three fresh point sets and the rows idx; with `heavy`,
    the same at n = 10^6 (x3, w3, fresh3, i3) and config 5's points x5,
    uniform in the 20 x 20 box (y = sin(x5[:, 0]) + 0.1 w3)."""
    rng = np.random.default_rng(0)
    n, n3 = z["bh_n"], z["bh_n3"]
    out = dict(x=rng.standard_normal((n, 2)), w=rng.uniform(0, 1, n))
    out["fresh"] = [rng.standard_normal((n, 2)) for _ in range(3)]
    out["idx"] = rng.integers(0, n, z["bh_rows"])
    if heavy:
        out.update(x3=rng.standard_normal((n3, 2)), w3=rng.uniform(0, 1, n3))
        out["fresh3"] = [rng.standard_normal((n3, 2)) for _ in range(3)]
        out["i3"] = rng.integers(0, n3, z["bh_rows3"])
        out["x5"] = rng.uniform(-10, 10, (n3, 2))
    return out


def bench_barneshut(run: Run):
    """The reference README's treecode (EQ, n = 65536, d = 2), then config
    5's at n = 10^6 and its GP solve through the exact lazy MVM (K1) and
    rank-r Nystrom PCG. The points are drawn in cfjax's order up front:
    each row then finds its own whichever rows run."""
    from ..barneshut import BarnesHutFactorization
    from ..barneshut.bh import work_bh_mvm
    from ..kernels import EQ, Lengthscale
    from ..kernels.profile_spec import to_spec
    from ..operators import cg, gramian, nystrom_preconditioner

    z = run.size
    heavy = GROUPS["barneshut"][4:]
    draws = barneshut_draws(z, heavy=any(run.wants(c) for c in heavy))
    n = z["bh_n"]
    x, w = run.t(draws["x"]), run.t(draws["w"])
    fresh, idx = draws["fresh"], draws["idx"]
    BarnesHutFactorization(EQ(), x, theta=0.5)   # warm
    F = {}

    def build():
        best = float("inf")
        for xn in fresh:
            xx = run.t(xn)
            F[0.5], s = run.wall(lambda: BarnesHutFactorization(EQ(), xx, theta=0.5))
            best = min(best, s)
        F["x"] = xx
        return {"seconds": best, "note": "warm wall, min of 3 fresh-point builds"}

    if run.row("barneshut_build_n65536_d2", build) is None:
        build()
    x = F["x"]
    F[0.5].buckets

    def plan():
        _, s = run.wall(lambda: F[0.5].plans)
        return {"seconds": s, "note": "one-time host interaction-plan sweep"}

    if run.row("barneshut_plan_build_n65536", plan) is None:
        F[0.5].plans
    ii = torch.as_tensor(idx, device=run.device)
    exact = rows64(EQ(), x, w, ii)
    for theta, config in ((0.5, "barneshut_mvm_theta0.5_n65536"),
                          (0.25, "barneshut_mvm_theta0.25_n65536")):
        def mvm_row(theta=theta, config=config):
            if theta not in F:
                F[theta] = BarnesHutFactorization(EQ(), x, theta=theta)
            Ft = F[theta]
            # the host's share of a call varies: 9 samples a count, their
            # interquartile range as the spread
            out = run.chained(Ft._matvec, w, iters=(2, 18), repeats=9)
            b = Ft @ w
            run.hold(config, x=x, w=w, out=b, idx=idx, theta=theta)
            return dict(out, work=work_bh_mvm(Ft), err=rel(b[ii], exact),
                        note=f"reference error {BH_REF_ERR[theta]:.2e}; planned interaction "
                             "lists, plain torch")

        run.row(config, mvm_row, err_bound=2 * BH_REF_ERR[theta])
    del F
    if "x5" not in draws:
        return
    n3 = z["bh_n3"]
    x3, w3, x5 = run.t(draws["x3"]), run.t(draws["w3"]), run.t(draws["x5"])
    fresh3 = draws["fresh3"]
    i3 = torch.as_tensor(draws["i3"], device=run.device)
    F3 = {}
    if any(run.wants(c) for c in heavy[:3]):
        BarnesHutFactorization(EQ(), x3, theta=0.5)   # warm

        def build3():
            best = float("inf")
            for xn in fresh3:
                xx = run.t(xn)
                F3["F"], s = run.wall(lambda: BarnesHutFactorization(EQ(), xx, theta=0.5))
                best = min(best, s)
            F3["x"] = xx
            return {"seconds": best, "note": "warm wall, min of 3 fresh-point builds"}

        if run.row("barneshut_build_n1e6_d2", build3) is None:
            build3()
        F3["F"].buckets

        def plan3():
            _, s = run.wall(lambda: F3["F"].plans)
            return {"seconds": s, "note": "one-time host interaction-plan sweep"}

        if run.row("barneshut_plan_build_n1e6", plan3) is None:
            F3["F"].plans

        def mvm3():
            Ft, xx = F3["F"], F3["x"]
            out = run.chained(Ft._matvec, w3, iters=(2, 10), repeats=9)
            b = Ft @ w3
            return dict(out, work=work_bh_mvm(Ft), err=rel(b[i3], rows64(EQ(), xx, w3, i3)),
                        note=f"err vs {len(i3)} exact rows")

        run.row("barneshut_mvm_theta0.5_n1e6", mvm3, err_bound=BH_N6_ERR)
        F3.clear()
    del fresh3
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    # BASELINE config 5's solve: the exact lazy MVM (K1) and rank-r Nystrom
    # PCG, points uniform in a 20 x 20 box
    sigma2 = 1e-2
    k5 = Lengthscale(EQ(), 1.0)
    yv = torch.sin(x5[:, 0]) + 0.1 * w3
    G5 = gramian(k5, x5)
    Kmv = lambda v: G5._matvec(v) + sigma2 * v
    work_k = mvm.work_direct(n3, n3, 2, mvm.profile_ops(to_spec(k5)[0]))
    rows = torch.as_tensor(check_rows(n3, z["resid_rows"]), device=run.device)
    for (rank5, maxit5), (cb, cs) in zip(((z["ranks"][0], 100), (z["ranks"][1], 60)),
                                         (heavy[3:5], heavy[5:7])):
        if not (run.wants(cb) or run.wants(cs)):
            continue
        M5 = {}

        def build5(rank5=rank5):
            nystrom_preconditioner(k5, x5, sigma2, rank=rank5)   # warm
            M5["M"], s = run.wall(lambda: nystrom_preconditioner(k5, x5, sigma2, rank=rank5))
            return {"seconds": s, "note": "warm wall"}

        if run.row(cb, build5) is None:
            build5()

        def solve5(maxit5=maxit5, cs=cs):
            cg(Kmv, yv, tol=1e-4, maxiter=2, M=M5["M"])   # warm
            (alpha, (it, res)), s = run.wall(lambda: cg(Kmv, yv, tol=1e-4, maxiter=maxit5,
                                                        M=M5["M"]))
            yr, ar = yv[rows].double(), alpha[rows].double()
            r64 = resid(yr - rows64(k5, x5, alpha, rows) - sigma2 * ar, yr)
            run.hold(cs, x=x5, y=yv, out=alpha, iters=it)
            return {"seconds": s, "work": it * work_k, "err": r64,
                    "note": f"{it} PCG iterations to relres "
                            f"{float(res) / float(torch.linalg.norm(yv)):.1e} (the bound counts "
                            f"their K1 products); err: float64 residual on {len(rows)} rows"}

        run.row(cs, solve5, expect="K1", err_bound=2e-4,
                note=f"exact lazy MVM (K1), rank-{rank5} Nystrom, sigma^2 {sigma2}, maxiter "
                     f"{maxit5}, x ~ U(-10, 10)^2; BASELINE config 5")
        M5.clear()
        if run.device.type == "cuda":
            torch.cuda.empty_cache()


def bench_sparse(run: Run):
    from ..kernels import EQ, Lengthscale
    from ..kernels.profile_spec import to_spec
    from ..operators.sparse_op import sparse_gramian
    from ..ops import tile_ell_mvm as tmvm

    z = run.size
    rng = np.random.default_rng(0)
    n, d = z["sp_n"], z["sp_d"]
    x = run.t(rng.standard_normal((n, d)))
    sparse_gramian(EQ(), x, tol=1e-6)   # warm
    x = run.t(rng.standard_normal((n, d)))
    S = {}

    def build():
        (S["S"], ratio), s = run.wall(lambda: sparse_gramian(EQ(), x, tol=1e-6))
        return {"seconds": s, "note": f"warm build; nnz ratio {ratio:.4f} (reference 0.0022)"}

    if run.row("sparsify_build_eq_n16384_d32", build) is None:
        build()
    Sp = S.pop("S")
    a = run.t(rng.standard_normal(n))

    def mvm_row():
        out = run.chained(Sp._matvec, a, work=tmvm.work_rows(Sp.nnz, n, n, a.element_size()))
        b = Sp @ a
        rs = Sp.rows
        ref = tmvm.rows_matvec_plain(rs._replace(val=rs.val.double()), a.double())
        run.hold("sparse_mvm_eq_n16384_d32", x=x, a=a, out=b)
        return dict(out, err=rel(b, ref), note=f"nnz {Sp.nnz}; err against the same "
                                               "operator's float64 product")

    run.row("sparse_mvm_eq_n16384_d32", mvm_row, expect="K4", err_bound=K4_BOUND,
            note="S @ a, the cfjax row's chained step without its TPU workaround")
    del Sp
    n2 = z["tree_n"]
    x2 = run.t(rng.standard_normal((n2, 2)))
    k2 = Lengthscale(EQ(), 0.01)
    sparse_gramian(k2, x2, tol=1e-6, format="lazy")   # warm
    x2 = run.t(rng.standard_normal((n2, 2)))

    def tree_build():
        (S["S"], r2), s = run.wall(lambda: sparse_gramian(k2, x2, tol=1e-6, format="lazy"))
        return {"seconds": s, "note": f"warm build; lazy leaf-tile operator, nnz ratio {r2:.1e}"}

    if run.row("sparsify_tree_build_n250k_d2", tree_build) is None:
        tree_build()
    S2 = S.pop("S")
    a2 = run.t(rng.standard_normal(n2))
    fp32, sfu = mvm.profile_ops(to_spec(k2)[0])
    idx = torch.as_tensor(check_rows(n2, 256), device=run.device)

    def lazy():
        work = Work(fp32=S2.nnz * (2 * 2 + fp32 + 1), sfu=S2.nnz * sfu,
                    hbm_bytes=a2.element_size() * (3.0 * n2 + 2 * n2))
        out = run.chained(S2._matvec, a2, iters=(2, 10), work=work)
        b = S2 @ a2
        run.hold("sparse_lazy_mvm_n250k_d2", x=x2, a=a2, out=b)
        return dict(out, err=rel(b[idx], rows64(k2, x2, a2, idx)),
                    note=f"recomputed kernel tiles, nnz {S2.nnz:.2e} (the bound counts the "
                         "nnz entries); err against exact float64 rows (the dropped entries "
                         "are below tol 1e-6)")

    run.row("sparse_lazy_mvm_n250k_d2", lazy, err_bound=K1_BOUND)


def bench_logml(run: Run):
    from ..gp import log_marginal_likelihood as lml
    from ..kernels import EQ, Lengthscale, separable
    from ..kernels.profile_spec import to_spec
    from ..utils.grids import LazyGrid

    z = run.size
    rng = np.random.default_rng(0)
    m = z["lml_m"]
    gs = tuple(np.linspace(0, 1, m) for _ in range(3))
    yk = run.t(rng.standard_normal(m ** 3), torch.float64)
    k3 = separable("^", EQ(), d=3)
    xg = LazyGrid(gs, device=run.device, dtype=torch.float64)
    f = lambda yy: lml(k3, xg, yy, noise=1e-2)

    def kron():
        f(yk)
        s, spread = run.dispatch(f, yk, iters=3)
        val = f(yk)
        if not math.isfinite(float(val)):
            raise ArithmeticError(f"the logML is {float(val)}")
        run.hold("logml_kronecker_eq3_64cubed", y=yk, out=val)
        return {"seconds": s, "spread": spread, "note": f"logML {float(val):.12e}"}

    run.row("logml_kronecker_eq3_64cubed", kron,
            note="float64: in float32 the factors' eigenvalues carry more rounding than the "
                 "noise 1e-2 (the value is NaN at 64^3); exact per-factor eigendecomposition, "
                 "n never materialized")

    def slq_work(n, d, k, launches, probes):
        """The K1 products an slq logML ran (a lower bound: the plain VJP
        and the rest are not counted); None where nothing ran."""
        if not launches:
            return None
        prof = mvm.profile_ops(to_spec(k)[0])
        return (launches.get("direct", 0) * mvm.work_direct(n, n, d, prof)
                + launches.get("direct_cols", 0) * mvm.work_direct(n, n, d, prof, p=probes))

    def counted(fn):
        """fn()'s result and its K1 products by `LAUNCHES` key, as they ran
        on the card (a CG step captured in a CUDA graph runs once a replay,
        and is launched once)."""
        with kernel_runs("k1_family", "k1_direct", "k1_matmat_family") as runs:
            out = fn()
        ran = {"direct": runs["k1_family"] + runs["k1_direct"],
               "direct_cols": runs["k1_matmat_family"]}
        return out, {k: v for k, v in ran.items() if v}

    n, d = z["slq_n"], 3
    x = run.t(rng.standard_normal((n, d)))
    yv = run.t(rng.standard_normal(n))
    # method="slq" is the route the automatic choice takes at n = 65536;
    # named, it stays the route at --scale tiny
    g = lambda yy: lml(EQ(), x, yy, noise=1e-1, method="slq", probes=8, lanczos_iters=32,
                       solve_tol=1e-4, solve_maxiter=200)

    def slq():
        g(yv)
        s, spread = run.dispatch(g, yv, iters=2)
        val, launches = counted(lambda: g(yv))
        run.hold("logml_slq_eq_n65536_d3", x=x, y=yv, out=val)
        return {"seconds": s, "spread": spread, "work": slq_work(n, d, EQ(), launches, 8),
                "note": f"logML {float(val):.9e}; one evaluation's K1 runs {launches} (the "
                        "bound counts their K1 products)"}

    run.row("logml_slq_eq_n65536_d3", slq, expect="K1 many-column",
            note="stochastic Lanczos quadrature (8 probes, 32 steps) + CG (tol 1e-4, "
                 "maxiter 200)")
    heavy = GROUPS["logml"][2:]
    if not any(run.wants(c) for c in heavy):
        return
    n20 = z["n20"]
    x20 = run.t(rng.standard_normal((n20, 2)))
    y20 = run.t(rng.standard_normal(n20))
    knobs = dict(noise=3e-1, method="slq", probes=4, lanczos_iters=24, solve_tol=1e-3,
                 solve_maxiter=40)
    h = lambda yy: lml(EQ(), x20, yy, **knobs)

    def value():
        h(y20)
        (val, launches), s = run.wall(lambda: counted(lambda: h(y20)))
        run.hold("logml_slq_eq_n2pow20_d2", x=x20, y=y20, out=val)
        return {"seconds": s, "work": slq_work(n20, 2, EQ(), launches, 4),
                "note": f"logML {float(val):.6e}; K1 runs {launches}"}

    run.row("logml_slq_eq_n2pow20_d2", value, expect="K1 many-column",
            note="n = 2^20 lazy logML value: 24 Lanczos steps x 4 probes, CG tol 1e-3 in at "
                 "most 40 iterations; warm wall")

    def grad():
        lt = torch.zeros((), dtype=run.dtype, device=run.device, requires_grad=True)

        def vg():
            val = lml(Lengthscale(EQ(), torch.exp(lt)), x20, y20, **knobs)
            (gl,) = torch.autograd.grad(val, lt)
            return val.detach(), gl

        ((val, gl), launches), s = run.wall(lambda: counted(vg))
        run.hold("logml_slq_eq_n2pow20_d2_grad", x=x20, y=y20, out=val, grad=gl)
        return {"seconds": s, "work": slq_work(n20, 2, EQ(), launches, 4),
                "note": f"logML {float(val):.6e}, d/dlog l {float(gl):.6e}; K1 runs "
                        f"{launches}; the backward is the plain VJP"}

    run.row("logml_slq_eq_n2pow20_d2_grad", grad, expect="K1 many-column",
            note="n = 2^20 logML value and gradient in the log-lengthscale (Hutchinson "
                 "backward + batched cg_columns); a single run")


def bench_refined(run: Run):
    """refined_solve at n = 10^5 on clustered points (cfjax's bench_refined):
    float32 Krylov through K1 inside, float64 residuals outside (the float64
    Gramian on the device, where cfjax took its CPU backend)."""
    from ..kernels import EQ, Lengthscale
    from ..operators import cg, gramian, nystrom_preconditioner, refined_solve

    config = "refined_solve_clustered_n1e5"
    if not run.wants(config):
        return
    z = run.size
    rng = np.random.default_rng(0)
    n, d, s2 = z["ref_n"], 2, 4e-3
    x = run.t(rng.standard_normal((n, d)).astype(np.float32), torch.float32)
    k = Lengthscale(EQ(), 1.0)
    G = gramian(k, x)
    G64 = gramian(k, x.double())
    alpha_true = rng.standard_normal(n)

    def one():
        M = nystrom_preconditioner(k, x, s2, rank=z["ref_rank"])
        hi = lambda v: G64 @ v + s2 * v
        lo = lambda v: G @ v.float() + s2 * v.float()
        b = hi(run.t(alpha_true, torch.float64))
        bn = float(torch.linalg.norm(b))
        x32, (it32, _) = cg(lo, b.float(), tol=1e-10, maxiter=300, M=M)
        rel32 = float(torch.linalg.norm(b - hi(x32.double()))) / bn
        (xr, (outer, res)), s = run.wall(lambda: refined_solve(
            hi, lo, b, M=M, tol=1e-8, inner_tol=1e-2, inner_maxiter=80, refinements=10))
        true = float(torch.linalg.norm(b - hi(xr.double()))) / bn
        run.hold(config, x=x, b=b, out=xr)
        return {"seconds": s, "err": true,
                "note": f"{outer} refinements to float64 relres {float(res) / bn:.1e} (float32 "
                        f"PCG alone: {rel32:.1e} after {it32} iterations); err: the returned "
                        "x's float64 residual"}

    run.row(config, one, expect="K1", err_bound=1e-8,
            note="rank-768 Nystrom, inner_tol 1e-2, inner_maxiter 80, 10 refinements, "
                 "sigma^2 4e-3, x ~ N(0, I)")


BENCH = {name: globals()[f"bench_{name}"] for name in GROUPS}


def run(groups=None, device="cuda", scale="full", dtype=torch.float32, skip_heavy=False,
        rows=None, row_timeout=None, keep=None, echo=True) -> list:
    """Run the groups (all by default) and return their rows. A group that
    raises outside a row leaves its remaining rows invalid with its error."""
    r = Run(device, scale, dtype, skip_heavy, rows, row_timeout, keep, echo)
    for name in groups or GROUPS:
        done = len(r.rows)
        try:
            BENCH[name](r)
        except Exception as e:
            seen = {row["cfjax_config"] for row in r.rows[done:]}
            for config in GROUPS[name]:
                if config not in seen and r.wants(config):
                    r.row(config, lambda e=e: {"error": f"the group failed before this row: "
                                                        f"{type(e).__name__}: {e}"})
        if r.device.type == "cuda":
            torch.cuda.empty_cache()
    return r.rows


def _ms(v):
    return "—" if v is None else f"{v * 1e3:.4f} ms" if v < 1 else f"{v:.3f} s"


def markdown(rows, header) -> str:
    lines = [f"BASELINE on the card: {header.get('card')}, {header.get('power_limit')} "
             f"(commit {header.get('commit')}, {header.get('date')})", "",
             "| config | seconds | device | reference | speedup | bound | share | float64 err "
             "(limit) | route | valid |", "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        dev = "—" if r.get("device_ms") is None else f"{r['device_ms']:.4f} ms"
        bound = "—" if r.get("bound_ms") is None else f"{r['bound_ms']:.5f} ms ({r['bound_by']})"
        share = "—" if r.get("share") is None else f"{r['share']:.2f}%"
        err = "—" if r.get("rel_err_f64") is None else (
            f"{r['rel_err_f64']:.2e}" + ("" if r.get("err_bound") is None
                                         else f" ({r['err_bound']:.0e})"))
        sp = "—" if r.get("speedup") is None else f"{r['speedup']:.1f}x"
        ok = "yes" if r["valid"] else f"no: {r['why']}"
        lines.append(f"| {r['config']} | {_ms(r.get('seconds'))} | {dev} | "
                     f"{_ms(r.get('ref_seconds'))} | {sp} | {bound} | {share} | {err} | "
                     f"{r['route']} | {ok} |")
    return "\n".join(lines) + "\n"


def write(rows, header, path=RESULTS, merge_from=None):
    """Merge the rows into the table of `merge_from` (default `path`) and
    write it to `path`, in the table's order: a row of this run replaces
    the same config's, the others stay as they were."""
    src = Path(merge_from or path)
    old = json.loads(src.read_text()) if src.exists() else {"runs": [], "rows": []}
    runs = old["runs"] + [header]
    merged = {r["cfjax_config"]: r for r in old["rows"]}
    for r in rows:
        merged[r["cfjax_config"]] = dict(r, run=len(runs) - 1)
    order = [c for g in GROUPS.values() for c in g]
    path.write_text(json.dumps({"runs": runs, "rows": [merged[c] for c in order if c in merged]},
                               indent=1) + "\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description="The BASELINE table on the card.")
    ap.add_argument("groups", nargs="*", help=f"any of {', '.join(GROUPS)} (default: all)")
    ap.add_argument("--write", action="store_true")
    ap.add_argument("--device", choices=DEVICES, default="cuda")
    ap.add_argument("--scale", choices=tuple(SIZES), default="full")
    ap.add_argument("--skip-heavy", action="store_true")
    ap.add_argument("--rows", default=None, help="comma-separated configs")
    ap.add_argument("--row-timeout", type=float, default=None)
    ap.add_argument("--commit", default=None)
    ap.add_argument("--out", default=str(RESULTS),
                    help="where --write puts the table, merged into the committed one")
    args = ap.parse_args(argv)
    unknown = [g for g in args.groups if g not in GROUPS]
    if unknown:
        ap.error(f"unknown groups {unknown}: the groups are {', '.join(GROUPS)}")
    if args.write and (args.device != "cuda" or args.scale != "full"):
        ap.error("--write records the card's run at full scale")
    device = take_device(args.device, "run_baseline")
    t0 = time.perf_counter()
    rows = run(args.groups or None, device, args.scale, skip_heavy=args.skip_heavy,
               rows=args.rows.split(",") if args.rows else None,
               row_timeout=args.row_timeout)
    c = card()
    header = {"card": c["name"], "power_limit": c["power_limit"],
              "commit": args.commit or commit(),
              "date": time.strftime("%Y-%m-%d %H:%M UTC", time.gmtime()),
              "groups": args.groups or list(GROUPS), "skip_heavy": args.skip_heavy,
              "rows": args.rows, "wall_s": time.perf_counter() - t0,
              "torch": torch.__version__, "cuda": torch.version.cuda}
    print(markdown(rows, header))
    if args.write:
        write(rows, header, Path(args.out), merge_from=RESULTS)
        print(f"wrote {args.out}")
    bad = [r["config"] for r in rows if not r["valid"]]
    print(f"total wall {header['wall_s']:.1f} s; {len(rows)} rows, {len(bad)} invalid"
          + (f": {', '.join(bad)}" if bad else ""), flush=True)
    if bad:
        sys.exit(1)
    return rows


if __name__ == "__main__":
    main()
