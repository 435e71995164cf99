"""The port's benchmark entry points on the CPU (`cfjax_torch/benchmarks/`):
the BASELINE table's twin (`run_baseline`), the headline (`headline`,
`bench_torch.py`) and the weak-scaling twin (`weak_scaling`).

The table's rows cover cfjax's 44 configurations; each group runs at
`--scale tiny` and returns well-formed rows; and, in float64 (x64 on the
cfjax side, as tests/conftest.py sets), the operands a group builds go
through cfjax's function and the port's to the same answer: the MVMs to
rounding (rtol 1e-10), the solves to their solver's tolerance, the
one-pass tier where the port emulates tf32's rounding to that tier's
limit, Barnes-Hut within cfjax's own error against the exact product, and
the SLQ logML on cfjax's own probes. The card-side counterparts are in
tests/test_torch_cuda.py."""

import importlib.util
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfjax
import cfjax.kernels as jk
import cfjax_torch
from cfjax.operators import slq as j_slq
from cfjax_torch.benchmarks import headline, run_baseline as rb, weak_scaling as ws
from cfjax_torch.operators import slq as t_slq
from cfjax_torch.operators.kronecker import work_kron_mvm, work_kron_solve
from cfjax_torch.operators.toeplitz import work_fft_mvm, work_levinson
from cfjax_torch.utils.roofline import Work
from cfjax_torch.utils.timing import MeasurementError

ROOT = Path(__file__).resolve().parents[1]
torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """Input without a device goes to the CPU in this module's tests; the
    configured device is restored after them."""
    shipped = cfjax_torch.config.DEFAULT.device
    cfjax_torch.set_config(device="cpu")
    yield
    cfjax_torch.set_config(device=shipped)


# ---------------------------------------------------------------- the table


def test_rows_cover_every_cfjax_config():
    cfjax_rows = json.loads((ROOT / "benchmarks" / "results.json").read_text())
    names = [r["config"] for r in cfjax_rows]
    ours = [c for g in rb.GROUPS.values() for c in g]
    assert len(names) == len(ours) == 44 and ours == names
    ports = [rb.port_name(c) for c in ours]
    assert len(set(ports)) == 44
    assert all(p == c or (c.endswith("_bf16") and p == c[:-5] + "_tf32")
               for p, c in zip(ports, ours))
    assert sum(p.endswith("_tf32") for p in ports) == 4
    assert rb.HEAVY <= set(ours) and len(rb.HEAVY) == 10


ROW_KEYS = {"config", "cfjax_config", "heavy", "valid", "seconds", "device_ms", "ref_seconds",
            "speedup", "bound_ms", "bound_by", "share", "share_device", "rel_err_f64",
            "err_bound", "route", "expect", "launches", "note", "why"}


@pytest.mark.parametrize("group", list(rb.GROUPS))
def test_group_runs_tiny_on_the_cpu(group):
    rows = rb.run([group], device="cpu", scale="tiny", echo=False)
    assert [r["cfjax_config"] for r in rows] == rb.GROUPS[group]
    for r in rows:
        assert ROW_KEYS <= set(r), r["config"]
        assert r["config"] == rb.port_name(r["cfjax_config"])
        assert r["route"] == "plain" and r["launches"] == {}   # no kernel on the CPU
        assert r["device_ms"] is None
        json.dumps(r)
        if not r["valid"]:
            # on a loaded host a tiny slope may not separate from the spread;
            # nothing else may fail
            assert r["why"].startswith("not separable"), (r["config"], r["why"])
            continue
        assert r["seconds"] > 0 and r["why"] is None, r["config"]
        if r["bound_ms"] is not None:
            assert r["share"] is not None and 0 < r["share"] <= 105
        if r["err_bound"] is not None:
            assert r["rel_err_f64"] <= r["err_bound"], r["config"]


# ------------------------------------------------- parity with cfjax, float64


@pytest.fixture(scope="module")
def kept():
    """Every group but `refined` (mixed precision by design) at tiny
    scale in float64, the port drawing cfjax's SLQ probes (PRNGKey(0),
    cfjax's default key): each row's operands and outputs."""
    keep = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_slq, "_rademacher", lambda gen, n, p, dtype, device: torch.tensor(
            np.asarray(j_slq._rademacher(jax.random.PRNGKey(0), n, p, jnp.float64)),
            dtype=dtype, device=device))
        rb.run([g for g in rb.GROUPS if g != "refined"], device="cpu", scale="tiny",
               dtype=torch.float64, keep=keep, echo=False)
    return keep


def _close(out, ref, rtol):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    err = np.linalg.norm(out - ref) / np.linalg.norm(ref)
    assert err <= rtol, err


J = jnp.asarray
SIZE = rb.SIZES["tiny"]


def test_dense_mvm_rows_match_cfjax(kept):
    from cfjax.operators import Gramian

    for config in rb.GROUPS["dense_mvm"]:
        k = kept[config]
        _close(k["out"], Gramian(jk.MaternP(2), J(k["x"])) @ J(k["a"]), 1e-10)


def test_sweep_rows_match_cfjax(kept):
    from cfjax.operators import Gramian

    for config in rb.GROUPS["dense_sweep"]:
        k = kept[config]
        d = k["x"].shape[1]
        # the one-pass rows round their tile's inputs to tf32, as the card
        # does; cfjax's x64 CPU backend does not
        rtol = rb.TIER_BOUND["K2"]["default"] if config.endswith("_bf16") else 1e-10
        _close(k["out"], Gramian(jk.EQ(), J(k["x"])) @ J(k["a"]), rtol)
        _close(k["out_acc"], Gramian(jk.Lengthscale(jk.EQ(), float(np.sqrt(d))), J(k["x"]))
               @ J(k["a"]), rtol)


def test_toeplitz_rows_match_cfjax(kept):
    from cfjax.operators import cg, gramian, levinson
    from cfjax.utils.grids import UniformGrid

    n = SIZE["toe_n"]
    T = gramian(jk.Exp(), UniformGrid(0.0, 1.0 / n, n))
    k = kept["toeplitz_fft_mvm_n65536"]
    _close(k["out"], T @ J(k["a"]), 1e-10)
    k = kept["toeplitz_solve_pcg_noisy_n65536"]
    Tn = T.add_diagonal(1e-2)
    xs, (it, _) = cg(Tn._matvec, J(k["b"]), tol=1e-5, maxiter=600, M=T.strang_preconditioner())
    assert int(it) == k["iters"]
    _close(k["out"], xs, 1e-8)
    k = kept["toeplitz_levinson_n16384"]
    n2 = SIZE["lev_n"]
    T2 = gramian(jk.Exp(), UniformGrid(0.0, 1.0 / n2, n2))
    _close(k["out"], levinson(T2.col, J(k["b"])), 1e-10)


def test_kronecker_rows_match_cfjax(kept):
    from cfjax.operators import gramian
    from cfjax.utils.grids import LazyGrid, UniformGrid

    m = SIZE["kron_m"]
    K = gramian(jk.separable("^", jk.EQ(), d=3),
                LazyGrid(tuple(UniformGrid(0.0, 1.0 / m, m) for _ in range(3))))
    k = kept["kronecker_mvm_eq3_128cubed"]
    _close(k["out"], K @ J(k["a"]), 1e-10)
    k = kept["kronecker_solve_eq3_128cubed"]
    # the factors are numerically singular: the solves agree to the
    # conditioning of the jittered system, held by the backward error in the row
    _close(k["out"], K.cholesky().solve(J(k["a"])), 1e-6)


def test_gradient_and_hessian_rows_match_cfjax(kept):
    from cfjax.derivative import GradientKernel, HessianKernel
    from cfjax.operators import gramian

    cases = {"gradient_mvm_maternp2_n1024_d1024": jk.MaternP(2),
             "gradient_mvm_eq_n4096_d16": jk.EQ(), "gradient_mvm_eq_n4096_d16_bf16": jk.EQ(),
             "gradient_mvm_composite_n1024_d1024":
                 jk.MaternP(2) + jk.Line(1.0) ** 2 + jk.NN(0.1)}
    for config, kern in cases.items():
        k = kept[config]
        rtol = rb.TIER_BOUND["K3"]["default"] if config.endswith("_bf16") else 1e-10
        _close(k["out"], gramian(GradientKernel(kern), J(k["x"])) @ J(k["v"]), rtol)
    k = kept["hessian_mvm_eq_n128_d16"]
    _close(k["out"], HessianKernel(jk.EQ()).gramian(J(k["x"])) @ J(k["v"]), 1e-10)


def test_barneshut_rows_agree_within_cfjax_error(kept):
    from cfjax.barneshut import BarnesHutFactorization
    from cfjax_torch.utils.testing import pairwise

    for config in ("barneshut_mvm_theta0.5_n65536", "barneshut_mvm_theta0.25_n65536"):
        k = kept[config]
        x, w = k["x"], k["w"]
        exact = pairwise(cfjax_torch.kernels.EQ(), torch.tensor(x)).numpy() @ w
        ref = np.asarray(BarnesHutFactorization(jk.EQ(), J(x), theta=k["theta"]) @ J(w))
        # at the tiny size the treecode's error is at rounding: held to 1e-10
        # of the product there
        cf_err = max(np.linalg.norm(ref - exact), 1e-10 * np.linalg.norm(exact))
        assert np.linalg.norm(k["out"] - ref) <= cf_err


def test_sparse_rows_match_cfjax(kept):
    from cfjax.operators.sparse_op import sparse_gramian

    k = kept["sparse_mvm_eq_n16384_d32"]
    S, _ = sparse_gramian(jk.EQ(), J(k["x"]), tol=1e-6)
    _close(k["out"], S @ J(k["a"]), 1e-12)
    k = kept["sparse_lazy_mvm_n250k_d2"]
    S, _ = sparse_gramian(jk.Lengthscale(jk.EQ(), 0.01), J(k["x"]), tol=1e-6, format="lazy")
    _close(k["out"], S @ J(k["a"]), 1e-12)


def test_logml_values_match_cfjax(kept):
    from cfjax.gp import log_marginal_likelihood as lml
    from cfjax.utils.grids import LazyGrid

    m = SIZE["lml_m"]
    k = kept["logml_kronecker_eq3_64cubed"]
    ref = lml(jk.separable("^", jk.EQ(), d=3), LazyGrid(tuple(np.linspace(0, 1, m)
                                                              for _ in range(3))),
              J(k["y"]), noise=1e-2)
    assert math.isclose(float(k["out"]), float(ref), rel_tol=1e-10)
    # same probes, so the Lanczos quadrature agrees to rounding; the two
    # packages' CG may stop an iteration apart within its tolerance (1e-4,
    # 1e-3), which moves the quadratic form below 1e-6 of the value
    k = kept["logml_slq_eq_n65536_d3"]
    ref = lml(jk.EQ(), J(k["x"]), J(k["y"]), noise=1e-1, method="slq", probes=8,
              lanczos_iters=32, solve_tol=1e-4, solve_maxiter=200)
    assert math.isclose(float(k["out"]), float(ref), rel_tol=1e-6)
    k = kept["logml_slq_eq_n2pow20_d2"]
    ref = lml(jk.EQ(), J(k["x"]), J(k["y"]), noise=3e-1, method="slq", probes=4,
              lanczos_iters=24, solve_tol=1e-3, solve_maxiter=40)
    assert math.isclose(float(k["out"]), float(ref), rel_tol=1e-6)


# ------------------------------------------------------ work models, validity


def test_work_models_match_hand_counts():
    w = work_fft_mvm(4)   # N = 8: three real FFTs 3 x 2.5 x 8 x 3 flops, 5 products x 6
    assert w.fp32 == (180 + 30) / 2 and w.hbm_bytes == 48 and w.tc_flops == 0
    w = work_kron_mvm([2, 3, 4])   # n = 24: 2 n (2 + 3 + 4) flops; v, K v, 4 + 9 + 16 entries
    assert w.tc_flops == 432 and w.tc_passes == 3 and w.hbm_bytes == 4 * (48 + 29)
    w = work_kron_solve([2, 3, 4])   # the triangular factors' 3 + 6 + 10 entries
    assert w.tc_flops == 432 and w.hbm_bytes == 4 * (48 + 19)
    assert work_levinson(5).fp32 == 50 and work_levinson(5, 8).hbm_bytes == 120
    s = Work(fp32=1, sfu=2, tc_flops=3, tc_passes=3, hbm_bytes=4)
    t = 2 * s + Work(fp32=10, tc_flops=1)
    assert (t.fp32, t.sfu, t.tc_flops, t.tc_passes, t.hbm_bytes) == (12, 4, 7, 3, 8)


def test_a_row_read_below_its_bound_is_invalid():
    work = Work(fp32=1e12)   # 1 / 33.45 s at the fp32 peak
    assert rb.judge(1.0, work)["valid"]
    fast = rb.judge(1e-3, work)
    assert not fast["valid"] and fast["why"].startswith("impossible")
    assert not rb.judge(0.1, work, device_ms=1e-3)["valid"]   # the device reading too
    assert not rb.judge(MeasurementError("flat", upper_bound=1e-6))["valid"]
    assert not rb.judge(0.0)["valid"]
    run = rb.Run(device="cpu", scale="tiny", echo=False)
    row = run.row("dense_mvm_maternp2_n16384_d3", lambda: {"seconds": 1e-9, "work": work})
    assert not row["valid"] and "impossible" in row["why"]
    row = run.row("hessian_mvm_eq_n128_d16", lambda: {"seconds": 1.0, "err": 1e-3},
                  err_bound=1e-6)
    assert not row["valid"] and "above the row's limit" in row["why"]
    row = run.row("hessian_mvm_eq_n128_d16", lambda: 1 / 0)
    assert not row["valid"] and row["why"].startswith("ZeroDivisionError")


def test_a_row_past_its_wall_is_not_run():
    import time

    run = rb.Run(device="cpu", scale="tiny", row_timeout=1, echo=False)
    row = run.row("refined_solve_clustered_n1e5", lambda: time.sleep(5))
    assert not row["valid"] and row["why"].startswith("not run: stopped at")
    assert row["wall_s"] < 4


def test_skip_heavy_and_write_options(tmp_path):
    assert not rb.Run(skip_heavy=True).wants("refined_solve_clustered_n1e5")
    assert rb.Run(rows=["gradient_mvm_eq_n4096_d16_tf32"]).wants("gradient_mvm_eq_n4096_d16_bf16")
    rows = [{"cfjax_config": c, "config": rb.port_name(c)} for c in
            ("hessian_mvm_eq_n128_d16", "dense_mvm_maternp2_n16384_d3")]
    path = tmp_path / "r.json"
    rb.write(rows[:1], {"card": "a"}, path)
    rb.write(rows[1:], {"card": "b"}, path)
    out = json.loads(path.read_text())
    assert [r["config"] for r in out["rows"]] == ["dense_mvm_maternp2_n16384_d3",
                                                  "hessian_mvm_eq_n128_d16"]
    assert [r["run"] for r in out["rows"]] == [1, 0] and len(out["runs"]) == 2
    with pytest.raises(SystemExit):
        rb.main(["--write", "--device", "cpu", "--scale", "tiny", "hessian"])


# ----------------------------------------------------------------- headline


def test_headline_prints_one_json_line(capsys, monkeypatch):
    # the slope timer is replaced by one call and a fixed reading: a host
    # CPU's spread often hides a tiny MVM's slope (the timer's own tests
    # cover it), and the JSON line must not depend on the host's load
    monkeypatch.setattr(headline, "time_chained", lambda step, v0: (step(v0), 1e-3)[1])
    out = headline.main(["--device", "cpu", "--n", "256"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert got == out
    for key in ("metric", "value", "unit", "vs_baseline", "row_check_rel_err", "device_ms",
                "backend", "card", "power_limit", "k1_launches"):
        assert key in got
    assert got["unit"] == "s" and got["backend"] == "cpu" and got["device_ms"] is None
    assert got["value"] == 1e-3 and math.isclose(got["vs_baseline"], 585.0)
    assert got["row_check_rel_err"] <= headline.ROW_BOUND
    assert headline.failures(got) == []
    assert headline.failures(dict(got, backend="cuda", k1_launches=0))


def test_headline_reports_a_slope_it_cannot_separate(capsys, monkeypatch):
    def flat(step, v0):
        raise MeasurementError("flat", upper_bound=1e-3)

    monkeypatch.setattr(headline, "time_chained", flat)
    with pytest.raises(SystemExit) as e:
        headline.main(["--device", "cpu", "--n", "64"])
    assert e.value.code == 1
    got = json.loads(capsys.readouterr().out)
    assert got["value"] is None and got["vs_baseline"] is None


@pytest.mark.skipif("torch.cuda.is_available()", reason="checks the run without a card")
def test_entry_points_refuse_to_run_without_a_card():
    for main in (headline.main, rb.main, ws.main):
        with pytest.raises(SystemExit) as e:
            main([])
        assert e.value.code != 0


# ------------------------------------------------------------- weak scaling


def test_comm_model_matches_cfjax():
    spec = importlib.util.spec_from_file_location("cfjax_weak_scaling",
                                                  ROOT / "benchmarks" / "weak_scaling.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for n in (1024, 8192, 1 << 20):
        for R, C in ((1, 1), (1, 2), (2, 2), (2, 4), (4, 4)):
            assert ws.comm_model(n, R, C) == mod.comm_model(n, R, C)
    assert ws.comm_model(4096, 2, 2, 8) == mod.comm_model(4096, 2, 2, 8)


def test_sharded_answers_at_world_two_match_one_rank():
    from cfjax_torch.utils.testing import run_world

    res = run_world(ws.rank_case, 2, 64, 64, 256, backend="gloo", device="cpu")
    rows = ws._rows(res, 64, 64, 256, "cpu")
    assert [r["config"] for r in rows] == ["weak_scaling_mvm_rowsharded_2rank_rows64",
                                           "weak_scaling_mvm_2dmesh_1x2_tile64",
                                           "gp_cg_2dmesh_1x2_n256"]
    assert ws.failures(rows) == []
    assert res["row_err"] <= ws.SHARD_BOUND and res["tile_err"] <= ws.SHARD_BOUND
    assert res["cg_err"] <= ws.SHARD_BOUND and res["cg_iters"] < 400
