"""The port's spans and counters (`cfjax_torch/utils/trace.py`) on the CPU.

With tracing off a span site is a flag check: `record_function`, CUDA
events and gradient hooks are patched to raise, and the Nystrom PCG, plain
CG on gradient observations, the dense logML with its backward and the slq
logML still run. Under the CPU profiler the spans form the tree the
program's layers make, carry the solver's iterations and the counted host
reads, and appear in the profiler's own events as user annotations of the
same name, nesting and duration. `chip_smoke.slq_stages` reads the slq
stages from the spans. The test marked `needs_gpu` holds `host_syncs`
against `torch.cuda.set_sync_debug_mode("warn")` on a card."""

import collections
import re
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import cfjax_torch
import cfjax_torch.kernels as tk
from cfjax_torch.derivative import GradientKernel
from cfjax_torch.gp import gp_condition
from cfjax_torch.gp.regression import log_marginal_likelihood
from cfjax_torch.operators.solvers import cg, cg_columns
from cfjax_torch.utils import trace

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]

needs_gpu = pytest.mark.skipif(
    "not torch.cuda.is_available()",
    reason="needs a CUDA device: the sync debug mode and the CUDA events are the card's")


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
    cfjax_torch.set_config(max_cholesky_size=64)
    yield
    cfjax_torch.set_config(max_cholesky_size=cfjax_torch.config.Config.max_cholesky_size)


@pytest.fixture
def fresh():
    trace.clear()
    yield
    trace.clear()


def points(n, d=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, d, generator=g, dtype=torch.float64)
    return x, torch.sin(x[:, 0])


def nystrom_job():
    """gp_condition on the Nystrom PCG branch (n = 256 above the lowered
    max_cholesky_size) and the posterior mean."""
    x, y = points(256)
    post = gp_condition(tk.MaternP(2), x, y, noise=1e-2, precond_rank=32, tol=1e-6,
                        maxiter=300)
    return post, post.mean(x[:16])


def gradient_job():
    """gp_condition on gradient observations: plain CG (3n unknowns above the
    lowered max_cholesky_size)."""
    x, _ = points(40)
    y = torch.cos(x).reshape(-1)
    post = gp_condition(GradientKernel(tk.EQ()), x, y, noise=1e-2, tol=1e-6, maxiter=500)
    return post, post.mean(x[:8])


def logml_job(method):
    """The logML of Lengthscale(MaternP(2), exp(theta)) and its backward to
    theta, on the dense branch or the slq one."""
    x, y = points(128 if method == "cholesky" else 256)
    theta = torch.tensor([0.1], dtype=torch.float64, requires_grad=True)
    k = tk.Lengthscale(tk.MaternP(2), torch.exp(theta))
    kw = {} if method == "cholesky" else dict(probes=4, lanczos_iters=8, solve_tol=1e-5)
    v = log_marginal_likelihood(k, x, y, noise=1e-2, method=method, **kw)
    v.backward()
    return v, theta.grad


JOBS = {"nystrom": nystrom_job, "gradient_cg": gradient_job,
        "dense_logml": lambda: logml_job("cholesky"), "slq_logml": lambda: logml_job("slq")}


def _raise(*a, **kw):
    raise AssertionError("a span site did more than check the flag with tracing off")


@pytest.mark.parametrize("job", sorted(JOBS))
def test_off_is_a_flag_check(job, small_cholesky_size, fresh, monkeypatch):
    for obj, name in ((torch.profiler, "record_function"),
                      (torch.autograd.profiler, "record_function"),
                      (torch.cuda, "Event"), (torch.Tensor, "register_hook")):
        monkeypatch.setattr(obj, name, _raise)
    assert trace.begin("off") is None
    JOBS[job]()
    assert trace.spans() == []


def by_name(spans):
    out = collections.defaultdict(list)
    for s in spans:
        out[s["name"]].append(s)
    return out


def test_nystrom_span_tree(small_cholesky_size, fresh):
    with trace.recording():
        post, _ = nystrom_job()
    sp = by_name(trace.spans())
    (cond,), (mean,), (nys,), (cgs,) = (sp["gp.condition"], sp["gp.mean"],
                                        sp["precond.nystrom"], sp["solvers.cg"])
    hosts = sp["precond.nystrom.host"]
    assert set(sp) == {"gp.condition", "gp.mean", "precond.nystrom", "precond.nystrom.host",
                       "solvers.cg"}
    assert cond["parent"] is None and cond["root"] == cond["id"]
    assert mean["parent"] is None and mean["root"] == mean["id"] != cond["id"]
    assert nys["parent"] == cond["id"] and cgs["parent"] == cond["id"]
    assert len(hosts) == 2 and all(h["parent"] == nys["id"] for h in hosts)
    assert {s["root"] for s in [nys, cgs] + hosts} == {cond["id"]}
    # children inside their parents, in the order the build runs them
    assert cond["start"] <= nys["start"] <= hosts[0]["start"] <= hosts[1]["end"] <= nys["end"]
    assert nys["end"] <= cgs["start"] <= cgs["end"] <= cond["end"] <= mean["start"]
    assert cgs["attrs"]["iters"] == post.solve_info[0] > 0
    # the root's counter deltas: the noise's copy to the points' device
    # (`add_diagonal`), the build's seven host transfers (float64 points:
    # the landmarks' index, Z, Kzz^-1/2; the Gram's two halves, E, the
    # denominators) and cg's reads
    assert sum(h["attrs"]["host_syncs"] for h in hosts) == nys["attrs"]["host_syncs"] == 7
    assert cond["attrs"]["host_syncs"] == 1 + 7 + cgs["attrs"]["host_syncs"]
    assert 0 < cgs["attrs"]["sync_wait_s"] < cgs["end"] - cgs["start"]


def test_gradient_cg_spans(small_cholesky_size, fresh):
    before = trace.counters()["host_syncs"]
    with trace.recording():
        post, _ = gradient_job()
    sp = by_name(trace.spans())
    assert set(sp) == {"gp.condition", "gp.mean", "solvers.cg"}
    (cgs,) = sp["solvers.cg"]
    its = post.solve_info[0]
    assert cgs["attrs"]["iters"] == its > 0
    # one read for the tolerance and the first residual, one a block of
    # iterations; around cg, the noise's copy to the device and the solve's
    # test that the diagonal shift is PSD. On the CPU nothing is captured.
    reads = cgs["attrs"]["reads"]
    assert cgs["attrs"]["host_syncs"] == reads and 2 <= reads < its // 4
    assert trace.counters()["host_syncs"] - before == reads + 2
    assert cgs["attrs"]["captured"] == 0 and cgs["attrs"]["frozen"] >= 0


@pytest.mark.parametrize("maxiter", [3, 500])
def test_host_syncs_count_the_reads_in_cg(maxiter, fresh, monkeypatch):
    """Every read cg makes (`Tensor.item`, `Tensor.cpu`) is one `host_syncs`,
    and nothing else is: on a dense SPD matrix, stopped by convergence or by
    maxiter. The reads are the span's `reads`: one before the first block of
    iterations, one after each block."""
    g = torch.Generator().manual_seed(3)
    B = torch.randn(64, 64, generator=g, dtype=torch.float64)
    A = B @ B.T + 64 * torch.eye(64, dtype=torch.float64)
    b = torch.randn(64, generator=g, dtype=torch.float64)
    reads = []
    for name in ("item", "cpu"):
        monkeypatch.setattr(torch.Tensor, name,
                            lambda t, f=getattr(torch.Tensor, name): reads.append(1) or f(t))
    before = trace.counters()["host_syncs"]
    with trace.recording():
        x, (its, _) = cg(lambda v: A @ v, b, tol=1e-10, maxiter=maxiter)
    (sp,) = trace.spans()
    assert trace.counters()["host_syncs"] - before == sp["attrs"]["host_syncs"] == len(reads)
    assert len(reads) == sp["attrs"]["reads"]
    assert len(reads) == 2 if maxiter == 3 else 2 < len(reads) < its
    assert sp["attrs"]["iters"] == its and (its == 3 if maxiter == 3 else 3 < its < maxiter)


def test_cg_columns_span(fresh):
    g = torch.Generator().manual_seed(4)
    B = torch.randn(32, 32, generator=g, dtype=torch.float64)
    A = B @ B.T + 32 * torch.eye(32, dtype=torch.float64)
    with trace.recording():
        X, its = cg_columns(lambda V: A @ V, torch.randn(32, 3, generator=g,
                                                          dtype=torch.float64), tol=1e-10)
    (sp,) = trace.spans()
    assert sp["name"] == "solvers.cg_columns" and sp["attrs"]["iters"] == its > 0
    assert sp["attrs"]["host_syncs"] == its + 1


def test_dense_logml_backward_stages(small_cholesky_size, fresh):
    with trace.recording():
        _, grad = logml_job("cholesky")
    assert torch.isfinite(grad).all()
    sp = by_name(trace.spans())
    (root,) = sp["gp.logml"]
    fwd = [sp[f"gp.logml.{s}"][0] for s in ("build", "cholesky", "solve")]
    bwd = [sp[f"gp.logml.{s}.bwd"][0] for s in ("solve", "cholesky", "build")]
    assert all(s["parent"] == root["id"] and s["root"] == root["id"] for s in fwd + bwd)
    assert [s["start"] for s in fwd] == sorted(s["start"] for s in fwd)
    # the backward reaches the stages in reverse, each ending where the next starts
    assert root["end"] <= bwd[0]["start"]
    assert all(a["end"] <= b["start"] for a, b in zip(bwd, bwd[1:]))
    # the hooks are gone once the backward has run: a second one records nothing new
    n = len(trace.spans())
    with trace.recording():
        v, _ = logml_job("cholesky")
    assert len(trace.spans()) == n + 7


def test_no_hooks_without_grad(small_cholesky_size, fresh, monkeypatch):
    monkeypatch.setattr(torch.Tensor, "register_hook", _raise)
    x, y = points(64)
    with trace.recording(), torch.no_grad():
        log_marginal_likelihood(tk.Lengthscale(tk.MaternP(2), 1.0), x, y, noise=1e-2)
    assert {s["name"] for s in trace.spans()} == {"gp.logml", "gp.logml.build",
                                                  "gp.logml.cholesky", "gp.logml.solve"}


def test_slq_span_tree(small_cholesky_size, fresh):
    with trace.recording():
        logml_job("slq")
    spans = trace.spans()
    sp = by_name(spans)
    (root,) = sp["gp.logml"]
    assert {s["root"] for s in spans} == {root["id"]}
    (lz,), (qf,) = sp["slq.lanczos"], sp["slq.quadform"]
    assert lz["parent"] == qf["parent"] == root["id"] and lz["attrs"]["iters"] == 8
    quad_cg = [s for s in sp["solvers.cg"] if s["parent"] == qf["id"]]
    assert len(quad_cg) == 1 and quad_cg[0]["attrs"]["iters"] == qf["attrs"]["iters"] > 0
    # the backwards: the Hutchinson solve and two pull-backs, under the logML's root
    (cols,) = sp["slq.cg_columns"]
    assert cols["parent"] == root["id"] and len(sp["slq.pull_back"]) == 2
    (inner,) = sp["solvers.cg_columns"]
    assert inner["parent"] == cols["id"] and inner["attrs"]["iters"] == cols["attrs"]["iters"]
    assert all(s["start"] >= root["end"] for s in [cols] + sp["slq.pull_back"])


def test_spans_are_profiler_annotations(small_cholesky_size, fresh):
    """Under the CPU profiler every span is recorded without `recording()`,
    and each appears among the profiler's events as a user annotation
    `cfjax_torch.<name>` of the same nesting and duration."""
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU]) as prof:
        nystrom_job()
        logml_job("cholesky")
    spans = trace.spans()
    assert len(spans) == 13
    events = sorted((e for e in prof.events() if e.name.startswith(trace.PREFIX)),
                    key=lambda e: e.time_range.start)
    assert len(events) == len(spans)
    assert all(getattr(e, "is_user_annotation", True) for e in events)
    ids = {s["id"]: s for s in spans}
    for name, group in by_name(spans).items():
        evs = [e for e in events if e.name == trace.PREFIX + name]
        assert len(evs) == len(group)
        for s, e in zip(sorted(group, key=lambda s: s["start"]), evs):
            # within 5%, or 0.2 ms: the span reads the host clock just
            # outside the range's entry and exit, the profiler stamps just
            # inside them, 10-45 us apart on an idle CPU
            dur, edur = s["end"] - s["start"], e.time_range.elapsed_us() * 1e-6
            assert abs(dur - edur) <= max(0.05 * dur, 2e-4), (name, dur, edur)
            # the innermost enclosing annotation is the parent span's, where
            # the parent was open on this thread when the span opened
            up = e.cpu_parent
            while up is not None and not up.name.startswith(trace.PREFIX):
                up = up.cpu_parent
            parent = ids.get(s["parent"])
            if parent is not None and parent["end"] >= s["end"]:
                assert up is not None and up.name == trace.PREFIX + parent["name"]
            else:
                assert up is None


def test_buffer_is_bounded(fresh):
    with trace.recording():
        for _ in range(trace.MAX_SPANS + 5):
            trace.end(trace.begin("bound"))
    spans = trace.spans()
    assert len(spans) == trace.MAX_SPANS
    assert [s["id"] for s in spans] == sorted(s["id"] for s in spans)
    trace.clear()
    assert trace.spans() == []


def test_recording_nests_and_restores(fresh):
    assert trace.begin("off") is None
    with trace.recording():
        with trace.recording():
            a = trace.begin("outer")
        b = trace.begin("inner")
        assert trace.current() is b
        trace.end(a)      # closing the outer span closes the child left open
        assert trace.current() is None
    assert trace.begin("off") is None
    sp = trace.spans()
    assert [s["name"] for s in sp] == ["inner", "outer"]
    assert sp[0]["parent"] == sp[1]["id"] and sp[0]["end"] <= sp[1]["end"]


def test_counters_read_launches():
    from cfjax_torch.ops.gramian_mvm import LAUNCHES

    c = trace.counters()
    assert c["host_syncs"] == trace.COUNTERS["host_syncs"]
    assert {k: c["launch." + k] for k in LAUNCHES} == LAUNCHES


def test_chip_smoke_patches_nothing_in_slq():
    """chip_smoke reads the slq stages from the spans: it assigns to no
    attribute of `cfjax_torch.operators.slq`."""
    src = (ROOT / "chip_smoke.py").read_text()
    assert not re.search(r"^\s*slq\.\w+\s*=|setattr\(\s*slq\b", src, re.MULTILINE)


def test_chip_smoke_slq_stages(small_cholesky_size, fresh):
    import chip_smoke
    import cfjax_torch.gp as gp

    x, y = points(256)
    with chip_smoke.slq_stages(500) as st:
        v, gl, gn = chip_smoke.lml_grads(tk, gp, x, y, keep=st, method="slq", probes=4,
                                         lanczos_iters=8, solve_tol=1e-6)
    assert np.isfinite([v, gl, gn]).all()
    assert st["lanczos_calls"] == 1 and not st["cols_hit"] and not st["quad_hit"]
    assert st["cols_iters"] > 0 and st["quad_iters"] > 0 and st["quad_frozen"] >= 0
    assert all(st[k] > 0 for k in ("lanczos_s", "cols_s", "quad_s", "vjp_s"))
    assert chip_smoke.stage_text(st).startswith("Lanczos")
    # alpha is the quadratic form's solution: (K + noise I) alpha = y
    K = tk.Lengthscale(tk.MaternP(2), 1.0)
    from cfjax_torch.operators.dispatch import gramian

    A = gramian(K, x).todense() + chip_smoke.NOISE * torch.eye(256, dtype=torch.float64)
    res = torch.linalg.norm(A @ st["alpha"] - y) / torch.linalg.norm(y)
    assert res < 1e-5


@needs_gpu
@pytest.mark.parametrize("job", ["nystrom", "gradient_cg"])
def test_host_syncs_match_sync_debug_warnings(job):
    """On the card, every wait of the host for the device inside
    gp_condition and the mean is one `host_syncs`: the count equals the
    warnings of the sync debug mode, with CG's step replayed from a CUDA
    graph and read once a block."""
    dev = torch.device("cuda")
    cfjax_torch.set_config(device="cuda", max_cholesky_size=512)
    try:
        g = torch.Generator().manual_seed(1)
        if job == "nystrom":
            x = torch.randn(2048, 3, generator=g).to(dev)
            k, y, kw = tk.MaternP(2), torch.sin(x[:, 0]), dict(precond_rank=64)
        else:
            x = 0.5 * torch.randn(256, 16, generator=g).to(dev)
            k, y, kw = GradientKernel(tk.EQ()), torch.cos(x).reshape(-1), {}
        gp_condition(k, x, y, noise=1e-2, tol=1e-5, maxiter=500, **kw).mean(x[:64])
        torch.cuda.synchronize()
        before = trace.counters()["host_syncs"]
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                trace.clear()
                with trace.recording():
                    post = gp_condition(k, x, y, noise=1e-2, tol=1e-5, maxiter=500, **kw)
                    post.mean(x[:64])
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = trace.counters()["host_syncs"] - before
        # the first switch to "warn" in a process warns once itself, from
        # torch.cuda's own frame: not a wait of the program's
        where = collections.Counter(f"{Path(w.filename).name}:{w.lineno}" for w in caught
                                    if "synchroniz" in str(w.message)
                                    and Path(w.filename) != Path(torch.cuda.__file__))
        assert sum(where.values()) == syncs, where
        (cgs,) = [s["attrs"] for s in trace.spans() if s["name"] == "solvers.cg"]
        assert cgs["captured"] == 1 and cgs["iters"] == post.solve_info[0] > 8
        assert syncs >= cgs["reads"] + 2 and cgs["reads"] < post.solve_info[0] / 4 + 4
    finally:
        trace.clear()
        cfjax_torch.set_config(device="cpu",
                               max_cholesky_size=cfjax_torch.config.Config.max_cholesky_size)


@needs_gpu
def test_device_spans_on_the_card():
    dev = torch.device("cuda")
    cfjax_torch.set_config(device="cuda")
    try:
        g = torch.Generator().manual_seed(2)
        x = torch.randn(2048, 3, generator=g).to(dev)
        y = torch.sin(x[:, 0])
        theta = torch.tensor([0.1], dtype=torch.float64, requires_grad=True)
        trace.clear()
        with trace.recording():
            v = log_marginal_likelihood(tk.Lengthscale(tk.MaternP(2), torch.exp(theta)), x, y,
                                        noise=1e-2)
            v.backward()
        sp = by_name(trace.spans())
        for s in ("build", "cholesky", "solve"):
            for name in (f"gp.logml.{s}", f"gp.logml.{s}.bwd"):
                (one,) = sp[name]
                assert one["attrs"]["device_ms"] > 0
        assert "device_ms" not in sp["gp.logml"][0]["attrs"]
    finally:
        trace.clear()
        cfjax_torch.set_config(device="cpu")
