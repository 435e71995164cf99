"""Test oracles and property probes (counterpart of `cfjax.utils.testing`,
reference src/util.jl:91-149).

`pairwise` evaluates the kernel matrix pair by pair through nested
`torch.func.vmap` over the kernel's own `__call__` — the generic path,
independent of the trait-specialized tiles. The Nystrom build uses
`pairwise_xy` for its landmark panels. `ispsd` and `iscov` test a matrix;
`isstationary_probe` and `isisotropic_probe` test a kernel on numpy draws
from the same seeds as cfjax's, on the CPU in float64. `run_world` runs a
function on every rank of a spawned `torch.distributed` world (the tests
of `cfjax_torch.parallel` and the card's multi-rank smoke phase).
`kernel_runs` counts the port's kernels that ran on the card, from a
profiler trace."""

from __future__ import annotations

import contextlib
import os
import pickle
import re
import tempfile
import time

import numpy as np
import torch
from torch.func import vmap


def pairwise_xy(k, x, y):
    return vmap(lambda xi: vmap(lambda yj: k(xi, yj))(y))(x)


def pairwise(k, x, y=None):
    """Dense kernel matrix by direct per-pair evaluation (oracle; O(n m)
    memory — test use only)."""
    x = torch.as_tensor(x)
    y = x if y is None else torch.as_tensor(y)
    return pairwise_xy(k, x, y)


def _numpy(A):
    return A.detach().cpu().numpy() if isinstance(A, torch.Tensor) else np.asarray(A)


def ispsd(A, tol: float = 1e-8) -> bool:
    ev = np.linalg.eigvalsh(_numpy(A))
    return bool(ev.min() > -tol)


def iscov(A, tol: float = 1e-8) -> bool:
    A = _numpy(A)
    return bool(np.allclose(A, A.T, atol=tol)) and ispsd(A, tol)


def _probe_matrices(k, x, y, transform):
    a = pairwise_xy(k, torch.from_numpy(x), torch.from_numpy(y))
    b = pairwise_xy(k, torch.from_numpy(transform(x)), torch.from_numpy(transform(y)))
    return _numpy(a), _numpy(b)


def isstationary_probe(k, d: int = 3, n: int = 16, seed: int = 0, tol=1e-8) -> bool:
    """Randomized check that k(x + s, y + s) == k(x, y) (src/util.jl:103-126)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d))
    y = rng.standard_normal((n, d))
    s = rng.standard_normal((1, d))
    a, b = _probe_matrices(k, x, y, lambda z: z + s)
    return bool(np.allclose(a, b, atol=tol))


def isisotropic_probe(k, d: int = 3, n: int = 16, seed: int = 0, tol=1e-8) -> bool:
    """Randomized check of rotation invariance (src/util.jl:128-149)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d))
    y = rng.standard_normal((n, d))
    Q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    a, b = _probe_matrices(k, x, y, lambda z: z @ Q.T)
    return isstationary_probe(k, d, n, seed, tol) and bool(np.allclose(a, b, atol=tol))


def _to_numpy(out):
    """`out` with every tensor in it (nested in dicts, lists, tuples) as a
    numpy array, so the result unpickles without torch's device state."""
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    if isinstance(out, dict):
        return {k: _to_numpy(v) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(_to_numpy(v) for v in out)
    return out


def _rank_main(rank, world, backend, device, tmp, fn, args):
    import torch.distributed as dist

    from .. import config

    config.set_config(device=device)
    if torch.device(device).type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world)
    try:
        out = fn(*args)
        if rank == 0:
            with open(os.path.join(tmp, "result.pkl"), "wb") as f:
                pickle.dump(_to_numpy(out), f)
    finally:
        dist.destroy_process_group()


def run_world(fn, world: int, *args, backend: str = "gloo", device: str = "cpu"):
    """Run `fn(*args)` on each of `world` ranks and return rank 0's result,
    its tensors as numpy arrays.

    The ranks are processes started by `torch.multiprocessing` with the
    "spawn" method. They meet through a `FileStore` in a fresh temporary
    directory, never a TCP port, so worlds started at once (test workers)
    cannot collide. Each rank sets the port's default device to `device`
    and joins a process group of `backend` before it calls `fn`; several
    ranks may share one card. A rank that raises or dies fails the call
    (`torch.multiprocessing.ProcessRaisedException` or
    `ProcessExitedException`). `fn` is pickled by name: it must be a
    module-level function of a module that imports no jax, since each rank
    imports that module anew."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank_main, args=(world, backend, device, tmp, fn, args),
                           nprocs=world, join=True, start_method="spawn")
        with open(os.path.join(tmp, "result.pkl"), "rb") as f:
            return pickle.load(f)


PAD_S = 0.005
# the profiler's warm-up before each trace's window: kernels and host time
PRIME, WARM_S = 8, 0.05


@contextlib.contextmanager
def kernel_runs(*names):
    """Count how often the CUDA kernels `names` (their function names in
    `csrc/`, e.g. "k1_family", "k3_tc", or a template's name with the start
    of its arguments, e.g. "k2_tc<true") ran on the device inside the block,
    from a `torch.profiler` trace of the device alone. The dict yielded is
    filled when the block ends. A kernel captured in a CUDA graph runs once
    a replay, where `ops.gramian_mvm.LAUNCHES` counts the host's launches:
    the capture once. Without CUDA every count is 0.

    The trace's window is padded: the device is idle when it opens, and
    `PAD_S` of host time passes, the device idle, after it opens and
    before it closes. Unpadded, 4 of about 80 traces of a solve on an
    H100 missed one to three of its kernels. Padded, the traces of a
    whole-file run of tests/test_torch_cuda.py on an H100 still lost
    the first three device records of nearly every window, and nothing
    after them; `PRIME` fills of a one-float buffer launched as the
    window opened took that loss there, but alone the same tests then
    lost the fills and a solve's first product besides (PERF.md). So
    the profiler is prepared in a warm-up step of its schedule, which
    keeps nothing: the fills and `WARM_S` of host time run there, and
    the window opens after it. Then a whole-file run counted every run;
    the process that had compiled the kernels on a fresh machine still
    lost about 7 records at the start of most of its windows, with pads
    of 5 or 50 ms alike (PERF.md)."""
    out = dict.fromkeys(names, 0)
    if not torch.cuda.is_available():
        yield out
        return
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    def pad():
        torch.cuda.synchronize()
        time.sleep(PAD_S)

    pats = {name: re.compile(rf"(^|\s){re.escape(name)}\b") for name in names}
    buf = torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True,
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        for _ in range(PRIME):
            buf.fill_(0.0)
        torch.cuda.synchronize()
        time.sleep(WARM_S)
        prof.step()
        pad()
        yield out
        pad()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for name, pat in pats.items():
                out[name] += bool(pat.search(e.name))
