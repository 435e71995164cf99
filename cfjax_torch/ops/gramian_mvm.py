"""Fused Gramian MVM kernels (counterpart of `cfjax.ops.pallas_mvm`).

Two CUDA kernels for Hopper, in `cfjax_torch/csrc/gramian_mvm.cu`:

  * K1 `gramian_matvec_direct` (replaces `pallas_gramian_matvec_direct`):
    b = K a for isotropic kernels at d <= 16, with the exact
    difference-form squared distance;
  * K2 `gramian_matvec_expand` (replaces `pallas_gramian_matvec`): b = K a
    for isotropic kernels at any d through ||x||^2 + ||y||^2 - 2 x.y, and
    for dot-product kernels through x.y, in full fp32 ("highest" tier).

The source is compiled with nvcc for sm_90a at first use into `build/`
at the checkout root and loaded with ctypes (`ops/build.py`). Each
wrapper takes the kernel's plain torch version when its tensors lie on
the CPU; for CUDA tensors it launches the kernel or raises. `LAUNCHES`
counts kernel launches per kernel (K3, in `ops/grad_mvm.py`, counts
under "grad"; K4, in `ops/tile_ell_mvm.py`, under "tile_ell"). Both
kernels are forward-only, like the Pallas kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..kernels.profile_spec import MAX_CONSTS, MAX_OPS, ProfileSpec, to_spec
from . import build as _build
from .tiles import sqdist_tile, inner_tile, resolve_precision

# largest d of the direct kernel (its template instances run d = 1..16)
DIRECT_MAX_D = 16
# row / column tile sizes of the kernels, for the column split
_K1_TM, _K1_TN = 64, 512
_K2_BM, _K2_BN = 64, 64

LAUNCHES = {"direct": 0, "expand": 0, "grad": 0, "tile_ell": 0}


class _CSpec(ctypes.Structure):
    _fields_ = [("n_ops", ctypes.c_int),
                ("op", ctypes.c_int * MAX_OPS),
                ("arg", ctypes.c_int * MAX_OPS),
                ("c", ctypes.c_float * MAX_CONSTS)]


@functools.lru_cache(maxsize=64)
def _cspec(spec: ProfileSpec) -> _CSpec:
    cs = _CSpec()
    cs.n_ops = len(spec.ops)
    for i, (op, a) in enumerate(zip(spec.ops, spec.args)):
        cs.op[i] = op
        cs.arg[i] = a
    for i, c in enumerate(spec.consts):
        cs.c[i] = c
    return cs


@functools.cache
def library() -> ctypes.CDLL:
    """The K1/K2 library (built once per source digest), with its C
    signatures set."""
    lib = _build.load("gramian_mvm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.k1_gramian_matvec_direct.argtypes = [p, p, p, p, p, i, i, i, i, i, _CSpec, p]
    lib.k1_gramian_matvec_direct.restype = i
    lib.k2_gramian_matvec_expand.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, _CSpec, p]
    lib.k2_gramian_matvec_expand.restype = i
    return lib


def _cdiv(a, b):
    return -(-a // b)


def column_split(n_row_blocks: int, m: int, tn: int, device) -> tuple:
    """(splits, columns per split): split the columns over gridDim.y so
    that about 4 blocks per SM are in flight, in whole column tiles."""
    col_tiles = _cdiv(m, tn)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = max(1, min(col_tiles, _cdiv(4 * sms, n_row_blocks)))
    per = _cdiv(col_tiles, want)
    return _cdiv(col_tiles, per), per * tn


def _check_inputs(k, x, y, a, spec, mode):
    """The value kernels' input contract (K1, K2)."""
    ts = (x, y, a)
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError("x, y and a must lie on one CUDA device")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("the CUDA Gramian MVM kernels take float32 tensors")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("x, y and a must be contiguous")
    if x.ndim != 2 or y.ndim != 2 or a.ndim != 1 or x.shape[1] != y.shape[1] \
            or a.shape[0] != y.shape[0]:
        raise ValueError(f"shapes x {tuple(x.shape)}, y {tuple(y.shape)}, a "
                         f"{tuple(a.shape)}: need (n, d), (m, d), (m,)")
    if any(t.requires_grad for t in ts) or any(
            b.requires_grad for b in k.buffers()):
        raise RuntimeError("the CUDA Gramian MVM kernels are forward-only: an "
                           "input requires grad")
    if spec is None:
        spec, why = to_spec(k)
        if spec is None:
            raise ValueError(f"no profile spec for this kernel: {why}")
    if spec.jet:
        raise ValueError("the value kernels take a value spec, not a derivative spec")
    if spec.mode != mode:
        raise ValueError(f"kernel mode {spec.mode!r}, this kernel takes {mode!r}")
    return spec


def _launch(kind, fn, out, *args):
    err = fn(*args, ctypes.c_void_p(torch.cuda.current_stream(out.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"CUDA Gramian MVM kernel {kind!r} failed to launch: "
                           f"cudaError {err}")
    LAUNCHES[kind] += 1
    return out


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr()) if t is not None else ctypes.c_void_p(None)


def _blocked(tile, k, x, y, a, block):
    n = x.shape[0]
    out = [torch.sum(k.profile_value(tile(x[i:i + block], y)) * a[None, :], dim=1)
           for i in range(0, n, block)]
    return torch.cat(out) if out else x.new_zeros((0,))


def gramian_matvec_direct_plain(k, x, y, a, block: int = 512):
    """Plain torch version of K1: b = K a, the squared distance by the
    difference form sum_i (x_i - y_i)^2, row block by row block."""
    return _blocked(lambda xb, yy: sqdist_tile(xb, yy, direct_max_d=x.shape[1]),
                    k, x, y, a, block)


def gramian_matvec_expand_plain(k, x, y, a, mode: str = "iso", precision=None,
                                block: int = 512):
    """Plain torch version of K2: b = K a with the profile of
    clamp(||x||^2 + ||y||^2 - 2 x.y, 0) (iso) or of x.y (dot), the inner
    products at `precision`."""
    if mode == "iso":
        tile = lambda xb, yy: sqdist_tile(xb, yy, precision, direct_max_d=0)
    else:
        tile = lambda xb, yy: inner_tile(xb, yy, precision)
    return _blocked(tile, k, x, y, a, block)


def gramian_matvec_direct(k, x, y, a, spec: ProfileSpec = None):
    """K1: b = K a for an isotropic kernel at d <= 16 (CUDA), or its plain
    version for CPU tensors."""
    if not x.is_cuda:
        return gramian_matvec_direct_plain(k, x, y, a)
    spec = _check_inputs(k, x, y, a, spec, "iso")
    n, d = x.shape
    m = y.shape[0]
    if not 1 <= d <= DIRECT_MAX_D:
        raise ValueError(f"the direct kernel takes 1 <= d <= {DIRECT_MAX_D}, got d={d}")
    out = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n == 0 or m == 0:
        return out.zero_()
    splits, per = column_split(_cdiv(n, _K1_TM), m, _K1_TN, x.device)
    partial = out if splits == 1 else torch.empty((splits, n), dtype=torch.float32,
                                                  device=x.device)
    return _launch("direct", library().k1_gramian_matvec_direct, out,
                   _ptr(x), _ptr(y), _ptr(a), _ptr(partial), _ptr(out), n, m, d,
                   splits, per, _cspec(spec))


def gramian_matvec_expand(k, x, y, a, mode: str = "iso", precision=None,
                          spec: ProfileSpec = None):
    """K2: b = K a for an isotropic (any d) or dot-product kernel (CUDA),
    or its plain version for CPU tensors. The kernel computes the
    "highest" tier only."""
    if not x.is_cuda:
        return gramian_matvec_expand_plain(k, x, y, a, mode, precision)
    spec = _check_inputs(k, x, y, a, spec, mode)
    if resolve_precision(precision) != "highest":
        raise ValueError("the expansion kernel computes full fp32 inner products "
                         "only; the tf32 tiers are not ported yet")
    n, d = x.shape
    m = y.shape[0]
    out = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n == 0 or m == 0:
        return out.zero_()
    x2 = torch.sum(x * x, dim=1) if mode == "iso" else None
    y2 = torch.sum(y * y, dim=1) if mode == "iso" else None
    splits, per = column_split(_cdiv(n, _K2_BM), m, _K2_BN, x.device)
    partial = out if splits == 1 else torch.empty((splits, n), dtype=torch.float32,
                                                  device=x.device)
    return _launch("expand", library().k2_gramian_matvec_expand, out,
                   _ptr(x), _ptr(y), _ptr(x2), _ptr(y2), _ptr(a), _ptr(partial),
                   _ptr(out), n, m, d, int(mode == "iso"), splits, per, _cspec(spec))
