"""Fused Gramian MVM kernels (counterpart of `cfjax.ops.pallas_mvm`).

Two CUDA kernels for Hopper, K1 in `cfjax_torch/csrc/gramian_mvm.cu` and
K2 in `cfjax_torch/csrc/expand_mvm.cu`:

  * K1 `gramian_matvec_direct` (replaces `pallas_gramian_matvec_direct`):
    b = K a for isotropic kernels at d <= 16, with the exact
    difference-form squared distance. A one-leaf profile (its spec's
    `family`, `kernels/profile_spec.py`) runs an instance specialised for
    its family, with register tiles and the profile in registers; any
    other profile runs the interpreted instance;
  * K1 `gramian_matmat_direct`, many columns: B = K A for A of shape
    (m, p), the same kernels, each entry's profile evaluated once for a
    chunk of 16 columns on the CUDA cores and contracted into them on the
    tensor cores at the matmul tier's passes (the SLQ probe batches and
    `cg_columns`); a spec that is not one leaf runs the interpreted
    instance once per column. A real-nu Matern is a family of both: its
    table (`utils/besselk.py` `matern_nu_knots`) is copied to the card
    once per nu and device (`matern_table`);
  * K2 `gramian_matvec_expand` (replaces `pallas_gramian_matvec`): b = K a
    for isotropic kernels at any d through ||x||^2 + ||y||^2 - 2 x.y, and
    for dot-product kernels through x.y, the x.y tile on the tensor cores
    at the matmul tier's passes (`tiles.TIER_PASSES`), a one-leaf profile
    through its family instance (the real-nu Matern's reads K1's table),
    any other through the interpreter.

The sources are compiled with nvcc for sm_90a at first use into `build/`
at the checkout root and loaded with ctypes (`ops/build.py`). Each
wrapper takes the kernel's plain torch version when its tensors lie on
the CPU; for CUDA tensors it launches the kernel or raises. `LAUNCHES`
counts kernel launches per kernel ("direct_cols" the many-column K1's,
one a call, or one a column for the interpreted instance; "matern" K1's
launches of the real-nu Matern family, single- and many-column,
"expand_matern" K2's; K3, in `ops/grad_mvm.py`, counts under "grad" and
its Matern family under "grad_matern"; K4, in `ops/tile_ell_mvm.py`,
under "tile_ell"). Both kernels are forward-only, like the Pallas
kernels.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from ..kernels.profile_spec import (FAMILY_CAUCHY, FAMILY_CONSTS, FAMILY_EQ, FAMILY_IMQ,
                                    FAMILY_MATERN, FAMILY_MATERN_NU, FAMILY_NONE, FAMILY_RQ,
                                    MAX_CONSTS, MAX_OPS, ProfileSpec, to_spec)
from ..utils.besselk import matern_nu_knots
from ..utils.roofline import Work
from . import build as _build
from .tiles import inner_tile, matmul_p, sqdist_tile, tier_passes

# largest d of the direct kernel (its template instances run d = 1..16)
DIRECT_MAX_D = 16
# row / column tile sizes of the kernels, for the column split
_K1_TM, _K1_TN = 64, 512
_K2_BM, _K2_BN = 64, 64
# K1's family instances: 128 rows per block; the staged tile's columns by
# the instance's D (d rounded up to 1, 2, 3, 4, 8 or 16)
_K1F_BM = 128
_K1F_TN = {1: 512, 2: 512, 3: 512, 4: 256, 8: 128, 16: 128}

LAUNCHES = {"direct": 0, "direct_cols": 0, "matern": 0, "expand": 0, "expand_matern": 0,
            "grad": 0, "grad_matern": 0, "tile_ell": 0}


class _CSpec(ctypes.Structure):
    _fields_ = [("n_ops", ctypes.c_int),
                ("op", ctypes.c_int * MAX_OPS),
                ("arg", ctypes.c_int * MAX_OPS),
                ("c", ctypes.c_float * MAX_CONSTS)]


class _CFamily(ctypes.Structure):
    _fields_ = [("c", ctypes.c_float * FAMILY_CONSTS), ("scale", ctypes.c_float)]


@functools.lru_cache(maxsize=64)
def _cfamily(spec: ProfileSpec) -> _CFamily:
    cf = _CFamily()
    for i, c in enumerate(spec.family_consts):
        cf.c[i] = c
    cf.scale = spec.family_scale
    return cf


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
    """The K1 library (built once per source digest), with its C
    signatures set."""
    lib = _build.load("gramian_mvm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.k1_gramian_matvec_direct.argtypes = [p, p, p, p, p, i, i, i, i, i, _CSpec, p]
    lib.k1_gramian_matvec_direct.restype = i
    lib.k1_gramian_matvec_family.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, _CFamily, p, p]
    lib.k1_gramian_matvec_family.restype = i
    lib.k1_gramian_matmat_family.argtypes = [p, p, p, p, p] + [i] * 9 + [_CFamily, p, p]
    lib.k1_gramian_matmat_family.restype = i
    lib.k1_gramian_matmat_shape.argtypes = [i, p, p, p]
    lib.k1_gramian_matmat_shape.restype = i
    return lib


@functools.cache
def _matmat_shape(d: int) -> tuple:
    """(rows a block, columns a staged tile, columns of A a chunk) of the
    many-column instance for d, as the library defines them."""
    rows, cols, chunk = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = library().k1_gramian_matmat_shape(d, ctypes.byref(rows), ctypes.byref(cols),
                                            ctypes.byref(chunk))
    if err != 0:
        raise ValueError(f"no many-column K1 instance for d={d}")
    return rows.value, cols.value, chunk.value


@functools.cache
def expand_library() -> ctypes.CDLL:
    """The K2 library (built once per source digest), with its C signature
    set."""
    lib = _build.load("expand_mvm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.k2_gramian_matvec_expand.argtypes = [p] * 7 + [i] * 10 + [_CSpec, _CFamily, p, p]
    lib.k2_gramian_matvec_expand.restype = i
    return lib


@functools.lru_cache(maxsize=16)
def matern_table(nu: float, device: torch.device) -> torch.Tensor:
    """The real-nu Matern family's table of nu on `device`, float32
    (MATERN_KNOTS, 4): copied once per nu and device, so a fit that moves
    nu builds and copies a new one and nothing else does."""
    return matern_nu_knots(nu).to(device=device, dtype=torch.float32).contiguous()


def family_table(spec, device):
    """A family spec's table on `device` (the real-nu Matern's), else None."""
    if spec is None or spec.family != FAMILY_MATERN_NU:
        return None
    return matern_table(spec.family_consts[-1], device)


def _cdiv(a, b):
    return -(-a // b)


@functools.cache
def sm_count(index: int) -> int:
    """The SMs of CUDA device `index` (read once: the wrappers ask on
    every launch)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def column_split(n_row_blocks: int, m: int, tn: int, device) -> tuple:
    """(splits, columns per split): split the columns over gridDim.y so
    that about 4 blocks per SM are in flight, in whole column tiles."""
    col_tiles = _cdiv(m, tn)
    sms = sm_count(device.index)
    want = max(1, min(col_tiles, _cdiv(4 * sms, n_row_blocks)))
    per = _cdiv(col_tiles, want)
    return _cdiv(col_tiles, per), per * tn


def vec4_ok(d, *ts):
    """The tensor-core kernels stage rows with 16-byte copies: d a multiple
    of 4 and every array 16-byte aligned."""
    return d % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in ts)


def _check_inputs(k, x, y, a, spec, mode, cols=False):
    """The value kernels' input contract (K1, K2; `cols`: a is (m, p))."""
    ts = (x, y, a)
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError("x, y and a must lie on one CUDA device")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("the CUDA Gramian MVM kernels take float32 tensors")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("x, y and a must be contiguous")
    if x.ndim != 2 or y.ndim != 2 or a.ndim != 1 + cols or x.shape[1] != y.shape[1] \
            or a.shape[0] != y.shape[0]:
        raise ValueError(f"shapes x {tuple(x.shape)}, y {tuple(y.shape)}, a "
                         f"{tuple(a.shape)}: need (n, d), (m, d), " + ("(m, p)" if cols else "(m,)"))
    if torch.is_grad_enabled() and (any(t.requires_grad for t in ts) or any(
            b.requires_grad for b in k.buffers())):
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


@contextlib.contextmanager
def uncounted():
    """Launches inside the block are taken back out of LAUNCHES: for a
    product made only to hold a kernel against its plain version."""
    saved = dict(LAUNCHES)
    try:
        yield
    finally:
        LAUNCHES.update(saved)


def _launch(kind, fn, out, *args):
    # the current stream's raw handle, read without building a
    # torch.cuda.Stream object on every launch
    err = fn(*args, torch._C._cuda_getCurrentRawStream(out.device.index))
    if err != 0:
        raise RuntimeError(f"CUDA Gramian MVM kernel {kind!r} failed to launch: "
                           f"cudaError {err}")
    LAUNCHES[kind] += 1
    return out


def _ptr(t):
    """A tensor's address for a `c_void_p` argument (None for NULL)."""
    return t.data_ptr() if t is not None else None


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


def gramian_matmat_direct_plain(k, x, y, A, block: int = 512, precision=None):
    """Plain torch version of the many-column K1: B = K A for A of shape
    (m, p), the squared distance by the difference form, row block by row
    block, each kernel tile contracted against all columns at once at the
    matmul tier `precision` (`tiles.matmul_p`: exact on the CPU)."""
    out = [matmul_p(k.profile_value(sqdist_tile(x[i:i + block], y, direct_max_d=x.shape[1])),
                    A, precision)
           for i in range(0, x.shape[0], block)]
    return torch.cat(out) if out else A.new_zeros((0, A.shape[1]))


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


def profile_ops(spec: ProfileSpec) -> tuple:
    """(fp32 instructions, SFU operations) of a one-leaf value profile per
    entry: its family's least work (EQ: FMUL, ex2; MaternP(p): max, 2 FMUL,
    the Horner steps, rsqrt, ex2; RQ: FFMA, FMUL, lg2, ex2; Cauchy and
    IMQ: FFMA, rcp / rsqrt; the tabulated real-nu Matern: max, the root
    and its residual (4), x and its rounding error (4), the interval's
    offset and its correction (3), the cubic (4), the knot's factor, the
    guard's two compares, rsqrt and ex2). An interpreted profile has no
    fixed count: its caller counts it (e.g. `utils.besselk.matern_nu_ops`)."""
    p = spec.family_p
    ops = {FAMILY_EQ: (1, 1), FAMILY_MATERN: (3 + p + (p > 0), 2), FAMILY_RQ: (2, 2),
           FAMILY_CAUCHY: (1, 1), FAMILY_IMQ: (1, 1), FAMILY_MATERN_NU: (19, 2)}
    if spec.jet or spec.family not in ops:
        raise ValueError("profile_ops counts the value families; an interpreted or "
                         "derivative spec is counted by its caller")
    return ops[spec.family]


def work_direct(n: int, m: int, d: int, profile: tuple, p: int = None,
                passes: int = 3) -> Work:
    """The least work of K1's function on this card: b = K a for x (n, d),
    y (m, d), a (m,), or with `p` columns B = K A. Per entry: 2d fp32 for
    the difference-form distance and the profile's (fp32, SFU) `profile`
    (`profile_ops`); one FFMA into the row sum for b = K a, and for B = K A
    2p tensor-core flops at the tier's tf32 `passes`, where the product's
    least work lies. Bytes: x, y and a (A) read once, b (B) written once,
    float32."""
    fp32, sfu = profile
    e = float(n) * m
    if p is None:
        return Work(fp32=e * (2 * d + fp32 + 1), sfu=e * sfu,
                    hbm_bytes=4.0 * ((n + m) * d + m + n))
    return Work(fp32=e * (2 * d + fp32), sfu=e * sfu, tc_flops=e * 2 * p, tc_passes=passes,
                hbm_bytes=4.0 * ((n + m) * d + (m + n) * p))


def work_expand(n: int, m: int, d: int, profile: tuple, passes: int,
                mode: str = "iso") -> Work:
    """The least work of K2's function on this card: b = K a through the
    x.y tile, 2d tensor-core flops an entry at the tier's tf32 `passes`;
    per entry the expansion (FADD, FFMA, FMNMX; iso only), the profile's
    (fp32, SFU) and the row sum's FFMA. Bytes as `work_direct`."""
    fp32, sfu = profile
    e = float(n) * m
    return Work(fp32=e * ((3 if mode == "iso" else 0) + fp32 + 1), sfu=e * sfu,
                tc_flops=e * 2 * d, tc_passes=passes,
                hbm_bytes=4.0 * ((n + m) * d + m + n))


def gramian_matvec_direct(k, x, y, a, spec: ProfileSpec = None):
    """K1: b = K a for an isotropic kernel at d <= 16 (CUDA), or its plain
    version for CPU tensors."""
    if not x.is_cuda:
        return gramian_matvec_direct_plain(k, x, y, a)
    spec = _check_inputs(k, x, y, a, spec, "iso")
    return _matvec_direct(x, y, a, spec, "direct")


def _check_direct_d(d):
    if not 1 <= d <= DIRECT_MAX_D:
        raise ValueError(f"the direct kernel takes 1 <= d <= {DIRECT_MAX_D}, got d={d}")


def _instance_d(d):
    """The D of K1's family instance for d: 1, 2, 3, 4, 8 or 16."""
    return next(D for D in sorted(_K1F_TN) if D >= d)


def _matvec_direct(x, y, a, spec, kind):
    """One K1 launch on checked inputs, counted under LAUNCHES[kind]."""
    n, d = x.shape
    m = y.shape[0]
    _check_direct_d(d)
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    if n == 0 or m == 0:
        return out.zero_()
    family = spec.family != FAMILY_NONE
    if spec.family == FAMILY_MATERN_NU:
        kind = "matern"
    if family:
        splits, per = column_split(_cdiv(n, _K1F_BM), m, _K1F_TN[_instance_d(d)], x.device)
    else:
        splits, per = column_split(_cdiv(n, _K1_TM), m, _K1_TN, x.device)
    partial = out if splits == 1 else torch.empty((splits, n), dtype=torch.float32,
                                                  device=x.device)
    args = (_ptr(x), _ptr(y), _ptr(a), _ptr(partial), _ptr(out), n, m, d, splits, per)
    if family:
        return _launch(kind, library().k1_gramian_matvec_family, out, *args, spec.family,
                       spec.family_p, _cfamily(spec), _ptr(family_table(spec, x.device)))
    return _launch(kind, library().k1_gramian_matvec_direct, out, *args, _cspec(spec))


def gramian_matmat_direct(k, x, y, A, spec: ProfileSpec = None, precision=None):
    """The many-column K1: B = K A for an isotropic kernel at d <= 16 and A
    of shape (m, p) (CUDA), or its plain version for CPU tensors. A
    one-leaf profile runs one launch of its family instance over chunks of
    16 columns, the product on the tensor cores at the tier's passes
    (`precision`, else the configured matmul_precision); any other runs
    the interpreted single-column instance once per column."""
    if not x.is_cuda:
        return gramian_matmat_direct_plain(k, x, y, A, precision=precision)
    spec = _check_inputs(k, x, y, A, spec, "iso", cols=True)
    n, d = x.shape
    m, p = A.shape
    _check_direct_d(d)
    if n * p >= 2 ** 31:
        raise ValueError(f"n p = {n * p} entries: the kernel indexes them with int")
    if spec.family == FAMILY_NONE:
        cols = [_matvec_direct(x, y, A[:, c].contiguous(), spec, "direct_cols")
                for c in range(p)]
        return torch.stack(cols, dim=1) if cols else A.new_zeros((n, 0))
    out = torch.empty((n, p), dtype=torch.float32, device=x.device)
    if n == 0 or m == 0 or p == 0:
        return out.zero_()
    bm, tn, chunk = _matmat_shape(d)
    splits, per = column_split(_cdiv(n, bm) * _cdiv(p, chunk), m, tn, x.device)
    partial = out if splits == 1 else torch.empty((splits, n, p), dtype=torch.float32,
                                                  device=x.device)
    kind = "matern" if spec.family == FAMILY_MATERN_NU else "direct_cols"
    return _launch(kind, library().k1_gramian_matmat_family, out, _ptr(x), _ptr(y),
                   _ptr(A), _ptr(partial), _ptr(out), n, m, d, p, splits, per,
                   spec.family, spec.family_p, tier_passes(precision), _cfamily(spec),
                   _ptr(family_table(spec, x.device)))


def expand_route(spec: ProfileSpec) -> str:
    """The LAUNCHES key of K2's instance for a value spec: "expand_matern"
    for the real-nu Matern family (its table, `family_table`), else
    "expand" (the other families and the interpreter)."""
    return "expand_matern" if spec.family == FAMILY_MATERN_NU else "expand"


def gramian_matvec_expand(k, x, y, a, mode: str = "iso", precision=None,
                          spec: ProfileSpec = None):
    """K2: b = K a for an isotropic (any d) or dot-product kernel (CUDA),
    or its plain version for CPU tensors. The x.y tile runs at the
    tier's tensor-core passes (`precision`, else the configured
    matmul_precision)."""
    if not x.is_cuda:
        return gramian_matvec_expand_plain(k, x, y, a, mode, precision)
    spec = _check_inputs(k, x, y, a, spec, mode)
    passes = tier_passes(precision)
    n, d = x.shape
    m = y.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    if n == 0 or m == 0:
        return out.zero_()
    x2 = torch.sum(x * x, dim=1) if mode == "iso" else None
    y2 = torch.sum(y * y, dim=1) if mode == "iso" else None
    splits, per = column_split(_cdiv(n, _K2_BM), m, _K2_BN, x.device)
    partial = out if splits == 1 else torch.empty((splits, n), dtype=torch.float32,
                                                  device=x.device)
    return _launch(expand_route(spec), expand_library().k2_gramian_matvec_expand, out,
                   _ptr(x), _ptr(y), _ptr(x2), _ptr(y2), _ptr(a), _ptr(partial),
                   _ptr(out), n, m, d, int(mode == "iso"), splits, per, passes,
                   spec.family, spec.family_p, int(vec4_ok(d, x, y)), _cspec(spec),
                   _cfamily(spec), _ptr(family_table(spec, x.device)))
