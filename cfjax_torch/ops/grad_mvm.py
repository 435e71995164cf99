"""K3: the gradient-gramian block MVM (counterpart of
`cfjax.ops.pallas_mvm.pallas_grad_matvec`).

For x (n, d), y (m, d) and A (m, d), out_i = sum_j B_ij A_j with the
d x d block B_ij = grad_x grad_y^T k(x_i, y_j) of an isotropic or
dot-product kernel:
  iso: B_ij a = -2 f'(s) a - 4 f''(s) <r, a> r,  s = |r|^2, r = x_i - y_j;
  dot: B_ij a = f'(s) a + f''(s) <x_i, a> y_j,   s = <x_i, y_j>.

`grad_matvec` launches the hand-written CUDA kernel
(`cfjax_torch/csrc/grad_mvm.cu`, built by `ops/build.py`) on CUDA tensors
and raises on what it does not take; on CPU tensors it takes the plain
torch version `grad_matvec_plain`, which takes f' and f'' from autodiff of
`k.profile` and forms s and <r, A> as cfjax's `grad_matvec_iso` does, its
products at the matmul tier. The kernel runs its four products on the
tensor cores at the tier's passes (`tiles.TIER_PASSES`), takes f' and f''
from the derivative spec's family in registers (`to_spec(k,
derivative=True)`, one-leaf kernels; the real-nu Matern's from two
tables, `matern_jet_table`) or its interpreted jet, and recomputes every
near-coincident pair in difference form, exact at coincident points (see
the source's header). Forward-only, like the Pallas kernel. Launches
count in `gramian_mvm.LAUNCHES["grad"]`, the real-nu Matern family's
under "grad_matern".
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..kernels.derivatives import elementwise_derivatives
from ..kernels.profile_spec import (FAMILY_EQ, FAMILY_MATERN, FAMILY_MATERN_NU, JET_CONSTS,
                                    ProfileSpec, to_spec)
from ..utils.besselk import matern_nu_jet_knots
from ..utils.roofline import Work
from . import build as _build
from .gramian_mvm import _cdiv, _CSpec, _cspec, _launch, _ptr, column_split, vec4_ok
from .tiles import inner_tile, map_rows, matmul_p, sqdist_tile, tier_passes

# row / column tile sizes of the kernel, for the column split
_K3_TM, _K3_TN = 128, 64
# most column tiles one split sums into its partial output (see grad_mvm.cu)
_K3_MAX_TILES = 64
# most bytes of the splits' partial outputs (splits x n x d floats) at large d
_K3_PARTIAL_BYTES = 1 << 26
# the near-coincident threshold tau of the kernel (K3_TAU in grad_mvm.cu): a
# pair with s <= tau (|x_i|^2 + |y_j|^2) is recomputed in difference form
NEAR_TAU = 2.0 ** -6


class _CJet(ctypes.Structure):
    _fields_ = [("c", ctypes.c_float * JET_CONSTS)]


@functools.lru_cache(maxsize=64)
def _cjet(spec: ProfileSpec) -> _CJet:
    cj = _CJet()
    for i, c in enumerate(spec.family_consts):
        cj.c[i] = c
    return cj


@functools.cache
def library() -> ctypes.CDLL:
    """The K3 library (built once per source digest), with its C signature set."""
    lib = _build.load("grad_mvm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.k3_grad_matvec.argtypes = [p] * 8 + [i] * 10 + [_CSpec, _CJet, p, p]
    lib.k3_grad_matvec.restype = i
    return lib


# (fp32 instructions, SFU operations) of a derivative family's jet f', f''
# per entry, by (family, p): EQ's FMUL, ex2 and two FMUL; MaternP(2)'s
# eleven fp32 and rsqrt, ex2, rcp; the tabulated real-nu Matern's
# (csrc/profile_spec.cuh `matern_nu_jet_tabled`) max, the root and its
# residual (4), x and its rounding error (4), the interval's offset and its
# correction (3), each table's cubic (4) and knot factor (1), the two
# folded constants, the guard's two compares, and rsqrt and two ex2
JET_OPS = {(FAMILY_EQ, 0): (3, 1), (FAMILY_MATERN, 2): (11, 3),
           (FAMILY_MATERN_NU, 0): (26, 3)}


@functools.lru_cache(maxsize=16)
def matern_jet_table(nu: float, device: torch.device) -> torch.Tensor:
    """The real-nu Matern jet family's two tables of nu on `device`, float32
    (2 MATERN_JET_KNOTS, 4): -f' then f'' (`utils/besselk.py`
    `matern_nu_jet_knots`), copied once per nu and device."""
    return torch.cat(matern_nu_jet_knots(nu)).to(device=device, dtype=torch.float32).contiguous()


def grad_route(spec: ProfileSpec) -> str:
    """The LAUNCHES key of K3's instance for a derivative spec:
    "grad_matern" for the real-nu Matern jet family (its tables,
    `jet_table`), else "grad"."""
    return "grad_matern" if spec.family == FAMILY_MATERN_NU else "grad"


def jet_table(spec, device):
    """A derivative family spec's tables on `device` (the real-nu Matern's),
    else None."""
    if spec.family != FAMILY_MATERN_NU:
        return None
    return matern_jet_table(spec.family_consts[-1], device)


def jet_ops(spec: ProfileSpec) -> tuple:
    """(fp32, SFU) of a derivative spec's family jet per entry (`JET_OPS`)."""
    try:
        return JET_OPS[spec.family, spec.family_p]
    except KeyError:
        raise ValueError(f"no operation count for the jet of family {spec.family} "
                         f"p={spec.family_p}") from None


def work_grad(n: int, m: int, d: int, jet: tuple, passes: int) -> Work:
    """The least work of K3's function on this card: out_i = sum_j B_ij A_j
    over the d x d gradient blocks, x (n, d), y and A (m, d). Its four
    (n, d) x (d, m) products, 8d tensor-core flops a pair at the tier's tf32
    `passes`; per pair the expansion and tau test (4), w (1), alpha, beta
    and rowsum(beta) (4), the clamp (1), and the jet's (fp32, SFU) `jet`
    (`jet_ops`). Bytes: x, y and A read once, out written once, float32."""
    fp32, sfu = jet
    e = float(n) * m
    return Work(fp32=e * (10 + fp32), sfu=e * sfu, tc_flops=e * 8 * d, tc_passes=passes,
                hbm_bytes=4.0 * (2 * n * d + 2 * m * d))


def grad_matvec_plain(k, x, y, A, mode: str = "iso", block: int = 256, precision=None):
    """Plain torch version of K3, row block by row block: the same closed
    form, with f' and f'' from autodiff of `k.profile`, the squared
    distance from `sqdist_tile` and <r_ij, A_j> = <x_i, A_j> - <y_j, A_j>,
    the products at `precision` (else the configured matmul tier)."""
    if mode not in ("iso", "dot"):
        raise ValueError(f"grad_matvec_plain covers iso and dot, not {mode!r}")
    t = torch.sum(y * A, dim=1)  # <y_j, A_j>
    p = precision

    def body(xb):
        if mode == "dot":
            _, k1, k2 = elementwise_derivatives(k.profile, inner_tile(xb, y, p), 2)
            return matmul_p(k1, A, p) + matmul_p(k2 * inner_tile(xb, A, p), y, p)
        _, k1, k2 = elementwise_derivatives(k.profile, sqdist_tile(xb, y, p), 2)
        W = k2 * (inner_tile(xb, A, p) - t[None, :])  # f'' <r_ij, A_j>
        return -2.0 * matmul_p(k1, A, p) - 4.0 * (torch.sum(W, dim=1)[:, None] * xb
                                                  - matmul_p(W, y, p))

    return map_rows(body, x, block, x.shape[1])


def _check_inputs(k, x, y, A, spec, mode):
    ts = (x, y, A)
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError("x, y and A must lie on one CUDA device")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("the CUDA gradient-block kernel takes float32 tensors")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("x, y and A must be contiguous")
    if x.ndim != 2 or y.ndim != 2 or tuple(A.shape) != tuple(y.shape) \
            or x.shape[1] != y.shape[1]:
        raise ValueError(f"shapes x {tuple(x.shape)}, y {tuple(y.shape)}, A "
                         f"{tuple(A.shape)}: need (n, d), (m, d), (m, d)")
    if any(t.requires_grad for t in ts) or any(b.requires_grad for b in k.buffers()):
        raise RuntimeError("the CUDA gradient-block kernel is forward-only: an input "
                           "requires grad")
    if spec is None:
        spec, why = to_spec(k, derivative=True)
        if spec is None:
            raise ValueError(f"no derivative spec for this kernel: {why}")
    if not spec.jet:
        raise ValueError("the gradient-block kernel takes a derivative spec "
                         "(to_spec(k, derivative=True)), not a value spec")
    if spec.mode != mode:
        raise ValueError(f"kernel mode {spec.mode!r}, this call takes {mode!r}")
    return spec


def grad_matvec(k, x, y, A, mode: str = "iso", spec: ProfileSpec = None, precision=None):
    """K3: the gradient-gramian block MVM (CUDA), or its plain version for
    CPU tensors. x (n, d), y (m, d), A (m, d) -> (n, d). The products run
    at the tier's tensor-core passes (`precision`, else the configured
    matmul_precision)."""
    if not x.is_cuda:
        return grad_matvec_plain(k, x, y, A, mode, precision=precision)
    spec = _check_inputs(k, x, y, A, spec, mode)
    passes = tier_passes(precision)
    n, d = x.shape
    m = y.shape[0]
    out = torch.empty((n, d), dtype=torch.float32, device=x.device)
    if n == 0 or m == 0 or d == 0:
        return out.zero_()
    iso = mode == "iso"
    # |x_i|^2, |y_j|^2 and <y_j, A_j> for the expansion (iso)
    x2 = torch.sum(x * x, dim=1) if iso else None
    y2 = torch.sum(y * y, dim=1) if iso else None
    ya = torch.sum(y * A, dim=1) if iso else None
    splits, per = column_split(_cdiv(n, _K3_TM), m, _K3_TN, x.device)
    most = max(1, _K3_PARTIAL_BYTES // (4 * n * d))
    if splits > most:
        per = _cdiv(_cdiv(m, _K3_TN), most) * _K3_TN
    per = min(per, _K3_MAX_TILES * _K3_TN)
    splits = _cdiv(m, per)
    partial = out if splits == 1 else torch.empty((splits, n, d), dtype=torch.float32,
                                                  device=x.device)
    return _launch(grad_route(spec), library().k3_grad_matvec, out,
                   _ptr(x), _ptr(y), _ptr(A), _ptr(x2), _ptr(y2), _ptr(ya), _ptr(partial),
                   _ptr(out), n, m, d, int(iso), splits, per, passes, spec.family,
                   spec.family_p, int(vec4_ok(d, x, y, A)), _cspec(spec), _cjet(spec),
                   _ptr(jet_table(spec, x.device)))
