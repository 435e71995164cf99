"""K4: the sparse operator MVM (counterpart of
`cfjax.operators.tile_ell._slab_matvec_pallas`).

cfjax's TileELL slabs are dense over column tiles, which a TPU needs for
its lane gather; on this card their padding is what costs. The kernel
reads instead the operator's row slices (`RowSlices`, built once per
operator by `operators/tile_ell.row_slices`): the rows in count-sorted
order, cut into slices of 32, each padded to its longest row and stored
slot-major (entry j of the slice's 32 rows contiguous), an int32 column and
a value per slot. For a vector a of length m:
  out[out_row[32 s + l]] = sum_j val[ptr[s] + 32 j + l] * a[col[ptr[s] + 32 j + l]].

`rows_matvec` launches the hand-written CUDA kernel
(`cfjax_torch/csrc/tile_ell_mvm.cu`, built by `ops/build.py`) on CUDA
tensors, in float32 or float64, once per MVM, and raises on what it does
not take; on CPU tensors it takes the plain torch version
`rows_matvec_plain`. `slab_matvec_plain`, the counterpart of cfjax's
`_slab_matvec_xla` over the TileELL slabs, stays as the reference of the
format. Forward-only, like the Pallas kernel. Launches count in
`gramian_mvm.LAUNCHES["tile_ell"]`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..utils.roofline import Work
from . import build as _build
from .gramian_mvm import _launch, _ptr, sm_count

LANES = 128   # the TileELL slabs' lane width
SLICE = 32    # rows per slice of the row-slice layout: one warp
MAX_WARPS = 8


class RowSlices(NamedTuple):
    """The row-slice layout of a sparse operator (see the module docstring)."""

    col: torch.Tensor       # (total,) int32, 0 in a pad slot
    val: torch.Tensor       # (total,) float32 or float64, 0 in a pad slot
    ptr: torch.Tensor       # (slices + 1,) int64 offsets, multiples of 32
    out_row: torch.Tensor   # (n,) int32: the output row of each layout row
    m: int                  # the operator's columns: the length of a


def slice_warps(slices: int, sms: int) -> int:
    """Warps per slice of a K4 launch: the least power of two (at most
    MAX_WARPS) that gives every SM its 64 resident warps, so a launch over
    few slices still fills the card. The block's warps split the slice's
    slots and add their sums in warp order."""
    warps = 1
    while warps < MAX_WARPS and warps * slices < 64 * sms:
        warps *= 2
    return warps



@functools.cache
def library() -> ctypes.CDLL:
    """The K4 library (built once per source digest), with its C signatures set."""
    lib = _build.load("tile_ell_mvm")
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.k4_rows_matvec_f32, lib.k4_rows_matvec_f64):
        fn.argtypes = [p] * 6 + [i] * 3 + [p]
        fn.restype = i
    return lib


def slab_matvec_plain(a2, off, val):
    """Plain torch version of cfjax's slab MVM over one TileELL group: gather
    a2[t, off], multiply by val and sum over (k, t), as cfjax's
    `_slab_matvec_xla` does. a2 (nt, 128), off and val (B, K, nt, 128) ->
    (B, 128)."""
    nt = off.shape[2]
    idx = off.long() + (torch.arange(nt, device=off.device) * LANES)[:, None]
    g = a2.reshape(-1)[idx]
    return torch.sum(val * g, dim=(1, 2))


def work_rows(nnz: int, n: int, m: int, itemsize: int = 4) -> Work:
    """The least work of K4's function on this card: out = S a over the
    operator's nnz nonzeros, an (n, m) operator. Bytes: each nonzero's
    4-byte column and its value read once, a read once, out written once;
    the FMAs are negligible beside them."""
    return Work(hbm_bytes=float(nnz) * (4 + itemsize) + (n + m) * itemsize)


def rows_matvec_plain(rs: RowSlices, a):
    """Plain torch version of K4: gather a[col], multiply by val, sum over
    each row's slots in slot order, and place the rows. -> (n,)."""
    n = rs.out_row.shape[0]
    slices = rs.ptr.shape[0] - 1
    width = torch.diff(rs.ptr) // SLICE
    pos = torch.arange(rs.col.shape[0], device=rs.col.device)
    start = torch.repeat_interleave(rs.ptr[:-1], width * SLICE)
    row = torch.repeat_interleave(torch.arange(slices, device=pos.device) * SLICE,
                                  width * SLICE) + (pos - start) % SLICE
    dtype = torch.promote_types(rs.val.dtype, a.dtype)
    sums = torch.zeros(slices * SLICE, dtype=dtype, device=a.device)
    sums.index_add_(0, row, (rs.val * a[rs.col.long()]).to(dtype))
    out = torch.empty(n, dtype=dtype, device=a.device)
    out[rs.out_row.long()] = sums[:n]
    return out


def _check_inputs(rs: RowSlices, a, warps):
    ts = (a, rs.col, rs.val, rs.ptr, rs.out_row)
    if not all(t.is_cuda and t.device == a.device for t in ts):
        raise ValueError("a and the row slices must lie on one CUDA device")
    if rs.col.dtype != torch.int32 or rs.out_row.dtype != torch.int32 \
            or rs.ptr.dtype != torch.int64:
        raise TypeError(f"col and out_row must be int32 and ptr int64, got {rs.col.dtype}, "
                        f"{rs.out_row.dtype} and {rs.ptr.dtype}")
    if rs.val.dtype not in (torch.float32, torch.float64) or a.dtype != rs.val.dtype:
        raise TypeError(f"the CUDA sparse kernel takes float32 or float64 a and val of one "
                        f"dtype, got {a.dtype} and {rs.val.dtype}")
    if rs.col.ndim != 1 or rs.col.shape != rs.val.shape or rs.ptr.ndim != 1 \
            or rs.out_row.shape[0] > SLICE * (rs.ptr.shape[0] - 1):
        raise ValueError(f"shapes col {tuple(rs.col.shape)}, val {tuple(rs.val.shape)}, ptr "
                         f"{tuple(rs.ptr.shape)}, out_row {tuple(rs.out_row.shape)}: need "
                         f"(total,), (total,), (slices + 1,), (n <= 32 slices,)")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("a and the row slices must be contiguous")
    if not 1 <= warps <= MAX_WARPS:
        raise ValueError(f"warps per slice must be in 1..{MAX_WARPS}, got {warps}")
    if a.requires_grad or rs.val.requires_grad:
        raise RuntimeError("the CUDA sparse kernel is forward-only: an input requires grad")


def rows_matvec(rs: RowSlices, a, warps: int = None):
    """K4: the operator's MVM over its row slices, one launch (CUDA), or its
    plain version for CPU tensors. a (m,) -> (n,). `warps` per slice:
    `slice_warps` of the launch's slices and the card's SMs unless given.
    A vector of another length than the operator's m is refused before
    the launch, which would read past its end."""
    if a.ndim != 1 or a.shape[0] != rs.m:
        raise ValueError(f"a has shape {tuple(a.shape)}; the operator takes ({rs.m},)")
    if not a.is_cuda:
        return rows_matvec_plain(rs, a)
    slices = rs.ptr.shape[0] - 1
    if warps is None:
        warps = slice_warps(slices, sm_count(a.device.index))
    _check_inputs(rs, a, warps)
    n = rs.out_row.shape[0]
    out = torch.empty(n, dtype=a.dtype, device=a.device)
    if n == 0:
        return out
    fn = library().k4_rows_matvec_f32 if a.dtype == torch.float32 \
        else library().k4_rows_matvec_f64
    return _launch("tile_ell", fn, out, _ptr(a), _ptr(rs.col), _ptr(rs.val), _ptr(rs.ptr),
                   _ptr(rs.out_row), _ptr(out), n, slices, warps)
