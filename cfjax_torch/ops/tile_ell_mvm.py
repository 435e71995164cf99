"""K4: the TileELL slab MVM (counterpart of
`cfjax.operators.tile_ell._slab_matvec_pallas`).

For one group of a TileELL operator (`operators/tile_ell.py`), with
a2 = pad(a).reshape(nt, 128) and off (int32), val of shape (B, K, nt, 128):
  out[b, l] = sum_k sum_t val[b, k, t, l] * a2[t, off[b, k, t, l]]  -> (B, 128).

`slab_matvec` launches the hand-written CUDA kernel
(`cfjax_torch/csrc/tile_ell_mvm.cu`, built by `ops/build.py`) on CUDA
tensors, in float32 or float64, and raises on what it does not take; on
CPU tensors it takes the plain torch version `slab_matvec_plain`, the
counterpart of cfjax's `_slab_matvec_xla`. The kernel handles nt = 1
itself (cfjax routes it to XLA: Mosaic rejects the (1, 128) gather). It is
forward-only, like the Pallas kernel. Launches count in
`gramian_mvm.LAUNCHES["tile_ell"]`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build as _build
from .gramian_mvm import _cdiv, _launch, _ptr

LANES = 128
# blocks of 128 threads per SM that the (k, t) split aims to keep in flight
_K4_BLOCKS_PER_SM = 8


@functools.cache
def library() -> ctypes.CDLL:
    """The K4 library (built once per source digest), with its C signatures set."""
    lib = _build.load("tile_ell_mvm")
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.k4_slab_matvec_f32, lib.k4_slab_matvec_f64):
        fn.argtypes = [p] * 5 + [i] * 5 + [p]
        fn.restype = i
    return lib


def slab_matvec_plain(a2, off, val):
    """Plain torch version of K4: gather a2[t, off], multiply by val and
    sum over (k, t), as cfjax's `_slab_matvec_xla` does."""
    nt = off.shape[2]
    idx = off.long() + (torch.arange(nt, device=off.device) * LANES)[:, None]
    g = a2.reshape(-1)[idx]
    return torch.sum(val * g, dim=(1, 2))


def _check_inputs(a2, off, val):
    ts = (a2, off, val)
    if not all(t.is_cuda and t.device == a2.device for t in ts):
        raise ValueError("a2, off and val must lie on one CUDA device")
    if off.dtype != torch.int32:
        raise TypeError(f"off must be int32, got {off.dtype}")
    if val.dtype not in (torch.float32, torch.float64) or a2.dtype != val.dtype:
        raise TypeError(f"the CUDA slab kernel takes float32 or float64 a2 and val of one "
                        f"dtype, got {a2.dtype} and {val.dtype}")
    if off.ndim != 4 or tuple(off.shape) != tuple(val.shape) or off.shape[3] != LANES \
            or tuple(a2.shape) != (off.shape[2], LANES):
        raise ValueError(f"shapes a2 {tuple(a2.shape)}, off {tuple(off.shape)}, val "
                         f"{tuple(val.shape)}: need (nt, 128), (B, K, nt, 128), (B, K, nt, 128)")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("a2, off and val must be contiguous")
    if a2.requires_grad or val.requires_grad:
        raise RuntimeError("the CUDA slab kernel is forward-only: an input requires grad")


def slab_matvec(a2, off, val):
    """K4: the slab MVM of one TileELL group (CUDA), or its plain version
    for CPU tensors. a2 (nt, 128), off and val (B, K, nt, 128) -> (B, 128)."""
    if not a2.is_cuda:
        return slab_matvec_plain(a2, off, val)
    _check_inputs(a2, off, val)
    B, K, nt, _ = off.shape
    out = torch.empty((B, LANES), dtype=val.dtype, device=val.device)
    if B == 0 or K == 0 or nt == 0:
        return out.zero_()
    kt = K * nt
    sms = torch.cuda.get_device_properties(val.device).multi_processor_count
    per = _cdiv(kt, max(1, min(kt, _cdiv(_K4_BLOCKS_PER_SM * sms, B))))
    splits = _cdiv(kt, per)
    partial = out if splits == 1 else torch.empty((splits, B, LANES), dtype=val.dtype,
                                                  device=val.device)
    fn = library().k4_slab_matvec_f32 if val.dtype == torch.float32 \
        else library().k4_slab_matvec_f64
    return _launch("tile_ell", fn, out, _ptr(a2), _ptr(off), _ptr(val), _ptr(partial),
                   _ptr(out), B, K, nt, splits, per)
