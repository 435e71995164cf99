"""Accuracy-controlled distance / inner-product tiles (counterpart of
`cfjax.ops.tiles`).

The expansion ||x||^2 + ||y||^2 - 2 x.y cancels, so reduced-precision
matmul inputs (tf32 on Hopper's tensor cores, like bf16 on the TPU's MXU)
put large absolute error on the squared-distance tile. Two remedies:
  * small d (<= config.direct_sqdist_max_d): the difference form
    sum_i (x_i - y_i)^2, unrolled over d — exact, no matmul;
  * larger d: the matmul expansion at a configurable input precision:
    "highest" = full fp32, "high" = 3xtf32 (head/residual split),
    "default" = tf32.
On the CPU every tier is exact fp32/fp64, as cfjax's tiers are on XLA's
CPU backend. On CUDA the tf32 tiers are emulated by rounding the inputs
to tf32 and multiplying in full fp32, which gives the tensor cores'
tf32 products exactly, independent of torch's global tf32 flags; the
full fp32 products (and "highest") hold those flags off (`full_fp32`).

The CUDA kernels K2 and K3 run each tier as passes over the tensor cores
(`TIER_PASSES`, csrc/tc_tile.cuh): "default" one tf32 pass, "high" the
three of 3xTF32 (the products `_mm` emulates), and "highest" the same
three: on the card their error against float64 matched a three-way
split's six passes (the counterpart of cfjax's bf16_6x) in every case
measured (PERF.md), so "highest" takes the faster split.
"""

from __future__ import annotations

import contextlib

import torch

from .. import config as _config


# tensor-core passes of each tier in the CUDA kernels
TIER_PASSES = {"default": 1, "high": 3, "highest": 3}


def resolve_precision(precision=None) -> str:
    p = _config.DEFAULT.matmul_precision if precision is None else precision
    if p not in ("default", "high", "highest"):
        raise ValueError(f"unknown matmul precision {p!r}")
    return p


def tier_passes(precision=None) -> int:
    """The tensor-core passes of a tier (else of the configured one)."""
    return TIER_PASSES[resolve_precision(precision)]


def _tf32(t):
    """Round float32 values to tf32 (10 explicit mantissa bits), to nearest."""
    b = t.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def full_fp32():
    """Hold CUDA float32 matrix products at full fp32 inside the block,
    whatever torch's global setting: with TF32 allowed
    (`torch.backends.cuda.matmul.fp32_precision = "tf32"`, or the older
    `allow_tf32` / `set_float32_matmul_precision("high")`, which it
    reflects) cuBLAS would round their inputs to tf32. cfjax's "highest"
    is f32-class whatever XLA's defaults are. The flag is set and restored
    through `fp32_precision` (reading the older flags after a mix of the two
    APIs raises in torch, restoring the value read does not)."""
    m = torch.backends.cuda.matmul
    if not hasattr(m, "fp32_precision"):   # torch before the fp32_precision API
        saved = m.allow_tf32
        m.allow_tf32 = False
        try:
            yield
        finally:
            m.allow_tf32 = saved
        return
    saved = m.fp32_precision
    # "none" defers to the backends' common setting
    if (saved if saved != "none" else getattr(torch.backends, "fp32_precision", "none")) != "tf32":
        yield
        return
    m.fp32_precision = "ieee"
    try:
        yield
    finally:
        m.fp32_precision = saved


def _mm(a, b, precision):
    p = resolve_precision(precision)
    with full_fp32():
        if p == "highest" or not a.is_cuda or a.dtype != torch.float32:
            return a @ b
        ah, bh = _tf32(a), _tf32(b)
        if p == "default":
            return ah @ bh
        al, bl = a - ah, b - bh
        return ah @ bh + (ah @ _tf32(bl) + _tf32(al) @ bh)


def matmul_p(a, b, precision=None):
    """a @ b at the configured matmul input precision."""
    return _mm(a, b, precision)


def inner_tile(xb, y, precision=None):
    """(B, m) inner-product tile x_i . y_j at controlled precision (leading
    batch dimensions of xb and y broadcast)."""
    return _mm(xb, y.mT, precision)


def sqdist_tile(xb, y, precision=None, direct_max_d=None):
    """(B, m) squared-distance tile ||x_i - y_j||^2, exact at small d
    (unrolled difference form), matmul expansion otherwise. Leading batch
    dimensions of xb and y broadcast: (G, B, d) and (G, m, d) give (G, B, m)."""
    d = xb.shape[-1]
    dmax = _config.DEFAULT.direct_sqdist_max_d if direct_max_d is None else direct_max_d
    if d <= dmax:
        D = None
        for i in range(d):
            t = xb[..., :, i, None] - y[..., None, :, i]
            t = t * t
            D = t if D is None else D + t
        return D
    S = inner_tile(xb, y, precision)
    D = (torch.sum(xb * xb, dim=-1)[..., :, None]
         + torch.sum(y * y, dim=-1)[..., None, :] - 2.0 * S)
    return torch.clamp(D, min=0.0)


def map_rows(body, x, block, width):
    """Apply body to the row blocks of x (block rows each) and concatenate
    its outputs, each a tensor or a tuple of tensors: the counterpart of
    cfjax's `lax.map` over padded row blocks. (0, width) zeros when x has
    no rows."""
    outs = [body(x[i:i + block]) for i in range(0, x.shape[0], block)]
    if not outs:
        return x.new_zeros((0, width))
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)
