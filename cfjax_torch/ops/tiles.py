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
tf32 products exactly, independent of torch's global tf32 flags.
"""

from __future__ import annotations

import torch

from .. import config as _config


def resolve_precision(precision=None) -> str:
    p = _config.DEFAULT.matmul_precision if precision is None else precision
    if p not in ("default", "high", "highest"):
        raise ValueError(f"unknown matmul precision {p!r}")
    return p


def _tf32(t):
    """Round float32 values to tf32 (10 explicit mantissa bits), to nearest."""
    b = t.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(a, b, precision):
    p = resolve_precision(precision)
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
