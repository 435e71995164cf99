"""The least work of K2's product (the x.y tile on the tensor cores): a
frozen copy of the program's `work_expand` (`cfjax_torch/ops/gramian_mvm.py`),
beside the benchmark's other work models (`models.py`), so that a share of
K2's roofline means in a later check what it means now."""

from __future__ import annotations

from .models import Work


def work_expand(n: int, m: int, d: int, profile: tuple, passes: int,
                mode: str = "iso") -> Work:
    """b = K a through the x.y tile, 2d tensor-core flops an entry at the
    tier's tf32 `passes`; per entry the expansion (FADD, FFMA, FMNMX; iso
    only), the profile's (fp32, SFU) and the row sum's FFMA. Bytes: x, y and
    a read once, b written once, float32."""
    fp32, sfu = profile
    e = float(n) * m
    return Work(fp32=e * ((3 if mode == "iso" else 0) + fp32 + 1), sfu=e * sfu,
                tc_flops=e * 2 * d, tc_passes=passes,
                hbm_bytes=4.0 * ((n + m) * d + m + n))
