"""The least work of the kernel-matrix products on the H100, counted from
their shapes, whatever implements them.

A `Work` counts fp32 instructions (an FFMA is one), SFU operations
(MUFU: rsqrt, ex2, lg2, rcp), tensor-core flops of one tf32 pass (a
multiply-add is two) with the passes that the accuracy of the result
needs, and the bytes that must cross HBM (each input read once, each
output written once). Its roofline time is the largest of each count over
its pipe's peak (`peaks.py`).
"""

from __future__ import annotations

from dataclasses import dataclass

from . import peaks

# (fp32 instructions, SFU operations) per entry of a one-leaf value
# profile: EQ FMUL, ex2; MaternP(p) max, 2 FMUL, the Horner steps (p + 1
# for p > 0), rsqrt, ex2
PROFILE_OPS = {("EQ", 0): (1, 1), ("MaternP", 0): (3, 2), ("MaternP", 1): (5, 2),
               ("MaternP", 2): (6, 2), ("MaternP", 3): (7, 2)}
# (fp32, SFU) per pair of a derivative profile's jet (f, f', f'')
JET_OPS = {("EQ", 0): (3, 1), ("MaternP", 2): (11, 3)}


def profile_key(kernel: dict) -> tuple:
    """(family, p) of a configuration's kernel entry, e.g. {"name":
    "MaternP", "args": [2]} -> ("MaternP", 2); a lengthscale does not
    change the count."""
    args = kernel.get("args", [])
    return kernel["name"], int(args[0]) if args else 0


@dataclass
class Work:
    """The least work of one application of an operation."""

    fp32: float = 0.0
    sfu: float = 0.0
    tc_flops: float = 0.0    # tensor-core flops of one tf32 pass
    tc_passes: int = 1
    hbm_bytes: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.fp32 + other.fp32, self.sfu + other.sfu,
                    self.tc_flops + other.tc_flops, max(self.tc_passes, other.tc_passes),
                    self.hbm_bytes + other.hbm_bytes)

    def __rmul__(self, times: float) -> "Work":
        return Work(times * self.fp32, times * self.sfu, times * self.tc_flops,
                    self.tc_passes, times * self.hbm_bytes)

    def seconds(self) -> dict:
        """Seconds of each resource at its peak."""
        return {"fp32": self.fp32 / peaks.FP32_RATE, "SFU": self.sfu / peaks.SFU_RATE,
                "tensor cores": self.tc_flops * self.tc_passes / peaks.TC_RATE,
                "HBM": self.hbm_bytes / peaks.HBM_RATE}

    def roofline_seconds(self) -> float:
        """The least time the card could take."""
        return max(self.seconds().values())

    def bound(self) -> str:
        """The resource that sets the roofline."""
        t = self.seconds()
        return max(t, key=t.get)


def work_direct(n: int, m: int, d: int, profile: tuple) -> Work:
    """b = K a for x (n, d), y (m, d), a (m,): per entry 2d fp32 for the
    difference-form distance, the profile's (fp32, SFU) and one FFMA into
    the row sum. Bytes: x, y and a read once, b written once, float32."""
    fp32, sfu = profile
    e = float(n) * m
    return Work(fp32=e * (2 * d + fp32 + 1), sfu=e * sfu,
                hbm_bytes=4.0 * ((n + m) * d + m + n))


def work_grad(n: int, m: int, d: int, jet: tuple, passes: int) -> Work:
    """out_i = sum_j B_ij A_j over the d x d gradient blocks, x (n, d), y
    and A (m, d): four (n, d) x (d, m) products, 8d tensor-core flops a
    pair at `passes` tf32 passes; per pair the expansion and its test (4),
    w (1), alpha, beta and the row sum (4), the clamp (1) and the jet's
    (fp32, SFU). Bytes: x, y and A read once, out written once, float32."""
    fp32, sfu = jet
    e = float(n) * m
    return Work(fp32=e * (10 + fp32), sfu=e * sfu, tc_flops=e * 8 * d, tc_passes=passes,
                hbm_bytes=4.0 * (2 * n * d + 2 * m * d))
