"""The least work of an operation and the roofline of an NVIDIA H100
(counterpart of `cfjax.utils.roofline`, whose peaks and slot costs belong
to another device and do not carry over).

A `Work` counts what a function needs, whatever implements it: fp32
instructions (an FFMA is one), SFU operations (MUFU: rsqrt, ex2, lg2,
rcp), tensor-core flops (a multiply-add is two) with the tf32 passes that
the accuracy of the result requires, and the bytes that must cross HBM
(each input read once, each output written once). Its roofline time is the
largest of each count over its pipe's rate; `summarize` turns a measured
time into the share of that bound and refuses a reading that would take
more than 105% of a peak.

The peaks are those of an H100 SXM 80GB HBM3 at its 700 W power limit and
1.98 GHz boost clock: 132 SMs x 128 fp32 lanes (67 TFLOP/s counting an FMA
as two), x 16 SFU lanes, 495 TFLOP/s of dense tf32 on the tensor cores and
3.35 TB/s of HBM3. A card set below 700 W runs below them under load, so a
reading names its card and power limit beside it.
"""

from __future__ import annotations

from dataclasses import dataclass

SMS = 132
CLOCK_HZ = 1.98e9
FP32_RATE = SMS * 128 * CLOCK_HZ   # fp32 instructions per second
SFU_RATE = SMS * 16 * CLOCK_HZ     # SFU operations per second
TC_RATE = 495e12                   # dense tf32 tensor-core flops per second
HBM_RATE = 3.35e12                 # bytes per second
# a reading may pass a peak by this much before it is refused: clock and
# counting slack, not a measurement
PEAK_SLACK = 1.05


@dataclass
class Work:
    """The least work of one application of an operation on this card."""

    fp32: float = 0.0        # fp32 instructions
    sfu: float = 0.0         # SFU operations
    tc_flops: float = 0.0    # tensor-core flops of one tf32 pass
    tc_passes: int = 1       # tf32 passes the result's accuracy needs (3 for fp32-class)
    hbm_bytes: float = 0.0   # bytes read and written once

    def __add__(self, other: "Work") -> "Work":
        """The work of both operations, one after the other (the tensor
        cores at the larger of their pass counts)."""
        return Work(self.fp32 + other.fp32, self.sfu + other.sfu,
                    self.tc_flops + other.tc_flops, max(self.tc_passes, other.tc_passes),
                    self.hbm_bytes + other.hbm_bytes)

    def __rmul__(self, times: float) -> "Work":
        """The work of `times` applications."""
        return Work(times * self.fp32, times * self.sfu, times * self.tc_flops,
                    self.tc_passes, times * self.hbm_bytes)

    def seconds(self, one_pass: bool = False) -> dict:
        """Seconds of each resource at its peak (`one_pass`: the tensor
        cores at one tf32 pass)."""
        passes = 1 if one_pass else self.tc_passes
        return {"fp32": self.fp32 / FP32_RATE, "SFU": self.sfu / SFU_RATE,
                "tensor cores": self.tc_flops * passes / TC_RATE,
                "HBM": self.hbm_bytes / HBM_RATE}

    def roofline_seconds(self) -> float:
        """The least time the card could take: each resource at its peak."""
        return max(self.seconds().values())

    def bound(self) -> str:
        """The resource that sets the roofline: "fp32", "SFU", "HBM" or
        "tensor cores" ("tensor cores/3x" at three passes); "latency" for
        no work."""
        t = self.seconds()
        name = max(t, key=t.get)
        if t[name] == 0:
            return "latency"
        if name == "tensor cores" and self.tc_passes > 1:
            name += f"/{self.tc_passes}x"
        return name

    def sanity_floor(self) -> float:
        """The least time a reading may take: below it, the reading implies
        more than PEAK_SLACK times a peak. The tensor cores count one tf32
        pass here, since a lower-precision path could beat the passes'
        bound."""
        return max(self.seconds(one_pass=True).values()) / PEAK_SLACK


def summarize(work: Work, seconds: float) -> dict:
    """For a reading of `seconds`: the share of the bound (`roofline_pct`),
    what sets it, and each resource's share of its peak (`peak_pct`, the
    tensor cores at one pass). A non-positive time, or one that implies
    more than 105% of a peak, is `valid: False` with the reason in `why`."""
    if not seconds > 0:
        return {"valid": False, "why": f"non-positive time {seconds}"}
    peak = {key: 100.0 * t / seconds for key, t in work.seconds(one_pass=True).items()}
    out = {"roofline_pct": 100.0 * work.roofline_seconds() / seconds,
           "bound": work.bound(), "peak_pct": peak, "valid": True}
    if seconds < work.sanity_floor():
        key = max(peak, key=peak.get)
        out["valid"] = False
        out["why"] = (f"impossible: implies {peak[key]:.0f}% of the {key} peak; floor "
                      f"{work.sanity_floor():.3e} s")
    return out
