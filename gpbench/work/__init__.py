"""The benchmark's yardstick for kernel rooflines: a frozen copy of the
H100's published peaks and of the least-work models of the kernel-matrix
products that the benchmark's cells time. The program keeps its own copies
(`cfjax_torch/utils/roofline.py`, `work_direct` in `ops/gramian_mvm.py`,
`work_grad` in `ops/grad_mvm.py`) and may change them; these stay as they
are, so a roofline share read in one check means what it meant in the
last."""

from .models import PROFILE_OPS, JET_OPS, Work, profile_key, work_direct, work_grad  # noqa: F401
from .peaks import CLOCK_HZ, FP32_RATE, HBM_RATE, PEAK_SLACK, SFU_RATE, SMS, TC_RATE  # noqa: F401
