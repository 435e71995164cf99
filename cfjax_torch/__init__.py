"""cfjax_torch — the PyTorch / CUDA port of cfjax.

Same module layout and public names as `cfjax`: a kernel zoo and its
algebra (`nn.Module`s with tensor hyperparameters), lazy `gramian()`
operators with structure dispatch, solvers and GP conditioning. The
Gramian MVM runs on hand-written CUDA kernels for Hopper (`ops.gramian_mvm`,
`csrc/gramian_mvm.cu`) when its tensors live on a CUDA device, and on
plain torch otherwise. The package never imports jax.
"""

from . import kernels
from .config import Config, set_config
from .kernels import *  # noqa: F401,F403

__version__ = "0.1.0"
