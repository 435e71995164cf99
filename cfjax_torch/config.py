"""Global configuration constants.

Counterpart of `cfjax.config`: the reference's module-level constants
(src/CovarianceFunctions.jl:37, src/gramian.jl:201-202,
src/barneshut.jl:3-4, src/sparse.jl:3) as a frozen dataclass. cfjax's
host-chunked CG settings (`cg_chunk_iters`, `cg_chunk_min_n`) are not
carried over: the port's CG is a Python loop, so it has no single
long-running device program to cut into segments.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Config:
    # numerical tolerance for factorization / PSD checks
    default_tol: float = 1e-6
    # below this size, `factorize` returns a dense Cholesky; above, stays lazy (CG)
    max_cholesky_size: int = 2**14
    # Barnes-Hut defaults
    barneshut_leafsize: int = 16
    barneshut_theta: float = 0.25
    # sparsification
    sparse_leafsize: int = 16
    # default row-block size for the blocked plain-torch MVM
    mvm_block_rows: int = 512
    # iterative solver defaults
    cg_maxiter: int = 1000
    cg_tol: float = 1e-8
    # matmul input precision of distance / inner-product tiles:
    # "highest" = full fp32, "high" = 3xtf32, "default" = tf32. The
    # expansion ||x||^2 + ||y||^2 - 2 x.y cancels, so the f32-class tier
    # is the default for a GP library.
    matmul_precision: str = "highest"
    # at d <= this, isotropic distance tiles use the exact unrolled
    # difference form (no matmul, no cancellation)
    direct_sqdist_max_d: int = 16
    # where the port places input that carries no device (numpy arrays,
    # lists, grids and lazy columns declared without one); a tensor keeps
    # its own. JAX puts such input on its default device, the card here.
    device: str = "cuda"


DEFAULT = Config()


def default_device(device=None) -> torch.device:
    """`device` when given, else the configured default. Reads the
    setting only: nothing is allocated, so it answers without a card."""
    return torch.device(DEFAULT.device if device is None else device)


def set_config(**kwargs):
    """Replace global config fields, e.g. set_config(max_cholesky_size=128)."""
    global DEFAULT
    DEFAULT = dataclasses.replace(DEFAULT, **kwargs)
    return DEFAULT
