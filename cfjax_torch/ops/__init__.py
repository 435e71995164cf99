from .gramian_mvm import (
    LAUNCHES,
    gramian_matvec_direct,
    gramian_matvec_direct_plain,
    gramian_matvec_expand,
    gramian_matvec_expand_plain,
)
from .grad_mvm import grad_matvec, grad_matvec_plain
from .tile_ell_mvm import slab_matvec, slab_matvec_plain
from .tiles import inner_tile, matmul_p, sqdist_tile
