from .gramian_mvm import (
    LAUNCHES,
    gramian_matmat_direct,
    gramian_matmat_direct_plain,
    gramian_matvec_direct,
    gramian_matvec_direct_plain,
    gramian_matvec_expand,
    gramian_matvec_expand_plain,
)
from .grad_mvm import grad_matvec, grad_matvec_plain
from .tile_ell_mvm import RowSlices, rows_matvec, rows_matvec_plain, slab_matvec_plain
from .tiles import inner_tile, matmul_p, sqdist_tile
