"""The parallel layer on `torch.distributed` (counterpart of
`cfjax.parallel`): sharded Gramian, gradient, value+gradient and Hessian
operators, Barnes-Hut, Kronecker and Toeplitz MVMs over a `DeviceMesh`."""

from .mesh import (
    ShardedGramian,
    default_mesh,
    init_distributed,
    replicate,
    shard_rows,
    sharded_cg,
    sharded_gramian_matvec,
)
from .structured import (
    ShardedGradientGramian,
    ShardedHessianGramian,
    ShardedValueGradientGramian,
    sharded_bh_matvec,
    sharded_block_apply,
    sharded_kronecker_matvec,
    sharded_toeplitz_matmat,
)
