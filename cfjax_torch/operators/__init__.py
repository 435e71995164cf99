from .linop import (
    DenseOperator,
    DiagonalOperator,
    FillOperator,
    LinearOperator,
    LowRankOperator,
    ProductOperator,
    ScaledOperator,
    SumOperator,
    ZeroOperator,
)
from .gramian import Gramian, gramian_dense, gramian_matvec, kernel_decline_reason
from .solvers import (CholeskyFactorization, LowRankFactorization, cg,
                      factorize, solve, solve_with_info)
from .preconditioner import nystrom_preconditioner
from .dispatch import LambdaKernel, explain, gramian
