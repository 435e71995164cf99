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
from .toeplitz import (
    CirculantOperator,
    ToeplitzOperator,
    circulant_matvec,
    durbin,
    levinson,
    toeplitz_matvec,
    trench,
)
from .kronecker import KroneckerCholesky, KroneckerOperator
from .solvers import (CholeskyFactorization, LowRankFactorization, approx_refined_solve, cg,
                      cg_columns, factorize, gmres, minres, refined_solve, solve,
                      solve_with_info)
from .preconditioner import nystrom_preconditioner
from .dispatch import LambdaKernel, explain, gramian
