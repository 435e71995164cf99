from .gradient import (
    DerivativeKernel,
    GradientGramian,
    GradientKernel,
    JacobianConjugatedGradientGramian,
    ValueDerivativeKernel,
    ValueGradientGramian,
    ValueGradientKernel,
)
from .pair import grad_matvec_pair, pair_family_available, pair_profile
from .hessian import (
    HessianGramian,
    HessianKernel,
    ValueGradientHessianGramian,
    ValueGradientHessianKernel,
)
from .separable import SeparableKernel
