from .base import (
    DotProductKernel,
    InputTrait,
    IsotropicKernel,
    Kernel,
    MultiKernel,
    StationaryKernel,
    input_trait,
)
from .stationary import (
    EQ,
    IMQ,
    RQ,
    SM,
    Cauchy,
    Constant,
    Cosine,
    Delta,
    Exp,
    GammaExp,
    InverseMultiQuadratic,
    Matern,
    MaternP,
    PseudoVoigt,
    Spectral,
    SpectralMixture,
)
from .mercer import (
    NN,
    Brownian,
    Dot,
    ExponentialDot,
    FiniteBasis,
    Line,
    MatrixKernel,
    NeuralNetwork,
    Poly,
    Polynomial,
)
from .algebra import (
    Power,
    Product,
    SeparableProduct,
    SeparableSum,
    Sum,
    separable,
)
from .transforms import (
    ARD,
    ARDKernel,
    Chained,
    Energetic,
    Lengthscale,
    Normed,
    Periodic,
    ScaledInputKernel,
    SymmetricKernel,
    VerticalRescaling,
    Warped,
    normalize,
)
from .parameters import from_reference, nparameters, parameters, similar, with_leaves
from .profile_spec import ProfileSpec, to_spec

# reference-name alias (src/stationary.jl:197 `CosineKernel`)
CosineKernel = Cosine
