from .besselk import besselk, besselkxv
from .grids import LazyGrid, UniformGrid, as_points, detect_uniform_grid
from .testing import iscov, isisotropic_probe, ispsd, isstationary_probe, pairwise, pairwise_xy
