from .grids import LazyGrid, UniformGrid, as_points, detect_uniform_grid
from .testing import pairwise, pairwise_xy
