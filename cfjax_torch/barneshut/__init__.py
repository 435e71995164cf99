from .tree import BalancedTree, build_tree
from .bh import BarnesHutFactorization, bh_matvec
