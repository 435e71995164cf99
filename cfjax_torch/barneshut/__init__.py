from .tree import BalancedTree, build_tree
