"""The check that a run loaded neither JAX nor the JAX package: each
module's top-level name (the part before the first dot) is compared whole,
so the port, `cfjax_torch`, passes and `cfjax.ops` does not."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "cfjax"})


class ForbiddenImport(RuntimeError):
    def __init__(self, found):
        super().__init__(f"modules loaded that a run may not load: {', '.join(found)}")
        self.found = found


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among `modules` (default: sys.modules)."""
    names = sys.modules if modules is None else modules
    return sorted({top_level(m) for m in names} & FORBIDDEN)
