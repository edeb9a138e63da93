"""What may not be loaded in a run: JAX, its libraries and the JAX package
the port was made from. Names are compared by their top-level part, whole
(``repro_torch`` is the port and allowed; ``repro`` is not)."""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden(modules: Iterable[str] = None) -> List[str]:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
