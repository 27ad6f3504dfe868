"""The import guard: a run measures the port alone.

A module counts by its top-level name (the part before the first dot),
compared whole: ``repro_torch`` passes, ``repro`` and ``repro.models``
do not.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

#: JAX, its libraries and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_loaded(modules: Iterable[str] | None = None) -> List[str]:
    """The forbidden top-level names among ``modules`` (default: every
    module loaded in this process), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))
