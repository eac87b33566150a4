"""The check that the process measured none of the JAX side: no loaded
module whose top-level name (the part before the first dot) is, as a whole
word, one of ``FORBIDDEN``. ``repro_torch`` begins with ``repro`` and is
allowed: names are compared whole."""
from __future__ import annotations

import sys
from typing import Iterable

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_loaded(names: Iterable[str] | None = None) -> list[str]:
    loaded = sys.modules if names is None else names
    return sorted({name.split(".")[0] for name in loaded} & set(FORBIDDEN))
