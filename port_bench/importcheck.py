"""The run's last guard: no JAX and no JAX package in this process."""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "photon_tpu"})


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name (the part before the first
    dot), compared whole, is forbidden: ``photon_tpu_torch`` passes,
    ``photon_tpu`` and ``photon_tpu.ops`` do not."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)
