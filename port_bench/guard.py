"""What the benchmark may not load: JAX and the JAX package, compared by the whole
top-level name of each module (the part before the first dot), so that the port,
whose name begins with the JAX package's, passes."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "quadruped_pympc_tamols_tpu")


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_modules(modules=None, forbidden=FORBIDDEN) -> list:
    """Names in ``modules`` (default ``sys.modules``) whose top-level name is one of
    ``forbidden``."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if top_level(n) in forbidden)
