"""The run-time import guard: no JAX, and not the JAX package.

Names are compared whole, by the part before the first dot:
``xmhw_tpu_torch`` (the port) is not ``xmhw_tpu`` (the JAX package),
though one name begins with the other.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "xmhw_tpu"})


def forbidden(modules=None):
    """Sorted top-level names in ``modules`` (default ``sys.modules``)
    that are forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
