"""The run's check that it loaded neither JAX nor the JAX package: the
top-level name of each loaded module (the part before the first dot) is
compared whole, so the port, ``chaq_sdfgen_tpu_torch``, which begins with the
JAX package's name, is not taken for it."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "chaq_sdfgen_tpu"})


def forbidden(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default: every
    module loaded in this process), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
