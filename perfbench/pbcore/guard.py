"""The import guard: a run of the port may not load JAX or the JAX package."""

from __future__ import annotations

import sys
from typing import List

BANNED = ("jax", "jaxlib", "flax", "llmseg_tpu")


def banned_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that are banned, compared whole
    (``llmseg_tpu_torch`` is not ``llmseg_tpu``)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(BANNED))
