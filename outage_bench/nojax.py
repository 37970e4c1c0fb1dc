"""The check that nothing the run loaded is JAX or the JAX package: each
module's top-level name (before the first dot) compared whole, so that
multimodal_outage_tpu_torch passes and multimodal_outage_tpu does not."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "orbax", "multimodal_outage_tpu"})


def forbidden(modules: Iterable[str]) -> List[str]:
    return sorted({m.split(".", 1)[0] for m in modules} & FORBIDDEN)


def loaded() -> List[str]:
    return forbidden(list(sys.modules))
