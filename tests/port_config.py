"""The port's Config beside the JAX package's. The port's ModelConfig has
one group that the JAX package's lacks, `gman` (GMAN is the port's own
st-GNN), which the CLI sizes by the horizon: jax_fields checks that group
and leaves it out, so that every other field is held to JAX's."""

from __future__ import annotations

import dataclasses

from multimodal_outage_tpu_torch.core.config import GMANConfig


def jax_fields(cfg) -> dict:
    """dataclasses.asdict(cfg) without model.gman, which must be the
    GMANConfig of the config's horizon (7 where it has no data group)."""
    d = dataclasses.asdict(cfg)
    model = d.get("model", d)
    if "gman" in model:
        horizon = d["data"]["horizon"] if "data" in d else 7
        assert model.pop("gman") == dataclasses.asdict(GMANConfig(steps=2 * horizon))
    return d
