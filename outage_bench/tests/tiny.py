"""Tiny cells for the CPU tests: the real drivers, configurations and
traffic files with every size cut so that a run takes seconds."""

from __future__ import annotations

import copy
from typing import Optional

from outage_bench import spec

TINY_MODEL = {"base_channels": 4, "depth": 2, "feature_vector_size": 16, "time_embed_size": 8,
              "gwnet": {"residual_channels": 8, "dilation_channels": 8, "skip_channels": 16,
                        "end_channels": 16, "blocks": 1, "layers": 2, "node_embed_dim": 2},
              "dcrnn": {"rnn_units": 8}}
TINY_DATA = {"n_counties": 4, "image_size": 16, "horizon": 3, "dataset_range": 6}


def _merge(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict):
            _merge(dst[k], v)
        else:
            dst[k] = v


def tiny_cell(name: str, compute_dtype: str = "float32", limits: Optional[dict] = None) -> spec.Cell:
    """The cell `name` of BENCHMARK.json at test size, its compute dtype
    float32 unless asked otherwise."""
    cell = copy.deepcopy(spec.load_cell(name))
    _merge(cell.config["model"], dict(TINY_MODEL, compute_dtype=compute_dtype))
    _merge(cell.config["data"], TINY_DATA)
    tr = cell.traffic
    tr["store"]["margin_days"] = 8
    tr.update({"warmup": 1, "trace_seconds": 0.2})
    if tr["driver"] == "sweep":
        tr["batch"] = 2
    if tr["driver"] == "train":
        tr.update({"batch": 4, "ref_rows": 2})
    if limits is not None:
        cell.limits = limits
    return cell
