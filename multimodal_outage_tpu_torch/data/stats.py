"""Normalization statistics of a packed store (the JAX package's
data/stats.py; reference find_mean_std.py:19-43)."""

from __future__ import annotations

import datetime
from typing import Dict, Tuple

import numpy as np

from multimodal_outage_tpu_torch.core.registry import HURRICANES
from multimodal_outage_tpu_torch.data.dataset import WindowDataset
from multimodal_outage_tpu_torch.data.store import NTLStore


def compute_mean_std(
    store: NTLStore,
    case_study: Dict[str, datetime.date] | None = None,
    dataset_range: int = 30,
    chunk: int = 32,
) -> Tuple[float, float]:
    """Global mean and std of every sample's future frame at horizon 1,
    over all hurricanes by default (find_mean_std.py:13-15, 27-32):
    float64 sums in chunks of `chunk` samples, population variance
    E[x²] − E[x]² (find_mean_std.py:40)."""
    ds = WindowDataset.from_case_study(
        store, case_study or HURRICANES, dataset_range=dataset_range, horizon=1
    )
    total = total_sq = 0.0
    count = 0
    for start in range(0, len(ds), chunk):
        pos = ds.window_positions(np.arange(start, min(start + chunk, len(ds))))[:, 1]
        fut = np.asarray(store.frames[pos], dtype=np.float64)
        total += fut.sum()
        total_sq += np.square(fut).sum()
        count += fut.size
    mean = total / count
    var = total_sq / count - mean**2
    return float(mean), float(np.sqrt(max(var, 0.0)))
