"""Packed NTL array store: a memory-mapped [D, N, H, W] float32 frame
array plus a [D, 3] (year, month, day) date table, with an optional
monthly-composite sidecar. The on-disk layout is the JAX package's, so
either package reads the other's stores. The fill sentinel is zeroed at
pack time (reference utils.py:60)."""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from multimodal_outage_tpu_torch.core.config import NTL_FILL_SENTINEL

_NTL_FILE = "ntl.npy"
_DATES_FILE = "dates.npy"
_META_FILE = "meta.json"
_MONTHLY_FILE = "monthly.npy"
_MONTHLY_MONTHS_FILE = "monthly_months.npy"


@dataclass
class NTLStore:
    frames: np.ndarray  # [D, N, H, W] float32 (memmap)
    dates: np.ndarray  # [D, 3] int32 (y, m, d), strictly increasing
    county_names: List[str]
    meta: dict
    monthly: np.ndarray | None = None  # [M, N, H, W] float32
    monthly_months: np.ndarray | None = None  # [M, 2] int32 (y, m)

    @property
    def n_dates(self) -> int:
        return self.frames.shape[0]

    @property
    def n_counties(self) -> int:
        return self.frames.shape[1]

    @property
    def image_size(self) -> int:
        return self.frames.shape[2]


def save_store(
    out_dir: str,
    frames: np.ndarray,
    dates: np.ndarray,
    county_names: Sequence[str],
    zero_sentinel: bool = True,
    extra_meta: dict | None = None,
    monthly: np.ndarray | None = None,
    monthly_months: np.ndarray | None = None,
) -> None:
    frames = np.ascontiguousarray(frames, dtype=np.float32)
    dates = np.ascontiguousarray(dates, dtype=np.int32)
    if frames.ndim != 4:
        raise ValueError(f"frames must be [D, N, H, W], got {frames.shape}")
    if dates.shape != (frames.shape[0], 3):
        raise ValueError(f"dates must be [{frames.shape[0]}, 3], got {dates.shape}")
    if len(county_names) != frames.shape[1]:
        raise ValueError("county_names length mismatch")
    if zero_sentinel:
        frames = np.where(frames == NTL_FILL_SENTINEL, 0.0, frames)

    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, _NTL_FILE), frames)
    np.save(os.path.join(out_dir, _DATES_FILE), dates)
    if monthly is not None:
        monthly = np.ascontiguousarray(monthly, dtype=np.float32)
        monthly_months = np.ascontiguousarray(monthly_months, dtype=np.int32)
        if monthly.ndim != 4 or monthly.shape[1] != frames.shape[1]:
            raise ValueError(
                f"monthly must be [M, {frames.shape[1]}, H, W], got "
                f"{monthly.shape}"
            )
        if monthly_months.shape != (monthly.shape[0], 2):
            raise ValueError(
                f"monthly_months must be [{monthly.shape[0]}, 2], got "
                f"{monthly_months.shape}"
            )
        if zero_sentinel:
            monthly = np.where(monthly == NTL_FILL_SENTINEL, 0.0, monthly)
        np.save(os.path.join(out_dir, _MONTHLY_FILE), monthly)
        np.save(os.path.join(out_dir, _MONTHLY_MONTHS_FILE), monthly_months)
    meta = {
        "county_names": list(county_names),
        "shape": list(frames.shape),
        **(extra_meta or {}),
    }
    with open(os.path.join(out_dir, _META_FILE), "w") as f:
        json.dump(meta, f, indent=2)


def load_store(data_dir: str, mmap: bool = True) -> NTLStore:
    if not store_exists(data_dir):
        raise FileNotFoundError(f"no packed store in {data_dir!r}")
    frames = np.load(
        os.path.join(data_dir, _NTL_FILE), mmap_mode="r" if mmap else None
    )
    dates = np.load(os.path.join(data_dir, _DATES_FILE))
    with open(os.path.join(data_dir, _META_FILE)) as f:
        meta = json.load(f)
    monthly = monthly_months = None
    monthly_path = os.path.join(data_dir, _MONTHLY_FILE)
    if os.path.exists(monthly_path):
        monthly = np.load(monthly_path, mmap_mode="r" if mmap else None)
        monthly_months = np.load(
            os.path.join(data_dir, _MONTHLY_MONTHS_FILE)
        ).astype(np.int32)
    return NTLStore(
        frames=frames,
        dates=dates.astype(np.int32),
        county_names=list(meta["county_names"]),
        meta=meta,
        monthly=monthly,
        monthly_months=monthly_months,
    )


def store_exists(data_dir: str) -> bool:
    return all(
        os.path.exists(os.path.join(data_dir, f))
        for f in (_NTL_FILE, _DATES_FILE, _META_FILE)
    )
