"""Ingest of local NASA Black Marble rasters into the packed store: the
port's copy of the offline half of the JAX package's
data/acquisition.py (itself the reference's eda/util.py).

ingest_directory packs a {county}/{Y_m_d}.{npy|pickle|pkl} tree of daily
VNP46A2 `Gap_Filled_DNB_BRDF-Corrected_NTL` rasters into the
[D, N, s, s] store (store.py save_store); ingest_monthly_directory
attaches a {county}/monthly_{Y}_{M}.npy tree of monthly VNP46A3
composites to a store as its risk-map baseline sidecar. Files are read on
the host; each county's rasters are resized on `device` (the card unless
the caller asks for the CPU), grouped by shape, with the port's one
antialiased bilinear resize (pipeline.py resize_bilinear), then pulled
back. The NASA fill sentinel is zeroed at native resolution, before the
resize, as the reference zeroes it at load (utils.py:60, 272).

Not here: the download functions and the county geometries, which need
the network.
"""

from __future__ import annotations

import datetime
import os
import pickle
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodal_outage_tpu_torch.core.config import NTL_FILL_SENTINEL
from multimodal_outage_tpu_torch.core.device import resolve_device
from multimodal_outage_tpu_torch.core.registry import HURRICANES
from multimodal_outage_tpu_torch.data.pipeline import resize_bilinear
from multimodal_outage_tpu_torch.data.store import load_store, save_store

_DATE_FILE_RE = re.compile(r"^(\d{4})_(\d{1,2})_(\d{1,2})\.(npy|pickle|pkl)$")
_MONTH_FILE_RE = re.compile(r"^monthly_(\d{4})_(\d{1,2})\.npy$")
NTL_VARIABLE = "Gap_Filled_DNB_BRDF-Corrected_NTL"


def hurricane_date_ranges(
    hurricanes: Dict[str, datetime.date] | None = None, margin_days: int = 90
) -> Dict[str, Tuple[datetime.date, datetime.date]]:
    """±margin windows per hurricane (reference eda/util.py:31-42)."""
    hurricanes = hurricanes or HURRICANES
    delta = datetime.timedelta(days=margin_days)
    return {k: (d - delta, d + delta) for k, d in hurricanes.items()}


def parse_date_filename(name: str) -> Optional[datetime.date]:
    """'2022_9_28.npy' → date (reference filename scheme, utils.py:26)."""
    m = _DATE_FILE_RE.match(name)
    if not m:
        return None
    return datetime.date(int(m.group(1)), int(m.group(2)), int(m.group(3)))


def find_available_dates(county_dir: str) -> List[datetime.date]:
    """Dates present for one county (reference eda/util.py:44-58)."""
    out = []
    for name in sorted(os.listdir(county_dir)):
        d = parse_date_filename(name)
        if d is not None:
            out.append(d)
    return out


def find_missing_dates(
    available: Iterable[datetime.date], start: datetime.date, end: datetime.date
) -> List[datetime.date]:
    """Gaps in [start, end] (reference eda/util.py:216-234)."""
    have = set(available)
    days = (start + datetime.timedelta(days=i) for i in range((end - start).days + 1))
    return [d for d in days if d not in have]


def common_dates(per_county: Dict[str, List[datetime.date]]) -> List[datetime.date]:
    """Dates present for every county (reference eda/util.py:60-80)."""
    sets = [set(v) for v in per_county.values()]
    if not sets:
        return []
    return sorted(set.intersection(*sets))


def _zero_sentinel(arr: np.ndarray) -> np.ndarray:
    return np.where(arr == NTL_FILL_SENTINEL, np.float32(0.0), arr)


def _load_raw_frame(path: str) -> np.ndarray:
    """One daily raster as float32 [H, W], its fill sentinel zeroed at
    native resolution: a .npy directly, else the reference's pickled
    xarray Dataset (utils.py:46-62), read as
    data["Gap_Filled_DNB_BRDF-Corrected_NTL"].values. A pickle can run
    code when loaded: read only files of a trusted download."""
    if path.endswith(".npy"):
        arr = np.asarray(np.load(path), dtype=np.float32)
    else:
        with open(path, "rb") as f:
            data = pickle.load(f)
        arr = np.asarray(data[NTL_VARIABLE].values, dtype=np.float32)
    return _zero_sentinel(arr)


def _resize_all(rasters: Sequence[np.ndarray], size: int, device: torch.device) -> np.ndarray:
    """[K] [H, W] rasters of any shapes → [K, size, size] float32 (the JAX
    package's _resize_to, acquisition.py:118-137, raster by raster): the
    rasters of one shape go to the device as one stack, are resized
    together and come back."""
    out = np.empty((len(rasters), size, size), np.float32)
    by_shape: Dict[Tuple[int, ...], List[int]] = {}
    for i, r in enumerate(rasters):
        by_shape.setdefault(r.shape, []).append(i)
    for idx in by_shape.values():
        stack = torch.from_numpy(np.stack([rasters[i] for i in idx])).to(device)
        out[idx] = resize_bilinear(stack, size).cpu().numpy()
    return out


def ingest_directory(
    raw_dir: str,
    out_dir: str,
    image_size: int = 128,
    counties: Optional[Sequence[str]] = None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pack a {county}/{Y_m_d}.{npy|pickle|pkl} tree into the store
    layout (JAX acquisition.py:140-183). Counties are sorted; only dates
    common to every county are kept (the windowing needs a dense [D, N]
    grid). Returns (frames [D, N, s, s], dates [D, 3])."""
    dev = resolve_device(device)
    counties = sorted(
        counties or [d for d in os.listdir(raw_dir) if os.path.isdir(os.path.join(raw_dir, d))]
    )
    per_county = {c: find_available_dates(os.path.join(raw_dir, c)) for c in counties}
    dates = common_dates(per_county)
    if not dates:
        raise ValueError(f"no common dates across counties in {raw_dir}")

    frames = np.zeros((len(dates), len(counties), image_size, image_size), np.float32)
    for ci, county in enumerate(counties):
        cdir = os.path.join(raw_dir, county)
        by_date = {}
        for name in os.listdir(cdir):
            d = parse_date_filename(name)
            if d is not None:
                by_date[d] = os.path.join(cdir, name)
        rasters = [_load_raw_frame(by_date[d]) for d in dates]
        frames[:, ci] = _resize_all(rasters, image_size, dev)

    date_arr = np.asarray([(d.year, d.month, d.day) for d in dates], dtype=np.int32)
    save_store(out_dir, frames, date_arr, counties)
    return frames, date_arr


def ingest_monthly_directory(
    raw_dir: str,
    store_dir: str,
    image_size: int = 128,
    counties: Optional[Sequence[str]] = None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Attach a {county}/monthly_{Y}_{M}.npy tree to an existing packed
    store as the monthly sidecar (JAX acquisition.py:405-456): the
    counties in the store's order, the months present for every county,
    sentinels zeroed before the resize. Returns (monthly [M, N, s, s],
    months [M, 2])."""
    dev = resolve_device(device)
    counties = list(counties or load_store(store_dir).county_names)

    per_county: Dict[str, Dict[Tuple[int, int], str]] = {}
    for c in counties:
        cdir = os.path.join(raw_dir, c)
        got = {}
        if os.path.isdir(cdir):
            for name in os.listdir(cdir):
                m = _MONTH_FILE_RE.match(name)
                if m:
                    got[(int(m.group(1)), int(m.group(2)))] = os.path.join(cdir, name)
        per_county[c] = got
    common = sorted(set.intersection(*[set(v) for v in per_county.values()])
                    if per_county else set())
    if not common:
        raise ValueError(f"no common monthly composites in {raw_dir}")

    monthly = np.zeros((len(common), len(counties), image_size, image_size), np.float32)
    for ci, c in enumerate(counties):
        rasters = [_zero_sentinel(np.asarray(np.load(per_county[c][key]), np.float32))
                   for key in common]
        monthly[:, ci] = _resize_all(rasters, image_size, dev)
    months = np.asarray(common, dtype=np.int32)
    np.save(os.path.join(store_dir, "monthly.npy"), monthly)
    np.save(os.path.join(store_dir, "monthly_months.npy"), months)
    return monthly, months
