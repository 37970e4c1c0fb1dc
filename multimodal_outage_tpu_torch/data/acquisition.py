"""NASA Black Marble acquisition and ingest: the port's copy of the JAX
package's data/acquisition.py (itself the reference's eda/util.py).

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

The downloads fetch what ingest reads, through blackmarblepy's
bm_raster over each Florida county's bounding box (GADM 4.1):
download_county_rasters the daily rasters ±margin_days around each
hurricane as {county}/{Y}_{M}_{D}.npy, download_missing_dates only the
days a county directory lacks (the recovery after a partial download),
download_monthly_composites the risk-map baseline months as
{county}/monthly_{Y}_{M}.npy and download_annual_composites
{county}/annual_{Y}.npy. They are host code and need the network, a
NASA Earthdata token in NASA_BEARER_TOKEN, and blackmarblepy, geopandas
and pandas, which are imported when a download is called, never when
this module is.
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
from multimodal_outage_tpu_torch.core.registry import HURRICANES, RISK_MONTHS
from multimodal_outage_tpu_torch.data.pipeline import resize_bilinear
from multimodal_outage_tpu_torch.data.store import load_store, save_store

_DATE_FILE_RE = re.compile(r"^(\d{4})_(\d{1,2})_(\d{1,2})\.(npy|pickle|pkl)$")
_MONTH_FILE_RE = re.compile(r"^monthly_(\d{4})_(\d{1,2})\.npy$")
NTL_VARIABLE = "Gap_Filled_DNB_BRDF-Corrected_NTL"
_NEEDS_EXTRAS = ("blackmarblepy/geopandas are required for downloads; run this "
                 "module on a host with the acquisition extras installed")
GADM_USA_COUNTIES_URL = "https://geodata.ucdavis.edu/gadm/gadm4.1/json/gadm41_USA_2.json.zip"


def get_bearer_token() -> str:
    """The NASA Earthdata bearer token from NASA_BEARER_TOKEN; never
    hardcoded (the reference committed one, eda/util.py:20)."""
    token = os.environ.get("NASA_BEARER_TOKEN", "")
    if not token:
        raise RuntimeError(
            "Set NASA_BEARER_TOKEN (NASA Earthdata bearer token) to download "
            "Black Marble data. Tokens are never hardcoded in this repo."
        )
    return token


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


def _bm_raster(with_geopandas: bool = True, message: str = _NEEDS_EXTRAS):
    """blackmarble.raster.bm_raster, imported now (with geopandas, which
    the county geometries need): RuntimeError(message) where either is
    missing."""
    try:
        from blackmarble.raster import bm_raster  # type: ignore
        if with_geopandas:
            import geopandas  # type: ignore  # noqa: F401
    except ImportError as e:
        raise RuntimeError(message) from e
    return bm_raster


def download_county_rasters(
    out_dir: str,
    hurricanes: Dict[str, datetime.date] | None = None,
    margin_days: int = 90,
    product_id: str = "VNP46A2",
    variable: str = NTL_VARIABLE,
) -> None:
    """Download each county's daily rasters over every hurricane's
    ±margin_days window, one request per (county, hurricane), into
    {out_dir}/{county}/{Y}_{M}_{D}.npy (reference eda/util.py:237-280;
    JAX acquisition.py:186-224). Needs NASA_BEARER_TOKEN, blackmarblepy,
    geopandas and pandas, and raises RuntimeError without the first
    three."""
    token = get_bearer_token()
    bm_raster = _bm_raster()
    import pandas as pd  # type: ignore

    ranges = hurricane_date_ranges(hurricanes, margin_days)
    for county, gdf in load_florida_county_geometries().items():
        county_dir = os.path.join(out_dir, county)
        os.makedirs(county_dir, exist_ok=True)
        for start, end in ranges.values():
            dates = pd.date_range(start, end, freq="D")
            raster = bm_raster(gdf, product_id=product_id, date_range=dates, bearer=token,
                               variable=variable)
            _save_available_days(raster, dates, variable, county_dir)


def _save_available_days(raster, dates, variable: str, county_dir: str) -> List[datetime.date]:
    """Save each requested day that the returned raster holds as
    {county_dir}/{Y}_{M}_{D}.npy (float32). A day with no upstream
    granule, the usual cause of a partial download, is skipped, not a
    KeyError. Returns the dates saved."""
    available = {str(t)[:10] for t in np.asarray(raster["time"].values)}
    saved = []
    for ts in dates:
        key = ts.strftime("%Y-%m-%d")
        if key not in available:
            continue
        day = raster.sel(time=key)[variable]
        np.save(os.path.join(county_dir, f"{ts.year}_{ts.month}_{ts.day}.npy"),
                np.asarray(day.values, dtype=np.float32))
        saved.append(ts.date() if hasattr(ts, "date") else ts)
    return saved


def _contiguous_runs(
    dates: Sequence[datetime.date],
) -> List[Tuple[datetime.date, datetime.date]]:
    """Sorted dates as inclusive contiguous (start, end) runs, so that a
    gap re-fetch makes one bm_raster request per run, not per day."""
    runs: List[Tuple[datetime.date, datetime.date]] = []
    for d in sorted(dates):
        if runs and (d - runs[-1][1]).days == 1:
            runs[-1] = (runs[-1][0], d)
        else:
            runs.append((d, d))
    return runs


def download_missing_dates(
    out_dir: str,
    hurricanes: Dict[str, datetime.date] | None = None,
    margin_days: int = 90,
    product_id: str = "VNP46A2",
    variable: str = NTL_VARIABLE,
) -> Dict[str, List[datetime.date]]:
    """Fetch only the days each county directory lacks in the hurricanes'
    windows (reference eda/util.py:216-234; JAX acquisition.py:261-318):
    the recovery after a partial download_county_rasters, one request per
    contiguous run of gaps. Overlapping windows give a day once. Returns,
    per county, the dates fetched and saved; a gap with no upstream
    granule is skipped and not counted, and stays a gap, so a later run
    asks for it again."""
    token = get_bearer_token()
    bm_raster = _bm_raster()
    import pandas as pd  # type: ignore

    ranges = hurricane_date_ranges(hurricanes, margin_days)
    fetched: Dict[str, List[datetime.date]] = {}
    for county, gdf in load_florida_county_geometries().items():
        county_dir = os.path.join(out_dir, county)
        os.makedirs(county_dir, exist_ok=True)
        have = find_available_dates(county_dir)
        gaps = sorted({d for start, end in ranges.values()
                       for d in find_missing_dates(have, start, end)})
        saved: List[datetime.date] = []
        for start, end in _contiguous_runs(gaps):
            dates = pd.date_range(start, end, freq="D")
            raster = bm_raster(gdf, product_id=product_id, date_range=dates, bearer=token,
                               variable=variable)
            saved.extend(_save_available_days(raster, dates, variable, county_dir))
        fetched[county] = saved
    return fetched


def _save_composite(bm_raster, gdf, first, freq: str, product_id: str, variable: str,
                    token: str, path: str) -> None:
    """One composite (the period that starts at the pd.Timestamp `first`)
    saved as float32 at path."""
    import pandas as pd  # type: ignore

    raster = bm_raster(gdf, product_id=product_id,
                       date_range=pd.date_range(first, first, freq=freq), bearer=token,
                       variable=variable)
    comp = raster.sel(time=first.strftime("%Y-%m-%d"))[variable]
    np.save(path, np.asarray(comp.values, dtype=np.float32))


def download_monthly_composites(
    out_dir: str,
    hurricanes: Dict[str, datetime.date] | None = None,
    product_id: str = "VNP46A3",
    variable: str = "NearNadir_Composite_Snow_Free",
) -> None:
    """Each county's monthly VNP46A3 composites for the risk-map baseline
    months of the hurricanes' years (RISK_MONTHS, reference
    utils.py:262-269; eda/util.py:135-165; JAX acquisition.py:321-364),
    as {county}/monthly_{Y}_{M}.npy for ingest_monthly_directory."""
    token = get_bearer_token()
    bm_raster = _bm_raster()
    import pandas as pd  # type: ignore

    years = sorted({d.year for d in (hurricanes or HURRICANES).values()})
    for county, gdf in load_florida_county_geometries().items():
        county_dir = os.path.join(out_dir, county)
        os.makedirs(county_dir, exist_ok=True)
        for year in years:
            for month in RISK_MONTHS.get(year, ()):
                _save_composite(bm_raster, gdf, pd.Timestamp(year=year, month=month, day=1),
                                "MS", product_id, variable, token,
                                os.path.join(county_dir, f"monthly_{year}_{month}.npy"))


def download_annual_composites(
    out_dir: str,
    years: Sequence[int],
    product_id: str = "VNP46A4",
    variable: str = "NearNadir_Composite_Snow_Free",
) -> None:
    """Each county's annual VNP46A4 composite for `years`, as
    {county}/annual_{Y}.npy (reference eda/util.py:283-286; JAX
    acquisition.py:367-402)."""
    token = get_bearer_token()
    bm_raster = _bm_raster(with_geopandas=False,
                           message="blackmarblepy/geopandas are required for downloads")
    import pandas as pd  # type: ignore

    for county, gdf in load_florida_county_geometries().items():
        county_dir = os.path.join(out_dir, county)
        os.makedirs(county_dir, exist_ok=True)
        for year in years:
            _save_composite(bm_raster, gdf, pd.Timestamp(year=year, month=1, day=1), "YS",
                            product_id, variable, token,
                            os.path.join(county_dir, f"annual_{year}.npy"))


def load_florida_county_geometries():
    """{county: a GeoDataFrame of its bounding box}, the Florida rows of
    GADM 4.1's level-2 USA counties read from GADM_USA_COUNTIES_URL,
    keyed NAME_2.lower() with spaces as underscores (reference
    eda/util.py:168-174, 289-307). Reads the network when called."""
    try:
        import geopandas as gpd  # type: ignore
    except ImportError as e:
        raise RuntimeError("geopandas required for county geometries") from e
    gdf = gpd.read_file(GADM_USA_COUNTIES_URL)
    fl = gdf[gdf["NAME_1"] == "Florida"]
    return {row["NAME_2"].lower().replace(" ", "_"):
            gpd.GeoDataFrame(geometry=[row.geometry.envelope], crs=fl.crs)
            for _, row in fl.iterrows()}
