"""Synthetic Black Marble store generator (numpy only).

The port's own copy of the JAX package's data/synthetic.py: per-county
"city light" blob fields with daily noise, hurricane-induced outage dips
decaying over ~2 weeks, and a sprinkle of the 6553.5 fill sentinel that
the store zeroes at pack time. Same seed, same frames as the JAX package.
"""

from __future__ import annotations

import datetime
from typing import Dict, List, Tuple

import numpy as np

from multimodal_outage_tpu_torch.core.config import NTL_FILL_SENTINEL
from multimodal_outage_tpu_torch.core.registry import HURRICANES, RISK_MONTHS
from multimodal_outage_tpu_torch.data.store import save_store


def _date_range(center: datetime.date, margin: int) -> List[datetime.date]:
    return [
        center + datetime.timedelta(days=d) for d in range(-margin, margin + 1)
    ]


def synthetic_dates(
    hurricanes: Dict[str, datetime.date] | None = None, margin: int = 45
) -> np.ndarray:
    """Sorted unique (y, m, d) rows covering ±margin days around each storm."""
    hurricanes = hurricanes or HURRICANES
    all_dates = sorted(
        {d for center in hurricanes.values() for d in _date_range(center, margin)}
    )
    return np.asarray(
        [(d.year, d.month, d.day) for d in all_dates], dtype=np.int32
    )


def _county_base_pattern(rng: np.random.Generator, size: int) -> np.ndarray:
    """Static 'city lights' for one county: a few gaussian blobs."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    img = np.zeros((size, size), dtype=np.float32)
    for _ in range(rng.integers(2, 6)):
        cy, cx = rng.random(2)
        sigma = 0.05 + 0.15 * rng.random()
        amp = 5.0 + 45.0 * rng.random()
        img += amp * np.exp(
            -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sigma**2)
        ).astype(np.float32)
    return img


def generate_frames(
    dates: np.ndarray,
    n_counties: int = 67,
    image_size: int = 128,
    seed: int = 42,
    hurricanes: Dict[str, datetime.date] | None = None,
    sentinel_fraction: float = 1e-3,
    pixel_noise: float = 0.0,
) -> np.ndarray:
    """[D, N, H, W] synthetic radiance with outage dips after hurricanes.

    pixel_noise: standard deviation of an extra per-pixel multiplicative
    noise, drawn after the per-(date, county) noise and before the
    sentinel mask (0 keeps frames spatially smooth, which makes the
    decoder's own predictions hard to tell from the encoded ground truth
    in scheduled-sampling studies)."""
    hurricanes = hurricanes or HURRICANES
    rng = np.random.default_rng(seed)
    d = dates.shape[0]
    base = np.stack(
        [_county_base_pattern(rng, image_size) for _ in range(n_counties)]
    )  # [N, H, W]

    date_objs = [datetime.date(*map(int, row)) for row in dates]
    # outage factor per (date, county): dip to ~20-70% after landfall,
    # exponential recovery with a ~10-day time constant
    impact = np.ones((d, n_counties), dtype=np.float32)
    county_sensitivity = 0.3 + 0.7 * rng.random(n_counties).astype(np.float32)
    for center in hurricanes.values():
        for i, day in enumerate(date_objs):
            dt = (day - center).days
            if dt >= 0:
                impact[i] *= 1.0 - 0.8 * county_sensitivity * np.exp(-dt / 10.0)

    noise = 1.0 + 0.1 * rng.standard_normal((d, n_counties, 1, 1)).astype(
        np.float32
    )
    frames = base[None] * impact[:, :, None, None] * noise
    if pixel_noise > 0.0:
        frames = frames * (
            1.0 + pixel_noise * rng.standard_normal(frames.shape).astype(np.float32)
        )
    frames = np.maximum(frames, 0.0)
    if sentinel_fraction > 0:
        mask = rng.random(frames.shape) < sentinel_fraction
        frames = np.where(mask, np.float32(NTL_FILL_SENTINEL), frames)
    return frames.astype(np.float32)


def generate_monthly_composites(
    frames: np.ndarray, dates: np.ndarray, seed: int = 42
) -> Tuple[np.ndarray, np.ndarray]:
    """Synthetic monthly-composite sidecar: one composite per (event year,
    risk month), modeled as the pre-event mean brightness."""
    rng = np.random.default_rng(seed + 1)
    years = sorted({int(y) for y in dates[:, 0]})
    pairs = [
        (y, m) for y in years if y in RISK_MONTHS for m in RISK_MONTHS[y]
    ]
    if not pairs:
        pairs = [(years[0], m) for m in (6, 7, 8)]
    clean = np.where(frames == NTL_FILL_SENTINEL, 0.0, frames)
    baseline = clean[: min(10, len(clean))].mean(axis=0)  # [N, H, W]
    monthly = np.stack(
        [
            baseline * np.float32(1.0 + 0.05 * rng.standard_normal())
            for _ in pairs
        ]
    ).astype(np.float32)
    return monthly, np.asarray(pairs, dtype=np.int32)


def county_names(n: int) -> List[str]:
    if n == 67:
        from multimodal_outage_tpu_torch.data.adjacency import load_adjacency_csv

        names, _ = load_adjacency_csv()
        return sorted(names)
    return [f"county_{i:03d}" for i in range(n)]


def generate_store(
    out_dir: str,
    n_counties: int = 67,
    image_size: int = 128,
    margin: int = 45,
    seed: int = 42,
    hurricanes: Dict[str, datetime.date] | None = None,
    pixel_noise: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Generate and save a packed synthetic store; returns (frames, dates).

    hurricanes: the storms whose ±margin windows the store covers (all of
    the registry by default); one storm makes a store a third the size."""
    dates = synthetic_dates(hurricanes, margin)
    frames = generate_frames(
        dates, n_counties, image_size, seed, hurricanes=hurricanes,
        pixel_noise=pixel_noise,
    )
    monthly, monthly_months = generate_monthly_composites(frames, dates, seed)
    save_store(
        out_dir,
        frames,
        dates,
        county_names(n_counties),
        extra_meta={"synthetic": True, "seed": seed, "margin": margin},
        monthly=monthly,
        monthly_months=monthly_months,
    )
    return frames, dates
