"""Prediction rasters and risk maps on the host (numpy + matplotlib): the
port's copy of the JAX package's viz/maps.py (reference utils.py:184-338):
cividis prediction rasters and RdYlGn percent-of-normal-NTL risk maps
(0-100), drawn from exported prediction arrays. matplotlib is imported
only when a map is drawn.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np
import torch

from multimodal_outage_tpu_torch.core.registry import RISK_MONTHS
from multimodal_outage_tpu_torch.data.pipeline import resize_bilinear

# Default spotlight counties (reference utils.py:205,313: indices 2, 34, 36
# of the alphabetically sorted county list).
CASE_STUDY_COUNTY_IDX = (2, 34, 36)


def ntl_to_np(
    ntl: np.ndarray, mean: float, std: float, denorm: bool = True
) -> np.ndarray:
    """[H, W, 1] or [1, H, W] tensor → display-oriented [H, W] array.

    Matches reference ntl_tensor_to_np (utils.py:184-192): denormalize,
    transpose, rot90.
    """
    ntl = np.asarray(ntl)
    if ntl.ndim == 3 and ntl.shape[-1] == 1:  # channels-last → channels-first
        ntl = np.transpose(ntl, (2, 0, 1))
    if denorm:
        ntl = ntl * std + mean
    ntl = np.transpose(ntl, (0, 2, 1))
    ntl = np.rot90(ntl, k=1, axes=(1, 2))
    return ntl[0]


def percent_of_normal(ntl: np.ndarray, normal_ntl: np.ndarray) -> np.ndarray:
    """100·(ntl+1)/(normal+1) (reference get_percent_of_normal_ntl,
    utils.py:234-244)."""
    return 100.0 * (ntl + 1.0) / (normal_ntl + 1.0)


def average_baseline_ntl(
    frames: np.ndarray, baseline_idx: Sequence[int]
) -> np.ndarray:
    """Mean of pre-event DAILY frames — the fallback 'normal' when the
    store ships no monthly-composite sidecar."""
    return np.mean(frames[list(baseline_idx)], axis=0)


def _resize_bilinear(arr: np.ndarray, size: int) -> np.ndarray:
    """[H, W] → [size, size] bilinear (the reference's torchvision
    Resize((128,128)) role, utils.py:273-277), antialiased when it
    shrinks, as jax.image.resize(method="bilinear") is: the port's one
    resize, data/pipeline.py resize_bilinear."""
    x = torch.from_numpy(np.array(arr, np.float32))
    return resize_bilinear(x, size).numpy()


def monthly_normal(
    store, county_idx: int, year: int, out_size: int
) -> np.ndarray:
    """Reference-faithful 'normal' NTL: the average of that event year's 3
    hardcoded monthly VNP46A3 composites (reference
    calculate_average_month_ntl, utils.py:247-283) — per month: sentinel
    already zeroed at pack time, bilinear-resize to the model resolution,
    display-orient (transpose+rot90, NO denormalize), then mean."""
    if store.monthly is None:
        raise ValueError("store has no monthly-composite sidecar")
    if year not in RISK_MONTHS:
        raise ValueError(
            f"Invalid date: no risk-map months configured for year {year}"
        )
    months = RISK_MONTHS[year]
    rows = {
        (int(y), int(m)): i
        for i, (y, m) in enumerate(np.asarray(store.monthly_months))
    }
    stack = []
    for m in months:
        if (year, m) not in rows:
            raise ValueError(
                f"monthly sidecar missing composite for {year}-{m:02d}"
            )
        comp = _resize_bilinear(
            np.asarray(store.monthly[rows[(year, m)], county_idx]), out_size
        )
        stack.append(ntl_to_np(comp[None], mean=0.0, std=1.0, denorm=False))
    return np.mean(stack, axis=0)


def save_prediction_rasters(
    preds: np.ndarray,  # [S, N, T, H, W, 1] normalized predictions
    out_dir: str,
    mean: float,
    std: float,
    county_names: Sequence[str] | None = None,
    county_idx: Sequence[int] = CASE_STUDY_COUNTY_IDX,
    max_samples: int | None = None,
) -> List[str]:
    """Per-(sample, horizon, county) cividis pcolormesh PNGs in nested
    folders (reference visualize_results_raster, utils.py:194-231)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    written = []
    n_samples = preds.shape[0] if max_samples is None else min(
        preds.shape[0], max_samples
    )
    for s in range(n_samples):
        for t in range(preds.shape[2]):
            for c in county_idx:
                if c >= preds.shape[1]:
                    continue
                name = (
                    county_names[c] if county_names else f"county_{c:03d}"
                )
                folder = os.path.join(out_dir, str(t + 1), name)
                os.makedirs(folder, exist_ok=True)
                img = ntl_to_np(preds[s, c, t], mean, std)
                fig, ax = plt.subplots(figsize=(4, 4), dpi=100)
                ax.pcolormesh(img, shading="auto", cmap="cividis")
                ax.set_axis_off()
                path = os.path.join(folder, f"sample_{s:04d}.png")
                fig.savefig(path, bbox_inches="tight")
                plt.close(fig)
                written.append(path)
    return written


def save_risk_maps(
    preds: np.ndarray,  # [S, N, T, H, W, 1] normalized predictions
    store,
    out_dir: str,
    mean: float,
    std: float,
    county_idx: Sequence[int] = CASE_STUDY_COUNTY_IDX,
    baseline_frames: int = 30,
    max_samples: int | None = 4,
    future_dates: np.ndarray | None = None,  # [S, T, 3] predicted-frame dates
) -> List[str]:
    """Percent-of-normal risk maps, RdYlGn vmin=0 vmax=100
    (reference visualize_risk_map, utils.py:306-338).

    The 'normal' baseline is the reference's 3-month monthly-composite
    average (monthly_normal) whenever the store ships the monthly sidecar
    AND future_dates supplies each predicted frame's date (to pick the
    event year, as the reference does from the frame filename,
    utils.py:259-269); otherwise it falls back to the mean of pre-event
    daily frames. Files are named by predicted-frame date when known
    (the reference names them from the frame filename, utils.py:327)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    written = []
    n_base = min(baseline_frames, store.n_dates)
    n_samples = preds.shape[0] if max_samples is None else min(
        preds.shape[0], max_samples
    )
    use_monthly = store.monthly is not None and future_dates is not None
    normal_cache: Dict = {}
    for s in range(n_samples):
        for t in range(preds.shape[2]):
            for c in county_idx:
                if c >= preds.shape[1]:
                    continue
                name = store.county_names[c]
                folder = os.path.join(out_dir, str(t + 1), name)
                os.makedirs(folder, exist_ok=True)
                ntl = ntl_to_np(preds[s, c, t], mean, std)
                year = (
                    int(future_dates[s, t, 0])
                    if future_dates is not None
                    else None
                )
                if use_monthly and year in RISK_MONTHS:
                    key = (c, year)
                    if key not in normal_cache:
                        normal_cache[key] = monthly_normal(
                            store, c, year, ntl.shape[0]
                        )
                    normal = normal_cache[key]
                else:
                    normal = average_baseline_ntl(
                        np.asarray(store.frames[:n_base, c]), range(n_base)
                    )
                    normal = np.rot90(normal.T, k=1)
                    if normal.shape != ntl.shape:
                        # store resolution may differ from model resolution:
                        # nearest-neighbor resize
                        zoom = ntl.shape[0] / normal.shape[0]
                        yy = (np.arange(ntl.shape[0]) / zoom).astype(int)
                        xx = (np.arange(ntl.shape[1]) / zoom).astype(int)
                        normal = normal[np.clip(yy, 0, normal.shape[0] - 1)][
                            :, np.clip(xx, 0, normal.shape[1] - 1)
                        ]
                pon = percent_of_normal(ntl, normal)
                fig, ax = plt.subplots(figsize=(4, 4), dpi=100)
                ax.pcolormesh(
                    pon, shading="auto", cmap="RdYlGn", vmin=0, vmax=100
                )
                ax.set_axis_off()
                if future_dates is not None:
                    y_, m_, d_ = (int(v) for v in future_dates[s, t])
                    fname = f"{y_}_{m_}_{d_}.png"
                else:
                    fname = f"sample_{s:04d}.png"
                path = os.path.join(folder, fname)
                fig.savefig(path, bbox_inches="tight")
                plt.close(fig)
                written.append(path)
    return written
