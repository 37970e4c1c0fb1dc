"""Device-resident input pipeline.

The packed frame store lives on the device in float32; a batch is an
index_select of its windows, the [B,T,N,…]→[B,N,T,…] permute (reference
lit.py:31) and the reference's per-image Resize + Normalize (reference
utils.py:35-38), all on the device — the counterpart of the JAX package's
data/pipeline.py DevicePipeline. Only tiny index and date arrays cross
from the host per batch.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F


def default_frame_transform(
    win: torch.Tensor, mean: torch.Tensor, std: torch.Tensor, image_size: int
) -> torch.Tensor:
    """Resize(image_size) + Normalize(mean, std) on a [B, N, T, H, W]
    float32 window → [B, N, T, s, s, 1] float32.

    Resize is bilinear with antialiasing when it shrinks, as
    jax.image.resize(method="bilinear") is. mean/std may be rounded to the
    compute dtype (as the JAX pipeline holds them); the arithmetic is
    float32 either way."""
    if win.shape[-1] != image_size or win.shape[-2] != image_size:
        b, n, t, h, w = win.shape
        win = F.interpolate(
            win.reshape(b * n * t, 1, h, w),
            size=(image_size, image_size),
            mode="bilinear",
            align_corners=False,
            antialias=True,
        ).reshape(b, n, t, image_size, image_size)
    return (win[..., None] - mean.float()) / std.float()


def gather_windows(
    frames: torch.Tensor,  # [D, N, H, W] float32 store on the device
    pos: torch.Tensor,  # [B, 2·horizon] int64 frame positions
    date_feats: torch.Tensor,  # [B, horizon, 6] float32
    mean: torch.Tensor,
    std: torch.Tensor,
    horizon: int,
    image_size: int,
    dtype: torch.dtype,
) -> Dict[str, torch.Tensor]:
    """Window gather + layout + normalize. The model input `x` is in the
    compute dtype; the target `y` stays float32 — MAPE's near-zero
    denominators amplify target quantization (JAX pipeline.py:107-110)."""
    b = pos.shape[0]

    def window(p: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
        win = frames.index_select(0, p.reshape(-1))  # [B·h, N, H, W]
        n, h, w = win.shape[1:]
        win = win.reshape(b, horizon, n, h, w).permute(0, 2, 1, 3, 4)
        return default_frame_transform(win, mean, std, image_size).to(
            out_dtype
        ).contiguous()

    return {
        "x": window(pos[:, :horizon], dtype),
        "y": window(pos[:, horizon:], torch.float32),
        "date_feats": date_feats,
    }


class DevicePipeline:
    """Keeps the packed frame store on the device; batches are device
    gathers driven by small host index arrays."""

    def __init__(
        self,
        store,
        mean: float,
        std: float,
        image_size: int,
        dtype: torch.dtype,
        device: torch.device,
    ):
        self.device = device
        # np.array copies the read-only memmap into a writable host buffer
        self.frames = torch.from_numpy(
            np.array(store.frames, dtype=np.float32)
        ).to(device)
        # held in the compute dtype, like the JAX pipeline's mean/std
        self.mean = torch.tensor(mean, dtype=dtype, device=device)
        self.std = torch.tensor(std, dtype=dtype, device=device)
        self.image_size = image_size
        self.dtype = dtype

    def batch(self, dataset, batch_idx: np.ndarray) -> Dict[str, torch.Tensor]:
        pos = torch.from_numpy(dataset.window_positions(batch_idx)).to(
            self.device
        )
        feats = torch.from_numpy(dataset.window_date_feats(batch_idx)).to(
            self.device
        )
        return gather_windows(
            self.frames, pos, feats, self.mean, self.std,
            dataset.horizon, self.image_size, self.dtype,
        )
