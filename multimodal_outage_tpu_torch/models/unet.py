"""U-Net image autoencoder: Contraction / bottleneck MLPs / Expansion
(JAX models/unet.py), over [B, N, T, H, W, C].

Channel schedule: contraction C_in →4 →8 →16 →32 →64 (H → H/16), the
bottleneck MLPs flat(64·(H/16)²) →/4 →256 and back, expansion 64 →32 →16
→8 →4 → C_out with the skip pyramid consumed in reverse.

remat (JAX models/unet.py:26-98, 147-189) recomputes conv blocks in the
backward of a train-mode forward under grad (layers.remat); an eval
forward, or one without grad (DCRNN's teacher pass), runs them plainly.
remat_scope "all" wraps every block; "stem" the blocks of the top two
resolutions, inc and down1 in the contraction and the last two Ups
(up3, up4 at depth 4) in the expansion; "conv" every block, keeping the
convolution outputs. The blocks keep their names, so parameter and
buffer names, and with them checkpoints, are the same across the toggle.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from multimodal_outage_tpu_torch.models.layers import (
    Dense,
    DoubleConv,
    Down,
    ROWS_TIME_MODEL,
    OutConv,
    Up,
    dropout,
    remat,
)


def _call(block: nn.Module, scope: Optional[str], stem: bool, *args) -> torch.Tensor:
    """block(*args) under the remat scope in force (None: no remat)."""
    if scope == "conv":
        return remat(block, *args, save_convs=True)
    if scope == "all" or (scope == "stem" and stem):
        return remat(block, *args)
    return block(*args)


def _scope(module: nn.Module, train: bool) -> Optional[str]:
    if module.remat and train and torch.is_grad_enabled():
        return module.remat_scope
    return None


class Contraction(nn.Module):
    """4-stage encoder → (bottleneck, skip pyramid) (JAX unet.py:34-98)."""

    def __init__(self, input_channels: int = 1, base_channels: int = 4, depth: int = 4,
                 remat: bool = False, bn_single_pass: bool = False,
                 pool: str = "reduce_window", dtype: torch.dtype = torch.float32,
                 pool_reference: bool = False, remat_scope: str = "all"):
        super().__init__()
        self.remat, self.remat_scope = remat, remat_scope
        sp = bn_single_pass
        self.inc = DoubleConv(input_channels, base_channels, dtype=dtype, bn_single_pass=sp)
        ch = base_channels
        self.depth = depth
        for i in range(depth):
            self.add_module(f"down{i + 1}", Down(
                ch, 2 * ch, dtype=dtype, bn_single_pass=sp, pool=pool,
                pool_reference=pool_reference,
            ))
            ch *= 2

    def forward(self, x: torch.Tensor, train: bool, sample_weight=None
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        scope = _scope(self, train)
        x = _call(self.inc, scope, True, x, train, sample_weight)
        skips = [x]
        for i in range(self.depth):
            x = _call(getattr(self, f"down{i + 1}"), scope, i == 0, x, train, sample_weight)
            if i < self.depth - 1:
                skips.append(x)
        return x, tuple(skips)


class BottleneckEncoder(nn.Module):
    """Flattened bottleneck → feature vector: relu(fc1) → dropout →
    relu(fc2) (JAX unet.py:101-119)."""

    def __init__(self, flat_dim: int, feature_vector_size: int = 256,
                 compression_factor: int = 4, dropout: float = 0.3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = flat_dim // compression_factor
        self.fc1 = Dense(flat_dim, hidden, dtype)
        self.fc2 = Dense(hidden, feature_vector_size, dtype)
        self.rate = dropout

    def forward(self, x: torch.Tensor, train: bool,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        flat = x.reshape(*x.shape[:-3], -1)  # [B, N, T, h·w·c]
        h = dropout(torch.relu(self.fc1(flat)), self.rate, train, generator, ROWS_TIME_MODEL)
        return torch.relu(self.fc2(h))


class BottleneckDecoder(nn.Module):
    """Feature vector → bottleneck grid (JAX unet.py:122-144)."""

    def __init__(self, grid_size: int, grid_channels: int, feature_vector_size: int = 256,
                 compression_factor: int = 4, dropout: float = 0.3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = feature_vector_size * compression_factor
        self.fc1 = Dense(feature_vector_size, hidden, dtype)
        self.fc2 = Dense(hidden, grid_size * grid_size * grid_channels, dtype)
        self.grid = (grid_size, grid_size, grid_channels)
        self.rate = dropout

    def forward(self, x: torch.Tensor, train: bool,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = dropout(torch.relu(self.fc1(x)), self.rate, train, generator, ROWS_TIME_MODEL)
        return torch.relu(self.fc2(h)).reshape(*x.shape[:-1], *self.grid)


class Expansion(nn.Module):
    """4-stage decoder over the skip pyramid in reverse, then the 1×1 head
    (JAX unet.py:147-189)."""

    def __init__(self, output_channels: int = 1, base_channels: int = 4, depth: int = 4,
                 remat: bool = False, bn_single_pass: bool = False,
                 dtype: torch.dtype = torch.float32, remat_scope: str = "all"):
        super().__init__()
        self.remat, self.remat_scope = remat, remat_scope
        ch = base_channels * 2 ** (depth - 1)
        self.depth = depth
        for i in range(depth):
            self.add_module(f"up{i + 1}", Up(2 * ch, ch, ch, dtype=dtype,
                                             bn_single_pass=bn_single_pass))
            ch //= 2
        self.outc = OutConv(base_channels, output_channels, dtype=dtype)

    def forward(self, x: torch.Tensor, skips: Tuple[torch.Tensor, ...], train: bool,
                sample_weight=None) -> torch.Tensor:
        scope = _scope(self, train)
        for i in range(self.depth):
            x = _call(getattr(self, f"up{i + 1}"), scope, i >= self.depth - 2, x,
                      skips[-(i + 1)], train, sample_weight)
        return self.outc(x)
