"""Trainable building blocks of the ModifiedUNet, channels-last.

The port of the JAX package's models/layers.py. Parameters keep the flax
names and layouts (Dense kernel [in, out], conv kernel HWIO, ConvTranspose
kernel [kh, kw, in, out]), so a module's named parameters map one to one
onto the JAX variable tree (weights.module_variables). Masters are
float32; every block casts its weights and input to its compute dtype in
the forward, as flax's `dtype=` does.

Activations are [..., H, W, C] with any leading axes; convolutions fold
the leading axes into one batch axis and run through cuDNN on a
channels-last view, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from multimodal_outage_tpu_torch.ops.max_pool import (
    MaxPool2x2Reference,
    max_pool_2x2_pallas,
    supports_shape,
)
from multimodal_outage_tpu_torch.weights import conv_transpose_weight

_SAMPLE_WEIGHT = (
    "sample_weight (pad-masked BatchNorm updates) only exists on the mesh "
    "path; it comes with the ROADMAP item 'SPMD with sample_weight'"
)


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax nn.Dropout: keep with probability 1−rate, scale kept values by
    1/(1−rate). The mask comes from `generator` (the global generator when
    None); it cannot reproduce JAX's random bits."""
    if not train or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


class Dense(nn.Module):
    """flax nn.Dense: x @ kernel + bias in the compute dtype."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype) @ self.kernel.to(self.dtype) + self.bias.to(self.dtype)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """[..., H, W, C] → [M, C, H, W] channels-last view (no copy when x is
    contiguous)."""
    h, w, c = x.shape[-3:]
    return x.reshape(-1, h, w, c).permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor, lead) -> torch.Tensor:
    y = y.permute(0, 2, 3, 1)
    return y.reshape(*lead, *y.shape[1:])


class Conv(nn.Module):
    """flax nn.Conv with SAME padding, stride 1, odd kernel sizes, kernel
    HWIO."""

    def __init__(self, kh: int, kw: int, cin: int, cout: int, use_bias: bool,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(kh, kw, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout)) if use_bias else None
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kh, kw = self.kernel.shape[:2]
        k = self.kernel.to(self.dtype).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last
        )
        b = None if self.bias is None else self.bias.to(self.dtype)
        y = F.conv2d(_nchw(x.to(self.dtype)), k, b, padding=(kh // 2, kw // 2))
        return _nhwc(y, x.shape[:-3])


class ConvTranspose(nn.Module):
    """flax nn.ConvTranspose, kernel 2×2, stride 2, VALID, with bias."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(2, 2, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = conv_transpose_weight(self.kernel.to(self.dtype))
        y = F.conv_transpose2d(_nchw(x.to(self.dtype)), w, self.bias.to(self.dtype), stride=2)
        return _nhwc(y, x.shape[:-3])


class GroupedBatchNorm(nn.Module):
    """BatchNorm with torch semantics and per-group train statistics
    (JAX models/layers.py:19-174).

    Train mode computes the statistics of each group of the leading
    `num_group_axes` axes (e.g. (batch, county)) over all other
    non-channel axes, in float32, either in one sweep shifted by the
    running mean before its update and clamped at 0 (single_pass,
    layers.py:92-104) or in two passes (:105-112). The running statistics
    follow torch's EMA (momentum 0.1) of the unbiased variance
    m/(m−1)·var (:114-115): serial_ema=True applies the closed form of G
    serial per-group updates, decay·r + w @ s with decay = (1−m)^G and
    w_k = m(1−m)^(G−1−k), groups in C order (batch outer, county inner:
    :132-151); serial_ema=False the uniform EMA of the group means
    (:152-167). Eval mode normalizes with the running statistics. The
    output is cast back to the input dtype (:172-174)."""

    def __init__(self, features: int, num_group_axes: int, momentum: float = 0.1,
                 eps: float = 1e-5, serial_ema: bool = True, single_pass: bool = False):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.num_group_axes = num_group_axes
        self.momentum = momentum
        self.eps = eps
        self.serial_ema = serial_ema
        self.single_pass = single_pass

    def forward(self, x: torch.Tensor, train: bool, sample_weight=None) -> torch.Tensor:
        if sample_weight is not None:
            raise NotImplementedError(_SAMPLE_WEIGHT)
        if not train:
            inv = torch.rsqrt(self.var + self.eps) * self.scale
            return ((x.float() - self.mean) * inv + self.bias).to(x.dtype)
        g = math.prod(x.shape[: self.num_group_axes])
        xg = x.float().reshape(g, -1, x.shape[-1])  # [G, m, C]
        if self.single_pass:
            m0 = self.mean.clone()
            xs = xg - m0
            s1 = xs.mean(dim=1, keepdim=True)
            s2 = xs.square().mean(dim=1, keepdim=True)
            mean = s1 + m0
            var = torch.clamp(s2 - s1.square(), min=0.0)
        else:
            mean = xg.mean(dim=1, keepdim=True)
            var = (xg - mean).square().mean(dim=1, keepdim=True)
        self._update_running(mean.detach(), var.detach(), xg.shape[1])
        inv = torch.rsqrt(var + self.eps) * self.scale
        return ((xg - mean) * inv + self.bias).to(x.dtype).reshape(x.shape)

    @torch.no_grad()
    def _update_running(self, mean: torch.Tensor, var: torch.Tensor, m: int) -> None:
        g, c = mean.shape[0], mean.shape[-1]
        s_mean = mean.reshape(g, c)
        s_var = (var * (m / max(m - 1, 1))).reshape(g, c)
        mom = self.momentum
        if self.serial_ema:
            w = mom * (1 - mom) ** torch.arange(
                g - 1, -1, -1, dtype=torch.float32, device=mean.device
            )
            decay = (1 - mom) ** g
            self.mean.copy_(decay * self.mean + w @ s_mean)
            self.var.copy_(decay * self.var + w @ s_var)
        else:
            self.mean.copy_((1 - mom) * self.mean + mom * s_mean.mean(0))
            self.var.copy_((1 - mom) * self.var + mom * s_var.mean(0))


class DoubleConv(nn.Module):
    """(Conv3×3 → GroupedBatchNorm → ReLU) × 2, no conv bias (JAX
    layers.py:177-210)."""

    def __init__(self, cin: int, features: int, num_group_axes: int = 2,
                 dtype: torch.dtype = torch.float32, bn_single_pass: bool = False):
        super().__init__()
        self.conv1 = Conv(3, 3, cin, features, use_bias=False, dtype=dtype)
        self.bn1 = GroupedBatchNorm(features, num_group_axes, single_pass=bn_single_pass)
        self.conv2 = Conv(3, 3, features, features, use_bias=False, dtype=dtype)
        self.bn2 = GroupedBatchNorm(features, num_group_axes, single_pass=bn_single_pass)

    def forward(self, x: torch.Tensor, train: bool, sample_weight=None) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x), train, sample_weight))
        return torch.relu(self.bn2(self.conv2(x), train, sample_weight))


def max_pool_2x2(x: torch.Tensor, impl: str = "reduce_window",
                 reference: bool = False) -> torch.Tensor:
    """2×2 max-pool over the last two spatial axes (JAX layers.py:213-254).

    "reduce_window": F.max_pool2d. "pairwise": two maximums of strided
    slices (even H and W; else reduce_window). "pallas": the kernel pair of
    ops/max_pool.py exactly where the JAX package runs its Pallas kernel
    (supports_shape: even H/W, W·C % 128 == 0), else reduce_window, so
    ties route as in the JAX package at every shape. reference=True runs
    the pallas impl's plain versions instead of the kernels (the step a
    kernel step is held against)."""
    h, w = x.shape[-3], x.shape[-2]
    if impl == "pairwise" and h % 2 == 0 and w % 2 == 0:
        x = torch.maximum(x[..., 0::2, :, :], x[..., 1::2, :, :])
        return torch.maximum(x[..., 0::2, :], x[..., 1::2, :])
    if impl == "pallas" and supports_shape(x):
        fn = MaxPool2x2Reference.apply if reference else max_pool_2x2_pallas
        return fn(x.contiguous())
    return _nhwc(F.max_pool2d(_nchw(x), 2), x.shape[:-3])


class Down(nn.Module):
    """MaxPool(2) → DoubleConv (JAX layers.py:257-273)."""

    def __init__(self, cin: int, features: int, dtype: torch.dtype = torch.float32,
                 bn_single_pass: bool = False, pool: str = "reduce_window",
                 pool_reference: bool = False):
        super().__init__()
        self.conv = DoubleConv(cin, features, dtype=dtype, bn_single_pass=bn_single_pass)
        self.pool = pool
        self.pool_reference = pool_reference

    def forward(self, x: torch.Tensor, train: bool, sample_weight=None) -> torch.Tensor:
        return self.conv(max_pool_2x2(x, self.pool, self.pool_reference), train, sample_weight)


class Up(nn.Module):
    """ConvTranspose 2×2 s2 → pad to the skip's size → concat [skip, up] →
    DoubleConv (JAX layers.py:276-319)."""

    def __init__(self, cin: int, skip_ch: int, features: int,
                 dtype: torch.dtype = torch.float32, bn_single_pass: bool = False):
        super().__init__()
        self.up = ConvTranspose(cin, cin // 2, dtype=dtype)
        self.conv = DoubleConv(skip_ch + cin // 2, features, dtype=dtype,
                               bn_single_pass=bn_single_pass)

    def forward(self, x: torch.Tensor, skip: torch.Tensor, train: bool,
                sample_weight=None) -> torch.Tensor:
        x = self.up(x)
        dh, dw = skip.shape[-3] - x.shape[-3], skip.shape[-2] - x.shape[-2]
        if dh or dw:
            x = F.pad(x, (0, 0, dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        return self.conv(torch.cat([skip, x], dim=-1), train, sample_weight)


class OutConv(nn.Module):
    """1×1 projection head (JAX layers.py:322-332)."""

    def __init__(self, cin: int, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv(1, 1, cin, features, use_bias=True, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)
