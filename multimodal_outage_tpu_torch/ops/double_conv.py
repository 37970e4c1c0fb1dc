"""Fused U-Net DoubleConv: (conv3×3 SAME → folded-BN affine → ReLU) × 2.

Replaces the TPU kernel multimodal_outage_tpu/ops/unet_pallas.py:119
fused_double_conv (pl.pallas_call at :85) with the hand-written CUDA
kernel csrc/double_conv.cu. Bytes bound it on the card (1-64 channels
sit far below the H100's FLOP/byte line), so the kernel reads each input
pixel and writes each output pixel once and keeps the intermediate in
shared memory; the .cu header says how.

fused_double_conv is the wrapper: on a CUDA tensor it launches the kernel
or raises; on a CPU tensor it runs double_conv_reference, the plain
PyTorch version the kernel is held against.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from multimodal_outage_tpu_torch.ops import _build

_SMEM_BUDGET = 227 * 1024  # H100 dynamic shared memory a block may use
_TILES = ((16, 16), (8, 16), (8, 8), (4, 8), (4, 4))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fold_batchnorm(scale, bias, mean, var, eps: float = 1e-5):
    """Eval BN y = (x−μ)·γ/√(σ²+ε) + β  →  per-channel (s, b): y = x·s + b
    (unet_pallas.py:32-35)."""
    s = scale * torch.rsqrt(var + eps)
    return s, bias - mean * s


def double_conv_reference(x, w1, s1, b1, w2, s2, b2):
    """Plain PyTorch version. x: [M, H, W, Cin]; w: HWIO; s/b: [C] f32.

    Convolutions run in float32 on the storage-dtype values (float32
    accumulation, as the TPU kernel's preferred_element_type), and the
    result is rounded to x.dtype after each ReLU (unet_pallas.py:103-115).
    Callers on the card must disable TF32 for an exact float32 reference."""

    def conv(v, k):
        y = F.conv2d(
            v.float().permute(0, 3, 1, 2), k.float().permute(3, 2, 0, 1),
            padding=1,
        )
        return y.permute(0, 2, 3, 1)

    y = torch.relu(conv(x, w1) * s1 + b1).to(x.dtype)
    return torch.relu(conv(y, w2) * s2 + b2).to(x.dtype)


def pick_tile(h: int, w: int, cin: int, c: int) -> Tuple[int, int, int]:
    """Largest output tile (th, tw) whose shared-memory footprint fits a
    block; returns (th, tw, bytes). Mirrors the kernel's smem layout."""
    for th, tw in _TILES:
        th, tw = min(th, h), min(tw, w)
        floats = (
            9 * c * max(cin, c)  # staged weights (w1, then w2)
            + 4 * c  # s1 b1 s2 b2
            + (th + 4) * (tw + 4) * (cin | 1)  # input tile + 2-pixel halo
            + (th + 2) * (tw + 2) * (c | 1)  # intermediate + 1-pixel halo
        )
        if 4 * floats <= _SMEM_BUDGET:
            return th, tw, 4 * floats
    raise ValueError(
        f"DoubleConv with Cin={cin}, C={c} does not fit one block's shared "
        "memory at any tile size"
    )


def fused_double_conv(x, w1, s1, b1, w2, s2, b2):
    """x [M, H, W, Cin] → [M, H, W, C] in x.dtype (float32 or bfloat16).

    w1 [3,3,Cin,C], w2 [3,3,C,C] in x.dtype; s1/b1/s2/b2 [C] float32."""
    if x.device.type == "cpu":
        return double_conv_reference(x, w1, s1, b1, w2, s2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_double_conv: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_double_conv: x must be float32 or bfloat16, got {x.dtype}")
    m, h, w, cin = x.shape
    c = w1.shape[3]
    if c % 4:
        raise ValueError(f"fused_double_conv: C={c} must be a multiple of 4")
    for name, t, shape, dt in (
        ("w1", w1, (3, 3, cin, c), x.dtype),
        ("w2", w2, (3, 3, c, c), x.dtype),
        ("s1", s1, (c,), torch.float32),
        ("b1", b1, (c,), torch.float32),
        ("s2", s2, (c,), torch.float32),
        ("b2", b2, (c,), torch.float32),
    ):
        if tuple(t.shape) != shape or t.dtype != dt or t.device != x.device:
            raise ValueError(
                f"fused_double_conv: {name} must be {dt} {shape} on {x.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"fused_double_conv: {name} must be contiguous")
    if not x.is_contiguous():
        raise ValueError("fused_double_conv: x must be contiguous (NHWC)")
    th, tw, smem = pick_tile(h, w, cin, c)
    out = torch.empty((m, h, w, c), dtype=x.dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.double_conv_launch(
            x.data_ptr(), w1.data_ptr(), s1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), s2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            m, h, w, cin, c, th, tw, smem, _DTYPES[x.dtype], stream,
        )
    _build.check(lib, code, "double_conv")
    fused_double_conv.launches += 1
    return out


fused_double_conv.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("double_conv")
    if lib.double_conv_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.double_conv_launch.argtypes = [p] * 8 + [i] * 9 + [p]
        lib.double_conv_launch.restype = i
    return lib


def flops(m: int, h: int, w: int, cin: int, c: int) -> int:
    """Multiply-adds ×2 of one call."""
    return 2 * m * h * w * 9 * (cin * c + c * c)


def min_bytes(m: int, h: int, w: int, cin: int, c: int, itemsize: int) -> int:
    """Bytes one call must move: x and the weights read once, out written
    once, the float32 affine vectors read once."""
    return itemsize * (m * h * w * (cin + c) + 9 * c * (cin + c)) + 4 * 4 * c
