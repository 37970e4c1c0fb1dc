"""2×2 / stride-2 max-pool, forward and backward, for the training path.

Replaces the TPU kernel pair multimodal_outage_tpu/ops/pool_pallas.py:235
max_pool_2x2_pallas (forward pl.pallas_call at :163, backward at :191)
with the hand-written CUDA kernels in csrc/max_pool.cu. Bytes bound both
(a few compares per value), so each reads its inputs and writes its output
once; the .cu header says how.

The backward is the JAX kernel's deterministic single-winner subgradient,
and so is its tie routing (pool_pallas.py:131-147): per window column the
even row wins when x[2i] >= x[2i+1], then the even column wins when its
row maximum is >= the odd one's. On the window [[0, 5], [5, 0]] that sends
the gradient to (1, 0), where F.max_pool2d and XLA's select-and-scatter
send it to (0, 1). ReLU outputs make such ties common in training.

max_pool_2x2_pallas(x) is the autograd-aware entry. Its two halves,
max_pool_forward and max_pool_backward, are the wrappers: on CUDA tensors
each launches its kernel or raises, on CPU tensors each runs its plain
PyTorch version (max_pool_reference / max_pool_backward_reference), which
the kernels are held against. Each wrapper counts its kernel launches in
`.launches`.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from multimodal_outage_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def supports_shape(x: torch.Tensor) -> bool:
    """Where the JAX package runs its kernel (pool_pallas.py:219-231):
    even H and W, and W·C a multiple of 128 (its TPU lane tiling). Kept
    as the port's gate so that ties route as the JAX package routes them
    at every shape; elsewhere both take reduce_window."""
    h, w, c = x.shape[-3], x.shape[-2], x.shape[-1]
    return h % 2 == 0 and w % 2 == 0 and (w * c) % 128 == 0


def _windows(x: torch.Tensor):
    """The four window positions of x [..., H, W, C]: (a, b, c, d) are
    rows 2i/2i+1 × columns 2j/2j+1 as a b / c d."""
    return (x[..., 0::2, 0::2, :], x[..., 0::2, 1::2, :],
            x[..., 1::2, 0::2, :], x[..., 1::2, 1::2, :])


def max_pool_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch forward: [..., H, W, C] → [..., H/2, W/2, C]. The
    row pair first, then the column pair, with NaN-propagating maximums
    (jnp.maximum's semantics)."""
    a, b, c, d = _windows(x)
    return torch.maximum(torch.maximum(a, c), torch.maximum(b, d)).contiguous()


def max_pool_backward_reference(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch backward: g [..., H/2, W/2, C] goes whole to one
    position of each window of x, with the JAX kernel's tie routing; dx
    has x's shape and dtype."""
    a, b, c, d = _windows(x)
    g = g.to(x.dtype)
    even_row0, even_row1 = a >= c, b >= d
    even_col = torch.maximum(a, c) >= torch.maximum(b, d)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    dx[..., 0::2, 0::2, :] = torch.where(even_col & even_row0, g, zero)
    dx[..., 1::2, 0::2, :] = torch.where(even_col & ~even_row0, g, zero)
    dx[..., 0::2, 1::2, :] = torch.where(~even_col & even_row1, g, zero)
    dx[..., 1::2, 1::2, :] = torch.where(~even_col & ~even_row1, g, zero)
    return dx


def _check(x: torch.Tensor, what: str) -> Tuple[int, int, int, int]:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() < 3 or not x.is_contiguous():
        raise ValueError(f"{what}: x must be a contiguous [..., H, W, C] tensor")
    h, w, c = x.shape[-3:]
    if h % 2 or w % 2:
        raise ValueError(f"{what}: H={h} and W={w} must be even")
    return x.numel() // (h * w * c), h, w, c


def _vec_bytes(c: int, itemsize: int, *tensors: torch.Tensor) -> int:
    """The widest access (16, 8 or 4 bytes) that divides one pixel's C
    values and to which every pointer is aligned."""
    for v in (16, 8, 4):
        if (c * itemsize) % v == 0 and all(t.data_ptr() % v == 0 for t in tensors):
            return v
    raise ValueError(
        f"max_pool: C={c} {itemsize}-byte values need a 4-byte aligned "
        "pixel (C·itemsize a multiple of 4)"
    )


def max_pool_forward(x: torch.Tensor) -> torch.Tensor:
    """x [..., H, W, C] → [..., H/2, W/2, C] in x.dtype."""
    if x.device.type == "cpu":
        return max_pool_reference(x)
    m, h, w, c = _check(x, "max_pool_forward")
    y = torch.empty((*x.shape[:-3], h // 2, w // 2, c), dtype=x.dtype, device=x.device)
    vec = _vec_bytes(c, x.element_size(), x, y)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.max_pool_fwd_launch(
            x.data_ptr(), y.data_ptr(), m, h, w, c, vec, _DTYPES[x.dtype], stream
        )
    _build.check(lib, code, "max_pool_fwd")
    max_pool_forward.launches += 1
    return y


max_pool_forward.launches = 0


def max_pool_backward(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dx [..., H, W, C] in x.dtype from x and the output cotangent g."""
    if x.device.type == "cpu":
        return max_pool_backward_reference(x, g)
    m, h, w, c = _check(x, "max_pool_backward")
    want = (*x.shape[:-3], h // 2, w // 2, c)
    g = g.to(x.dtype).contiguous()
    if tuple(g.shape) != want or g.device != x.device:
        raise ValueError(
            f"max_pool_backward: g must be {want} on {x.device}, got "
            f"{tuple(g.shape)} on {g.device}"
        )
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    vec = _vec_bytes(c, x.element_size(), x, g, dx)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.max_pool_bwd_launch(
            x.data_ptr(), g.data_ptr(), dx.data_ptr(), m, h, w, c, vec,
            _DTYPES[x.dtype], stream,
        )
    _build.check(lib, code, "max_pool_bwd")
    max_pool_backward.launches += 1
    return dx


max_pool_backward.launches = 0


class MaxPool2x2(torch.autograd.Function):
    """Forward and backward through the wrappers above."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return max_pool_forward(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return max_pool_backward(x, g)


class MaxPool2x2Reference(torch.autograd.Function):
    """The plain versions on any device: what a train step on the card is
    held against (the same tie routing, no kernel)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return max_pool_reference(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return max_pool_backward_reference(x, g)


def max_pool_2x2_pallas(x: torch.Tensor) -> torch.Tensor:
    """[..., H, W, C] → [..., H/2, W/2, C], differentiable; named after the
    JAX function it ports."""
    return MaxPool2x2.apply(x)


def _lib() -> ctypes.CDLL:
    lib = _build.load("max_pool")
    if lib.max_pool_fwd_launch.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.max_pool_fwd_launch.argtypes = [p, p, ll, i, i, i, i, i, p]
        lib.max_pool_fwd_launch.restype = i
        lib.max_pool_bwd_launch.argtypes = [p, p, p, ll, i, i, i, i, i, p]
        lib.max_pool_bwd_launch.restype = i
    return lib


def min_bytes(numel: int, itemsize: int, backward: bool) -> int:
    """Bytes one call must move. Forward: read x, write x/4. Backward:
    read x and g (x/4), write dx."""
    if backward:
        return itemsize * (2 * numel + numel // 4)
    return itemsize * (numel + numel // 4)


def ops(numel: int, backward: bool) -> int:
    """Compares of one call: 3 per output value forward, 3 plus 4 selects
    backward."""
    return (7 if backward else 3) * (numel // 4)
