"""Fused U-Net DoubleConv: (conv3×3 SAME → folded-BN affine → ReLU) × 2.

Replaces the TPU kernel multimodal_outage_tpu/ops/unet_pallas.py:119
fused_double_conv (pl.pallas_call at :85) with the hand-written CUDA
kernel csrc/double_conv.cu, which has two bodies chosen by dtype:

- bfloat16 (serving): a tensor-core implicit GEMM (mma.sync m16n8k16,
  float32 accumulate) with persistent blocks that stage w1 and w2 once
  and walk over (image, tile) items, the next item's input tile arriving
  by cp.async while the current one computes. At 128² and 64² (1-16
  channels) bytes bound it; at 8² 32→64 and 16² 64→32 the work reaches
  the H100's FLOP/byte line, which only tensor cores can meet.
  plan_bf16 reckons its tile, channel padding and shared memory.
- float32: CUDA-core FMAs, one block per (image, tile), the tile from
  pick_tile. TF32 would break the 1e-4 float32 bar.

Both read each input pixel and write each output pixel once and keep the
intermediate in shared memory; the .cu header says how.

fused_double_conv is the wrapper: on a CUDA tensor it launches the kernel
or raises, with gradients from autograd of the plain version; on a CPU
tensor it runs double_conv_reference, the plain PyTorch version the
kernel is held against. kernel_takes says which shapes the kernel takes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from multimodal_outage_tpu_torch.ops import _build

_SMEM_BUDGET = 227 * 1024  # H100 dynamic shared memory a block may use
_TILES = ((16, 16), (8, 16), (8, 8), (4, 8), (4, 4))
# bf16 tiles, largest first; the planner takes the first of at least
# 16×16 pixels (or the whole image) of which two blocks fit an SM's 228 KB
# (1 KB of each reserved), else the first that fits: below 16×16 the
# halo costs more than a second resident block gains (timed on an H100
# at 16² 64→32: 8×8 with two blocks per SM was slower than 16×16 with one)
_BF16_TILES = ((32, 32), (16, 32)) + _TILES
_SM_SMEM = 228 * 1024
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_NTILES = 16  # bf16: C ≤ 128
_PRE_WORDS = 4  # bf16: kPre in csrc/double_conv.cu


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
    """float32: the largest output tile (th, tw) whose shared-memory
    footprint fits a block; returns (th, tw, bytes). Mirrors the float32
    kernel's smem layout."""
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


class Bf16Plan(NamedTuple):
    """The bf16 kernel's tile and padding (csrc/double_conv.cu bf16_layout).

    cp1/cp2: Cin and C padded for K (2, 4, 8 or a multiple of 16); px:
    pixels per GEMM row (2 at C = 4), so K = 3·(2 + px)·cp taps ×
    channels in kc1/kc2 chunks of 16; npad: C padded for N, whose px·npad
    columns are 8 × a power of two; smem: dynamic shared bytes; items:
    (image, tile) work items."""

    th: int
    tw: int
    cp1: int
    cp2: int
    npad: int
    px: int
    kc1: int
    kc2: int
    smem: int
    items: int


def _k_pad(ch: int) -> int:
    return 2 if ch <= 2 else 4 if ch <= 4 else 8 if ch <= 8 else -(-ch // 16) * 16


def _n_tiles(c: int) -> int:
    p = 1
    while 8 * p < c:
        p *= 2
    return p


def _pixels_per_row(c: int, tw: int) -> int:
    """Pixels per GEMM row: two neighbours at C = 4 (N = 2 × 4 channels)
    where the tile width is even, else one."""
    return 2 if c == 4 and tw % 2 == 0 else 1


def _k_chunks(cp: int, px: int) -> int:
    """K chunks of 16 over a 3 × (2 + px) tap window of cp channels."""
    return -(-3 * (2 + px) * cp // 16)


def _bf16_smem(cin: int, c: int, th: int, tw: int) -> int:
    """Bytes of the bf16 kernel's shared memory, region by region as in
    bf16_layout (each region a multiple of 16 bytes)."""
    up16 = lambda b: -(-b // 16) * 16
    up32 = lambda n: -(-n // 32) * 32
    cp1, cp2, nt = _k_pad(cin), _k_pad(c), _n_tiles(c)
    s1, s2 = (cp if cp < 16 else cp + 8 for cp in (cp1, cp2))
    px = _pixels_per_row(c, tw)
    kc1, kc2 = (_k_chunks(cp, px) for cp in (cp1, cp2))
    return (
        (kc1 + kc2) * nt * 256  # w1, w2 as packed B fragments
        + 4 * 8 * nt * 4  # s1 b1 s2 b2
        + 32 * (kc1 + kc2)  # A offsets per K pair
        + up16(4 * (th + 4) * (tw + 4))  # input-tile pixel table
        + 8 * (up32((th + 2) * (tw + 2) // px) + up32(th * tw // px))  # GEMM row tables
        + 2 * up16((th + 4) * (tw + 4) * s1 * 2)  # input tile ×2, 2-pixel halo
        + up16((th + 2) * (tw + 2) * s2 * 2)  # intermediate, 1-pixel halo
    )


@functools.lru_cache(maxsize=None)
def plan_bf16(m: int, h: int, w: int, cin: int, c: int) -> Bf16Plan:
    """The largest output tile (up to 32×32; the whole image at 8² and
    16²) of at least 16×16 pixels of which two blocks fit an SM, else the
    largest that fits one (_BF16_TILES), among those whose input tile,
    where Cin % 4 != 0, the block's registers hold. Raises ValueError for
    a shape the bf16 kernel does not take: C not a multiple of 4, C > 128,
    or no fit."""
    if c <= 0 or c % 4:
        raise ValueError(f"fused_double_conv: C={c} must be a multiple of 4")
    nt = _n_tiles(c)
    if nt > _MAX_NTILES:
        raise ValueError(f"fused_double_conv: bf16 takes C ≤ {8 * _MAX_NTILES}, got C={c}")
    cp1, cp2 = _k_pad(cin), _k_pad(c)
    fits = []
    for th, tw in _BF16_TILES:
        th, tw = min(th, h), min(tw, w)
        smem = _bf16_smem(cin, c, th, tw)
        # without cp.async (Cin % 4 != 0) a thread holds its share of the
        # next input tile in _PRE_WORDS registers
        held = cin % 4 == 0 or (th + 4) * (tw + 4) * cp1 // 2 <= _PRE_WORDS * 256
        if smem <= _SMEM_BUDGET and held:
            fits.append((th, tw, smem))
    if fits:
        two = [f for f in fits if 2 * (f[2] + 1024) <= _SM_SMEM and f[0] * f[1] >= min(256, h * w)]
        th, tw, smem = (two or fits)[0]
        px = _pixels_per_row(c, tw)
        return Bf16Plan(th, tw, cp1, cp2, 8 * nt // px, px, _k_chunks(cp1, px),
                        _k_chunks(cp2, px), smem, m * -(-h // th) * -(-w // tw))
    raise ValueError(
        f"fused_double_conv: bf16 DoubleConv with Cin={cin}, C={c} does not fit one "
        "block's shared memory at any tile size"
    )


def bf16_grid(items: int, sms: int, per_sm: int) -> int:
    """Persistent grid: one block per work item, at most a full wave."""
    if per_sm <= 0:
        raise ValueError("fused_double_conv: the bf16 kernel fits no block on an SM")
    return min(items, sms * per_sm)


# (device index, C, smem) → blocks per SM, asked of the CUDA runtime once
_PER_SM: Dict[Tuple[int, int, int], int] = {}


def launch_config(m: int, h: int, w: int, cin: int, c: int, dtype: torch.dtype,
                  device: torch.device) -> Tuple[int, int, int, int]:
    """(th, tw, dynamic shared bytes, blocks) of the kernel's launch for
    one call: bf16 from plan_bf16 and the persistent grid, float32 from
    pick_tile with one block per (image, tile)."""
    if dtype != torch.bfloat16:
        th, tw, smem = pick_tile(h, w, cin, c)
        return th, tw, smem, m * -(-h // th) * -(-w // tw)
    plan = plan_bf16(m, h, w, cin, c)
    key = (device.index, c, plan.smem)
    if key not in _PER_SM:
        lib = _lib()
        per_sm = lib.double_conv_bf16_blocks_per_sm(c, plan.smem)
        if per_sm < 0:
            _build.check(lib, -per_sm, "double_conv occupancy")
        _PER_SM[key] = per_sm
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return plan.th, plan.tw, plan.smem, bf16_grid(plan.items, sms, _PER_SM[key])


def kernel_takes(cin: int, c: int, dtype: torch.dtype) -> bool:
    """Whether the kernel takes a DoubleConv of Cin → C in `dtype` (C a
    multiple of 4; bf16: C ≤ 128; the smallest tile fits a block). The
    serving engine sends the other shapes to double_conv_reference, as the
    JAX engine sends its kernel's (serving.py:338-347)."""
    if dtype not in _DTYPES or c <= 0 or c % 4:
        return False
    th, tw = _TILES[-1]
    try:
        if dtype == torch.bfloat16:
            plan_bf16(1, th, tw, cin, c)
        else:
            pick_tile(th, tw, cin, c)
    except ValueError:
        return False
    return True


def _launch(x, w1, s1, b1, w2, s2, b2):
    """The kernel on CUDA tensors, or raise."""
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
    if x.dtype == torch.bfloat16 and x.data_ptr() % 16:
        raise ValueError("fused_double_conv: x must be 16-byte aligned (cp.async)")
    th, tw, smem, blocks = launch_config(m, h, w, cin, c, x.dtype, x.device)
    lib = _lib()
    out = torch.empty((m, h, w, c), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.double_conv_launch(
            x.data_ptr(), w1.data_ptr(), s1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), s2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            m, h, w, cin, c, th, tw, smem, blocks, _DTYPES[x.dtype], stream,
        )
    _build.check(lib, code, "double_conv")
    fused_double_conv.launches += 1
    return out


class _FusedDoubleConv(torch.autograd.Function):
    """Forward through the kernel; backward by autograd of the plain
    version re-materialised from the saved inputs (the JAX custom_vjp,
    unet_pallas.py:118-134)."""

    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        return _launch(*args)

    @staticmethod
    def backward(ctx, dy):
        leaves = [v.detach().requires_grad_(need)
                  for v, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [v for v in leaves if v.requires_grad]
        with torch.enable_grad():
            y = double_conv_reference(*leaves)
            grads = iter(torch.autograd.grad(y, wanted, dy))
        return tuple(next(grads) if v.requires_grad else None for v in leaves)


def fused_double_conv(x, w1, s1, b1, w2, s2, b2):
    """x [M, H, W, Cin] → [M, H, W, C] in x.dtype (float32 or bfloat16),
    differentiable: the kernel forward on the card, exact gradients of the
    plain version.

    w1 [3,3,Cin,C], w2 [3,3,C,C] in x.dtype; s1/b1/s2/b2 [C] float32."""
    args = (x, w1, s1, b1, w2, s2, b2)
    if x.device.type == "cpu":
        return double_conv_reference(*args)
    if torch.is_grad_enabled() and any(v.requires_grad for v in args):
        return _FusedDoubleConv.apply(*args)
    return _launch(*args)  # no graph to record (serving runs in inference mode)


fused_double_conv.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("double_conv")
    if lib.double_conv_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.double_conv_launch.argtypes = [p] * 8 + [i] * 10 + [p]
        lib.double_conv_launch.restype = i
        lib.double_conv_bf16_blocks_per_sm.argtypes = [i, i]
        lib.double_conv_bf16_blocks_per_sm.restype = i
    return lib


def flops(m: int, h: int, w: int, cin: int, c: int) -> int:
    """Multiply-adds ×2 of one call."""
    return 2 * m * h * w * 9 * (cin * c + c * c)


def min_bytes(m: int, h: int, w: int, cin: int, c: int, itemsize: int) -> int:
    """Bytes one call must move: x and the weights read once, out written
    once, the float32 affine vectors read once."""
    return itemsize * (m * h * w * (cin + c) + 9 * c * (cin + c)) + 4 * 4 * c
