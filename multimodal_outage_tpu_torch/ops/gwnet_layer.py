"""One fused Graph WaveNet layer (kernel_size 1): gated unit, skip
projection and order-K diffusion over every support, → (h, s).

Replaces the TPU kernel multimodal_outage_tpu/ops/gwnet_pallas.py:187
fused_gwnet_layer (pl.pallas_call at :139) with the hand-written CUDA
kernel csrc/gwnet_layer.cu. A layer is a few MFLOP per (b, t) position,
so launch latency bounds it; the .cu header says how the kernel is laid
out for that.

gwnet_layer_reference is the plain PyTorch version (the JAX package's
forward_reference, gwnet_pallas.py:166): what the default Graph WaveNet
path runs and what the kernel is held against. gwnet_layer_forward is the
wrapper: on CUDA tensors it launches the kernel or raises; on CPU tensors
it runs the plain version. fused_gwnet_layer is the autograd.Function
around it, the counterpart of the JAX custom_vjp: the forward is the
wrapper, the backward re-materialises the plain version and takes its
VJP (gwnet_pallas.py:206-210), gradients for supports included.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from multimodal_outage_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def gwnet_layer_reference(x, supports, wf, bf, wg, bg, ws, bs, wc, bc, order: int):
    """One gated-TCN + diffusion layer → (h, s) (JAX ops/gwnet_pallas.py:166
    forward_reference): g = tanh(x·Wf + bf) ⊙ σ(x·Wg + bg), s = g·Ws + bs,
    h = [g, A g, A² g, …]·Wc + bc over every support A."""
    g = torch.tanh(x @ wf + bf) * torch.sigmoid(x @ wg + bg)
    s = g @ ws + bs
    terms = [g]
    for a in supports:
        t = g
        for _ in range(order):
            t = torch.einsum("bvtc,vw->bwtc", t, a)
            terms.append(t)
    return torch.cat(terms, dim=-1) @ wc + bc, s


def gwnet_layer_forward(
    x: torch.Tensor, supports: torch.Tensor,
    wf: torch.Tensor, bf: torch.Tensor, wg: torch.Tensor, bg: torch.Tensor,
    ws: torch.Tensor, bs: torch.Tensor, wc: torch.Tensor, bc: torch.Tensor,
    order: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, N, T, C] (float32 or bfloat16) → (h [B, N, T, C], s [B, N, T,
    Cs]) in x.dtype. supports [S, N, N] and the weights in x.dtype, all
    contiguous."""
    if x.device.type == "cpu":
        return gwnet_layer_reference(x, supports, wf, bf, wg, bg, ws, bs, wc, bc, order)
    if x.device.type != "cuda":
        raise ValueError(f"gwnet_layer_forward: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"gwnet_layer_forward: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or supports.dim() != 3:
        raise ValueError("gwnet_layer_forward: x must be [B, N, T, C] and supports [S, N, N]")
    b, n, t, c = x.shape
    cd, cs, s_count = wf.shape[-1], ws.shape[-1], supports.shape[0]
    expect = {
        "x": (x, (b, n, t, c)), "supports": (supports, (s_count, n, n)),
        "wf": (wf, (c, cd)), "bf": (bf, (cd,)), "wg": (wg, (c, cd)), "bg": (bg, (cd,)),
        "ws": (ws, (cd, cs)), "bs": (bs, (cs,)),
        "wc": (wc, ((s_count * order + 1) * cd, c)), "bc": (bc, (c,)),
    }
    for name, (v, shape) in expect.items():
        if tuple(v.shape) != shape or v.dtype != x.dtype or v.device != x.device:
            raise ValueError(
                f"gwnet_layer_forward: {name} must be {x.dtype} {shape} on {x.device}, "
                f"got {v.dtype} {tuple(v.shape)} on {v.device}"
            )
        if not v.is_contiguous() or v.data_ptr() % 16:
            raise ValueError(f"gwnet_layer_forward: {name} must be contiguous and 16-byte aligned")
    if order < 1 or any(v % 4 for v in (c, cd, cs)):
        raise ValueError("gwnet_layer_forward: order >= 1 and channel widths multiples of 4")
    lib = _lib()
    smem = lib.gwnet_layer_smem_bytes(n, cd, s_count, order)
    if smem > 227 * 1024:
        raise ValueError(
            f"gwnet_layer_forward: {smem} bytes of shared memory for N={n} "
            "exceed one block's 227 KB"
        )
    h = torch.empty((b, n, t, c), dtype=x.dtype, device=x.device)
    s = torch.empty((b, n, t, cs), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.gwnet_layer_launch(
            x.data_ptr(), supports.data_ptr(), wf.data_ptr(), bf.data_ptr(),
            wg.data_ptr(), bg.data_ptr(), ws.data_ptr(), bs.data_ptr(),
            wc.data_ptr(), bc.data_ptr(), h.data_ptr(), s.data_ptr(),
            b, n, t, c, cd, cs, s_count, order, _DTYPES[x.dtype], stream,
        )
    _build.check(lib, code, "gwnet_layer")
    gwnet_layer_forward.launches += 1
    return h, s


gwnet_layer_forward.launches = 0


class FusedGWNetLayer(torch.autograd.Function):
    """Forward through gwnet_layer_forward; backward by autograd of the
    plain version re-materialised from the saved inputs."""

    @staticmethod
    def forward(ctx, x, supports, wf, bf, wg, bg, ws, bs, wc, bc, order):
        inputs = [v.contiguous() for v in (x, supports, wf, bf, wg, bg, ws, bs, wc, bc)]
        ctx.save_for_backward(*inputs)
        ctx.order = order
        return gwnet_layer_forward(*inputs, order=order)

    @staticmethod
    def backward(ctx, dh, ds):
        leaves = [v.detach().requires_grad_(need)
                  for v, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [v for v in leaves if v.requires_grad]
        with torch.enable_grad():
            h, s = gwnet_layer_reference(*leaves, order=ctx.order)
            grads = iter(torch.autograd.grad((h, s), wanted, (dh, ds)))
        return (*(next(grads) if v.requires_grad else None for v in leaves), None)


def fused_gwnet_layer(x, supports, wf, bf, wg, bg, ws, bs, wc, bc, order: int = 2):
    """Differentiable (h, s) of one layer: the kernel forward on the card,
    exact gradients of the plain version; named after the JAX function it
    ports."""
    return FusedGWNetLayer.apply(x, supports, wf, bf, wg, bg, ws, bs, wc, bc, order)


def _lib() -> ctypes.CDLL:
    lib = _build.load("gwnet_layer")
    if lib.gwnet_layer_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gwnet_layer_launch.argtypes = [p] * 12 + [i] * 9 + [p]
        lib.gwnet_layer_launch.restype = i
        lib.gwnet_layer_smem_bytes.argtypes = [i] * 4
        lib.gwnet_layer_smem_bytes.restype = i
    return lib


def flops(b: int, n: int, t: int, c: int, cd: int, cs: int, s_count: int, order: int) -> int:
    """Multiply-adds ×2 of one call (elementwise work not counted)."""
    nt = s_count * order + 1
    return 2 * b * t * (n * c * 2 * cd + n * cd * cs + (nt - 1) * n * n * cd + n * nt * cd * c)


def min_bytes(x: torch.Tensor, supports: torch.Tensor, *weights: torch.Tensor, cs: int) -> int:
    """Bytes one call must move: inputs and weights read once, h and s
    written once."""
    read = sum(v.numel() * v.element_size() for v in (x, supports, *weights))
    return read + x.numel() // x.shape[-1] * (x.shape[-1] + cs) * x.element_size()
