"""One fused Graph WaveNet layer (kernel_size 1): gated unit, skip
projection and order-K diffusion over every support, → (h, s).

Replaces the TPU kernel multimodal_outage_tpu/ops/gwnet_pallas.py:187
fused_gwnet_layer (pl.pallas_call at :139) with the hand-written CUDA
kernel csrc/gwnet_layer.cu: one block per (b, t) position, whose time is
the latency of its chain of four dependent products, not FLOPs or bytes.
In bf16 every product runs on the tensor cores (mma.sync) from weights
the block stages itself, row-major, as they arrive; bf16_layout below
mirrors that body's shared memory. In float32 the same chain runs on the
CUDA cores. On an H100 a bf16 call takes ~0.018 ms of device time at B =
1-16 (the CUDA-core body it replaced ~0.064 ms), less than this
wrapper's host time per call (checks, allocation, launch: ~0.04-0.07 ms
measured by back-to-back CUDA events); the .cu header has the design.

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
from typing import Dict, Tuple

import torch

from multimodal_outage_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM = 232448  # dynamic shared memory one block may have (227 KB)
_NAMES = ("x", "supports", "wf", "bf", "wg", "bg", "ws", "bs", "wc", "bc")


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
    # one pass over the inputs (the host's time per call is of the order
    # of the kernel's); the error path names the offender
    inputs = (x, supports, wf, bf, wg, bg, ws, bs, wc, bc)
    shapes = ((b, n, t, c), (s_count, n, n), (c, cd), (cd,), (c, cd), (cd,), (cd, cs), (cs,),
              ((s_count * order + 1) * cd, c), (c,))
    dtype, device = x.dtype, x.device
    for name, v, shape in zip(_NAMES, inputs, shapes):
        if v.shape != shape or v.dtype != dtype or v.device != device:
            raise ValueError(
                f"gwnet_layer_forward: {name} must be {dtype} {shape} on {device}, "
                f"got {v.dtype} {tuple(v.shape)} on {v.device}"
            )
        if not v.is_contiguous() or v.data_ptr() % 16:
            raise ValueError(f"gwnet_layer_forward: {name} must be contiguous and 16-byte aligned")
    if order < 1 or any(v % 4 for v in (c, cd, cs)):
        raise ValueError("gwnet_layer_forward: order >= 1 and channel widths multiples of 4")
    smem = smem_bytes(n, c, cd, cs, s_count, order, x.dtype)
    if smem > MAX_SMEM:
        raise ValueError(
            f"gwnet_layer_forward: the {x.dtype} body needs {smem} bytes of shared memory "
            f"for N={n}, C={c}, Cd={cd}, Cs={cs}, S={s_count}, order={order}, above one "
            "block's 227 KB"
        )
    lib = _lib()
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


def smem_bytes(n: int, c: int, cd: int, cs: int, s_count: int, order: int,
               dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block of the kernel's body for dtype,
    as the library computes it (bf16: bf16_layout(...)["total"])."""
    return _lib().gwnet_layer_smem_bytes(n, c, cd, cs, s_count, order,
                                         int(dtype == torch.bfloat16))


# LayoutB's fields in declaration order, as gwnet_layer_bf16_layout
# writes them
LAYOUT_FIELDS = ("Np", "MT", "Cp", "C8", "Cdp", "Cd8", "Cs8", "nt",
                 "ld_x", "ld_at", "ld_t", "ld_fg", "ld_s", "ld_c",
                 "x", "at", "terms", "wfg", "ws", "wc", "bias", "sup", "total")


def smem_layout(n: int, c: int, cd: int, cs: int, s_count: int, order: int) -> Dict[str, int]:
    """The bf16 body's shared-memory layout as the library computes it
    (csrc/gwnet_layer.cu LayoutB), keyed as bf16_layout."""
    out = (ctypes.c_int * len(LAYOUT_FIELDS))()
    _lib().gwnet_layer_bf16_layout(n, c, cd, cs, s_count, order, out)
    return dict(zip(LAYOUT_FIELDS, out))


def _lib() -> ctypes.CDLL:
    lib = _build.load("gwnet_layer")
    if lib.gwnet_layer_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gwnet_layer_launch.argtypes = [p] * 12 + [i] * 9 + [p]
        lib.gwnet_layer_launch.restype = i
        lib.gwnet_layer_smem_bytes.argtypes = [i] * 7
        lib.gwnet_layer_smem_bytes.restype = i
        lib.gwnet_layer_bf16_layout.argtypes = [i] * 6 + [ctypes.POINTER(i)]
        lib.gwnet_layer_bf16_layout.restype = None
    return lib


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def bf16_layout(n: int, c: int, cd: int, cs: int, s_count: int, order: int) -> Dict[str, int]:
    """The bf16 body's shared memory, as csrc/gwnet_layer.cu LayoutB lays
    it out: padded widths, row strides in elements ("ld_*", each 8 past a
    multiple of 16, so the 8 rows of an ldmatrix fall in distinct banks)
    and byte offsets of the buffers (x rows [Np, Cp]; Aᵀ [S, Np, Np];
    terms [Np, nt·Cdp], term j from column j·Cdp; [Wf | Wg] [Cp, 2·Cd8]
    interleaved by fg_column; Ws [Cdp, Cs8]; Wc [nt·Cdp, C8], source row i
    at wc_row(i); the biases; the supports as they come, [S·N·N]), and
    "total", the block's bytes."""
    lay = {
        "Np": _up(n, 16), "Cp": _up(c, 16), "C8": _up(c, 8), "Cdp": _up(cd, 16),
        "Cd8": _up(cd, 8), "Cs8": _up(cs, 8), "nt": s_count * order + 1,
    }
    lay["MT"] = lay["Np"] // 16
    lay.update(
        ld_x=lay["Cp"] + 8, ld_at=lay["Np"] + 8, ld_t=lay["nt"] * lay["Cdp"] + 8,
        ld_fg=2 * lay["Cd8"] + 8, ld_s=_up(lay["Cs8"], 16) + 8, ld_c=_up(lay["C8"], 16) + 8,
    )
    sizes = (  # (buffer, bytes), in order
        ("x", 2 * lay["Np"] * lay["ld_x"]),
        ("at", 2 * s_count * lay["Np"] * lay["ld_at"]),
        ("terms", 2 * lay["Np"] * lay["ld_t"]),
        ("wfg", 2 * lay["Cp"] * lay["ld_fg"]),
        ("ws", 2 * lay["Cdp"] * lay["ld_s"]),
        ("wc", 2 * lay["nt"] * lay["Cdp"] * lay["ld_c"]),
        ("bias", 2 * (2 * lay["Cd8"] + lay["Cs8"] + lay["C8"])),
        ("sup", 2 * s_count * n * n),
    )
    off = 0
    for name, nbytes in sizes:
        lay[name] = off
        off += _up(nbytes, 16)
    lay["total"] = off
    return lay


def fg_column(c: int, gate: bool) -> int:
    """Column of the staged [Wf | Wg] (and of its bias) that holds filter
    column c (gate False) or gate column c (gate True): blocks of 8
    columns interleaved, so both sit in the same slot c % 8 of n-tiles
    2⌊c/8⌋ and 2⌊c/8⌋ + 1."""
    return 16 * (c // 8) + 8 * int(gate) + c % 8


def wc_row(i: int, cd: int) -> int:
    """Row of the staged Wc that holds source row i: term i // cd starts at
    row (i // cd)·Cdp, Cdp = 16⌈cd/16⌉."""
    return i // cd * _up(cd, 16) + i % cd


def flops(b: int, n: int, t: int, c: int, cd: int, cs: int, s_count: int, order: int) -> int:
    """Multiply-adds ×2 of one call (elementwise work not counted)."""
    nt = s_count * order + 1
    return 2 * b * t * (n * c * 2 * cd + n * cd * cs + (nt - 1) * n * n * cd + n * nt * cd * c)


def min_bytes(x: torch.Tensor, supports: torch.Tensor, *weights: torch.Tensor, cs: int) -> int:
    """Bytes one call must move: inputs and weights read once, h and s
    written once."""
    read = sum(v.numel() * v.element_size() for v in (x, supports, *weights))
    return read + x.numel() // x.shape[-1] * (x.shape[-1] + cs) * x.element_size()
