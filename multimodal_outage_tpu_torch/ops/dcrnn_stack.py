"""Whole eval-mode DCRNN seq2seq in one kernel.

Replaces the TPU kernel multimodal_outage_tpu/ops/dcrnn_stack_pallas.py:169
dcrnn_stack_forward (pl.pallas_call at :207) with the hand-written CUDA
kernel csrc/dcrnn_stack.cu. The recurrence is (T + horizon) steps × L
DCGRU cells of small dependent products on a 67-node graph, bound by its
serial chain rather than by FLOPs or bytes, so the whole seq2seq is one
launch; the .cu header says how.

dcrnn_stack_params splits the DCRNN tree's projection kernels into the
per-term × (x part, h part) blocks the kernel takes (a copy of
dcrnn_stack_pallas.py:126-166). stack_params_to puts them on the device;
in bfloat16 it also lays them out once in mma.sync B-fragment order
(stack_fragments, ops/fragments.py pack_fragments) for the kernel's
tensor-core body.
dcrnn_stack_forward is the wrapper: on CUDA tensors it launches the
kernel or raises; on CPU tensors it runs stack_forward_reference, the
plain PyTorch version the kernel is held against.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict

import torch
import torch.nn.functional as F

from multimodal_outage_tpu_torch.ops import _build
from multimodal_outage_tpu_torch.ops.fragments import (  # noqa: F401 (re-exported)
    _up,
    fragment_slot,
    pack_fragments,
    unpack_fragments,
)

_DTYPES = (torch.float32, torch.bfloat16)
_CELL_KEYS = ("gx", "gh", "gb", "cx", "ch", "cb")


def dcrnn_stack_params(
    params: Dict[str, Any],
    *,
    num_rnn_layers: int = 2,
    max_diffusion_step: int = 2,
    n_supports: int,
    input_dim: int,
    output_dim: int,
    rnn_units: int = 64,
) -> Dict[str, Any]:
    """Split a DCRNN param tree (encoder/decoder → cell{l} →
    gates|candidate → proj) into {"cells": [(gx, gh, gb, cx, ch, cb) per
    cell, encoder cells first], "proj_w", "proj_b"}. A DiffusionConv
    projects concat(terms), each term concat(x part, h part), so the rows
    of its [n_terms·(Dx+U), F] kernel split into kx [n_terms, Dx, F] and
    kh [n_terms, U, F]; biases become [1, F]."""
    nt = 1 + n_supports * max_diffusion_step
    t = lambda v: torch.as_tensor(v)

    def split(conv_p, dx: int):
        k = t(conv_p["proj"]["kernel"])
        din = dx + rnn_units
        kx = torch.stack([k[j * din: j * din + dx] for j in range(nt)])
        kh = torch.stack([k[j * din + dx: (j + 1) * din] for j in range(nt)])
        return kx, kh, t(conv_p["proj"]["bias"]).reshape(1, -1)

    cells = []
    for prefix, d0 in (("encoder", input_dim), ("decoder", output_dim)):
        dx = d0
        for l in range(num_rnn_layers):
            cp = params[prefix][f"cell{l}"]
            gx, gh, gb = split(cp["gates"], dx)
            cx, ch, cb = split(cp["candidate"], dx)
            cells.append((gx, gh, gb, cx, ch, cb))
            dx = rnn_units
    return {
        "cells": cells,
        "proj_w": t(params["decoder"]["proj"]["kernel"]),
        "proj_b": t(params["decoder"]["proj"]["bias"]).reshape(1, -1),
    }


def stack_params_to(sp: Dict[str, Any], device, dtype: torch.dtype) -> Dict[str, Any]:
    """sp with every array contiguous on `device` in `dtype`, as the
    kernel takes them; in bfloat16 also "frags", the projection weights
    in fragment order (stack_fragments), packed here once."""
    to = lambda v: v.to(device, dtype).contiguous()
    out = {
        "cells": [tuple(to(w) for w in cell) for cell in sp["cells"]],
        "proj_w": to(sp["proj_w"]), "proj_b": to(sp["proj_b"]),
    }
    if dtype == torch.bfloat16:
        out["frags"] = stack_fragments(out)
    return out


def stack_fragments(sp: Dict[str, Any]) -> Dict[str, Any]:
    """The projection weights of sp (dcrnn_stack_params, then
    stack_params_to) in fragment order, as the bf16 kernel reads them:
    per cell (wx, wh, wr) and "proj".

    wx packs each term's x-part gate and candidate columns side by side,
    the gates padded to 8·⌈2U/8⌉ columns and the candidate to 8·⌈U/8⌉, so
    one pass over the shared x-part chains feeds both; wh holds the h
    part of the gates and wr the (r ⊙ h) part of the candidate; proj is
    the decoder's output projection as one term."""
    u = sp["proj_w"].shape[0]
    g8, c8 = _up(2 * u, 8), _up(u, 8)
    cols = lambda w, m: F.pad(w, (0, m - w.shape[-1]))
    cells = [
        (pack_fragments(torch.cat([cols(gx, g8), cols(cx, c8)], -1)),
         pack_fragments(cols(gh, g8)), pack_fragments(cols(ch, c8)))
        for gx, gh, _, cx, ch, _ in sp["cells"]
    ]
    return {"cells": cells, "proj": pack_fragments(sp["proj_w"][None])}


def stack_forward_reference(
    x: torch.Tensor,
    supports: torch.Tensor,
    sp: Dict[str, Any],
    *,
    horizon: int,
    num_rnn_layers: int = 2,
    max_diffusion_step: int = 2,
    rnn_units: int = 64,
) -> torch.Tensor:
    """Plain PyTorch version: x [B, N, T, Dx0] → [B, N, horizon, Dout] in
    x.dtype.

    Sums are float32; values round to x.dtype where the TPU kernel rounds:
    after each A-product (dcrnn_stack_pallas.py:72), each Chebyshev step
    (:81-83), r (:100), r⊙h, the new state (:104) and each output
    (:119-121), with supports and weights taken in x.dtype. In float32 the
    rounding is the identity and this is the JAX package's
    stack_forward_reference (:227-284)."""
    dt = x.dtype
    rnd = lambda v: v.to(dt).float()
    f = lambda v: rnd(torch.as_tensor(v, device=x.device))
    sup = f(supports)
    u_n = rnn_units

    def chains(v):  # v [B, N, D]
        out = [v]
        for a in sup:
            prev, cur = v, rnd(torch.einsum("vw,bvd->bwd", a, v))
            out.append(cur)
            for _ in range(2, max_diffusion_step + 1):
                nxt = rnd(2.0 * rnd(torch.einsum("vw,bvd->bwd", a, cur)) - prev)
                out.append(nxt)
                prev, cur = cur, nxt
        return out

    def proj_sum(terms, w, acc):
        w = f(w)
        for j, tm in enumerate(terms):
            acc = acc + tm @ w[j]
        return acc

    def dcgru(cell, x_in, h):
        gx, gh, gb, cx, ch, cb = cell
        cx_terms = chains(x_in)
        ru = torch.sigmoid(proj_sum(chains(h), gh, proj_sum(cx_terms, gx, f(gb))))
        r, u = rnd(ru[..., :u_n]), ru[..., u_n:]
        c = torch.tanh(proj_sum(chains(rnd(r * h)), ch, proj_sum(cx_terms, cx, f(cb))))
        return rnd(u * h + (1.0 - u) * c)

    b, n, t, _ = x.shape
    xf = rnd(x)
    states = [xf.new_zeros(b, n, u_n) for _ in range(num_rnn_layers)]
    for ti in range(t):
        inp = xf[:, :, ti]
        for l in range(num_rnn_layers):
            states[l] = inp = dcgru(sp["cells"][l], inp, states[l])
    proj_w, proj_b = f(sp["proj_w"]), f(sp["proj_b"])
    prev = xf.new_zeros(b, n, proj_w.shape[1])  # GO symbol
    outs = []
    for _ in range(horizon):
        inp = prev
        for l in range(num_rnn_layers):
            states[l] = inp = dcgru(sp["cells"][num_rnn_layers + l], inp, states[l])
        prev = rnd(inp @ proj_w + proj_b)
        outs.append(prev)
    return torch.stack(outs, dim=2).to(dt)


def dcrnn_stack_forward(
    x: torch.Tensor,
    supports: torch.Tensor,
    sp: Dict[str, Any],
    *,
    horizon: int,
    num_rnn_layers: int = 2,
    max_diffusion_step: int = 2,
    rnn_units: int = 64,
) -> torch.Tensor:
    """x [B, N, T, Dx0] (float32 or bfloat16) → [B, N, horizon, Dout] in
    x.dtype. supports [S, N, N] and sp (dcrnn_stack_params, then
    stack_params_to) in x.dtype, contiguous, on x's device. float32 runs
    the kernel's CUDA-core body on sp's row-major weights; bfloat16 its
    tensor-core body on sp["frags"]."""
    kw = dict(horizon=horizon, num_rnn_layers=num_rnn_layers,
              max_diffusion_step=max_diffusion_step, rnn_units=rnn_units)
    if x.device.type == "cpu":
        return stack_forward_reference(x, supports, sp, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"dcrnn_stack_forward: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"dcrnn_stack_forward: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or supports.dim() != 3:
        raise ValueError("dcrnn_stack_forward: x must be [B, N, T, Dx0] and supports [S, N, N]")
    b, n, t, dx0 = x.shape
    u, L, s_count = rnn_units, num_rnn_layers, supports.shape[0]
    nt = s_count * max_diffusion_step + 1
    dout = sp["proj_w"].shape[-1]
    if len(sp["cells"]) != 2 * L or max_diffusion_step < 1 or horizon < 1:
        raise ValueError(
            f"dcrnn_stack_forward: {len(sp['cells'])} cells for {L} layers "
            f"(need {2 * L}); max_diffusion_step and horizon must be >= 1"
        )
    tensors = [("x", x, (b, n, t, dx0)), ("supports", supports, (s_count, n, n)),
               ("proj_w", sp["proj_w"], (u, dout)), ("proj_b", sp["proj_b"], (1, dout))]
    for i, cell in enumerate(sp["cells"]):
        dx = (dx0 if i < L else dout) if i % L == 0 else u
        shapes = ((nt, dx, 2 * u), (nt, u, 2 * u), (1, 2 * u), (nt, dx, u), (nt, u, u), (1, u))
        tensors += [(f"cells[{i}].{k}", w, shape)
                    for k, w, shape in zip(_CELL_KEYS, cell, shapes)]
    for name, v, shape in tensors:
        if tuple(v.shape) != shape or v.dtype != x.dtype or v.device != x.device:
            raise ValueError(
                f"dcrnn_stack_forward: {name} must be {x.dtype} {shape} on {x.device}, "
                f"got {v.dtype} {tuple(v.shape)} on {v.device}"
            )
        if not v.is_contiguous() or v.data_ptr() % 16:
            raise ValueError(f"dcrnn_stack_forward: {name} must be contiguous and 16-byte aligned")
    if any(v % 4 for v in (dx0, dout, u)) or L > 4:
        raise ValueError("dcrnn_stack_forward: widths must be multiples of 4 and layers <= 4")
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        frags = _check_fragments(sp, nt, dx0, dout, u, L)
    lib = _lib()
    smem = lib.dcrnn_stack_smem_bytes(n, u, L, s_count, max_diffusion_step, int(bf16))
    if smem > 227 * 1024:
        raise ValueError(
            f"dcrnn_stack_forward: {smem} bytes of shared memory for N={n}, "
            f"U={u} exceed one block's 227 KB"
        )
    y = torch.empty((b, n, horizon, dout), dtype=x.dtype, device=x.device)
    dims = (b, n, t, horizon, L, s_count, max_diffusion_step, dx0, dout, u)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if bf16:
            cells = (ctypes.c_void_p * (5 * L * 2))(*(
                v.data_ptr() for (wx, wh, wr), cell in zip(frags["cells"], sp["cells"])
                for v in (wx, wh, wr, cell[2], cell[5])))
            code = lib.dcrnn_stack_launch_bf16(
                x.data_ptr(), supports.data_ptr(), cells, frags["proj"].data_ptr(),
                sp["proj_b"].data_ptr(), y.data_ptr(), *dims, stream)
        else:
            cells = (ctypes.c_void_p * (12 * L))(
                *(w.data_ptr() for cell in sp["cells"] for w in cell))
            code = lib.dcrnn_stack_launch_f32(
                x.data_ptr(), supports.data_ptr(), cells, sp["proj_w"].data_ptr(),
                sp["proj_b"].data_ptr(), y.data_ptr(), *dims, stream)
    _build.check(lib, code, "dcrnn_stack")
    dcrnn_stack_forward.launches += 1
    return y


dcrnn_stack_forward.launches = 0


def _check_fragments(sp: Dict[str, Any], nt: int, dx0: int, dout: int, u: int,
                     L: int) -> Dict[str, Any]:
    """sp["frags"] (stack_fragments), each of the shape the bf16 kernel
    reads, contiguous, 16-byte aligned bf16 on the weights' device."""
    frags = sp.get("frags")
    if frags is None or len(frags["cells"]) != 2 * L:
        raise ValueError("dcrnn_stack_forward: bfloat16 needs sp['frags'] "
                         "(stack_params_to in bfloat16 packs them)")
    g8, c8, k16 = _up(2 * u, 8) // 8, _up(u, 8) // 8, _up(u, 16) // 16
    shapes = [("frags.proj", frags["proj"], (1, k16, _up(dout, 8) // 8, 32, 4))]
    for i, (wx, wh, wr) in enumerate(frags["cells"]):
        dx = (dx0 if i < L else dout) if i % L == 0 else u
        shapes += [(f"frags.cells[{i}].wx", wx, (nt, _up(dx, 16) // 16, g8 + c8, 32, 4)),
                   (f"frags.cells[{i}].wh", wh, (nt, k16, g8, 32, 4)),
                   (f"frags.cells[{i}].wr", wr, (nt, k16, c8, 32, 4))]
    dev = sp["proj_w"].device
    for name, v, shape in shapes:
        if (tuple(v.shape) != shape or v.dtype != torch.bfloat16 or v.device != dev
                or not v.is_contiguous() or v.data_ptr() % 16):
            raise ValueError(f"dcrnn_stack_forward: {name} must be contiguous 16-byte aligned "
                             f"bfloat16 {shape} on {dev}, got {v.dtype} {tuple(v.shape)}")
    return frags


def _lib() -> ctypes.CDLL:
    lib = _build.load("dcrnn_stack")
    if lib.dcrnn_stack_launch_f32.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.dcrnn_stack_launch_f32, lib.dcrnn_stack_launch_bf16):
            fn.argtypes = [p] * 6 + [i] * 10 + [p]
            fn.restype = i
        lib.dcrnn_stack_smem_bytes.argtypes = [i] * 6
        lib.dcrnn_stack_smem_bytes.restype = i
    return lib


def flops(b: int, n: int, t: int, horizon: int, dx0: int, dout: int, units: int,
          n_layers: int, s_count: int, order: int, part: str = "all") -> int:
    """Multiply-adds ×2 of one call (elementwise work not counted): part
    "chains" (the diffusion products), "proj" (term × weight products and
    the decoder's output projection) or "all". The decoder's first step has
    the zero GO symbol as input, whose x part contributes nothing and is
    skipped."""
    nt = s_count * order + 1
    with_chains, with_proj = part in ("all", "chains"), part in ("all", "proj")

    def cell(dx: int, x: bool = True) -> int:
        d = (dx if x else 0) + 2 * units  # x, h and r⊙h chains
        chains = s_count * order * n * n * d
        proj = nt * n * ((dx * 3 * units if x else 0) + units * 2 * units + units * units)
        return with_chains * chains + with_proj * proj

    per_step = lambda d0, x=True: cell(d0, x) + (n_layers - 1) * cell(units)
    macs = (t * per_step(dx0) + (horizon - 1) * per_step(dout) + per_step(dout, False)
            + with_proj * horizon * n * units * dout)
    return 2 * b * macs


def min_bytes(x: torch.Tensor, supports: torch.Tensor, sp: Dict[str, Any], horizon: int) -> int:
    """Bytes one call must move: x, supports and weights read once, y
    written once."""
    tensors = [x, supports, sp["proj_w"], sp["proj_b"], *(w for c in sp["cells"] for w in c)]
    dout = sp["proj_w"].shape[-1]
    y = x.shape[0] * x.shape[1] * horizon * dout * x.element_size()
    return sum(v.numel() * v.element_size() for v in tensors) + y
