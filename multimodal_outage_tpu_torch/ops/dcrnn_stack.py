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

The bf16 body runs each sample on a thread-block cluster of C CTAs, one
per SM, each owning U/(4C) unit quads (their r, u and c columns) and a
slice of the output columns, with its slice of the projection weights
resident in shared memory and the states exchanged through distributed
shared memory (two cluster barriers a cell); the encoder's layer-0 x
part, which no state enters, is a prepass spread over the cluster. What
bounds it now: the Chebyshev chains of the narrow inputs, which every CTA
computes whole on mma.sync, latency-bound, and the barriers. stack_plan
chooses C and lays out each CTA's shared memory: a plain function of the
shapes, the batch and how many clusters of each size the card runs at
once (the wrapper asks the card, cudaOccupancyMaxActiveClusters, and
keeps the answer); the fewest waves of clusters wins, then the largest C.

dcrnn_stack_forward is the wrapper: on CUDA tensors it launches the
kernel or raises; on CPU tensors it runs stack_forward_reference, the
plain PyTorch version the kernel is held against. Counters:
dcrnn_stack_forward.launches, and .ctas_per_sample {C: launches} (the
float32 body runs one block per sample, C = 1).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict, Mapping, Optional

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

SMEM_LIMIT = 232_448  # bytes of shared memory a block may opt in to on the H100
_WARPS = 16           # warps of a CTA (csrc/dcrnn_stack.cu kThreads / 32)
_CHUNK = 64           # input columns per x-part chain pass (kChunk)
_CLUSTERS = (16, 8, 4, 2, 1)  # CTAs per sample tried; 16 is Hopper's largest cluster


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


def cluster_layout(n: int, layers: int, s_count: int, order: int, dx0: int, dout: int,
                   units: int, c: int, smem_limit: int = SMEM_LIMIT) -> Optional[Dict[str, Any]]:
    """The shared memory of one CTA of the bf16 body with c CTAs per
    sample, or None where c does not split the unit quads or the buffers
    alone exceed smem_limit. Byte offsets, each region 16-byte aligned:
    at (the transposed supports), states (every layer's whole state), rh,
    terms (the nt Chebyshev terms), acc (the own columns' float32 sums),
    slots (split k-step partial sums), bias (every cell's biases, float32),
    then the resident weight slices:
    the h and r⊙h parts of every cell first, then the x parts of all cells
    but encoder layer 0 (the prepass's), each where it still fits; the
    rest is read from L2. "resident"[cell][part] is the offset of the slice
    of part 0 wx, 1 wh, 2 wr, or -1."""
    quads = units // 4
    if units % 4 or c < 1 or quads % c:
        return None
    nq, np_, up, nt = quads // c, _up(n, 16), _up(units, 16), s_count * order + 1
    ncv = (nq + 1) // 2
    lay = {"C": c, "quads": nq, "ld_at": np_ + 8, "ld_t": max(up, _CHUNK) + 8,
           "ld_acc": _up(8 * (nq + ncv), 32) + 8}
    total = 0
    for name, size in (("at", 2 * s_count * np_ * lay["ld_at"]),
                       ("states", 2 * layers * np_ * lay["ld_t"]),
                       ("rh", 2 * np_ * lay["ld_t"]),
                       ("terms", 2 * nt * np_ * lay["ld_t"]),
                       ("acc", 4 * np_ * lay["ld_acc"]),
                       ("slots", 4 * _WARPS * 128),
                       ("bias", 4 * 2 * layers * (_up(2 * units, 8) + _up(units, 8)))):
        lay[name] = total
        total += _up(size, 16)
    lay["weights"] = total
    if total > smem_limit:
        return None
    halves = (3 * nq, 2 * nq, nq)  # wx, wh, wr: quads of the slice

    def k_steps(cell: int, part: int) -> int:
        dx = units if cell % layers else (dout if cell else dx0)
        return nt * _up(dx if part == 0 else units, 16) // 16

    resident = [[-1, -1, -1] for _ in range(2 * layers)]
    for cell, part in ([(cl, pt) for pt in (1, 2) for cl in range(2 * layers)]
                       + [(cl, 0) for cl in range(1, 2 * layers)]):
        size = halves[part] * k_steps(cell, part) * 128
        if total + size <= smem_limit:
            resident[cell][part] = total
            total += size
    lay["resident"] = resident
    lay["total"] = total
    return lay


def stack_plan(b: int, n: int, layers: int, s_count: int, order: int, dx0: int, dout: int,
               units: int, active: Mapping[int, int],
               smem_limit: int = SMEM_LIMIT) -> Dict[str, Any]:
    """CTAs per sample C and the layout of each (cluster_layout) for a
    batch of b. active[c] is how many clusters of c CTAs the card runs at
    once with that layout's shared memory (0 or absent: none). Among the
    C in (16, 8, 4, 2, 1) whose layout fits and that the card runs, the
    fewest waves ⌈b / active[C]⌉ win, then the largest C. Raises where none
    fits."""
    best = None
    for c in _CLUSTERS:
        lay = cluster_layout(n, layers, s_count, order, dx0, dout, units, c, smem_limit)
        if lay is None or active.get(c, 0) < 1:
            continue
        waves = -(-b // active[c])
        if best is None or waves < best[0]:
            best = (waves, lay)
    if best is None:
        raise ValueError(
            f"dcrnn_stack_forward: no cluster split of N={n}, U={units} fits one block's "
            f"{smem_limit} bytes of shared memory on this card")
    return best[1]


def plan_ints(lay: Dict[str, Any]) -> list:
    """The plan as the bf16 launcher takes it (csrc/dcrnn_stack.cu
    dcrnn_stack_launch_bf16)."""
    keys = ("C", "ld_at", "ld_t", "ld_acc", "at", "states", "rh", "terms", "acc", "slots",
            "bias", "weights", "total")
    return [lay[k] for k in keys] + [o for cell in lay["resident"] for o in cell]


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
    lib = _lib()
    if bf16:
        frags = _check_fragments(sp, nt, dx0, dout, u, L)
        lay = _plan(b, n, L, s_count, max_diffusion_step, dx0, dout, u, x.device)
        c = lay["C"]
        nch = -(-_up(dx0, 16) // _CHUNK)
        part = torch.empty(b * t * nch * _up(n, 16) * (_up(2 * u, 8) + _up(u, 8)),
                           dtype=torch.float32, device=x.device)
    else:
        c = 1
        smem = lib.dcrnn_stack_smem_bytes_f32(n, u, L, s_count)
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
                sp["proj_b"].data_ptr(), y.data_ptr(), part.data_ptr(), *dims, lay["ints"],
                stream)
        else:
            cells = (ctypes.c_void_p * (12 * L))(
                *(w.data_ptr() for cell in sp["cells"] for w in cell))
            code = lib.dcrnn_stack_launch_f32(
                x.data_ptr(), supports.data_ptr(), cells, sp["proj_w"].data_ptr(),
                sp["proj_b"].data_ptr(), y.data_ptr(), *dims, stream)
    _build.check(lib, code, "dcrnn_stack")
    dcrnn_stack_forward.launches += 1
    counts = dcrnn_stack_forward.ctas_per_sample
    counts[c] = counts.get(c, 0) + 1
    return y


dcrnn_stack_forward.launches = 0
dcrnn_stack_forward.ctas_per_sample = {}


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


@functools.lru_cache(maxsize=None)
def _plan(b: int, n: int, layers: int, s_count: int, order: int, dx0: int, dout: int,
          units: int, device: torch.device) -> Dict[str, Any]:
    """stack_plan for these shapes on `device`, asking the card how many
    clusters of each candidate layout it runs at once (a size the card
    refuses counts as none), with "ints", the plan as the launcher takes
    it."""
    lib, active = _lib(), {}
    with torch.cuda.device(device):
        for c in _CLUSTERS:
            lay = cluster_layout(n, layers, s_count, order, dx0, dout, units, c)
            if lay is not None:
                count = ctypes.c_int(0)
                code = lib.dcrnn_stack_max_clusters(c, lay["total"], ctypes.byref(count))
                active[c] = count.value if code == 0 else 0
    lay = stack_plan(b, n, layers, s_count, order, dx0, dout, units, active)
    ints = plan_ints(lay)
    return {**lay, "ints": (ctypes.c_int * len(ints))(*ints)}


def _lib() -> ctypes.CDLL:
    lib = _build.load("dcrnn_stack")
    if lib.dcrnn_stack_launch_f32.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dcrnn_stack_launch_f32.argtypes = [p] * 6 + [i] * 10 + [p]
        lib.dcrnn_stack_launch_bf16.argtypes = [p] * 7 + [i] * 10 + [ctypes.POINTER(i), p]
        for fn in (lib.dcrnn_stack_launch_f32, lib.dcrnn_stack_launch_bf16):
            fn.restype = i
        lib.dcrnn_stack_smem_bytes_f32.argtypes = [i] * 4
        lib.dcrnn_stack_smem_bytes_f32.restype = i
        lib.dcrnn_stack_max_clusters.argtypes = [i, i, ctypes.POINTER(i)]
        lib.dcrnn_stack_max_clusters.restype = i
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
