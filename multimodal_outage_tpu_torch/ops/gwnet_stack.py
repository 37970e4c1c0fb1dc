"""Whole-stack eval-mode Graph WaveNet forward in one kernel.

Replaces the TPU kernel multimodal_outage_tpu/ops/gwnet_stack_pallas.py:200
gwnet_stack_forward (pl.pallas_call at :253) with the hand-written CUDA
kernel csrc/gwnet_stack.cu. The 67-node network is a serial chain of ~70
small products, bound by latency and launches rather than FLOPs, so the
whole stack is one launch with every activation in shared memory; the
.cu header says how.

stack_params_from_module stacks the Graph WaveNet tree into the arrays
the kernel takes. Its bf16 body runs every product on the tensor cores
from weights in mma.sync B-fragment order: stack_fragments lays them out
once (at engine build), and the wrapper takes them as sp["frags"].
gwnet_stack_forward is the wrapper: on a CUDA tensor it launches the
kernel or raises; on a CPU tensor it runs stack_forward_reference, the
plain PyTorch version the kernel is held against.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from multimodal_outage_tpu_torch.models.gwnet import adaptive_adjacency
from multimodal_outage_tpu_torch.ops import _build
from multimodal_outage_tpu_torch.ops.double_conv import fold_batchnorm
from multimodal_outage_tpu_torch.ops.fragments import _up, pack_fragments

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_F32_KEYS = ("bc", "aa", "ab")
_KEYS = (
    "start_w", "start_b", "wfg", "bfg", "ws", "bs", "wc", "bc", "aa", "ab",
    "e1w", "e1b", "e2w", "e2b",
)


def stack_params_from_module(
    params: Dict, batch_stats: Dict, n_layers: int,
    dtype: torch.dtype = torch.float32, eps: float = 1e-5,
) -> Dict[str, torch.Tensor]:
    """Stack a GraphWaveNet fused-path param tree (the JAX models/gwnet.py
    names: filter_conv{i}_kernel …, gconv{i}_*, bn{i}, start_conv,
    end_conv_1/2) into the arrays the kernel takes, with BatchNorm folded
    (gwnet_stack_pallas.py:137-177). Filter and gate weights are joined
    along their output axis (wfg, bfg) so one product gives both. Every
    array is in `dtype` except the float32 gconv bias and BN affine
    (gwnet_stack_pallas.py:226-245)."""
    t = lambda v: torch.as_tensor(v, dtype=torch.float32)
    layers = range(n_layers)
    folded = [
        fold_batchnorm(
            t(params[f"bn{i}"]["scale"]), t(params[f"bn{i}"]["bias"]),
            t(batch_stats[f"bn{i}"]["mean"]), t(batch_stats[f"bn{i}"]["var"]),
            eps,
        )
        for i in layers
    ]
    stack = lambda fmt: torch.stack([t(params[fmt.format(i)]) for i in layers])
    sp = {
        "start_w": t(params["start_conv"]["kernel"]),
        "start_b": t(params["start_conv"]["bias"]),
        "wfg": torch.cat(
            [stack("filter_conv{}_kernel"), stack("gate_conv{}_kernel")], -1
        ),
        "bfg": torch.cat(
            [stack("filter_conv{}_bias"), stack("gate_conv{}_bias")], -1
        ),
        "ws": stack("skip_conv{}_kernel"),
        "bs": stack("skip_conv{}_bias"),
        "wc": stack("gconv{}_kernel"),
        "bc": stack("gconv{}_bias"),
        "aa": torch.stack([a for a, _ in folded]),
        "ab": torch.stack([b for _, b in folded]),
        "e1w": t(params["end_conv_1"]["kernel"]),
        "e1b": t(params["end_conv_1"]["bias"]),
        "e2w": t(params["end_conv_2"]["kernel"]),
        "e2b": t(params["end_conv_2"]["bias"]),
    }
    return {
        k: v.contiguous() if k in _F32_KEYS else v.to(dtype).contiguous()
        for k, v in sp.items()
    }


def interleaved_column(c: int, gate: bool) -> int:
    """Column of stack_fragments' interleaved [Wf | Wg] that holds filter
    column c (gate=False) or gate column c (gate=True): blocks of
    8 filter columns and the same 8 gate columns alternate, so both land
    in the same lane and element of n-tiles 2q and 2q + 1."""
    return 16 * (c // 8) + 8 * gate + c % 8


def stack_fragments(sp: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The weights of sp (stack_params_from_module, bfloat16) in
    fragment order (ops/fragments.py pack_fragments), as the kernel's bf16
    body reads them: "start", "wfg" (filter and gate interleaved, see
    interleaved_column; Cd padded to 8), "ws", "wc" (each term's rows
    padded to 16, the term buffer's layout), "e1" and "e2"."""
    n_layers, c, cd2 = sp["wfg"].shape
    cd = cd2 // 2
    cd16 = _up(cd, 16)
    cols = torch.tensor([interleaved_column(i, gate) for gate in (False, True) for i in range(cd)],
                        device=sp["wfg"].device)
    wfg = sp["wfg"].new_zeros(n_layers, c, 2 * _up(cd, 8))
    wfg[..., cols] = sp["wfg"]
    nt = sp["wc"].shape[1] // cd
    wc = F.pad(sp["wc"].reshape(n_layers, nt, cd, -1), (0, 0, 0, cd16 - cd))
    return {
        "start": pack_fragments(sp["start_w"][None]),
        "wfg": pack_fragments(wfg),
        "ws": pack_fragments(sp["ws"]),
        "wc": pack_fragments(wc.reshape(n_layers, nt * cd16, -1)),
        "e1": pack_fragments(sp["e1w"][None]),
        "e2": pack_fragments(sp["e2w"][None]),
    }


def adaptive_supports(
    supports: Optional[torch.Tensor],
    nodevec1: Optional[torch.Tensor],
    nodevec2: Optional[torch.Tensor],
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Static supports followed by the learned adaptive adjacency
    (gwnet_stack_pallas.py:180-197) → [S, N, N] in dtype."""
    parts = []
    if supports is not None:
        parts.append(supports.to(dtype))
    if nodevec1 is not None:
        parts.append(adaptive_adjacency(nodevec1, nodevec2, dtype)[None])
    return torch.cat(parts, 0).contiguous()


def stack_forward_reference(
    x: torch.Tensor, supports: torch.Tensor, sp: Dict[str, torch.Tensor],
    order: int = 2,
) -> torch.Tensor:
    """Plain PyTorch version: x [B, N, T, Cin] → [B, N, T, Cout] in x.dtype.

    Products accumulate in float32 and round to x.dtype where the TPU
    kernel rounds (gwnet_stack_pallas.py:90,100,116,126,128,131); in
    float32 the rounding is the identity and this is the JAX package's
    stack_forward_reference (:268-296)."""
    dt = x.dtype
    f = lambda v: v.float()
    rnd = lambda v: v.to(dt).float()
    cd = sp["wfg"].shape[-1] // 2
    h = rnd(f(x) @ f(sp["start_w"]) + f(sp["start_b"]))
    skip = None
    for i in range(sp["wfg"].shape[0]):
        fg = h @ f(sp["wfg"][i]) + f(sp["bfg"][i])
        g = rnd(torch.tanh(fg[..., :cd]) * torch.sigmoid(fg[..., cd:]))
        s = g @ f(sp["ws"][i]) + f(sp["bs"][i])
        skip = s if skip is None else skip + s
        terms = [g]
        for a in f(supports):
            cur = g
            for _ in range(order):
                cur = rnd(torch.einsum("bvtc,vw->bwtc", cur, a))
                terms.append(cur)
        acc = torch.cat(terms, -1) @ f(sp["wc"][i])
        h = rnd((acc + sp["bc"][i] + h) * sp["aa"][i] + sp["ab"][i])
    out = rnd(torch.relu(skip))
    out = rnd(torch.relu(out @ f(sp["e1w"]) + f(sp["e1b"])))
    return (out @ f(sp["e2w"]) + f(sp["e2b"])).to(dt)


def gwnet_stack_forward(
    x: torch.Tensor, supports: torch.Tensor, sp: Dict[str, torch.Tensor],
    order: int = 2,
) -> torch.Tensor:
    """x [B, N, T, Cin] (float32 or bfloat16) → [B, N, T, Cout] in x.dtype.

    supports [S, N, N] and sp (stack_params_from_module) in x.dtype, bar
    sp's float32 bc/aa/ab. float32 runs the kernel's CUDA-core body on
    sp's row-major weights; bfloat16 its tensor-core body on sp["frags"]
    (stack_fragments), with sp's biases."""
    if x.device.type == "cpu":
        return stack_forward_reference(x, supports, sp, order)
    if x.device.type != "cuda":
        raise ValueError(f"gwnet_stack_forward: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"gwnet_stack_forward: x must be float32 or bfloat16, got {x.dtype}")
    b, n, t, cin = x.shape
    n_layers, c, cd2 = sp["wfg"].shape
    cd, cs, ce, cout = cd2 // 2, sp["ws"].shape[2], sp["e1w"].shape[1], sp["e2w"].shape[1]
    s_count = supports.shape[0]
    expect = {
        "start_w": (cin, c), "start_b": (c,), "wfg": (n_layers, c, 2 * cd),
        "bfg": (n_layers, 2 * cd), "ws": (n_layers, cd, cs), "bs": (n_layers, cs),
        "wc": (n_layers, (s_count * order + 1) * cd, c), "bc": (n_layers, c),
        "aa": (n_layers, c), "ab": (n_layers, c), "e1w": (cs, ce), "e1b": (ce,),
        "e2w": (ce, cout), "e2b": (cout,),
    }
    tensors = [("x", x, (b, n, t, cin), x.dtype),
               ("supports", supports, (s_count, n, n), x.dtype)]
    tensors += [
        (k, sp[k], expect[k], torch.float32 if k in _F32_KEYS else x.dtype)
        for k in _KEYS
    ]
    for name, v, shape, dt in tensors:
        if tuple(v.shape) != shape or v.dtype != dt or v.device != x.device:
            raise ValueError(
                f"gwnet_stack_forward: {name} must be {dt} {shape} on {x.device}, "
                f"got {v.dtype} {tuple(v.shape)} on {v.device}"
            )
        if not v.is_contiguous() or v.data_ptr() % 16:
            raise ValueError(f"gwnet_stack_forward: {name} must be contiguous and 16-byte aligned")
    if any(v % 4 for v in (c, cd, cs, ce, cout)):
        raise ValueError("gwnet_stack_forward: channel widths must be multiples of 4")
    weights = dict(sp)
    if x.dtype == torch.bfloat16:  # the tensor-core body reads the fragments in place of the weights
        frags = _check_fragments(sp, s_count * order + 1)
        weights.update({k: frags[f] for k, f in _FRAG_OF.items()})
    lib = _lib()
    smem = smem_bytes(n, cin, c, cd, cs, ce, cout, s_count, order, x.dtype)
    if smem > 227 * 1024:
        raise ValueError(
            f"gwnet_stack_forward: {smem} bytes of shared memory for N={n} "
            "exceed one block's 227 KB"
        )
    y = torch.empty((b, n, t, cout), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.gwnet_stack_launch(
            x.data_ptr(), supports.data_ptr(), *(weights[k].data_ptr() for k in _KEYS),
            y.data_ptr(), b, n, t, cin, c, cd, cs, ce, cout, s_count, order,
            n_layers, _DTYPES[x.dtype], stream,
        )
    _build.check(lib, code, "gwnet_stack")
    gwnet_stack_forward.launches += 1
    return y


gwnet_stack_forward.launches = 0

# the packed fragments the bf16 body reads in place of these weights
_FRAG_OF = {"start_w": "start", "wfg": "wfg", "ws": "ws", "wc": "wc", "e1w": "e1", "e2w": "e2"}


def _check_fragments(sp: Dict[str, torch.Tensor], nt: int) -> Dict[str, torch.Tensor]:
    """sp["frags"] (stack_fragments), each of the shape the bf16 kernel
    reads, contiguous, 16-byte aligned bf16 on the weights' device."""
    frags = sp.get("frags")
    if frags is None:
        raise ValueError("gwnet_stack_forward: bfloat16 needs sp['frags'] "
                         "(stack_fragments packs them)")
    n_layers, c, cd2 = sp["wfg"].shape
    cd, cin, cs = cd2 // 2, sp["start_w"].shape[0], sp["ws"].shape[2]
    ce, cout = sp["e1w"].shape[1], sp["e2w"].shape[1]
    k16, n8 = lambda v: _up(v, 16) // 16, lambda v: _up(v, 8) // 8
    shapes = {
        "start": (1, k16(cin), n8(c)), "wfg": (n_layers, k16(c), 2 * n8(cd)),
        "ws": (n_layers, k16(cd), n8(cs)), "wc": (n_layers, nt * k16(cd), n8(c)),
        "e1": (1, k16(cs), n8(ce)), "e2": (1, k16(ce), n8(cout)),
    }
    dev = sp["wfg"].device
    for name, shape in shapes.items():
        v, shape = frags.get(name), shape + (32, 4)
        if (v is None or tuple(v.shape) != shape or v.dtype != torch.bfloat16
                or v.device != dev or not v.is_contiguous() or v.data_ptr() % 16):
            got = None if v is None else (v.dtype, tuple(v.shape), v.device)
            raise ValueError(f"gwnet_stack_forward: frags.{name} must be contiguous 16-byte "
                             f"aligned bfloat16 {shape} on {dev}, got {got}")
    return frags


def smem_bytes(n: int, cin: int, c: int, cd: int, cs: int, ce: int, cout: int,
               s_count: int, order: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block of the kernel's body for dtype
    (the float32 and the bf16 bodies lay it out differently)."""
    return _lib().gwnet_stack_smem_bytes(n, cin, c, cd, cs, ce, cout, s_count, order,
                                         int(dtype == torch.bfloat16))


def _lib() -> ctypes.CDLL:
    lib = _build.load("gwnet_stack")
    if lib.gwnet_stack_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gwnet_stack_launch.argtypes = [p] * 17 + [i] * 13 + [p]
        lib.gwnet_stack_launch.restype = i
        lib.gwnet_stack_smem_bytes.argtypes = [i] * 10
        lib.gwnet_stack_smem_bytes.restype = i
    return lib


def flops(b: int, n: int, t: int, sp: Dict[str, torch.Tensor], s_count: int, order: int) -> int:
    """Multiply-adds ×2 of one call (elementwise work not counted)."""
    n_layers, c, cd2 = sp["wfg"].shape
    cin, cd = sp["start_w"].shape[0], cd2 // 2
    cs, ce, cout = sp["ws"].shape[2], sp["e1w"].shape[1], sp["e2w"].shape[1]
    per_layer = (
        n * c * cd2 + n * cd * cs + s_count * order * n * n * cd
        + n * (s_count * order + 1) * cd * c
    )
    return 2 * b * t * (n * cin * c + n_layers * per_layer + n * cs * ce + n * ce * cout)


def min_bytes(x: torch.Tensor, supports: torch.Tensor, sp: Dict[str, torch.Tensor], cout: int) -> int:
    """Bytes one call must move: inputs and weights read once, y written once."""
    tensors = [x, supports, *(sp[k] for k in _KEYS)]
    return sum(v.numel() * v.element_size() for v in tensors) + (
        x.numel() // x.shape[-1] * cout * x.element_size()
    )
