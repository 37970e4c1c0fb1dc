"""The mesh's collectives, with the autograd rules the SPMD step needs.

Only all_reduce, all_gather and broadcast are used: gloo, the backend of
ranks that share a card and of the CPU, runs no other on CUDA tensors
(it has no reduce_scatter). Reduced tensors travel in float32 (a bf16
partial sum is widened, summed and rounded once). A group of None is a
group of one: every function is then the identity.

The host time spent inside these calls is summed in COLLECTIVE_SECONDS
(chip_smoke.py phase 15 reads it).
"""

from __future__ import annotations

import time
from typing import List

import torch
import torch.distributed as dist

COLLECTIVE_SECONDS = [0.0]


def _timed(fn, *args, **kw):
    t0 = time.perf_counter()
    try:
        return fn(*args, **kw)
    finally:
        COLLECTIVE_SECONDS[0] += time.perf_counter() - t0


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of t over the group (a new tensor, in t's dtype)."""
    if group is None:
        return t
    buf = t.detach().float().clone()
    _timed(dist.all_reduce, buf, group=group)
    return buf.to(t.dtype)


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along dim, in group rank order."""
    if group is None:
        return t
    src = t.detach().contiguous()
    wide = src.dtype == torch.bfloat16  # gather exactly: bf16 ⊂ float32
    if wide:
        src = src.float()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    _timed(dist.all_gather, parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(t.dtype) if wide else out


def broadcast(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """t as global rank src holds it, on every rank (in place)."""
    _timed(dist.broadcast, t, src=src)
    return t


def flat_all_reduce(tensors: List[torch.Tensor], group) -> None:
    """Sum each tensor over the group in place, as one float32 buffer (one
    collective for a whole gradient tree)."""
    if group is None or not tensors:
        return
    flat = torch.cat([t.detach().float().reshape(-1) for t in tensors])
    _timed(dist.all_reduce, flat, group=group)
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].view_as(t))
        off += n


class _AllReduceSum(torch.autograd.Function):
    """Forward: the sum over the group. Backward: the sum of the
    gradients over the group — each rank's loss is a part of the total, so
    the gradient of a rank's input takes every rank's part."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _CopyToModel(torch.autograd.Function):
    """Megatron's f, on the input of a column-parallel layer: identity
    forward; backward, the sum over the model group of the partial
    gradients each rank's shard gives its (replicated) input."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g, after a row-parallel matmul: the sum of the partial
    products forward; identity backward (the result is replicated, and so
    is every rank's loss)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherTime(torch.autograd.Function):
    """All-gather of the T axis over the time group before a module that
    mixes T. Backward: the gathered tensor's gradient summed over the
    group (each rank back-propagated its own slice of the output through
    the replicated computation), then this rank's slice of it."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        ctx.index = dist.get_rank(group)
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(g, ctx.group)
        return g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _AllReduceSum.apply(x, group)


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromModel.apply(x, group)


def gather_time(x: torch.Tensor, group, dim: int = 2) -> torch.Tensor:
    return x if group is None else _GatherTime.apply(x, group, dim)
