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

remat() runs a block under torch.utils.checkpoint so that the backward
recomputes its activations (JAX nn.remat). GroupedBatchNorm knows when it
runs inside such a block: the recompute neither updates the running
statistics again nor reads them as the forward pass left them, so a
remat'd step equals the plain step bitwise, as flax's remat, which
carries batch_stats into the recomputed function, does.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from multimodal_outage_tpu_torch.core.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    TIME_AXIS,
    active_mesh,
    full_time,
    mesh_state,
    time_sharded,
    use_mesh,
)
from multimodal_outage_tpu_torch.ops.max_pool import (
    MaxPool2x2Reference,
    max_pool_2x2_pallas,
    supports_shape,
)
from multimodal_outage_tpu_torch.weights import conv_transpose_weight

# the mesh axes along which each dim of a [B, N, T, C] activation is split
# (batch over data, T over time; a tensor-parallel hidden C over model)
ROWS_TIME = (DATA_AXIS, None, TIME_AXIS, None)
ROWS_TIME_MODEL = (DATA_AXIS, None, TIME_AXIS, MODEL_AXIS)


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator] = None,
            axes: Tuple[Optional[str], ...] = ROWS_TIME) -> torch.Tensor:
    """flax nn.Dropout: keep with probability 1−rate, scale kept values by
    1/(1−rate). The mask comes from `generator` (the global generator when
    None); it cannot reproduce JAX's random bits.

    Under a mesh (core/mesh.py use_mesh), x is this rank's block of the
    global activation, split along the mesh axes `axes` names per dim: the
    mask is drawn for the global shape and this rank's block is cut from
    it, so a mesh step draws the one-device step's mask."""
    if not train or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    mesh = active_mesh()
    if mesh is None:
        keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    else:
        shape, index = list(x.shape), []
        for dim, axis in enumerate(axes):
            split = axis is not None and (axis != TIME_AXIS or time_sharded())
            k = mesh.size(axis) if split else 1
            shape[dim] *= k
            index.append(slice(mesh.coord(axis) * x.shape[dim],
                               (mesh.coord(axis) + 1) * x.shape[dim]) if k > 1 else slice(None))
        keep = (torch.rand(shape, generator=generator, device=x.device) < keep_prob)[tuple(index)]
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


class Dense(nn.Module):
    """flax nn.Dense: x @ kernel + bias in the compute dtype.

    tp (set by parallel/sharding.py shard_model) makes it one half of a
    Megatron pair over the mesh's model group: "column" holds a block of
    the output columns (and of the bias) and takes its replicated input
    through f (identity forward, gradient summed over the group); "row"
    holds a block of the input rows, sums the partial products over the
    group (g) and adds the full bias once after."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dtype = dtype
        self.tp: Optional[str] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return x.to(self.dtype) @ self.kernel.to(self.dtype) + self.bias.to(self.dtype)
        from multimodal_outage_tpu_torch.parallel.collectives import (
            copy_to_model,
            reduce_from_model,
        )

        mesh = active_mesh()
        if mesh is None:
            raise RuntimeError("a tensor-parallel Dense runs only under its mesh (use_mesh)")
        group = mesh.group(MODEL_AXIS)
        if self.tp == "column":
            x = copy_to_model(x.to(self.dtype), group)
            return x @ self.kernel.to(self.dtype) + self.bias.to(self.dtype)
        y = reduce_from_model(x.to(self.dtype) @ self.kernel.to(self.dtype), group)
        return y + self.bias.to(self.dtype)


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
    output is cast back to the input dtype (:172-174).

    sample_weight [B] (1 valid, 0 pad; the mesh step's 'w' row) masks the
    running-stat update per group (_update_running), so a padded tail
    updates the statistics as the ragged batch does (:117-160).

    Under a mesh (core/mesh.py use_mesh): where T is split over the time
    ranks, a group's moments are summed over the time group before
    normalising; the running statistics are updated from the global
    batch's groups (_update_running).

    Inside remat(): the forward pass records the running mean its single
    sweep is shifted by, and the backward's recompute reads that record
    and leaves the running statistics alone. The recompute runs under the
    mesh the forward ran under (_RematPass), also on the thread autograd
    runs a card's backward on, so it sums the same moments."""

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
        if not train:
            inv = torch.rsqrt(self.var + self.eps) * self.scale
            return ((x.float() - self.mean) * inv + self.bias).to(x.dtype)
        g = math.prod(x.shape[: self.num_group_axes])
        xg = x.float().reshape(g, -1, x.shape[-1])  # [G, m, C]
        mesh = active_mesh()
        if mesh is not None and time_sharded():
            mean, var, m = self._time_sharded_moments(xg, mesh)
        elif self.single_pass:
            m0 = self._shift()
            xs = xg - m0
            s1 = xs.mean(dim=1, keepdim=True)
            s2 = xs.square().mean(dim=1, keepdim=True)
            mean = s1 + m0
            var = torch.clamp(s2 - s1.square(), min=0.0)
            m = xg.shape[1]
        else:
            mean = xg.mean(dim=1, keepdim=True)
            var = (xg - mean).square().mean(dim=1, keepdim=True)
            m = xg.shape[1]
        if not getattr(_REMAT, "replay", False):
            v = None
            if sample_weight is not None:
                # validity per group: the per-sample row broadcast over the
                # group axes, C order (batch outer), binarised
                w = (torch.as_tensor(sample_weight, device=x.device) > 0).float()
                gshape = x.shape[: self.num_group_axes]
                v = w.reshape(w.shape + (1,) * (len(gshape) - w.dim())).expand(gshape).reshape(g)
            self._update_running(mean.detach(), var.detach(), m, v)
        inv = torch.rsqrt(var + self.eps) * self.scale
        return ((xg - mean) * inv + self.bias).to(x.dtype).reshape(x.shape)

    def _time_sharded_moments(self, xg: torch.Tensor, mesh):
        """A group's moments when its reduced axes hold this rank's slice of
        T: the sums (shifted ones for single_pass; two rounds for the
        two-pass variance) summed over the time group, then divided by
        the global count m."""
        from multimodal_outage_tpu_torch.parallel.collectives import sum_over

        group = mesh.group(TIME_AXIS)
        m = xg.shape[1] * mesh.shape.time
        c = xg.shape[-1]
        if self.single_pass:
            m0 = self._shift()
            xs = xg - m0
            sums = sum_over(torch.cat([xs.sum(1, keepdim=True),
                                       xs.square().sum(1, keepdim=True)], -1), group)
            s1, s2 = sums[..., :c] / m, sums[..., c:] / m
            return s1 + m0, torch.clamp(s2 - s1.square(), min=0.0), m
        mean = sum_over(xg.sum(1, keepdim=True), group) / m
        var = sum_over((xg - mean).square().sum(1, keepdim=True), group) / m
        return mean, var, m

    def _shift(self) -> torch.Tensor:
        """The running mean the single sweep is shifted by: as it stands,
        or inside remat() as it stood when the forward pass ran."""
        frame = getattr(_REMAT, "frame", None)
        if frame is None:
            return self.mean.clone()
        if _REMAT.replay:
            return frame[self]
        frame[self] = self.mean.clone()
        return frame[self]

    @torch.no_grad()
    def _update_running(self, mean: torch.Tensor, var: torch.Tensor, m: int,
                        v: Optional[torch.Tensor] = None) -> None:
        """The running-stat EMA from the G groups' statistics (JAX
        models/layers.py:114-167). v [G] (0/1) masks groups: the serial
        closed form skips the invalid ones in order, w_k = v_k·m·(1−m)^
        (Σ_{j>k} v_j) (the count after k by a reversed cumsum) and decay =
        (1−m)^Σv; the group-mean path takes the Σv-weighted mean. An
        all-zero v leaves both unchanged. On a mesh with data > 1 the
        groups' rows and v are all-gathered over the data group in rank
        order, so every rank applies the update of the global batch,
        batch outer, and the statistics stay replicated."""
        g, c = mean.shape[0], mean.shape[-1]
        s_mean = mean.reshape(g, c)
        s_var = (var * (m / max(m - 1, 1))).reshape(g, c)
        mesh = active_mesh()
        if mesh is not None and mesh.shape.data > 1:
            from multimodal_outage_tpu_torch.parallel.collectives import all_gather

            group = mesh.group(DATA_AXIS)
            s_mean, s_var = all_gather(s_mean, group), all_gather(s_var, group)
            v = None if v is None else all_gather(v, group)
            g = s_mean.shape[0]
        mom = self.momentum
        if self.serial_ema:
            if v is None:
                w = mom * (1 - mom) ** torch.arange(
                    g - 1, -1, -1, dtype=torch.float32, device=mean.device
                )
                decay = (1 - mom) ** g
            else:
                cnt_after = torch.flip(torch.cumsum(torch.flip(v, (0,)), 0), (0,)) - v
                w = v * mom * torch.pow(torch.tensor(1 - mom, device=v.device), cnt_after)
                decay = torch.pow(torch.tensor(1 - mom, device=v.device), v.sum())
            self.mean.copy_(decay * self.mean + w @ s_mean)
            self.var.copy_(decay * self.var + w @ s_var)
        elif v is None:
            self.mean.copy_((1 - mom) * self.mean + mom * s_mean.mean(0))
            self.var.copy_((1 - mom) * self.var + mom * s_var.mean(0))
        else:
            n = v.sum()
            denom = torch.clamp(n, min=1.0)
            new_mean = (1 - mom) * self.mean + mom * ((v @ s_mean) / denom)
            new_var = (1 - mom) * self.var + mom * ((v @ s_var) / denom)
            self.mean.copy_(torch.where(n > 0, new_mean, self.mean))
            self.var.copy_(torch.where(n > 0, new_var, self.var))


# the remat() call running on this thread: .frame, a dict of the shift
# each GroupedBatchNorm took on its forward pass; .replay, True during the
# backward's recompute
_REMAT = threading.local()


class _RematPass:
    """One pass of a remat() call, the forward (replay False) or the
    backward's recompute (replay True), under the mesh state the forward
    ran under (core/mesh.py mesh_state: a card's backward runs on
    autograd's device thread, where the caller's use_mesh is not in
    force), around the selective-checkpoint context of the pass when
    there is one."""

    def __init__(self, frame: dict, replay: bool, mesh, inner=None):
        self.frame, self.replay, self.mesh, self.inner = frame, replay, mesh, inner

    def __enter__(self) -> "_RematPass":
        self.stack = contextlib.ExitStack()
        prev = (getattr(_REMAT, "frame", None), getattr(_REMAT, "replay", False))
        _REMAT.frame, _REMAT.replay = self.frame, self.replay
        self.stack.callback(self._restore, prev)
        mesh, full_t = self.mesh
        self.stack.enter_context(use_mesh(mesh))
        self.stack.enter_context(full_time(full_t))
        if self.inner is not None:
            self.stack.enter_context(self.inner)
        return self

    @staticmethod
    def _restore(prev) -> None:
        _REMAT.frame, _REMAT.replay = prev

    def __exit__(self, *exc) -> bool:
        return self.stack.__exit__(*exc)


def _save_conv_outputs(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """The selective-checkpoint policy of remat_scope "conv": keep the
    outputs of the 3×3 convolutions and the ConvTranspose (F.conv2d and
    F.conv_transpose2d both dispatch aten.convolution), recompute the rest
    (JAX save_only_these_names("conv_out") on layers.py:203, 303)."""
    if op is torch.ops.aten.convolution.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat(block: nn.Module, *args, save_convs: bool = False) -> torch.Tensor:
    """block(*args) with its activations recomputed in the backward
    (non-reentrant torch.utils.checkpoint; JAX nn.remat). save_convs keeps
    the convolution outputs and recomputes only what lies between them.
    The blocks draw no random numbers, so no RNG state is stashed. A
    kernel called through ctypes inside the block (the max-pool pair)
    runs again in the recompute."""

    def contexts():  # called by the forward pass, on the caller's thread
        frame: dict = {}
        mesh = mesh_state()
        fwd = rec = None
        if save_convs:
            fwd, rec = create_selective_checkpoint_contexts(_save_conv_outputs)
        return _RematPass(frame, False, mesh, fwd), _RematPass(frame, True, mesh, rec)

    return checkpoint(block, *args, use_reentrant=False, context_fn=contexts,
                      preserve_rng_state=False)


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
