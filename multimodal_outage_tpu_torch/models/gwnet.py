"""Graph WaveNet over [B, N, T, C]: the port of the JAX package's
models/gwnet.py, every branch of its __call__ (:183-308), and the
adaptive adjacency the serving path needs.

The fused path (kernel_size 1 and at least one support, static or
adaptive) runs each layer as one call of ops/gwnet_layer.py: the plain
gwnet_layer_reference by default, or with use_pallas the per-layer kernel
through fused_gwnet_layer, in train and eval mode alike (its backward is
autograd of the plain version). Its parameters are flat
(filter_conv{i}_kernel, …), the same either way, so checkpoints are
interchangeable (JAX models/gwnet.py:151-155).

Every other config takes the non-fused layer, left to cuDNN and cuBLAS as
the JAX package leaves it to XLA (:254-288): the gated TCN of two dilated
VALID convolutions over T (dilation 1, 2, … restarting every `layers`),
the skip Dense, then DiffusionGCN over the supports or, with none,
residual_conv. Its parameters are nested (filter_conv{i}/kernel
[k, C, Cd], gconv{i}/mlp/kernel, …). For kernel_size > 1 the input is
left-padded by receptive_field − 1 steps before start_conv, so the output
keeps T. reference_view_quirk reproduces the reference's raw .view
reinterprets of the input and output (JAX :192-194, 304-307).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from multimodal_outage_tpu_torch.core.config import ModelConfig
from multimodal_outage_tpu_torch.models.layers import Dense, GroupedBatchNorm, dropout
from multimodal_outage_tpu_torch.ops.gwnet_layer import fused_gwnet_layer, gwnet_layer_reference


def adaptive_adjacency(
    nodevec1: torch.Tensor, nodevec2: torch.Tensor,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Learned adaptive adjacency softmax(relu(E1·E2), axis=1), computed in
    float32 (JAX models/gwnet.py:38-45; reference graph_wavenet.py:199-203)."""
    a = torch.relu(nodevec1.float() @ nodevec2.float())
    return torch.softmax(a, dim=1).to(dtype)


def svd_aptinit(adj, node_embed_dim: int):
    """SVD initialization of the adaptive-adjacency node embeddings (JAX
    models/gwnet.py:48-58; reference graph_wavenet.py:136-141, the
    randomadj=False path): U, S, Vᵀ = svd(adj) in float64 numpy,
    E1 = U[:, :d]·√S[:d], E2 = √S[:d]·Vᵀ[:d], as float32 numpy arrays.
    numpy's SVD, not torch.linalg.svd, so the factors (and the signs of
    their singular-vector pairs) are the JAX package's."""
    adj = adj.detach().cpu().numpy() if torch.is_tensor(adj) else adj
    u, s, vt = np.linalg.svd(np.asarray(adj, np.float64))
    d = node_embed_dim
    root = np.sqrt(s[:d])
    init1 = (u[:, :d] * root[None, :]).astype(np.float32)
    init2 = (root[:, None] * vt[:d, :]).astype(np.float32)
    return init1, init2


def install_aptinit(params: Dict[str, Any], adj, node_embed_dim: int) -> Dict[str, Any]:
    """params with st_gnn/nodevec1, nodevec2 replaced by svd_aptinit(adj)
    (JAX models/gwnet.py:61-75, wired in at its train/loop.py:478-489); a
    new tree, the input is not changed. No-op without an adaptive
    adjacency. Raises where the factors do not fit the embeddings (fewer
    nodes than node_embed_dim)."""
    st = params.get("st_gnn", {})
    if "nodevec1" not in st:
        return params
    e1, e2 = svd_aptinit(adj, node_embed_dim)
    new_st = dict(st)
    for name, e in (("nodevec1", e1), ("nodevec2", e2)):
        if tuple(e.shape) != tuple(st[name].shape):
            raise ValueError(
                f"svd_aptinit: {name} is {tuple(st[name].shape)} but the SVD of a "
                f"{np.shape(adj)} adjacency gives {e.shape}; node_embed_dim "
                f"({node_embed_dim}) must not exceed the number of nodes"
            )
        new_st[name] = torch.from_numpy(e)
    return {**params, "st_gnn": new_st}


def nconv(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Diffusion step over the node axis (JAX models/gwnet.py:78-83;
    reference einsum 'ncvl,vw->ncwl'): out[b,w,t,c] = Σ_v x[b,v,t,c]·A[v,w]."""
    return torch.einsum("bvtc,vw->bwtc", x, a)


class TemporalConv(nn.Module):
    """flax nn.Conv over T of [B, N, T, C]: kernel [k, Cin, Cout], VALID,
    dilation d, with bias, so T shrinks by d·(k − 1). It runs as F.conv1d on
    [B·N, C, T]; the flax kernel goes to [Cout, Cin, k] without a flip, as
    both are cross-correlations."""

    def __init__(self, k: int, cin: int, cout: int, dilation: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(k, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dilation, self.dtype = dilation, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, t, c = x.shape
        w = self.kernel.to(self.dtype).permute(2, 1, 0)
        y = F.conv1d(x.to(self.dtype).reshape(b * n, t, c).transpose(1, 2), w,
                     self.bias.to(self.dtype), dilation=self.dilation)
        return y.transpose(1, 2).reshape(b, n, y.shape[-1], -1)


class DiffusionGCN(nn.Module):
    """Order-k diffusion over each support, concat [x, A₁x, A₁²x, A₂x, …],
    the 1×1 mix `mlp`, dropout (JAX models/gwnet.py:86-109)."""

    def __init__(self, cin: int, features: int, n_supports: int, order: int, rate: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mlp = Dense((n_supports * order + 1) * cin, features, dtype)
        self.order, self.rate = order, rate

    def forward(self, x: torch.Tensor, supports: torch.Tensor, train: bool,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        out = [x]
        for a in supports:
            x1 = nconv(x, a)
            out.append(x1)
            for _ in range(2, self.order + 1):
                x1 = nconv(x1, a)
                out.append(x1)
        return dropout(self.mlp(torch.cat(out, dim=-1)), self.rate, train, generator)


_LAYER_KEYS = ("filter_conv", "gate_conv", "skip_conv", "gconv")


def receptive_field(kernel_size: int, blocks: int, layers: int) -> int:
    """The stack's receptive field over T (JAX models/gwnet.py:140-149;
    reference graph_wavenet.py:122,145-170): 1 at kernel_size 1, 13 at the
    paper's kernel_size 2 with 4 blocks of dilations 1, 2."""
    rf = 1
    for _ in range(blocks):
        scope = kernel_size - 1
        for _ in range(layers):
            rf += scope
            scope *= 2
    return rf


class GraphWaveNet(nn.Module):
    """start conv, L layers (each + residual → GroupedBatchNorm over (N, T)
    per sample) with the skip outputs summed, then relu → end_conv_1 →
    relu → end_conv_2 (JAX models/gwnet.py:183-308). n_static is the number
    of static supports the forward is given (ignored without gcn_bool,
    whose forward drops them); the layers diffuse over those and the
    adaptive adjacency, if any. Parameters carry the JAX names."""

    def __init__(self, cfg: ModelConfig, n_nodes: int, n_static: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        g = cfg.gwnet
        self.g, self.dtype = g, dtype
        self.n_static = n_static if g.gcn_bool else 0
        adaptive = g.addaptadj and g.gcn_bool
        n_supports = self.n_static + int(adaptive)
        self.fused = g.kernel_size == 1 and n_supports > 0
        if g.use_pallas and not self.fused:
            raise ValueError(
                "use_pallas runs the fused Graph WaveNet layer, which needs "
                "kernel_size=1 and a support (gcn_bool with static supports or "
                f"addaptadj); this config (kernel_size={g.kernel_size}, "
                f"gcn_bool={g.gcn_bool}, {n_supports} supports) has no fused layer"
            )
        self.rf = receptive_field(g.kernel_size, g.blocks, g.layers)
        self._layer = fused_gwnet_layer if g.use_pallas else gwnet_layer_reference
        self.n_layers = g.blocks * g.layers
        c, cd, cs = g.residual_channels, g.dilation_channels, g.skip_channels
        self.start_conv = Dense(cfg.st_gnn_in_dim, c, dtype)
        if adaptive:
            self.nodevec1 = nn.Parameter(torch.zeros(n_nodes, g.node_embed_dim))
            self.nodevec2 = nn.Parameter(torch.zeros(g.node_embed_dim, n_nodes))
        else:
            self.nodevec1 = self.nodevec2 = None
        n_terms = n_supports * g.order + 1
        shapes = {"filter_conv": (c, cd), "gate_conv": (c, cd), "skip_conv": (cd, cs),
                  "gconv": (n_terms * cd, c)}
        for i in range(self.n_layers):
            if self.fused:
                for name in _LAYER_KEYS:
                    cin, cout = shapes[name]
                    self.register_parameter(f"{name}{i}_kernel",
                                            nn.Parameter(torch.zeros(cin, cout)))
                    self.register_parameter(f"{name}{i}_bias", nn.Parameter(torch.zeros(cout)))
            else:
                dilation = 2 ** (i % g.layers)
                for name in ("filter_conv", "gate_conv"):
                    self.add_module(f"{name}{i}",
                                    TemporalConv(g.kernel_size, c, cd, dilation, dtype))
                self.add_module(f"skip_conv{i}", Dense(cd, cs, dtype))
                if n_supports:
                    self.add_module(f"gconv{i}", DiffusionGCN(cd, c, n_supports, g.order,
                                                              g.dropout, dtype))
                else:
                    self.add_module(f"residual_conv{i}", Dense(cd, c, dtype))
            self.add_module(f"bn{i}", GroupedBatchNorm(c, num_group_axes=1,
                                                       single_pass=cfg.bn_single_pass))
        self.end_conv_1 = Dense(cs, g.end_channels, dtype)
        self.end_conv_2 = Dense(g.end_channels, cfg.feature_vector_size, dtype)

    def forward(self, x: torch.Tensor, supports: Optional[torch.Tensor], train: bool,
                generator: Optional[torch.Generator] = None,
                sample_weight=None) -> torch.Tensor:
        g, dt = self.g, self.dtype
        b, n, t, c_in = x.shape
        if g.reference_view_quirk:
            # torch .view(1, C, N, T) memory reinterpret of [N, T, C]
            x = x.reshape(b, c_in, n, t).permute(0, 2, 3, 1)
        if self.rf > 1:
            # left-pad T before start_conv, so the pad rows carry its bias
            x = F.pad(x, (0, 0, self.rf - 1, 0))
        x = self.start_conv(x)
        if not g.gcn_bool:
            supports = None
        given = 0 if supports is None else supports.shape[0]
        if given != self.n_static:
            raise ValueError(f"Graph WaveNet built for {self.n_static} static supports, "
                             f"given {given}")
        parts = [] if supports is None else [supports.to(dt)]
        if self.nodevec1 is not None:
            parts.append(adaptive_adjacency(self.nodevec1, self.nodevec2, dt)[None])
        all_supports = torch.cat(parts, dim=0) if parts else None
        skip = None
        for i in range(self.n_layers):
            residual = x
            if self.fused:
                p = [getattr(self, f"{name}{i}_{part}").to(dt)
                     for name in _LAYER_KEYS for part in ("kernel", "bias")]
                x, s = self._layer(residual, all_supports, *p, order=g.order)
                x = dropout(x, g.dropout, train, generator)
            else:
                x = (torch.tanh(getattr(self, f"filter_conv{i}")(residual))
                     * torch.sigmoid(getattr(self, f"gate_conv{i}")(residual)))
                s = getattr(self, f"skip_conv{i}")(x)
                if all_supports is not None:
                    x = getattr(self, f"gconv{i}")(x, all_supports, train, generator)
                else:  # no dropout on this branch (JAX :283-288)
                    x = getattr(self, f"residual_conv{i}")(x)
            skip = s if skip is None else s + skip[:, :, -s.shape[2]:, :]
            x = getattr(self, f"bn{i}")(x + residual[:, :, -x.shape[2]:, :], train,
                                        sample_weight)
        out = torch.relu(self.end_conv_1(torch.relu(skip)))
        out = self.end_conv_2(out)
        if g.reference_view_quirk:
            # torch .view(N, T, C) memory reinterpret of [1, C, N, T]
            bo, no, to, co = out.shape
            out = out.permute(0, 3, 1, 2).reshape(bo, no, to, co)
        return out
