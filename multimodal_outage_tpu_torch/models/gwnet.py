"""Graph WaveNet: the adaptive adjacency the serving path needs, and the
trainable module of the fused path (JAX models/gwnet.py:151-181,
238-252, 291-302), over [B, N, T, C].

Every layer of the fused path (kernel_size 1, diffusion supports) is one
call of ops/gwnet_layer.py: the plain gwnet_layer_reference by default,
or with use_pallas the per-layer kernel through fused_gwnet_layer, in
train and eval mode alike (its backward is autograd of the plain
version). The parameters are the same either way, so checkpoints are
interchangeable (JAX models/gwnet.py:151-155).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

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


_LAYER_KEYS = ("filter_conv", "gate_conv", "skip_conv", "gconv")


class GraphWaveNet(nn.Module):
    """The Graph WaveNet of the fused path: start conv, L layers of
    (layer → dropout → + residual → GroupedBatchNorm over (N, T) per
    sample) with the skip outputs summed, then relu → end_conv_1 → relu →
    end_conv_2. The layer is gwnet_layer_reference, or fused_gwnet_layer
    with cfg.gwnet.use_pallas. Parameters carry the JAX names
    (filter_conv{i}_kernel, …, bn{i}, nodevec1/2)."""

    def __init__(self, cfg: ModelConfig, n_nodes: int, n_static: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        g = cfg.gwnet
        if g.kernel_size != 1 or not g.gcn_bool or g.reference_view_quirk or (
            n_static == 0 and not g.addaptadj
        ):
            raise NotImplementedError(
                "the port runs the fused Graph WaveNet path only "
                "(kernel_size=1, gcn_bool, diffusion supports, no "
                "reference_view_quirk); the others come with the ROADMAP "
                "item 'non-fused Graph WaveNet branches'"
            )
        c, cd, cs = g.residual_channels, g.dilation_channels, g.skip_channels
        self.order, self.rate, self.dtype = g.order, g.dropout, dtype
        self._layer = fused_gwnet_layer if g.use_pallas else gwnet_layer_reference
        self.n_layers = g.blocks * g.layers
        n_terms = (n_static + int(g.addaptadj)) * g.order + 1
        self.start_conv = Dense(cfg.st_gnn_in_dim, c, dtype)
        if g.addaptadj:
            self.nodevec1 = nn.Parameter(torch.zeros(n_nodes, g.node_embed_dim))
            self.nodevec2 = nn.Parameter(torch.zeros(g.node_embed_dim, n_nodes))
        else:
            self.nodevec1 = self.nodevec2 = None
        shapes = {"filter_conv": (c, cd), "gate_conv": (c, cd), "skip_conv": (cd, cs),
                  "gconv": (n_terms * cd, c)}
        for i in range(self.n_layers):
            for name in _LAYER_KEYS:
                cin, cout = shapes[name]
                self.register_parameter(f"{name}{i}_kernel", nn.Parameter(torch.zeros(cin, cout)))
                self.register_parameter(f"{name}{i}_bias", nn.Parameter(torch.zeros(cout)))
            self.add_module(f"bn{i}", GroupedBatchNorm(c, num_group_axes=1,
                                                       single_pass=cfg.bn_single_pass))
        self.end_conv_1 = Dense(cs, g.end_channels, dtype)
        self.end_conv_2 = Dense(g.end_channels, cfg.feature_vector_size, dtype)

    def forward(self, x: torch.Tensor, supports: Optional[torch.Tensor], train: bool,
                generator: Optional[torch.Generator] = None,
                sample_weight=None) -> torch.Tensor:
        dt = self.dtype
        x = self.start_conv(x)
        parts = [] if supports is None else [supports.to(dt)]
        if self.nodevec1 is not None:
            parts.append(adaptive_adjacency(self.nodevec1, self.nodevec2, dt)[None])
        all_supports = torch.cat(parts, dim=0)
        skip = None
        for i in range(self.n_layers):
            residual = x
            p = [getattr(self, f"{name}{i}_{part}").to(dt)
                 for name in _LAYER_KEYS for part in ("kernel", "bias")]
            x, s = self._layer(residual, all_supports, *p, order=self.order)
            skip = s if skip is None else s + skip
            x = dropout(x, self.rate, train, generator)
            x = getattr(self, f"bn{i}")(x + residual, train, sample_weight)
        out = torch.relu(self.end_conv_1(torch.relu(skip)))
        return self.end_conv_2(out)
