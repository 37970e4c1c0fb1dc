"""ModifiedUNet, the trainable fusion model (JAX models/fusion.py): U-Net
contraction → bottleneck encoder → (‖ Date2Vec) → st-GNN (Graph WaveNet or
DCRNN) → bottleneck decoder → U-Net expansion, over [B, N, T, H, W, C].

Parameters sit under the JAX variable tree's key paths and in its
layouts (weights.module_variables / load_variables), so gradients,
checkpoints and init_variables trees are the same tree as the JAX
package's. They are float32 masters, cast to cfg.compute_dtype in the
forward. With cfg.gwnet.use_pallas the Graph WaveNet's layers take the
per-layer kernel on any device: its wrapper routes by the tensor's device,
so on the CPU the plain version runs (the JAX package gates this on the
TPU backend, models/fusion.py:40, because interpret mode is slow).

DCRNN's scheduled sampling (JAX models/fusion.py:121-139): in train mode
with cfg.dcrnn.teacher_forcing > 0, the ground-truth future frames go
through the same contraction and encoder in eval mode and without
gradient, after the train pass, so they are normalized with the running
statistics that pass has just updated, as in the JAX package's one
apply; the decoder feeds them with the step's probability.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from multimodal_outage_tpu_torch.core.config import ModelConfig
from multimodal_outage_tpu_torch.data.adjacency import model_adjtype, n_static_supports
from multimodal_outage_tpu_torch.models.date2vec import Date2Vec
from multimodal_outage_tpu_torch.models.dcrnn import DCRNN
from multimodal_outage_tpu_torch.models.gwnet import GraphWaveNet
from multimodal_outage_tpu_torch.models.unet import (
    BottleneckDecoder,
    BottleneckEncoder,
    Contraction,
    Expansion,
)


class ModifiedUNet(nn.Module):
    """pool_reference=True runs the pallas pool's plain versions instead of
    its kernels, on any device (the step a kernel step is held against)."""

    def __init__(self, cfg: ModelConfig, horizon: int, n_counties: int,
                 image_size: int = 128, pool_reference: bool = False):
        super().__init__()
        if cfg.st_gnn not in ("gwnet", "dcrnn"):
            raise ValueError(f"unknown st_gnn {cfg.st_gnn!r}; pick 'gwnet' or 'dcrnn'")
        self.cfg, self.horizon = cfg, horizon
        self.dtype = dtype = getattr(torch, cfg.compute_dtype)
        sp = cfg.bn_single_pass
        top = cfg.base_channels * 2**cfg.depth
        grid = image_size // 2**cfg.depth
        self.contraction = Contraction(
            cfg.input_channels, cfg.base_channels, cfg.depth, cfg.remat, sp,
            cfg.pool, dtype, pool_reference, remat_scope=cfg.remat_scope,
        )
        self.encoder = BottleneckEncoder(
            grid * grid * top, cfg.feature_vector_size, cfg.compression_factor,
            cfg.encoder_dropout, dtype,
        )
        self.date2vec = Date2Vec(cfg.time_embed_size, trainable=cfg.train_date2vec)
        n_static = n_static_supports(model_adjtype(cfg))
        if cfg.st_gnn == "dcrnn":
            d = cfg.dcrnn
            self.st_gnn = DCRNN(
                cfg.st_gnn_in_dim, cfg.feature_vector_size, horizon, d.rnn_units,
                d.num_rnn_layers, d.max_diffusion_step, n_static, d.teacher_forcing, dtype,
            )
        else:
            self.st_gnn = GraphWaveNet(cfg, n_counties, n_static, dtype)
        self.decoder = BottleneckDecoder(
            grid, top, cfg.feature_vector_size, cfg.compression_factor,
            cfg.encoder_dropout, dtype,
        )
        self.expansion = Expansion(
            cfg.output_channels, cfg.base_channels, cfg.depth, cfg.remat, sp, dtype,
            remat_scope=cfg.remat_scope,
        )

    def forward(
        self,
        x: torch.Tensor,  # [B, N, T, H, W, C_in] normalized NTL
        date_feats: torch.Tensor,  # [B, T, 6] raw (0,0,0,y,m,d)
        supports: Optional[torch.Tensor],  # [S, N, N] static GCN supports
        train: bool = False,
        generator: Optional[torch.Generator] = None,  # dropout masks
        sample_weight=None,
        targets: Optional[torch.Tensor] = None,  # [B, N, horizon, H, W, C] future
        tf_prob: Optional[float] = None,  # this step's sampling probability
        sampling: Optional[torch.Generator] = None,  # CPU generator of the coins
    ) -> torch.Tensor:
        if sample_weight is not None:
            raise NotImplementedError(
                "sample_weight only exists on the mesh path; it comes with "
                "the ROADMAP item 'SPMD with sample_weight'"
            )
        b, n, t = x.shape[:3]
        dt = self.dtype
        bottleneck, skips = self.contraction(x.to(dt), train)
        z = self.encoder(bottleneck, train, generator)
        teacher = {}
        if (targets is not None and train and self.cfg.st_gnn == "dcrnn"
                and self.cfg.dcrnn.teacher_forcing > 0.0):
            with torch.no_grad():
                latent = self.encoder(self.contraction(targets.to(dt), False)[0], False)
            teacher = {"targets": latent, "tf_prob": tf_prob, "sampling": sampling}
        te = self.date2vec(date_feats.to(x.device)).to(dt)
        te = te[:, None].expand(b, n, t, te.shape[-1])
        z = torch.cat([z, te], dim=-1)  # [B, N, T, 320]
        if supports is not None:
            supports = torch.as_tensor(supports, device=x.device)
        z = self.st_gnn(z, supports, train, generator, **teacher)
        d = self.decoder(z, train, generator)
        return self.expansion(d, skips, train).float()


def build_model(cfg: ModelConfig, horizon: int, n_counties: int, image_size: int = 128,
                pool_reference: bool = False) -> ModifiedUNet:
    """The module with zero parameters; fill it with
    weights.load_variables (from init_variables, a checkpoint or the JAX
    package's tree)."""
    return ModifiedUNet(cfg, horizon, n_counties, image_size, pool_reference)
