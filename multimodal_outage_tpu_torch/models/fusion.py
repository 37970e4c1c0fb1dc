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

sample_weight [B] (the mesh step's 'w' row) reaches every
GroupedBatchNorm, masking the running-stat update of pad rows (JAX
models/fusion.py:91-188); DCRNN has none. Under a mesh (core/mesh.py)
the U-Net, the bottleneck, Date2Vec and the kernel_size-1 Graph WaveNet
run on this rank's slice of T; an st-GNN that mixes T gets it gathered
(_st_gnn).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from multimodal_outage_tpu_torch.core.config import ModelConfig
from multimodal_outage_tpu_torch.core.mesh import TIME_AXIS, active_mesh, full_time, time_sharded
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
        b, n, t = x.shape[:3]
        dt = self.dtype
        sw = sample_weight
        bottleneck, skips = self.contraction(x.to(dt), train, sw)
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
        if self.cfg.st_gnn == "gwnet":
            teacher["sample_weight"] = sw  # DCRNN has no BatchNorm (JAX dcrnn.py:194-197)
        z = self._st_gnn(z, supports, train, generator, teacher)
        d = self.decoder(z, train, generator)
        return self.expansion(d, skips, train, sw).float()

    def _st_gnn(self, z, supports, train, generator, kw) -> torch.Tensor:
        """The st-GNN. Under a mesh whose time axis splits T, a module that
        mixes T (DCRNN, the Graph WaveNet TCN of kernel_size > 1, the
        reference_view_quirk reinterpret) gets the whole window: T (and
        the teacher's latent targets) all-gathered over the time group,
        computed alike on every time rank, this rank's slice kept
        (parallel/collectives.py gather_time)."""
        g = self.cfg.gwnet
        pointwise = (self.cfg.st_gnn == "gwnet" and g.kernel_size == 1
                     and not g.reference_view_quirk)
        if pointwise or not time_sharded():
            return self.st_gnn(z, supports, train, generator, **kw)
        from multimodal_outage_tpu_torch.parallel.collectives import gather_time

        mesh = active_mesh()
        group = mesh.group(TIME_AXIS)
        t_local = z.shape[2]
        z = gather_time(z, group)
        if kw.get("targets") is not None:
            kw = {**kw, "targets": gather_time(kw["targets"], group)}
        with full_time():
            out = self.st_gnn(z, supports, train, generator, **kw)
        return out.narrow(2, mesh.coord(TIME_AXIS) * t_local, t_local)


def build_model(cfg: ModelConfig, horizon: int, n_counties: int, image_size: int = 128,
                pool_reference: bool = False) -> ModifiedUNet:
    """The module with zero parameters; fill it with
    weights.load_variables (from init_variables, a checkpoint or the JAX
    package's tree)."""
    return ModifiedUNet(cfg, horizon, n_counties, image_size, pool_reference)
