"""Serving engine: the eval-mode ModifiedUNet forward on the card.

The counterpart of the JAX package's serving.py ServingModel, for
st_gnn="gwnet", "dcrnn" and "gman" (the port's own). At build it folds
every U-Net BatchNorm into a per-channel affine (eps 1e-5), drops dropout
and prepares the st-GNN's weights and supports, once. The forward:

  U-Net contraction   5 DoubleConvs (ops/double_conv.py; a width its kernel
                      does not take, kernel_takes, runs the plain version,
                      chosen per level at build) with 2×2 max-pools
  bottleneck encoder  2 Dense + ReLU, float32
  Date2Vec            float32 (models/date2vec.py)
  st-GNN              Graph WaveNet: one kernel for the whole stack
                      (ops/gwnet_stack.py, BN folded) where it applies
                      (gwnet_path), else the trainable module in eval
                      mode (models/gwnet.py, BN not folded): every
                      non-fused config (kernel_size > 1, no gcn_bool, no
                      support at all), reference_view_quirk, and
                      gwnet_stack=False, whose fused layers are the
                      per-layer kernel with gwnet_pallas
                      (ops/gwnet_layer.py);
                      DCRNN: one kernel for the whole seq2seq
                      (ops/dcrnn_stack.py), or with dcrnn_stack=False the
                      module in eval mode (models/dcrnn.py);
                      GMAN: models/gman.py FoldedGMAN, every BatchNorm
                      folded, the spatio-temporal embedding computed once,
                      the attentions through scaled_dot_product_attention
  bottleneck decoder  2 Dense + ReLU, float32
  U-Net expansion     4 × (ConvTranspose 2×2 → pad-to-match → concat skip →
                      DoubleConv), then the 1×1 head

Spans (core/tracing.py, recorded only under a torch profiler): each
single-device forward is an engine.forward root over engine.contraction,
engine.st_gnn and engine.expansion, the three timed on the card; the
root's own time is the bottleneck Dense layers and Date2Vec.

Max-pool, Dense, ConvTranspose, concat and the 1×1 head are the ops the
JAX engine leaves to XLA; here they stay PyTorch ops. Every batch size
takes the same path: the JAX engine's B=1-only rule for the DCRNN kernel
(its serving.py:393-399) is a TPU measurement and is not carried over.

ServingModel(mesh=) (JAX serving.py:104-167, 299-330, 476-490) is the
SPMD engine of one rank of a mesh (core/mesh.py): the trainable module
in eval mode, its tensor-parallel Dense layers split over the model
ranks, each request split B over the data ranks and T over the time
ranks, the output gathered onto every rank. The kernel paths are
single-device programs: a mesh engine rejects their flags with the JAX
engine's ValueError, and a request batch the data axis does not divide
with its message.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from multimodal_outage_tpu_torch.core import tracing
from multimodal_outage_tpu_torch.core.config import ST_GNNS, DataConfig, ModelConfig
from multimodal_outage_tpu_torch.core.device import resolve_device
from multimodal_outage_tpu_torch.core.metrics import (
    MeanAggregator,
    regression_metrics,
    weighted_regression_metrics,
)
from multimodal_outage_tpu_torch.core.registry import leave_one_out
from multimodal_outage_tpu_torch.models import date2vec
from multimodal_outage_tpu_torch.models.dcrnn import DCRNN
from multimodal_outage_tpu_torch.models.gman import FoldedGMAN
from multimodal_outage_tpu_torch.models.gwnet import GraphWaveNet
from multimodal_outage_tpu_torch.ops import dcrnn_stack as dsm
from multimodal_outage_tpu_torch.ops.double_conv import (
    double_conv_reference,
    fold_batchnorm,
    fused_double_conv,
    kernel_takes,
)
from multimodal_outage_tpu_torch.ops.gwnet_stack import (
    adaptive_supports,
    gwnet_stack_forward,
    stack_forward_reference,
    stack_fragments,
    stack_params_from_module,
)
from multimodal_outage_tpu_torch.weights import conv_transpose_weight, load_variables


def gwnet_path(g, has_supports: bool, gwnet_stack: Optional[bool],
               gwnet_pallas: bool) -> bool:
    """Whether a Graph WaveNet engine runs the stack kernel (kernel 2) or
    the eval-mode module. Kernel 2 computes the fused path only
    (kernel_size 1, gcn_bool, a static or adaptive support) without
    reference_view_quirk; gwnet_stack=None takes it exactly where it
    applies and gwnet_pallas is not asked for (the JAX engine's auto rule,
    its serving.py:226-235, without the TPU test). A kernel asked for runs
    or raises: an explicit gwnet_stack=True that cannot apply, and
    gwnet_pallas=True on a config with no fused layer (or beside
    gwnet_stack=True), raise ValueError rather than switch paths."""
    fused = g.kernel_size == 1 and g.gcn_bool and (has_supports or g.addaptadj)
    what = (f"kernel_size={g.kernel_size}, gcn_bool={g.gcn_bool}, supports "
            f"{'given' if has_supports else 'none'}, addaptadj={g.addaptadj}, "
            f"reference_view_quirk={g.reference_view_quirk}")
    if gwnet_pallas and not fused:
        raise ValueError(f"gwnet_pallas=True: the per-layer kernel runs the fused Graph "
                         f"WaveNet layer, which this config has not ({what})")
    if gwnet_stack is None:
        return fused and not g.reference_view_quirk and not gwnet_pallas
    if gwnet_stack and (not fused or g.reference_view_quirk or gwnet_pallas):
        raise ValueError(f"gwnet_stack=True: the stack kernel computes the fused path "
                         f"without reference_view_quirk or gwnet_pallas ({what})")
    return gwnet_stack


def _n_nodes(cfg: ModelConfig, st, supports) -> int:
    """The county count of a variables tree's st-GNN: GMAN's spatial
    embedding's rows, else the supports' size, else (a Graph WaveNet
    without static supports) the adaptive adjacency's node embedding's."""
    if cfg.st_gnn == "gman":
        return torch.as_tensor(st["spatial_embedding"]).shape[0]
    if supports is not None:
        return torch.as_tensor(supports).shape[-1]
    return torch.as_tensor(st["nodevec1"]).shape[0]


class ServingModel:
    """Eval forward built once from a variables tree (weights.py).

    The st-GNN knobs are the JAX engine's: gwnet_stack, gwnet_pallas and
    dcrnn_stack (see the module docstring). reference=True runs the plain
    PyTorch version of every kernel instead of the kernel, on whatever
    device — the engine the kernel path is held against. The engine is
    immutable after construction."""

    def __init__(
        self,
        cfg: ModelConfig,
        variables: Dict[str, Any],
        supports,
        horizon: int = 7,
        device: Optional[str] = "cuda",
        reference: bool = False,
        gwnet_stack: Optional[bool] = None,
        gwnet_pallas: bool = False,
        dcrnn_stack: Optional[bool] = None,
        mesh=None,
    ):
        if cfg.st_gnn not in ST_GNNS:
            raise NotImplementedError(
                f"ServingModel serves st_gnn in {ST_GNNS} (got {cfg.st_gnn!r})")
        self.mesh = mesh
        if mesh is not None:
            if gwnet_stack or dcrnn_stack or gwnet_pallas:
                raise ValueError(
                    "Pallas kernel paths are single-device programs; build "
                    "the ServingModel without mesh= for the fused B=1 "
                    "route, or drop the kernel flags for SPMD serving"
                )
            self._mesh_engine(cfg, variables, supports, horizon, mesh)
            return
        if dcrnn_stack is None:
            dcrnn_stack = True
        if cfg.st_gnn == "gwnet":
            gwnet_stack = gwnet_path(cfg.gwnet, supports is not None, gwnet_stack, gwnet_pallas)
        if cfg.st_gnn == "dcrnn" and supports is None:
            raise ValueError(
                "dcrnn_stack=True requires a supports array: the fused DCGRU "
                "kernel bakes the diffusion supports at engine build"
                if dcrnn_stack else "DCRNN requires a supports array [S, N, N]; got None"
            )
        self.cfg = cfg
        self.gwnet_stack = cfg.st_gnn == "gwnet" and gwnet_stack
        self.horizon = horizon
        self.device = dev = resolve_device(device)
        self.dtype = dtype = getattr(torch, cfg.compute_dtype)
        self.reference = reference
        p, bs = variables["params"], variables["batch_stats"]
        f32 = lambda v: torch.as_tensor(v).to(dev, torch.float32).contiguous()
        cast = lambda v: torch.as_tensor(v).to(dev, dtype).contiguous()

        def folded(pp, ss):
            """(DoubleConv function, its weights): the kernel where it takes
            the level's Cin → C, else the plain version (JAX serving.py:343-347)."""
            s1, b1 = fold_batchnorm(*(f32(v) for v in (
                pp["bn1"]["scale"], pp["bn1"]["bias"], ss["bn1"]["mean"], ss["bn1"]["var"])))
            s2, b2 = fold_batchnorm(*(f32(v) for v in (
                pp["bn2"]["scale"], pp["bn2"]["bias"], ss["bn2"]["mean"], ss["bn2"]["var"])))
            w1 = cast(pp["conv1"]["kernel"])
            kernel = not reference and kernel_takes(w1.shape[2], w1.shape[3], dtype)
            fn = fused_double_conv if kernel else double_conv_reference
            return fn, (w1, s1, b1, cast(pp["conv2"]["kernel"]), s2, b2)

        cp, cbs = p["contraction"], bs["contraction"]
        self._down = [folded(cp["inc"], cbs["inc"])] + [
            folded(cp[f"down{i}"]["conv"], cbs[f"down{i}"]["conv"])
            for i in range(1, cfg.depth + 1)
        ]
        dense = lambda d: (f32(d["kernel"]), f32(d["bias"]))
        self._encoder = [dense(p["encoder"]["fc1"]), dense(p["encoder"]["fc2"])]
        self._decoder = [dense(p["decoder"]["fc1"]), dense(p["decoder"]["fc2"])]
        self._d2v = {k: {kk: f32(vv) for kk, vv in v.items()} for k, v in p["date2vec"].items()}

        sup = None if supports is None else f32(supports)
        if cfg.st_gnn == "dcrnn":
            self._st_gnn = self._dcrnn(p["st_gnn"], sup, dcrnn_stack)
        elif cfg.st_gnn == "gman":
            self._st_gnn = FoldedGMAN(p["st_gnn"], bs["st_gnn"], cfg.gman, horizon, dev, dtype)
        elif gwnet_stack:
            self._st_gnn = self._gwnet_stack(p["st_gnn"], bs["st_gnn"], sup)
        else:
            self._st_gnn = self._gwnet_module(p["st_gnn"], bs["st_gnn"], sup, gwnet_pallas)

        ep, ebs = p["expansion"], bs["expansion"]
        self._up = [
            (
                conv_transpose_weight(cast(ep[f"up{i}"]["up"]["kernel"])),
                cast(ep[f"up{i}"]["up"]["bias"]),
                folded(ep[f"up{i}"]["conv"], ebs[f"up{i}"]["conv"]),
            )
            for i in range(1, cfg.depth + 1)
        ]
        oc = ep["outc"]["conv"]
        self._outc = (cast(torch.as_tensor(oc["kernel"])[0, 0]), cast(oc["bias"]))
        # the DoubleConv function of each level, contraction then expansion
        self.double_conv_fns = tuple(fn for fn, _ in self._down + [u[2] for u in self._up])

    def _mesh_engine(self, cfg: ModelConfig, variables, supports, horizon: int, mesh) -> None:
        """The module path on a mesh: ModifiedUNet in eval mode at the
        variables' sizes, this rank's tensor-parallel shards loaded."""
        from multimodal_outage_tpu_torch.models.fusion import build_model
        from multimodal_outage_tpu_torch.parallel.sharding import shard_model, shard_tree

        p = variables["params"]
        top = cfg.base_channels * 2**cfg.depth
        grid = int(round(math.sqrt(torch.as_tensor(p["decoder"]["fc2"]["kernel"]).shape[1]
                                   / top)))
        n = _n_nodes(cfg, p["st_gnn"], supports)
        self.cfg, self.horizon, self.reference = cfg, horizon, False
        self.gwnet_stack = False
        self.device = mesh.device
        self.dtype = getattr(torch, cfg.compute_dtype)
        model = build_model(cfg, horizon, n, grid * 2**cfg.depth)
        shard_model(model, mesh)
        load_variables(model, {"params": shard_tree(p, mesh),
                               "batch_stats": variables["batch_stats"]})
        self._module = model.to(self.device).eval()
        self._supports = (None if supports is None
                          else torch.as_tensor(supports).to(self.device, torch.float32))
        self.double_conv_fns = ()

    def forward_local(self, x: torch.Tensor, date_feats: torch.Tensor) -> torch.Tensor:
        """A mesh engine's forward of this rank's part of a request (its
        rows and T slice, as the mesh pipeline gives them) → its part of
        the output."""
        from multimodal_outage_tpu_torch.core.mesh import use_mesh

        with torch.inference_mode(), use_mesh(self.mesh):
            return self._module(x.to(self.device), date_feats.to(self.device), self._supports,
                                train=False)

    def _gwnet_stack(self, st, st_bs, sup) -> Callable[[torch.Tensor], torch.Tensor]:
        """The whole Graph WaveNet stack as one kernel: BN folded, weights
        stacked (in bf16 also packed in fragment order for the kernel's
        tensor-core body) and static + adaptive supports baked here."""
        g, dev, dtype = self.cfg.gwnet, self.device, self.dtype
        sp = {k: v.to(dev) for k, v in stack_params_from_module(
            st, st_bs, g.blocks * g.layers, dtype).items()}
        if dtype == torch.bfloat16:
            sp["frags"] = stack_fragments(sp)
        nodevec = lambda k: torch.as_tensor(st[k]).to(dev, torch.float32) if g.addaptadj else None
        all_sup = adaptive_supports(sup, nodevec("nodevec1"), nodevec("nodevec2"), dtype)
        fn = stack_forward_reference if self.reference else gwnet_stack_forward
        return lambda z: fn(z, all_sup, sp, order=g.order)

    def _gwnet_module(self, st, st_bs, sup, gwnet_pallas: bool) -> Callable[[torch.Tensor], torch.Tensor]:
        """The trainable Graph WaveNet in eval mode (running BN statistics,
        not folded), its layers the per-layer kernel with gwnet_pallas."""
        g = dataclasses.replace(self.cfg.gwnet, use_pallas=gwnet_pallas and not self.reference)
        n_nodes = torch.as_tensor(st["nodevec1"]).shape[0] if "nodevec1" in st else 0
        module = GraphWaveNet(dataclasses.replace(self.cfg, gwnet=g), n_nodes,
                              0 if sup is None else sup.shape[0], self.dtype)
        load_variables(module, {"params": st, "batch_stats": st_bs})
        module.to(self.device).eval()
        return lambda z: module(z, sup, train=False)

    def _dcrnn(self, st, sup, dcrnn_stack: bool) -> Callable[[torch.Tensor], torch.Tensor]:
        """DCRNN: the whole seq2seq as one kernel (weights split per term
        here) or, with dcrnn_stack=False, the module in eval mode."""
        cfg, d = self.cfg, self.cfg.dcrnn
        arch = dict(num_rnn_layers=d.num_rnn_layers, max_diffusion_step=d.max_diffusion_step,
                    rnn_units=d.rnn_units)
        kw = dict(horizon=self.horizon, **arch)
        if dcrnn_stack:
            sp = dsm.stack_params_to(dsm.dcrnn_stack_params(
                st, n_supports=sup.shape[0], input_dim=cfg.st_gnn_in_dim,
                output_dim=cfg.feature_vector_size, **arch,
            ), self.device, self.dtype)
            sup_t = sup.to(self.dtype).contiguous()
            fn = dsm.stack_forward_reference if self.reference else dsm.dcrnn_stack_forward
            return lambda z: fn(z, sup_t, sp, **kw)
        module = DCRNN(cfg.st_gnn_in_dim, cfg.feature_vector_size, n_supports=sup.shape[0],
                       dtype=self.dtype, **kw)
        load_variables(module, {"params": st})
        module.to(self.device).eval()
        return lambda z: module(z, sup, train=False)

    @torch.inference_mode()
    def __call__(self, x: torch.Tensor, date_feats: torch.Tensor) -> torch.Tensor:
        """x [B, N, T, H, W, Cin], date_feats [B, T, 6] → [B, N, T, H, W,
        Cout] float32. A mesh engine takes the whole request on every rank
        and returns the whole output on every rank."""
        if self.mesh is not None:
            from multimodal_outage_tpu_torch.parallel.sharding import gather_output, shard_batch

            dp = self.mesh.shape.data
            if x.shape[0] % dp:
                raise ValueError(
                    f"request batch {x.shape[0]} not divisible by the mesh "
                    f"data axis {dp} — pad the batch "
                    "(parallel.sharding.pad_batch) or use a mesh-less "
                    "engine for B=1 latency serving"
                )
            part = shard_batch(self.mesh, {"x": x, "date_feats": date_feats})
            return gather_output(self.forward_local(part["x"], part["date_feats"]), self.mesh)
        cfg, dtype, card = self.cfg, self.dtype, self.device.type == "cuda"
        b, n, t, hh, ww, c_in = x.shape
        m = b * n * t
        dc = lambda v, fn_args: fn_args[0](v, *fn_args[1])

        with tracing.span("engine.forward"):
            with tracing.span("engine.contraction", device=card):
                y = dc(x.to(self.device, dtype).reshape(m, hh, ww, c_in).contiguous(),
                       self._down[0])
                skips = [y]
                for i in range(1, cfg.depth + 1):
                    y = F.max_pool2d(y.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1).contiguous()
                    y = dc(y, self._down[i])
                    if i < cfg.depth:
                        skips.append(y)

            # bottleneck encoder (float32 Dense, as the JAX engine's f32
            # params promote it) + Date2Vec in float32
            z = y.reshape(b, n, t, -1).float()
            for w, bias in self._encoder:
                z = torch.relu(z @ w + bias)
            te = date2vec.encode(date_feats.to(self.device), self._d2v).to(dtype).float()
            te = te[:, None].expand(b, n, t, te.shape[-1])
            z = torch.cat([z, te], -1).to(dtype).contiguous()

            with tracing.span("engine.st_gnn", device=card):
                z = self._st_gnn(z)

            # bottleneck decoder
            d = z.float()
            for w, bias in self._decoder:
                d = torch.relu(d @ w + bias)
            grid = hh // (2**cfg.depth)
            y = d.reshape(m, grid, grid, -1).to(dtype)

            with tracing.span("engine.expansion", device=card):
                for i, (wt, bt, conv_args) in enumerate(self._up, start=1):
                    y = F.conv_transpose2d(y.permute(0, 3, 1, 2), wt, bt,
                                           stride=2).permute(0, 2, 3, 1)
                    skip = skips[-i]
                    dh, dw = skip.shape[1] - y.shape[1], skip.shape[2] - y.shape[2]
                    if dh or dw:
                        y = F.pad(y, (0, 0, dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
                    y = dc(torch.cat([skip, y], -1).contiguous(), conv_args)
                w, bias = self._outc
                y = y @ w + bias
                return y.reshape(b, n, t, hh, ww, -1).float()


def latency_percentiles(times_ms: List[float]) -> Dict[str, float]:
    vals = sorted(times_ms)
    return {
        "p50_ms": vals[len(vals) // 2],
        "p90_ms": vals[min(int(0.9 * len(vals)), len(vals) - 1)],
    }


def time_requests(serve: ServingModel, batches: List[Dict[str, torch.Tensor]], repeats: int = 3) -> List[float]:
    """Per-request latency in ms: one warm-up forward, then each batch
    `repeats` times. On the card each request is bracketed by CUDA events
    on the current stream (host enqueue included, as a caller sees it);
    on the CPU by the host clock."""
    call = serve if getattr(serve, "mesh", None) is None else serve.forward_local
    call(batches[0]["x"], batches[0]["date_feats"])
    out = []
    for batch in batches:
        for _ in range(repeats):
            if serve.device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                call(batch["x"], batch["date_feats"])
                end.record()
                end.synchronize()
                out.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                call(batch["x"], batch["date_feats"])
                out.append(1e3 * (time.perf_counter() - t0))
    return out


def serve_eval(
    data_cfg: DataConfig,
    serve: ServingModel,
    store,
    test_case: str,
    batch_size: int,
    max_batches: Optional[int] = None,
    latency_stats: bool = False,
    collect_preds: Optional[List[np.ndarray]] = None,
    transform=None,
    frame_transform=None,
) -> Tuple[Dict[str, float], Dict[str, float], int]:
    """Sweep the held-out hurricane through the engine, as the JAX
    package's train/loop.py serve_eval does. Returns (metrics, latency,
    forwards): metrics are the mean of per-batch values; latency (with
    latency_stats) has p50/p90 per-request ms over up to six full-size
    batches; forwards counts every engine call made here. Each swept
    batch's prediction is appended to collect_preds, when given, as a
    host array.

    Batches come through train/loop.py make_pipeline and _epoch_iter, so
    a store past data_cfg.device_store_budget_mb streams through the host
    path, and transform / frame_transform reach every batch as in fit
    (JAX train/loop.py:773-860). The batches kept for the latency
    requests are device tensors from either path.

    A mesh engine sweeps on its mesh: padded batches, each rank its part
    (train/loop.py _mesh_epoch_iter), the weighted global metrics, the
    predictions gathered and trimmed to the test windows, and a mesh
    request (this rank's part) timed for the latency."""
    from contextlib import closing
    from itertools import islice

    from multimodal_outage_tpu_torch.core.config import Config, TrainConfig
    from multimodal_outage_tpu_torch.data.dataset import WindowDataset
    from multimodal_outage_tpu_torch.train.loop import _epoch_iter, make_pipeline

    _, test_cases = leave_one_out(test_case)
    test_ds = WindowDataset.from_case_study(
        store, test_cases, data_cfg.dataset_range, data_cfg.horizon
    )
    if len(test_ds) == 0:
        raise ValueError(
            f"no test windows for {test_case!r} at dataset_range "
            f"{data_cfg.dataset_range} and horizon {data_cfg.horizon}"
        )
    # frames in DataConfig.device_dtype on the device path, as the JAX
    # serve_eval and the port's fit hold them (float32 on the host path);
    # the engine casts them to its compute dtype
    cfg = Config(data=data_cfg, train=TrainConfig(batch_size=batch_size))
    mesh = getattr(serve, "mesh", None)  # an engine without one serves on its device
    pipe = make_pipeline(cfg, store, serve.device, frame_transform, mesh)
    agg = MeanAggregator()
    timed: List[Dict[str, torch.Tensor]] = []
    forwards = 0
    full = batch_size // (1 if mesh is None else mesh.shape.data)
    preds: List[np.ndarray] = []
    with closing(_epoch_iter(test_ds, np.arange(len(test_ds)), cfg, False, 0, pipe,
                             serve.device, transform, frame_transform, mesh)) as batches:
        for batch in islice(batches, max_batches):
            if mesh is None:
                yhat = serve(batch["x"], batch["date_feats"])
                agg.update(regression_metrics(yhat, batch["y"]))
            else:
                from multimodal_outage_tpu_torch.parallel.sharding import gather_output

                yhat = serve.forward_local(batch["x"], batch["date_feats"])
                agg.update(weighted_regression_metrics(yhat, batch["y"], batch["w"], mesh))
                if collect_preds is not None:
                    yhat = gather_output(yhat, mesh)
            forwards += 1
            if collect_preds is not None:
                preds.append(yhat.cpu().numpy())
            if len(timed) < 6 and batch["x"].shape[0] == full:
                timed.append(batch)
    if collect_preds is not None and preds:
        # a mesh pads the tail batch: trim the pad rows off
        collect_preds.extend(preds if mesh is None else [np.concatenate(preds)[:len(test_ds)]])
    latency: Dict[str, float] = {}
    if latency_stats and timed:
        times = time_requests(serve, timed)
        forwards += 1 + len(times)
        latency = latency_percentiles(times)
    return agg.compute(), latency, forwards
