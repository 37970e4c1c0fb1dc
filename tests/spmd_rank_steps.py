"""Rank entries of the port's SPMD tests (tests/test_torch_port_spmd*.py
and tests/test_torch_port_cuda.py): spawned rank processes import this
module, so it imports torch, numpy and the port only — no JAX."""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Tuple

import numpy as np
import torch

from multimodal_outage_tpu_torch import weights
from multimodal_outage_tpu_torch.core.config import DCRNNConfig, GWNetConfig, ModelConfig
from multimodal_outage_tpu_torch.core.mesh import Mesh, MeshShape
from multimodal_outage_tpu_torch.models.fusion import build_model
from multimodal_outage_tpu_torch.parallel import sharding
from multimodal_outage_tpu_torch.train.state import create_train_state
from multimodal_outage_tpu_torch.train.steps import make_train_step

LR, SEED = 1e-3, 5


def model_config(st_gnn: str, dropout: bool, single_pass: bool = False,
                 dtype: str = "float32", use_pallas: bool = False,
                 remat_scope: str = "") -> ModelConfig:
    """The tests' model: float32, the two-pass BatchNorm unless asked (see
    the test module's docstring), dropout at the defaults or off, the
    U-Net's blocks under remat when remat_scope names a scope."""
    rate = {} if dropout else {"encoder_dropout": 0.0}
    return ModelConfig(compute_dtype=dtype, st_gnn=st_gnn, bn_single_pass=single_pass,
                       gwnet=GWNetConfig(dropout=0.3 if dropout else 0.0, use_pallas=use_pallas),
                       dcrnn=DCRNNConfig(), remat=bool(remat_scope),
                       remat_scope=remat_scope or "all", **rate)


def supports_for(st_gnn: str, n: int) -> torch.Tensor:
    return torch.eye(n)[None].repeat(2 if st_gnn == "dcrnn" else 1, 1, 1)


def _grads(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k.replace(".", "/"): (p.grad if p.grad is not None else torch.zeros_like(p)).detach()
            for k, p in model.named_parameters()}


def _result(model, metrics, grads, mesh=None, eval_metrics=None) -> Dict:
    v = weights.module_variables(model)
    params, bs = v["params"], v["batch_stats"]
    if mesh is not None:
        params = sharding.gather_tree(params, mesh)
        grads = weights.flatten(sharding.gather_tree(weights.unflatten(grads), mesh))
    return {"metrics": {k: float(x) for k, x in metrics.items()},
            "eval": {k: float(x) for k, x in eval_metrics.items()},
            "params": {k: t.detach().cpu().numpy() for k, t in weights.flatten(params).items()},
            "stats": {k: t.detach().cpu().numpy() for k, t in weights.flatten(bs).items()},
            "grads": {k: t.detach().cpu().numpy() for k, t in grads.items()}}


def one_device_step(cfg: ModelConfig, variables, batch: Dict[str, np.ndarray], t: int, n: int,
                    h: int, device: str = "cpu") -> Dict:
    """The plain port step on one device (the bar every mesh step is held
    to), from numpy variables and a numpy batch."""
    from multimodal_outage_tpu_torch.core.metrics import regression_metrics
    from multimodal_outage_tpu_torch.train.steps import make_predict_step

    model = weights.load_variables(build_model(cfg, t, n, h), variables).to(device)
    state = create_train_state(model)
    tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    sup = supports_for(cfg.st_gnn, n).to(device)
    ev = regression_metrics(make_predict_step(model)(tb, sup), tb["y"])
    m = make_train_step(model)(state, tb, sup, LR, SEED)
    return _result(model, m, _grads(model), eval_metrics=ev)


def mesh_step(mesh: Mesh, cfg: ModelConfig, variables, batch: Dict[str, np.ndarray], t: int,
              n: int, h: int, batch_size: int) -> Dict:
    """One SPMD step: the batch padded to batch_size (pad_batch), this
    rank's part of it, the sharded weighted step; the full tree gathered."""
    model = weights.load_variables(build_model(cfg, t, n, h), variables)
    sharding.shard_model(model, mesh)
    model.to(mesh.device)
    state = create_train_state(model)
    part = sharding.shard_batch(mesh, sharding.pad_batch(batch, batch_size))
    sup = supports_for(cfg.st_gnn, n).to(mesh.device)
    ev = sharding.make_sharded_eval_step(model, mesh)(part, sup)
    m = sharding.make_sharded_train_step(model, mesh)(state, part, sup, LR, SEED)
    return _result(model, m, _grads(model), mesh, ev)


class backward_on_another_thread:
    """Inside: Tensor.backward runs on a thread of its own, where no mesh
    is active, as autograd runs a CUDA graph's backward on the card's
    device thread; on the CPU the caller's thread would run it."""

    def __enter__(self):
        self.orig = orig = torch.Tensor.backward

        def backward(tensor, *a, **kw):
            err = []

            def run():
                try:
                    orig(tensor, *a, **kw)
                except BaseException as e:  # re-raised on the caller's thread
                    err.append(e)

            th = threading.Thread(target=run)
            th.start()
            th.join()
            if err:
                raise err[0]

        torch.Tensor.backward = backward
        return self

    def __exit__(self, *exc):
        torch.Tensor.backward = self.orig
        return False


def mesh_steps(mesh: Mesh, cases: List[Tuple], variables: Dict, batches: Dict, dims: Tuple):
    """Every case (key, st_gnn, shape, dropout, batch name, batch size[,
    options]) on this world's ranks, each on a Mesh of its shape; rank 0
    returns {key: result}. options: "remat_scope" (model_config), and
    "backward_thread" (the backward on a thread of its own)."""
    t, n, h = dims
    torch.backends.cudnn.allow_tf32 = False  # the card's plain float32, as the tests' reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    out = {}
    for key, st, shape, dropout, bname, bsize, *opts in cases:
        opt = opts[0] if opts else {}
        shape = MeshShape(*shape)
        m = mesh if shape == mesh.shape else Mesh(shape, mesh.device)
        cfg = model_config(st, dropout, remat_scope=opt.get("remat_scope", ""))
        ctx = backward_on_another_thread() if opt.get("backward_thread") else contextlib.nullcontext()
        with ctx:
            out[key] = mesh_step(m, cfg, variables[st], batches[bname], t, n, h, bsize)
    return out if mesh.is_main else None


def round_trip(mesh: Mesh, tree) -> Dict:
    """shard_tree then gather_tree of a full tree; rank 0 returns both the
    gathered tree and its own shards' shapes."""
    shards = sharding.shard_tree(tree, mesh)
    back = sharding.gather_tree(shards, mesh)
    flat = weights.flatten(back)
    return {"back": {k: v.numpy() for k, v in flat.items()},
            "shapes": {k: tuple(v.shape) for k, v in weights.flatten(shards).items()},
            "rank": mesh.rank}


def pipeline_batches(mesh: Mesh, store_dir: str, horizon: int, image_size: int,
                     batch_idx: List[np.ndarray]) -> Dict:
    """This rank's batches from the replicated and the date-sharded device
    store, and the date rows it holds; every rank returns its own (the
    test reads rank 0's and rank 1's through two runs)."""
    from multimodal_outage_tpu_torch.core.registry import HURRICANES
    from multimodal_outage_tpu_torch.data.dataset import WindowDataset
    from multimodal_outage_tpu_torch.data.pipeline import DevicePipeline
    from multimodal_outage_tpu_torch.data.store import load_store
    from multimodal_outage_tpu_torch.parallel.collectives import all_gather

    store = load_store(store_dir)
    ds = WindowDataset.from_case_study(store, HURRICANES, 12, horizon)
    kw = dict(mean=3.2, std=10.4, image_size=image_size, dtype=torch.float32,
              device=mesh.device)
    rep = DevicePipeline(store, mesh=mesh, **kw)
    shard = DevicePipeline(store, mesh=mesh, shard_store=True, **kw)
    same = all(torch.equal(a[k], b[k]) for idx in batch_idx
               for a, b in [(rep.batch(ds, idx), shard.batch(ds, idx))] for k in a)
    held = shard.frames.cpu().numpy()
    want = np.zeros_like(held)
    rows = np.asarray(store.frames[shard.offset:shard.offset + held.shape[0]], np.float32)
    want[: rows.shape[0]] = rows
    ok = torch.tensor([float(same), float(np.array_equal(held, want))])
    oks = all_gather(ok[None], None if mesh.shape.size == 1 else _world(mesh), 0)
    return {"ranks_ok": oks.tolist(), "held": held.shape[0], "dates": store.frames.shape[0],
            "batch": {k: v.cpu().numpy() for k, v in rep.batch(ds, batch_idx[0]).items()}}


def _world(mesh: Mesh):
    import torch.distributed as dist

    return dist.group.WORLD


def fail_on_rank_1(mesh: Mesh):
    if mesh.rank == 1:
        raise ValueError("rank 1 gives up")
    mesh.barrier()  # rank 0 waits in a collective until it is terminated
    return "never"
