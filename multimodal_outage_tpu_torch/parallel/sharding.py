"""SPMD sharding rules and the sharded steps (JAX parallel/sharding.py).

  data axis  — each rank takes its rows of the batch; the gradients of
               every leaf are summed over the data × time ranks
  model axis — Megatron's tensor parallelism over the bottleneck MLPs:
                 encoder.fc1, decoder.fc1, st_gnn.end_conv_1  column-parallel
                 encoder.fc2, decoder.fc2, st_gnn.end_conv_2  row-parallel
               Dense kernels are [in, out]: a column-parallel kernel and
               its bias are split along out, a row-parallel kernel along
               in, its bias replicated and added once after the sum
               (models/layers.py Dense, parallel/collectives.py f and g)
  time axis  — each rank takes its slice of T (x and y at axis 2,
               date_feats at axis 1)

The rules are the JAX package's nine (module, name) suffixes, matched
against the port's variable tree, which is the flax tree (weights.py);
they apply to the parameters and to both Adam moments alike.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from multimodal_outage_tpu_torch.core.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    TIME_AXIS,
    Mesh,
    local_batch_slice,
    use_mesh,
)
from multimodal_outage_tpu_torch.core.metrics import weighted_regression_metrics
from multimodal_outage_tpu_torch.parallel import collectives as C
from multimodal_outage_tpu_torch.weights import flatten, unflatten

Spec = Tuple[Optional[str], ...]

# (module, param-name) → the partition of each dim, matched against the
# tail of the leaf's path (JAX parallel/sharding.py:_TP_RULES)
_TP_RULES: Dict[Tuple[str, ...], Spec] = {
    ("encoder", "fc1", "kernel"): (None, MODEL_AXIS),
    ("encoder", "fc1", "bias"): (MODEL_AXIS,),
    ("encoder", "fc2", "kernel"): (MODEL_AXIS, None),
    ("decoder", "fc1", "kernel"): (None, MODEL_AXIS),
    ("decoder", "fc1", "bias"): (MODEL_AXIS,),
    ("decoder", "fc2", "kernel"): (MODEL_AXIS, None),
    ("st_gnn", "end_conv_1", "kernel"): (None, MODEL_AXIS),
    ("st_gnn", "end_conv_1", "bias"): (MODEL_AXIS,),
    ("st_gnn", "end_conv_2", "kernel"): (MODEL_AXIS, None),
}


def pspec_for(path: str, ndim: int) -> Spec:
    """The partition of the leaf at `path` ("a/b/c"): a rule's spec when
    its suffix matches and the ranks agree, else () (replicated)."""
    names = tuple(path.split("/"))
    for pattern, spec in _TP_RULES.items():
        k = len(pattern)
        if len(names) >= k and names[-k:] == pattern and ndim == len(spec):
            return spec
    return ()


def tree_specs(tree: Dict[str, Any]) -> Dict[str, Spec]:
    """{path: spec} of every leaf of a nested tree."""
    return {k: pspec_for(k, np.ndim(v) if not torch.is_tensor(v) else v.dim())
            for k, v in flatten(tree).items()}


def _model_dim(spec: Spec) -> Optional[int]:
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def shard_leaf(v: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of a full leaf."""
    dim = _model_dim(spec)
    mp = mesh.shape.model
    if dim is None or mp == 1:
        return v
    n = v.shape[dim]
    if n % mp:
        raise ValueError(f"a {tuple(v.shape)} leaf does not split into {mp} equal "
                         f"model-axis blocks along dim {dim}")
    per = n // mp
    return v.narrow(dim, mesh.coord(MODEL_AXIS) * per, per).contiguous()


def shard_tree(tree: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """The rank's shards of a full tree (params, batch_stats or an Adam
    moment tree): TP leaves split along their model dim, the rest as
    they are."""
    flat = flatten(tree)
    out = {}
    for k, v in flat.items():
        t = v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v, np.float32))
        out[k] = shard_leaf(t, pspec_for(k, t.dim()), mesh)
    return unflatten(out)


def gather_tree(tree: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """The full tree from every rank's shards (all-gather over the model
    group); every rank of the group takes part and gets the full tree."""
    out = {}
    for k, v in flatten(tree).items():
        dim = _model_dim(pspec_for(k, v.dim()))
        out[k] = v if dim is None else C.all_gather(v, mesh.group(MODEL_AXIS), dim)
    return unflatten(out)


def shard_model(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Resize the model's TP parameters to this rank's blocks (their
    values: the full ones' blocks) and mark their Dense layers column- or
    row-parallel. Build the optimizer after this."""
    if mesh.shape.model == 1:
        return model
    with torch.no_grad():
        for name, p in model.named_parameters():
            path = name.replace(".", "/")
            spec = pspec_for(path, p.dim())
            if _model_dim(spec) is not None:
                p.data = shard_leaf(p.data, spec, mesh)
    for name, mod in model.named_modules():
        path = name.replace(".", "/")
        kernel = pspec_for(path + "/kernel", 2)
        if kernel == (None, MODEL_AXIS):
            mod.tp = "column"
        elif kernel == (MODEL_AXIS, None):
            mod.tp = "row"
    return model


def pad_batch(batch: Dict[str, Any], batch_size: int) -> Dict[str, Any]:
    """Pad a (ragged tail) batch to batch_size rows and attach the
    per-sample weights 'w' (1 valid, 0 pad), bit for bit JAX's pad_batch:
    pad rows cycle the valid samples (np.resize semantics), so train-mode
    statistics over them stay in distribution, and w masks them out of
    the loss, the gradients, the metrics and the BatchNorm running-stat
    EMA."""
    b = next(iter(batch.values())).shape[0]
    w = np.zeros((batch_size,), np.float32)
    w[:b] = 1.0
    if b == batch_size:
        return {**batch, "w": w}
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        reps = -(-batch_size // b)
        out[k] = np.concatenate([v] * reps, axis=0)[:batch_size]
    out["w"] = w
    return out


def _time_axis(name: str) -> Optional[int]:
    """JAX _batch_pspec: x/y [B, N, T, H, W, C] at axis 2, date_feats [B,
    T, 6] at axis 1, the rest (w) along the batch only."""
    return {"x": 2, "y": 2, "date_feats": 1}.get(name)


def local_part(name: str, v, mesh: Mesh, rows: bool = True):
    """This rank's rows (when `rows`) and T slice of a global batch leaf."""
    if rows:
        v = v[local_batch_slice(v.shape[0], mesh)]
    ax = _time_axis(name)
    tp = mesh.shape.time
    if ax is not None and tp > 1:
        n = v.shape[ax]
        if n % tp:
            raise ValueError(f"{name}: T={n} not divisible by mesh time axis {tp}")
        per = n // tp
        t0 = mesh.coord(TIME_AXIS) * per
        v = v.narrow(ax, t0, per) if torch.is_tensor(v) else np.take(
            v, np.arange(t0, t0 + per), axis=ax)
    return v


def shard_batch(mesh: Mesh, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A logically global batch (every rank passes the same) → this rank's
    rows and T slice, on its device."""
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) else v
        out[k] = local_part(k, v, mesh).contiguous().to(mesh.device)
    return out


def shard_local_batch(mesh: Mesh, local: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """This rank's rows, gathered by itself (multi-host feeding, JAX
    shard_local_batch) → its T slice, on its device."""
    out = {}
    for k, v in local.items():
        v = torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) else v
        out[k] = local_part(k, v, mesh, rows=False).contiguous().to(mesh.device)
    return out


def gather_output(y: torch.Tensor, mesh: Mesh, time_dim: int = 2) -> torch.Tensor:
    """A batch-sharded [B/dp, N, T/tp, ...] output → the global one, on
    every rank (all-gather over time, then over data)."""
    y = C.all_gather(y, mesh.group(TIME_AXIS), time_dim)
    return C.all_gather(y, mesh.group(DATA_AXIS), 0)


def _weights(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    w = batch.get("w")
    if w is None:
        return torch.ones(batch["y"].shape[0], device=batch["y"].device)
    return w.to(batch["y"].device, torch.float32)


def _train_teacher(model, batch, seed, state):
    from multimodal_outage_tpu_torch.train.steps import (
        sampling_generator,
        tf_schedule,
        uses_teacher_forcing,
    )

    if not uses_teacher_forcing(model):
        return {}
    return {"targets": batch["y"], "tf_prob": float(tf_schedule(model, state.step)),
            "sampling": sampling_generator(seed, state.step)}


def weighted_loss(yhat: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                  mesh: Mesh) -> torch.Tensor:
    """This rank's part of Σ w·mean_sq / max(Σ w, 1) over the global
    batch: the parts of all data × time ranks sum to the loss, so their
    gradients sum to its gradient. The per-sample mean is over the
    global sample (its T slices on the time ranks)."""
    per_sample = float(np.prod(y.shape[1:])) * mesh.shape.time
    sq = torch.sum(torch.square(yhat - y).reshape(y.shape[0], -1), dim=1) / per_sample
    wsum = C.all_reduce(w.sum(), mesh.group(DATA_AXIS))
    return torch.sum(w * sq) / torch.clamp(wsum, min=1.0)


def make_sharded_train_step(model: torch.nn.Module, mesh: Mesh, weighted: bool = True,
                            debug_nans: bool = False) -> Callable[..., Dict[str, torch.Tensor]]:
    """The SPMD train step, called as train/steps.py make_train_step's:
    train_step(state, batch, supports, lr, seed) → metrics, on this
    rank's batch part (shard_batch / the mesh pipeline). The model must
    be shard_model'd and its Adam built after. The forward runs under the
    mesh (BatchNorm moments summed over the time ranks, its running
    statistics updated from the global batch's groups; dropout masks cut
    from the global batch's; tensor-parallel Dense layers); the loss is
    this rank's part of the weighted global loss (weighted_loss; with
    weighted False every row weighs 1); each gradient leaf is summed over
    the data × time ranks in one collective; Adam updates each rank's
    shards. The metrics are the global batch's on every rank
    (weighted_regression_metrics). The batch's 'w' also masks the
    BatchNorm running-stat EMA (sample_weight)."""
    from multimodal_outage_tpu_torch.train.steps import step_generator

    params = [p for p in model.parameters() if p.requires_grad]
    dt = mesh.group("data_time")

    def train_step(state, batch, supports, lr, seed):
        for p in params:
            p.grad = None
        w = _weights(batch)
        gen = step_generator(seed, state.step, batch["x"].device)
        kw = _train_teacher(model, batch, seed, state)
        anomaly = (torch.autograd.detect_anomaly(check_nan=True) if debug_nans
                   else contextlib.nullcontext())
        with use_mesh(mesh), anomaly:
            yhat = model(batch["x"], batch["date_feats"], supports, train=True,
                         generator=gen, sample_weight=w if weighted else None, **kw)
            loss = weighted_loss(yhat, batch["y"], w, mesh)
            if debug_nans and not bool(torch.isfinite(loss)):
                raise FloatingPointError(f"debug_nans: non-finite loss at step {state.step}")
            loss.backward()
        C.flat_all_reduce([p.grad for p in params if p.grad is not None], dt)
        state.opt.step(lr)
        state.step += 1
        with torch.no_grad():
            return weighted_regression_metrics(yhat.detach(), batch["y"], w, mesh)

    return train_step


def make_sharded_predict_step(model: torch.nn.Module, mesh: Mesh) -> Callable[..., torch.Tensor]:
    """predict_step(batch, supports) → this rank's part of the eval-mode
    prediction (gather_output gives the global one)."""

    @torch.no_grad()
    def predict_step(batch, supports):
        with use_mesh(mesh):
            return model(batch["x"], batch["date_feats"], supports, train=False)

    return predict_step


def make_sharded_eval_step(model: torch.nn.Module, mesh: Mesh) -> Callable[..., Dict[str, torch.Tensor]]:
    """eval_step(batch, supports) → the global batch's weighted metrics,
    on every rank: a padded tail reduces to the ragged batch's values."""
    predict = make_sharded_predict_step(model, mesh)

    def eval_step(batch, supports):
        yhat = predict(batch, supports)
        return weighted_regression_metrics(yhat, batch["y"], _weights(batch), mesh)

    return eval_step
