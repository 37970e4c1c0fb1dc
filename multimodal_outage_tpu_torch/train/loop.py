"""Training loop on one device (JAX train/loop.py:135-222, 326-340,
407-770): epochs with a per-epoch cosine LR, a val sweep after each
epoch, early stopping on val_loss, best-k checkpoints, and at the end the
best checkpoint swept over val and the held-out hurricane; and predict
(JAX train/loop.py:901-1010), the same sweep of a checkpoint over the
held-out hurricane. Both run either st-GNN, over the supports of its
adjtype (data/adjacency.py model_adjtype); DCRNN runs as the module, in
eval through its self-feeding decoder.

fit also runs the JAX loop's run options: resume from the latest
checkpoint, a pretrained Date2Vec bundle installed at init, TensorBoard
scalars, a torch.profiler trace of a few steps, and NaN debugging.

With GWNetConfig.randomadj False (`--svd_aptinit`) fit starts the node
embeddings from the SVD of the first static support (models/gwnet.py
install_aptinit), as the JAX loop does; predict and serve read them from
the checkpoint.

Gradient accumulation (TrainConfig.grad_accum, JAX train/loop.py:
519-597): a fixed split count K runs each batch as K equal microbatches
(train/steps.py make_accum_train_step); grad_accum 0 ("auto") starts
one-shot and, when a step runs out of device memory, retries it with the
next split count that divides the batch. Remat is the model's
(ModelConfig.remat, models/unet.py).

Batches come from one of two input paths, chosen by make_pipeline as
the JAX loop chooses (train/loop.py:155-190): the device pipeline
(data/pipeline.py DevicePipeline, the whole float32 store on the card)
with DataConfig.pipeline "device" or when the store fits
device_store_budget_mb, else the host path (PrefetchIterator: a native
gather from the memmap into pinned buffers, copied and preprocessed on a
side stream, DataConfig.prefetch batches ahead). Every stream of fit,
evaluate and predict goes through _epoch_iter, which applies the two
hooks of the reference dataset's transform slot (utils.py:14,35-38):
`transform` (dict→dict on the device batch, after the built-ins) and
`frame_transform` (in place of the built-in Resize + Normalize).

SPMD (JAX train/loop.py:254-325, 450-512, 804-1041): when cfg.mesh
resolves to more than one device (core/mesh.py mesh_from_config) fit,
predict and serve_eval (serving.py) run on a (data, model, time) mesh of
ranks started by parallel/launch.py, and return rank 0's result. Every
batch is padded to the batch size with a 'w' row masking the pad rows
(_mesh_epoch_iter, parallel/sharding.py pad_batch), each rank holding
its rows and T slice; the steps are parallel/sharding.py's; metrics are
the weighted global ones; a checkpoint holds the gathered full tree,
written by rank 0, and reads back on any mesh or none; predict trims the
padded tail off its arrays. _validate_mesh_cfg raises JAX's three
errors. The hooks reach the mesh batches too (they must keep 'w', and
pickle: the ranks are spawned processes).
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time
from contextlib import closing
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from multimodal_outage_tpu_torch.core import tracing
from multimodal_outage_tpu_torch.core.checkpoint import (
    CheckpointManager,
    require_checkpoints,
    restore_variables,
)
from multimodal_outage_tpu_torch.core.config import Config, asdict
from multimodal_outage_tpu_torch.core.device import resolve_device
from multimodal_outage_tpu_torch.core.mesh import (
    Mesh,
    MeshShape,
    local_batch_slice,
    mesh_from_config,
    torchrun_env,
)
from multimodal_outage_tpu_torch.core.metrics import (
    MeanAggregator,
    regression_metrics,
    weighted_regression_metrics,
)
from multimodal_outage_tpu_torch.core.oom import is_oom_error
from multimodal_outage_tpu_torch.core.registry import leave_one_out
from multimodal_outage_tpu_torch.core.run_logging import RunLogger, device_memory_stats
from multimodal_outage_tpu_torch.data.adjacency import config_supports
from multimodal_outage_tpu_torch.data.dataset import (
    WindowDataset,
    batch_indices,
    train_val_split,
)
from multimodal_outage_tpu_torch.data.pipeline import DevicePipeline, PrefetchIterator
from multimodal_outage_tpu_torch.data.store import load_store
from multimodal_outage_tpu_torch.models.fusion import build_model
from multimodal_outage_tpu_torch.models.gwnet import install_aptinit
from multimodal_outage_tpu_torch.train.date2vec_pretrain import install_bundle, load_bundle
from multimodal_outage_tpu_torch.train.state import (
    TrainState,
    cosine_annealing_lr,
    create_train_state,
    param_count,
)
from multimodal_outage_tpu_torch.train.steps import (
    make_accum_train_step,
    make_predict_step,
    make_train_step,
)
from multimodal_outage_tpu_torch.weights import init_variables, load_variables, module_variables

_GRAD_ACCUM_ON_MESH = (
    "grad_accum (including auto) is a single-device-path "
    "feature; with a mesh, scale batch over the data axis "
    "instead"
)


def check_supported(cfg: Config) -> None:
    """Raise JAX's refusal of grad_accum != 1 with a mesh of more than one
    device (train/loop.py:457-462)."""
    mesh = cfg.mesh
    if mesh.model != 1 or mesh.time != 1 or mesh.data not in (-1, 1):
        if cfg.train.grad_accum != 1:
            raise ValueError(_GRAD_ACCUM_ON_MESH)


def _validate_mesh_cfg(cfg: Config, shape: MeshShape) -> None:
    """JAX's fit/predict/serve_eval mesh-vs-config checks (train/loop.py:
    1011-1032), word for word. The max-pool kernel is refused on a mesh
    of more than one device as the JAX package refuses its Pallas
    kernel there (a quirk the port keeps)."""
    if cfg.train.batch_size % shape.data != 0:
        raise ValueError(
            f"batch_size {cfg.train.batch_size} not divisible by mesh "
            f"data axis {shape.data}"
        )
    if cfg.data.horizon % shape.time != 0:
        raise ValueError(
            f"horizon {cfg.data.horizon} not divisible by mesh time axis {shape.time}"
        )
    if cfg.model.pool == "pallas" and shape.size > 1:
        raise ValueError(
            "pool='pallas' cannot run under a multi-device mesh (no GSPMD "
            "partitioning rule for pallas_call); use pool='reduce_window'"
        )


def resolve_mesh(cfg: Config, device_type: str) -> Optional[MeshShape]:
    """cfg.mesh resolved (None: one device) and validated, for fit,
    predict and serve (JAX mesh_from_config and _validate_mesh_cfg, as
    its _inference_mesh)."""
    shape = mesh_from_config(cfg.mesh, device_type)
    if shape is not None:
        _validate_mesh_cfg(cfg, shape)
    return shape


class _NullLogger:
    """The run log of a rank other than 0: rank 0 writes the run's."""

    def log(self, row) -> None:
        pass

    def close(self) -> None:
        pass


def _accum_split_count(b: int, mb_size: int) -> int:
    """Smallest number of EQUAL microbatches of size <= mb_size that b
    divides into (grad-accumulation splitting rule). Equal microbatches
    keep the accumulation exact — mean of equal-chunk gradients == the
    full-batch gradient and the serial-EMA BatchNorm telescopes — while
    never running a chunk larger than the microbatch budget: a one-shot
    near-full ragged tail would OOM on exactly the configs grad_accum
    exists for (b=16 does not fit a 16 GB chip). Always terminates:
    k=b gives microbatch size 1."""
    if b <= mb_size:
        return 1
    k = -(-b // mb_size)  # ceil
    while b % k:
        k += 1
    return k


def _next_split_count(b: int, k: int) -> int:
    """Smallest split count > k that divides b into equal microbatches —
    the auto-grad-accum OOM fallback steps the SPLIT COUNT, not the
    budget: halving the byte budget can leave the split count unchanged
    (re-dispatching the identical failing program) or overshoot past a
    split that fits (b=6: budgets 6→3→1 give k=1→2→6, skipping k=3)."""
    k += 1
    while b % k:
        k += 1
    return k


def _grad_accum_step(cfg: Config, model: torch.nn.Module,
                     one_shot: Callable[..., Dict[str, torch.Tensor]]):
    """fit's train step for cfg.train.grad_accum != 1 (JAX train/loop.py:
    519-597). K > 0: microbatches of at most batch_size // K, a ragged
    last batch b in _accum_split_count(b, budget) equal ones. K = 0
    ("auto"): the budget starts at the whole batch; a step that runs out
    of device memory is retried at _next_split_count's split, with a line
    on stderr, and every later step keeps the smaller budget.

    The JAX loop fetches a metric for the first _AUTO_ACCUM_SETTLE steps
    of a shape, because its dispatch is asynchronous and a runtime OOM
    shows only at the next host fetch. PyTorch's caching allocator raises
    in the call that allocates, inside the step, so no fetch is needed.
    Before each auto attempt the module's buffers (the BatchNorm running
    statistics, a few KB) are copied; a failed attempt may have advanced
    some in place, so they are put back and every .grad is dropped before
    the retry, which runs after the exception and its traceback (which
    holds the failed attempt's activations) are released. An OOM after
    Adam began (its count moved) may have updated some parameters and is
    not retried: it raises a RuntimeError naming the --grad_accum or
    --batch_size that would fit (the counterpart of JAX's abort when a
    runtime OOM consumed the donated state)."""
    ga, bs = cfg.train.grad_accum, cfg.train.batch_size
    auto = ga == 0
    if not auto and bs % ga:
        raise ValueError(f"batch_size {bs} not divisible by grad_accum {ga}")
    budget = bs if auto else bs // ga
    steps = {1: one_shot}
    buffers, params = list(model.buffers()), list(model.parameters())

    def train_step(state, batch, supports, lr, seed):
        nonlocal budget
        b = batch["x"].shape[0]
        while True:
            k = _accum_split_count(b, budget)
            if k not in steps:
                steps[k] = make_accum_train_step(model, k, cfg.train.debug_nans)
            if not auto:
                return steps[k](state, batch, supports, lr, seed)
            saved = [t.clone() for t in buffers]
            count = state.opt.count
            try:
                return steps[k](state, batch, supports, lr, seed)
            except RuntimeError as e:  # torch.cuda.OutOfMemoryError is one
                if not (is_oom_error(e) and k < b):
                    raise
                if state.opt.count != count:
                    raise RuntimeError(
                        "auto grad_accum cannot retry: the step ran out of device "
                        "memory in the optimizer update, after some parameters may "
                        "have moved. Restart with an explicit --grad_accum >= "
                        f"{_next_split_count(bs, _accum_split_count(bs, budget))} "
                        "or a smaller --batch_size"
                    ) from e
            # retry outside the except block: its traceback is released
            gc.collect()
            with torch.no_grad():
                for t, s in zip(buffers, saved):
                    t.copy_(s)
            for p in params:
                p.grad = None
            budget = b // _next_split_count(b, k)
            print(
                f"[auto grad_accum] step OOM'd; retrying with "
                f"microbatch <= {budget} "
                f"({_accum_split_count(b, budget)} "
                f"microbatches at batch {b})",
                file=sys.stderr,
            )

    return train_step


def prepare_datasets(
    cfg: Config, test_case: str
) -> Tuple[WindowDataset, np.ndarray, np.ndarray, WindowDataset]:
    """Leave-one-hurricane-out protocol (reference lit.py:143-175):
    (train+val dataset, train positions, val positions, test dataset)."""
    store = load_store(cfg.data.data_dir)
    train_val_cases, test_cases = leave_one_out(test_case)
    ds = WindowDataset.from_case_study(
        store, train_val_cases, cfg.data.dataset_range, cfg.data.horizon
    )
    test_ds = WindowDataset.from_case_study(
        store, test_cases, cfg.data.dataset_range, cfg.data.horizon
    )
    train_idx, val_idx = train_val_split(len(ds), cfg.data.val_fraction, cfg.train.seed)
    return ds, train_idx, val_idx, test_ds


PIPELINES = ("auto", "device", "host")


def pipeline_choice(cfg: Config, store) -> str:
    """"device" or "host", as JAX make_pipeline picks on one device
    (train/loop.py:155-190): "host" when asked; "device" when asked or
    when the float32 store's megabytes (bytes / 1e6) fit
    device_store_budget_mb; else "host". Any other value raises."""
    choice = cfg.data.pipeline
    if choice not in PIPELINES:
        raise ValueError(f"DataConfig.pipeline must be one of {PIPELINES}, got {choice!r}")
    if choice == "host":
        return "host"
    size_mb = store.frames.size * 4 / 1e6
    if choice == "device" or size_mb <= cfg.data.device_store_budget_mb:
        return "device"
    return "host"


def make_pipeline(cfg: Config, store, device, frame_transform=None,
                  mesh: Optional[Mesh] = None) -> Optional[DevicePipeline]:
    """The DevicePipeline of the store on `device` when pipeline_choice
    says "device", else None: _epoch_iter then streams batches through
    the host path. frame_transform ([B,N,T,H,W] float32 → [B,N,T,s,s,C])
    replaces the built-in Resize + Normalize on either path. With a mesh
    the pipeline gives each rank its part of a batch, and
    cfg.data.shard_store splits the store's dates over the data ranks."""
    if pipeline_choice(cfg, store) == "host":
        return None
    return DevicePipeline(store, cfg.data.mean, cfg.data.std, cfg.data.image_size,
                          getattr(torch, cfg.data.device_dtype), device,
                          frame_transform=frame_transform, mesh=mesh,
                          shard_store=cfg.data.shard_store)


def _epoch_iter(ds, idx, cfg: Config, shuffle: bool, seed: int, device_pipe, device,
                transform=None, frame_transform=None, mesh: Optional[Mesh] = None):
    """Every batch stream of fit, evaluate, predict and serve_eval (JAX
    train/loop.py:193-251, its single-device branches): the windows
    idx[b] for each index batch of batch_indices, from the device
    pipeline, or from a PrefetchIterator (depth cfg.data.prefetch) when
    device_pipe is None, with frame_transform in place of the built-in
    Resize + Normalize. transform, when given, maps each device batch
    dict→dict after the built-ins. With a mesh, _mesh_epoch_iter's
    batches. Closing the generator stops the prefetch thread."""
    if mesh is not None:
        yield from _mesh_epoch_iter(ds, idx, cfg, shuffle, seed, device_pipe, device, mesh,
                                    transform, frame_transform)
        return
    batches = (idx[b] for b in batch_indices(len(idx), cfg.train.batch_size, shuffle, seed))
    if device_pipe is not None:
        source = (device_pipe.batch(ds, b) for b in batches)
    else:
        source = iter(PrefetchIterator(
            ds, batches, cfg.data.mean, cfg.data.std, cfg.data.image_size, device,
            depth=cfg.data.prefetch, frame_transform=frame_transform,
        ))
    try:
        for batch in source:
            yield batch if transform is None else transform(batch)
    finally:
        source.close()


def _mesh_epoch_iter(ds, idx, cfg: Config, shuffle: bool, seed: int, device_pipe, device,
                     mesh: Mesh, transform=None, frame_transform=None):
    """The SPMD batch stream (JAX train/loop.py:254-325): every batch
    padded to the batch size by cycling its valid windows (np.resize), a
    'w' row of 1 for valid and 0 for pad rows; this rank gets its rows
    and its T slice, with its rows of 'w'. The device pipeline gathers
    only those; the host path gathers this rank's rows (all of T) and
    slices T on the device."""
    from multimodal_outage_tpu_torch.parallel.sharding import shard_local_batch

    bs = cfg.train.batch_size
    rows = local_batch_slice(bs, mesh)
    plan = []
    for b in batch_indices(len(idx), bs, shuffle, seed):
        sel = idx[b]
        w = np.ones((bs,), np.float32)
        if len(sel) < bs:
            w[len(sel):] = 0.0
            sel = np.resize(sel, bs)
        plan.append((sel, w))
    if device_pipe is not None:
        source = (device_pipe.batch(ds, sel) for sel, _ in plan)
    else:
        source = iter(PrefetchIterator(
            ds, (sel[rows] for sel, _ in plan), cfg.data.mean, cfg.data.std,
            cfg.data.image_size, device, depth=cfg.data.prefetch,
            frame_transform=frame_transform,
        ))
    try:
        for (_, w), batch in zip(plan, source):
            if device_pipe is None:  # this rank's rows, all of T: its T slice
                batch = shard_local_batch(mesh, batch)
            batch["w"] = torch.from_numpy(w[rows].copy()).to(device)
            yield batch if transform is None else transform(batch)
    finally:
        source.close()


def evaluate(
    predict_step, ds, idx, cfg: Config, supports, device_pipe,
    collect: Optional[Tuple[List[np.ndarray], List[np.ndarray]]] = None,
    transform=None, frame_transform=None, mesh: Optional[Mesh] = None,
) -> Dict[str, float]:
    """Mean of per-batch metrics (reference lit.py:100-106), each from the
    batch's one eval forward. With collect=(preds, targets), each batch's
    prediction and target are also appended there as host arrays. Batches
    come from _epoch_iter on the supports' device. With a mesh the
    metrics are the global batch's weighted ones and the collected arrays
    the global (padded) batches, on every rank."""
    from multimodal_outage_tpu_torch.parallel.sharding import gather_output

    agg = MeanAggregator()
    with closing(_epoch_iter(ds, idx, cfg, False, 0, device_pipe, supports.device,
                             transform, frame_transform, mesh)) as batches:
        for batch in batches:
            yhat = predict_step(batch, supports)
            if mesh is None:
                agg.update(regression_metrics(yhat, batch["y"]))
            else:
                agg.update(weighted_regression_metrics(yhat, batch["y"], batch["w"], mesh))
            if collect is not None:
                y = batch["y"]
                if mesh is not None:
                    yhat, y = gather_output(yhat, mesh), gather_output(y, mesh)
                collect[0].append(yhat.cpu().numpy())
                collect[1].append(y.cpu().numpy())
    return agg.compute()


def _ckpt_tree(state: TrainState, epoch: int, best_val: float, best_epoch: int, bad: int,
               mesh: Optional[Mesh] = None):
    """The checkpoint tree. On a mesh, the full tree gathered from the
    ranks' tensor-parallel shards (every rank takes part; rank 0 writes
    it), so any mesh, or none, reads it back."""
    v = module_variables(state.model)
    opt = state.opt.state_tree()
    if mesh is not None:
        from multimodal_outage_tpu_torch.parallel.sharding import gather_tree

        v = {"params": gather_tree(v["params"], mesh), "batch_stats": v["batch_stats"]}
        opt = {"mu": gather_tree(opt["mu"], mesh), "nu": gather_tree(opt["nu"], mesh),
               "count": opt["count"]}
    return {
        "params": v["params"],
        "batch_stats": v["batch_stats"],
        "opt_state": opt,
        "step": state.step,
        "meta": {"epoch": epoch, "best_val": best_val, "best_epoch": best_epoch,
                 "bad_epochs": bad},
    }


def _load_tree(model: torch.nn.Module, tree, mesh: Optional[Mesh] = None) -> None:
    """A full {"params", "batch_stats"} tree into the model, this rank's
    shards of it on a mesh."""
    params = tree["params"]
    if mesh is not None:
        from multimodal_outage_tpu_torch.parallel.sharding import shard_tree

        params = shard_tree(params, mesh)
    load_variables(model, {"params": params, "batch_stats": tree["batch_stats"]})


def _load_opt(state: TrainState, opt, mesh: Optional[Mesh] = None) -> None:
    if mesh is not None:
        from multimodal_outage_tpu_torch.parallel.sharding import shard_tree

        opt = {"mu": shard_tree(opt["mu"], mesh), "nu": shard_tree(opt["nu"], mesh),
               "count": opt["count"]}
    state.opt.load_state_tree(opt)


def _rank_stats(mesh: Mesh, values: List[float]) -> List[List[float]]:
    """Each rank's `values`, in rank order, on every rank (one all_reduce
    of a [world, k] table where each rank fills its row)."""
    import torch.distributed as dist

    table = torch.zeros(mesh.shape.size, len(values), dtype=torch.float64)
    table[mesh.rank] = torch.tensor(values, dtype=torch.float64)
    buf = table.to(mesh.device)
    dist.all_reduce(buf)
    return buf.cpu().tolist()


def _initial_variables(cfg: Config, n_counties: int, supports: np.ndarray):
    """init_variables from cfg.train.seed, with the Date2Vec bundle's
    fc1/fc2 installed when cfg.model.d2v_bundle names one (JAX
    train/state.py:53-59) and, for Graph WaveNet with randomadj False, the
    node embeddings from the SVD of supports[0] (JAX train/loop.py:478-489)."""
    variables = init_variables(cfg.model, cfg.data.horizon, n_counties, cfg.train.seed,
                               cfg.data.image_size)
    g = cfg.model.gwnet
    if cfg.model.st_gnn == "gwnet" and not g.randomadj:
        variables["params"] = install_aptinit(variables["params"], supports[0],
                                              g.node_embed_dim)
    if cfg.model.d2v_bundle:
        variables["params"] = install_bundle(variables["params"],
                                             load_bundle(cfg.model.d2v_bundle))
    return variables


def _agree(metrics: Dict[str, float], mesh: Optional[Mesh]) -> Dict[str, float]:
    """Rank 0's metrics on every rank, so that every rank takes the same
    early-stopping and checkpoint decisions."""
    if mesh is None or not metrics:
        return metrics
    from multimodal_outage_tpu_torch.parallel.collectives import broadcast

    keys = sorted(metrics)
    vals = broadcast(torch.tensor([metrics[k] for k in keys], dtype=torch.float64,
                                  device=mesh.device))
    return dict(zip(keys, vals.cpu().tolist()))


class _StepTrace:
    """The profiling window of fit (JAX train/loop.py:637-667): a
    torch.profiler session, CPU activity plus the card's, from the
    process's local step `log_every` for `profile_steps` steps; at its
    end the device is synchronized and a Chrome trace is written to
    <profile_dir>/trace.json, with the window's spans (core/tracing.py:
    train.step and its phases, pipeline.batch) on a track of their own.
    Leaving the `with` block closes and writes a window the loop left
    open, also on an exception."""

    def __init__(self, profile_dir: Optional[str], start: int, steps: int, dev: torch.device):
        self.dir, self.start, self.stop_at, self.dev = profile_dir, start, start + steps, dev
        self.prof = None

    def before_step(self, step_count: int) -> None:
        if self.dir and self.prof is None and step_count == self.start:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            tracing.clear()
            self.prof.start()

    def after_step(self, step_count: int) -> None:
        if self.prof is not None and step_count >= self.stop_at:
            self.stop()

    def __enter__(self) -> "_StepTrace":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def stop(self) -> None:
        if self.prof is None:
            return
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self.prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, "trace.json")
        self.prof.export_chrome_trace(path)
        merge_spans(path, tracing.spans())
        tracing.clear()
        self.prof = None


def merge_spans(path: str, spans: List[tracing.Span]) -> None:
    """Adds spans to the Chrome trace at `path` as complete events on a
    track of their own ("program spans"), on the file's time base (its
    baseTimeNanoseconds, where it has one), so an operator sees the
    program's phases beside the kernels."""
    with open(path) as f:
        trace = json.load(f)
    base, track = trace.get("baseTimeNanoseconds", 0), "program spans"
    trace["traceEvents"].append({"ph": "M", "name": "process_name", "pid": track, "tid": 0,
                                 "args": {"name": track}})
    trace["traceEvents"].extend(
        {"ph": "X", "cat": "program_span", "name": s.name, "pid": track, "tid": 0,
         "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": {"id": s.id, "parent": s.parent, "root": s.root, "device_ms": s.device_ms}}
        for s in spans)
    with open(path, "w") as f:
        json.dump(trace, f)


def fit(
    cfg: Config,
    test_case: str = "michael",
    run_dir: Optional[str] = None,
    progress: bool = True,
    device=None,
    transform=None,
    frame_transform=None,
) -> Dict[str, float]:
    """Train with early stopping; returns the best model's val and test
    metrics, plus the run's counts and, on the card, train_step_ms_p50:
    the median CUDA-event time of a train step after this process's
    first. train_steps is the global step (state.step, restored by a
    resume); eval_forwards counts this process's eval forwards.

    cfg.train.resume continues from the latest checkpoint, if there is
    one (else it starts fresh, as the JAX loop does): params, BN running
    statistics, Adam's moments and count, the global step, and the
    early-stopping state; the epoch after the checkpoint's is the first.
    The dropout generator and DCRNN's teacher-forcing coins and schedule
    are functions of (seed, global step) and the batch order of seed +
    epoch, so a resumed run repeats the uninterrupted one. The train
    rows' "step" and the profiling window count this process's steps
    (JAX train/loop.py:602, 637-667).

    transform (dict→dict on each device batch, after the built-ins) and
    frame_transform ([B,N,T,H,W] float32 → [B,N,T,s,s,C], in place of
    the built-in Resize + Normalize) reach every batch of the train
    loop, the val sweeps and the final val and test sweeps (JAX
    train/loop.py:407-424).

    When cfg.mesh resolves to more than one device, the run is SPMD over
    a mesh of ranks (module docstring; JAX train/loop.py:450-512), and
    the result is rank 0's, with "mesh" (its shape) and "ranks": per
    rank, its peak device memory (MiB, 0 on the CPU) and the host seconds
    inside collectives."""
    leave_one_out(test_case)  # fail fast on bad flags before any work
    check_supported(cfg)
    dev = resolve_device(device)
    shape = resolve_mesh(cfg, dev.type)
    if shape is not None:
        if cfg.train.grad_accum != 1:
            raise ValueError(_GRAD_ACCUM_ON_MESH)
        from multimodal_outage_tpu_torch.parallel import launch

        return launch.run(_fit_rank, shape, dev.type,
                          (cfg, test_case, run_dir, progress, transform, frame_transform),
                          progress=progress)
    return _fit(cfg, test_case, run_dir, progress, dev, transform, frame_transform)


def _fit_rank(mesh: Mesh, cfg: Config, test_case: str, run_dir, progress: bool, transform,
              frame_transform) -> Dict[str, float]:
    return _fit(cfg, test_case, run_dir, progress, mesh.device, transform, frame_transform, mesh)


def _fit(cfg: Config, test_case: str, run_dir, progress: bool, dev: torch.device, transform,
         frame_transform, mesh: Optional[Mesh] = None) -> Dict[str, float]:
    """fit's body, on one device (mesh None) or as one rank of a mesh."""
    main = mesh is None or mesh.is_main
    progress = progress and main
    run_dir = run_dir or os.path.join(cfg.train.checkpoint_dir, cfg.train.job_id)
    logger = (RunLogger(run_dir, config=asdict(cfg), tensorboard=cfg.train.tensorboard)
              if main else _NullLogger())
    ckpt = CheckpointManager(os.path.join(run_dir, "checkpoints"), cfg.train.keep_top_k)

    ds, train_idx, val_idx, test_ds = prepare_datasets(cfg, test_case)
    store = ds.store
    if progress:
        print(f"Size of train_set: {len(train_idx)}, val_set: {len(val_idx)}, "
              f"and test_set: {len(test_ds)}")
    static = config_supports(cfg, store)
    supports = torch.from_numpy(static).to(dev)
    horizon, size = cfg.data.horizon, cfg.data.image_size
    model = build_model(cfg.model, horizon, store.n_counties, size)
    load_variables(model, _initial_variables(cfg, store.n_counties, static))
    if progress:
        print(f"Model parameters: {param_count(model):,}")
    if mesh is not None:
        from multimodal_outage_tpu_torch.parallel import sharding

        sharding.shard_model(model, mesh)
    model.to(dev)
    state = create_train_state(model)
    if mesh is None:
        train_step = make_train_step(model, debug_nans=cfg.train.debug_nans)
        if cfg.train.grad_accum != 1:
            train_step = _grad_accum_step(cfg, model, train_step)
        predict_step = make_predict_step(model)
    else:
        train_step = sharding.make_sharded_train_step(model, mesh, weighted=True,
                                                      debug_nans=cfg.train.debug_nans)
        predict_step = sharding.make_sharded_predict_step(model, mesh)
    pipe = make_pipeline(cfg, store, dev, frame_transform, mesh)
    hooks = (transform, frame_transform, mesh)

    best_val, best_epoch, bad_epochs, start_epoch = float("inf"), -1, 0, 0
    if cfg.train.resume and ckpt.latest_step() is not None:
        tree = ckpt.restore_latest()
        _load_tree(model, tree, mesh)
        _load_opt(state, tree["opt_state"], mesh)
        state.step = int(tree["step"])
        meta = tree["meta"]
        start_epoch = int(meta["epoch"]) + 1
        best_val, best_epoch = float(meta["best_val"]), int(meta["best_epoch"])
        bad_epochs = int(meta["bad_epochs"])
        if progress:
            print(f"Resumed from epoch {start_epoch - 1} (best_val={best_val:.5f})")

    n_eval = lambda n: -(-n // cfg.train.batch_size)
    eval_forwards = 0
    step_count = 0  # this process's train steps
    trace = _StepTrace(cfg.train.profile_dir, cfg.train.log_every, cfg.train.profile_steps, dev)
    step_events: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []
    with trace:
        for epoch in range(start_epoch, cfg.train.epochs):
            lr = cosine_annealing_lr(epoch, cfg.train.lr, cfg.train.cosine_t_max)
            t0 = time.time()
            metric_sum: Dict[str, torch.Tensor] = {}
            metric_count = 0
            with closing(_epoch_iter(ds, train_idx, cfg, True, cfg.train.seed + epoch, pipe,
                                     dev, *hooks)) as batches:
                for batch in batches:
                    trace.before_step(step_count)
                    if dev.type == "cuda":
                        ev = tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
                        ev[0].record()
                    metrics = train_step(state, batch, supports, lr, cfg.train.seed)
                    if dev.type == "cuda":
                        ev[1].record()
                        step_events.append(ev)
                    step_count += 1
                    trace.after_step(step_count)
                    if step_count % cfg.train.log_every == 0:
                        logger.log({
                            "phase": "train", "epoch": epoch, "step": step_count, "lr": lr,
                            **{f"train_{k}": float(v) for k, v in metrics.items()},
                            **device_memory_stats(dev),
                        })
                    # accumulated on the device: no host sync per step
                    metric_sum = {k: metric_sum.get(k, 0) + v for k, v in metrics.items()}
                    metric_count += 1
            train_metrics = {k: float(v) / metric_count for k, v in metric_sum.items()}

            val_metrics = _agree(
                evaluate(predict_step, ds, val_idx, cfg, supports, pipe, None, *hooks), mesh)
            eval_forwards += n_eval(len(val_idx))
            dt = time.time() - t0
            tiles = len(train_idx) * store.n_counties * horizon
            logger.log({
                "phase": "val", "epoch": epoch, "epoch_seconds": dt,
                "train_tiles_per_sec": tiles / dt,
                **{f"val_{k}": v for k, v in val_metrics.items()},
            })
            if progress:
                print(f"epoch {epoch}: train_loss={train_metrics.get('loss', float('nan')):.5f} "
                      f"val_loss={val_metrics['loss']:.5f} ({dt:.1f}s, lr={lr:.2e})")
            if val_metrics["loss"] < best_val:
                best_val, best_epoch, bad_epochs = val_metrics["loss"], epoch, 0
            else:
                bad_epochs += 1
            tree = _ckpt_tree(state, epoch, best_val, best_epoch, bad_epochs, mesh)
            if main:
                ckpt.save(epoch, tree, metrics={"val_loss": val_metrics["loss"]})
            if mesh is not None:
                mesh.barrier()  # the files are in place before any rank reads them
            if bad_epochs >= cfg.train.early_stop_patience:
                if progress:
                    print(f"Early stopping at epoch {epoch}")
                break

    # the best checkpoint, swept over val and the held-out hurricane
    # (reference PrintMetricsCallback / TestBestModelCallback, lit.py:74-140)
    _load_tree(model, ckpt.restore(), mesh)
    final_val = evaluate(predict_step, ds, val_idx, cfg, supports, pipe, None, *hooks)
    final_test = evaluate(predict_step, test_ds, np.arange(len(test_ds)), cfg, supports, pipe,
                          None, *hooks)
    eval_forwards += n_eval(len(val_idx)) + n_eval(len(test_ds))
    results: Dict[str, float] = {
        "best_epoch": best_epoch,
        **{f"val_{k}": v for k, v in final_val.items()},
        **{f"test_{k}": v for k, v in final_test.items()},
        "train_steps": state.step,
        "eval_forwards": eval_forwards,
    }
    if len(step_events) > 1:
        times = sorted(a.elapsed_time(b) for a, b in step_events[1:])
        results["train_step_ms_p50"] = times[len(times) // 2]
    if mesh is not None:
        from multimodal_outage_tpu_torch.parallel.collectives import COLLECTIVE_SECONDS

        peak = (torch.cuda.max_memory_allocated(dev) / 2**20 if dev.type == "cuda" else 0.0)
        rows = _rank_stats(mesh, [peak, COLLECTIVE_SECONDS[0]])
        results["mesh"] = str(mesh.shape)
        results["ranks"] = [{"peak_mem_mb": r[0], "collective_s": r[1]} for r in rows]
    logger.log({"phase": "final", **results})
    if progress:
        print(
            "Best Model Metrics:\n"
            f"Validation Loss: {final_val['loss']}\nValidation MAE: {final_val['mae']}\n"
            f"Validation MAPE: {final_val['mape']}\nValidation RMSE: {final_val['rmse']}\n"
            f"Test Loss: {final_test['loss']}; Test MAE: {final_test['mae']}; "
            f"Test MAPE: {final_test['mape']}; Test RMSE: {final_test['rmse']}"
        )
    logger.close()
    return results


def predict(
    cfg: Config,
    checkpoint_dir: str,
    test_case: str,
    step: Optional[int] = None,
    device=None,
    transform=None,
    frame_transform=None,
) -> Tuple[np.ndarray, np.ndarray, Dict[str, float]]:
    """Sweep the held-out hurricane with a checkpoint (JAX train/loop.py:
    901-1010; reference tlit.py:46-94): the best step's (or `step`'s)
    params and batch_stats, the test windows in order at
    cfg.train.batch_size, through the sweep fit's final test sweep runs.
    Returns (preds, targets, metrics): float32 [S, N, T, H, W, 1] arrays
    and the mean of per-batch metrics. transform and frame_transform
    reach every batch, as in fit. On a mesh of more than one device the
    sweep is SPMD (batches padded, the weighted metrics equal to the
    ragged batch's), and the arrays are trimmed to the S windows."""
    require_checkpoints(checkpoint_dir)  # before any other work
    check_supported(cfg)
    dev = resolve_device(device)
    shape = resolve_mesh(cfg, dev.type)
    if shape is not None:
        from multimodal_outage_tpu_torch.parallel import launch

        return launch.run(_predict_rank, shape, dev.type,
                          (cfg, checkpoint_dir, test_case, step, transform, frame_transform))
    return _predict(cfg, checkpoint_dir, test_case, step, dev, transform, frame_transform)


def _predict_rank(mesh: Mesh, cfg, checkpoint_dir, test_case, step, transform,
                  frame_transform):
    out = _predict(cfg, checkpoint_dir, test_case, step, mesh.device, transform,
                   frame_transform, mesh)
    # a spawned rank's arrays would cross a pipe only to be dropped
    return out if mesh.is_main or torchrun_env() else None


def _predict(cfg: Config, checkpoint_dir: str, test_case: str, step: Optional[int],
             dev: torch.device, transform, frame_transform, mesh: Optional[Mesh] = None):
    store = load_store(cfg.data.data_dir)
    _, test_cases = leave_one_out(test_case)
    test_ds = WindowDataset.from_case_study(
        store, test_cases, cfg.data.dataset_range, cfg.data.horizon
    )
    if len(test_ds) == 0:
        raise ValueError(f"no test windows for {test_case!r} at dataset_range "
                         f"{cfg.data.dataset_range} and horizon {cfg.data.horizon}")
    supports = torch.from_numpy(config_supports(cfg, store)).to(dev)
    horizon, size = cfg.data.horizon, cfg.data.image_size
    model = build_model(cfg.model, horizon, store.n_counties, size)
    variables = restore_variables(checkpoint_dir, step)
    if mesh is None:
        load_variables(model, variables)
        step_fn = make_predict_step(model)
    else:
        from multimodal_outage_tpu_torch.parallel import sharding

        sharding.shard_model(model, mesh)
        _load_tree(model, variables, mesh)
        step_fn = sharding.make_sharded_predict_step(model, mesh)
    model.to(dev)
    pipe = make_pipeline(cfg, store, dev, frame_transform, mesh)
    preds: List[np.ndarray] = []
    targets: List[np.ndarray] = []
    metrics = evaluate(step_fn, test_ds, np.arange(len(test_ds)), cfg, supports, pipe,
                       (preds, targets), transform, frame_transform, mesh)
    # a mesh pads the tail batch: trim the pad rows off (JAX :1002-1008)
    n = len(test_ds)
    return np.concatenate(preds)[:n], np.concatenate(targets)[:n], metrics
