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

Not here yet (check_supported raises): mesh/SPMD with sample_weight.
"""

from __future__ import annotations

import gc
import os
import sys
import time
from contextlib import closing
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from multimodal_outage_tpu_torch.core.checkpoint import (
    CheckpointManager,
    require_checkpoints,
    restore_variables,
)
from multimodal_outage_tpu_torch.core.config import Config, asdict
from multimodal_outage_tpu_torch.core.device import resolve_device
from multimodal_outage_tpu_torch.core.metrics import MeanAggregator, regression_metrics
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


def check_supported(cfg: Config) -> None:
    """Raise on the settings this slice of the port does not run: a device
    mesh, and with it first grad_accum != 1, which JAX refuses on a mesh
    (train/loop.py:457-462)."""
    mesh = cfg.mesh
    if mesh.model != 1 or mesh.time != 1 or mesh.data not in (-1, 1):
        if cfg.train.grad_accum != 1:
            raise ValueError(
                "grad_accum (including auto) is a single-device-path "
                "feature; with a mesh, scale batch over the data axis "
                "instead"
            )
        raise NotImplementedError(
            "a device mesh: not in the port yet; it comes with the ROADMAP item "
            "'SPMD with sample_weight'"
        )


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


def make_pipeline(cfg: Config, store, device, frame_transform=None) -> Optional[DevicePipeline]:
    """The DevicePipeline of the store on `device` when pipeline_choice
    says "device", else None: _epoch_iter then streams batches through
    the host path. frame_transform ([B,N,T,H,W] float32 → [B,N,T,s,s,C])
    replaces the built-in Resize + Normalize on either path."""
    if pipeline_choice(cfg, store) == "host":
        return None
    return DevicePipeline(store, cfg.data.mean, cfg.data.std, cfg.data.image_size,
                          getattr(torch, cfg.data.device_dtype), device,
                          frame_transform=frame_transform)


def _epoch_iter(ds, idx, cfg: Config, shuffle: bool, seed: int, device_pipe, device,
                transform=None, frame_transform=None):
    """Every batch stream of fit, evaluate, predict and serve_eval (JAX
    train/loop.py:193-251, its single-device branches): the windows
    idx[b] for each index batch of batch_indices, from the device
    pipeline, or from a PrefetchIterator (depth cfg.data.prefetch) when
    device_pipe is None, with frame_transform in place of the built-in
    Resize + Normalize. transform, when given, maps each device batch
    dict→dict after the built-ins. Closing the generator stops the
    prefetch thread."""
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


def evaluate(
    predict_step, ds, idx, cfg: Config, supports, device_pipe,
    collect: Optional[Tuple[List[np.ndarray], List[np.ndarray]]] = None,
    transform=None, frame_transform=None,
) -> Dict[str, float]:
    """Mean of per-batch metrics (reference lit.py:100-106), each from the
    batch's one eval forward. With collect=(preds, targets), each batch's
    prediction and target are also appended there as host arrays. Batches
    come from _epoch_iter on the supports' device."""
    agg = MeanAggregator()
    with closing(_epoch_iter(ds, idx, cfg, False, 0, device_pipe, supports.device,
                             transform, frame_transform)) as batches:
        for batch in batches:
            yhat = predict_step(batch, supports)
            agg.update(regression_metrics(yhat, batch["y"]))
            if collect is not None:
                collect[0].append(yhat.cpu().numpy())
                collect[1].append(batch["y"].cpu().numpy())
    return agg.compute()


def _ckpt_tree(state: TrainState, epoch: int, best_val: float, best_epoch: int, bad: int):
    v = module_variables(state.model)
    return {
        "params": v["params"],
        "batch_stats": v["batch_stats"],
        "opt_state": state.opt.state_tree(),
        "step": state.step,
        "meta": {"epoch": epoch, "best_val": best_val, "best_epoch": best_epoch,
                 "bad_epochs": bad},
    }


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


class _StepTrace:
    """The profiling window of fit (JAX train/loop.py:637-667): a
    torch.profiler session, CPU activity plus the card's, from the
    process's local step `log_every` for `profile_steps` steps; at its
    end the device is synchronized and a Chrome trace is written to
    <profile_dir>/trace.json. Leaving the `with` block closes and writes
    a window the loop left open, also on an exception."""

    def __init__(self, profile_dir: Optional[str], start: int, steps: int, dev: torch.device):
        self.dir, self.start, self.stop_at, self.dev = profile_dir, start, start + steps, dev
        self.prof = None

    def before_step(self, step_count: int) -> None:
        if self.dir and self.prof is None and step_count == self.start:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
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
        self.prof.export_chrome_trace(os.path.join(self.dir, "trace.json"))
        self.prof = None


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
    train/loop.py:407-424)."""
    leave_one_out(test_case)  # fail fast on bad flags before any work
    check_supported(cfg)
    dev = resolve_device(device)
    run_dir = run_dir or os.path.join(cfg.train.checkpoint_dir, cfg.train.job_id)
    logger = RunLogger(run_dir, config=asdict(cfg), tensorboard=cfg.train.tensorboard)
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
    model.to(dev)
    state = create_train_state(model)
    if progress:
        print(f"Model parameters: {param_count(model):,}")
    train_step = make_train_step(model, debug_nans=cfg.train.debug_nans)
    if cfg.train.grad_accum != 1:
        train_step = _grad_accum_step(cfg, model, train_step)
    predict_step = make_predict_step(model)
    pipe = make_pipeline(cfg, store, dev, frame_transform)
    hooks = (transform, frame_transform)

    best_val, best_epoch, bad_epochs, start_epoch = float("inf"), -1, 0, 0
    if cfg.train.resume and ckpt.latest_step() is not None:
        tree = ckpt.restore_latest()
        load_variables(model, tree)
        state.opt.load_state_tree(tree["opt_state"])
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

            val_metrics = evaluate(predict_step, ds, val_idx, cfg, supports, pipe, None, *hooks)
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
            ckpt.save(epoch, _ckpt_tree(state, epoch, best_val, best_epoch, bad_epochs),
                      metrics={"val_loss": val_metrics["loss"]})
            if bad_epochs >= cfg.train.early_stop_patience:
                if progress:
                    print(f"Early stopping at epoch {epoch}")
                break

    # the best checkpoint, swept over val and the held-out hurricane
    # (reference PrintMetricsCallback / TestBestModelCallback, lit.py:74-140)
    load_variables(model, ckpt.restore())
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
    901-1010, its single-device branch; reference tlit.py:46-94): the best
    step's (or `step`'s) params and batch_stats, the test windows in
    order at cfg.train.batch_size, through the sweep fit's final test
    sweep runs. Returns (preds, targets, metrics): float32 [S, N, T, H, W,
    1] arrays and the mean of per-batch metrics. transform and
    frame_transform reach every batch, as in fit."""
    require_checkpoints(checkpoint_dir)  # before any other work
    check_supported(cfg)
    dev = resolve_device(device)
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
    load_variables(model, restore_variables(checkpoint_dir, step))
    model.to(dev)
    pipe = make_pipeline(cfg, store, dev, frame_transform)
    preds: List[np.ndarray] = []
    targets: List[np.ndarray] = []
    metrics = evaluate(make_predict_step(model), test_ds, np.arange(len(test_ds)), cfg,
                       supports, pipe, (preds, targets), transform, frame_transform)
    return np.concatenate(preds), np.concatenate(targets), metrics
