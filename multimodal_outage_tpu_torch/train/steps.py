"""Train and eval steps (JAX train/steps.py:39-271).

A train step: forward in train mode (per-group BatchNorm statistics,
running-stat EMA, dropout), MSE loss, backward, Adam at `lr`, and the
regression metrics of the step's predictions. PyTorch runs it eagerly;
the parameters, BN running stats and Adam moments are updated in place.
With DCRNN's teacher forcing on, the step also passes the ground-truth
future frames, the step's sampling probability and the coins' generator
to the model. With debug_nans the step raises FloatingPointError at the
first non-finite value, as the JAX package's jax_debug_nans does.

make_accum_train_step runs one step as `accum` equal microbatches in
order, each a forward and a backward that adds into .grad, then one Adam
update with the mean of their gradients (JAX make_accum_train_step).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import numpy as np
import torch

from multimodal_outage_tpu_torch.core.metrics import regression_metrics
from multimodal_outage_tpu_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The dropout generator of one step: a function of (seed, step), as
    the JAX step folds the step into its key (steps.py:94)."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + step)


def sampling_generator(seed: int, step: int, micro: Optional[int] = None) -> torch.Generator:
    """The CPU generator of one step's teacher-forcing coins: a function of
    (seed, step) on a stream apart from the dropout generator's, as the
    JAX step folds 0x5a into its dropout key (steps.py:64-71). The same on
    the CPU and on the card. The seed is hashed into the 32 bits that the
    CPU generator reads. micro j gives microbatch j of an accumulating
    step its own stream (JAX steps.py:186-189)."""
    spawn = () if micro is None else (micro,)
    state = np.random.SeedSequence([seed, step, 0x5A], spawn_key=spawn).generate_state(1)[0]
    return torch.Generator().manual_seed(int(state))


def microbatch_generator(seed: int, step: int, micro: int,
                         device: torch.device) -> torch.Generator:
    """The dropout generator of microbatch `micro` of an accumulating step:
    a function of (seed, step, micro), another for each microbatch and
    apart from the one-shot step's, as JAX folds the microbatch index into
    the step's key (steps.py:186-188)."""
    state = np.random.SeedSequence([seed, step, 0xACC], spawn_key=(micro,)).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def uses_teacher_forcing(model: torch.nn.Module) -> bool:
    """True when the fusion model's DCRNN scheduled-sampling knob is on
    (JAX steps.py:39-48)."""
    cfg = getattr(model, "cfg", None)
    return (cfg is not None and getattr(cfg, "st_gnn", None) == "dcrnn"
            and cfg.dcrnn.teacher_forcing > 0.0)


def tf_schedule(model: torch.nn.Module, step: int) -> np.float32:
    """The sampling probability at `step`, in float32 (JAX steps.py:51-61):
    the constant p₀ = cfg.dcrnn.teacher_forcing, or with tf_decay_steps
    τ > 0 the inverse-sigmoid curriculum p₀·τ/(τ + e^{step/τ})."""
    d = model.cfg.dcrnn
    p0 = np.float32(d.teacher_forcing)
    if d.tf_decay_steps <= 0:
        return p0
    tau = np.float32(d.tf_decay_steps)
    return p0 * tau / (tau + np.exp(np.float32(step) / tau))


def _check_finite(v: torch.Tensor, what: str, step: int) -> None:
    if not bool(torch.isfinite(v).all()):
        raise FloatingPointError(f"debug_nans: non-finite {what} at step {step}")


def _forward_backward(model: torch.nn.Module, batch: Batch, supports: Optional[torch.Tensor],
                      gen: torch.Generator, teacher: dict, debug_nans: bool,
                      step: int) -> torch.Tensor:
    """One train-mode forward, its MSE and the backward that adds the
    gradients into .grad; returns the detached prediction."""
    anomaly = (torch.autograd.detect_anomaly(check_nan=True) if debug_nans
               else contextlib.nullcontext())
    with anomaly:
        yhat = model(batch["x"], batch["date_feats"], supports, train=True, generator=gen,
                     **teacher)
        loss = torch.mean(torch.square(yhat - batch["y"]))
        if debug_nans:
            _check_finite(yhat, "forward output", step)
            _check_finite(loss, "loss", step)
        try:
            loss.backward()
        except RuntimeError as e:  # detect_anomaly's report of a NaN gradient
            if debug_nans and "nan values" in str(e):
                raise FloatingPointError(f"debug_nans: step {step}: {e}") from e
            raise
    return yhat.detach()


def make_train_step(model: torch.nn.Module,
                    debug_nans: bool = False) -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns train_step(state, batch, supports, lr, seed) → metrics: the
    step's {"loss", "mae", "mape", "rmse"} as detached 0-d tensors (no
    host sync). The step's gradients stay in each parameter's .grad until
    the next step.

    debug_nans: the forward output and the loss are checked on the host
    each step (a sync), and the backward runs under
    torch.autograd.detect_anomaly(check_nan=True) for that step only;
    either raises FloatingPointError at the first NaN or inf (backward:
    NaN), before the parameters are updated."""
    params = [p for p in model.parameters() if p.requires_grad]
    teacher = uses_teacher_forcing(model)

    def train_step(
        state: TrainState, batch: Batch, supports: Optional[torch.Tensor],
        lr: float, seed: int,
    ) -> Dict[str, torch.Tensor]:
        for p in params:
            p.grad = None
        gen = step_generator(seed, state.step, batch["x"].device)
        kw = {}
        if teacher:  # at the step count before this step increments it
            kw = {"targets": batch["y"], "tf_prob": float(tf_schedule(model, state.step)),
                  "sampling": sampling_generator(seed, state.step)}
        yhat = _forward_backward(model, batch, supports, gen, kw, debug_nans, state.step)
        state.opt.step(lr)
        state.step += 1
        with torch.no_grad():
            return regression_metrics(yhat, batch["y"])

    return train_step


def make_accum_train_step(model: torch.nn.Module, accum: int,
                          debug_nans: bool = False) -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns the gradient-accumulation train step (JAX train/steps.py:
    135-237), called as make_train_step's: the flat batch [b, ...], b
    divisible by accum, is split along dim 0 into accum equal views, run
    in order, each a train-mode forward on the live BatchNorm buffers and
    a backward that adds into .grad; then the gradients are divided by
    accum and Adam takes one step. accum == 1 is make_train_step itself.

    This is the full batch's step: the MSE is a mean over the batch, so
    the mean of equal microbatches' gradients is its gradient; BatchNorm
    normalizes each (sample, county) group on its own, and the serial EMA
    run microbatch after microbatch telescopes into one serial pass over
    all groups in order. Each microbatch draws dropout from its own
    generator (microbatch_generator), and with teacher forcing its coins
    from its own stream, at the step's probability. The metrics are the
    microbatches' means, with rmse = √loss (the full batch's)."""
    if accum == 1:
        return make_train_step(model, debug_nans)
    params = [p for p in model.parameters() if p.requires_grad]
    teacher = uses_teacher_forcing(model)

    def train_step(
        state: TrainState, batch: Batch, supports: Optional[torch.Tensor],
        lr: float, seed: int,
    ) -> Dict[str, torch.Tensor]:
        b = batch["x"].shape[0]
        if b % accum:
            raise ValueError(f"batch of {b} does not split into {accum} equal microbatches")
        mb = b // accum
        for p in params:
            p.grad = None
        tf_prob = float(tf_schedule(model, state.step)) if teacher else None
        sums: Dict[str, torch.Tensor] = {}
        for j in range(accum):
            part = {k: v[j * mb:(j + 1) * mb] for k, v in batch.items()}
            gen = microbatch_generator(seed, state.step, j, part["x"].device)
            kw = {}
            if teacher:
                kw = {"targets": part["y"], "tf_prob": tf_prob,
                      "sampling": sampling_generator(seed, state.step, j)}
            yhat = _forward_backward(model, part, supports, gen, kw, debug_nans, state.step)
            with torch.no_grad():
                for k, v in regression_metrics(yhat, part["y"]).items():
                    sums[k] = sums[k] + v if k in sums else v
            del yhat
        for p in params:
            if p.grad is not None:
                p.grad.div_(accum)
        state.opt.step(lr)
        state.step += 1
        metrics = {k: v / accum for k, v in sums.items()}
        metrics["rmse"] = torch.sqrt(metrics["loss"])
        return metrics

    return train_step


def make_predict_step(model: torch.nn.Module) -> Callable[..., torch.Tensor]:
    """Returns predict_step(batch, supports) → the eval-mode forward's
    float32 prediction (running BN statistics, no dropout)."""

    @torch.no_grad()
    def predict_step(batch: Batch, supports: Optional[torch.Tensor]) -> torch.Tensor:
        return model(batch["x"], batch["date_feats"], supports, train=False)

    return predict_step
