"""Train and eval steps (JAX train/steps.py:74-132, 240-271).

A train step: forward in train mode (per-group BatchNorm statistics,
running-stat EMA, dropout), MSE loss, backward, Adam at `lr`, and the
regression metrics of the step's predictions. PyTorch runs it eagerly;
the parameters, BN running stats and Adam moments are updated in place.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from multimodal_outage_tpu_torch.core.metrics import regression_metrics
from multimodal_outage_tpu_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The dropout generator of one step: a function of (seed, step), as
    the JAX step folds the step into its key (steps.py:94)."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + step)


def make_train_step(model: torch.nn.Module) -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns train_step(state, batch, supports, lr, seed) → metrics: the
    step's {"loss", "mae", "mape", "rmse"} as detached 0-d tensors (no
    host sync). The step's gradients stay in each parameter's .grad until
    the next step."""
    params = [p for p in model.parameters() if p.requires_grad]

    def train_step(
        state: TrainState, batch: Batch, supports: Optional[torch.Tensor],
        lr: float, seed: int,
    ) -> Dict[str, torch.Tensor]:
        for p in params:
            p.grad = None
        x = batch["x"]
        gen = step_generator(seed, state.step, x.device)
        yhat = model(x, batch["date_feats"], supports, train=True, generator=gen)
        loss = torch.mean(torch.square(yhat - batch["y"]))
        loss.backward()
        state.opt.step(lr)
        state.step += 1
        with torch.no_grad():
            return regression_metrics(yhat.detach(), batch["y"])

    return train_step


def make_predict_step(model: torch.nn.Module) -> Callable[..., torch.Tensor]:
    """Returns predict_step(batch, supports) → the eval-mode forward's
    float32 prediction (running BN statistics, no dropout)."""

    @torch.no_grad()
    def predict_step(batch: Batch, supports: Optional[torch.Tensor]) -> torch.Tensor:
        return model(batch["x"], batch["date_feats"], supports, train=False)

    return predict_step
