"""Train state and optimizer (JAX train/state.py).

Adam with optax.scale_by_adam's defaults (β1 0.9, β2 0.999, ε 1e-8, no
ε_root) and the learning rate applied by the step, so that the per-epoch
cosine schedule (reference lit.py:59-72) is a plain argument. The update
is done in place on the float32 master parameters.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict

import torch
import torch.nn as nn

from multimodal_outage_tpu_torch.weights import flatten, unflatten


class Adam:
    """optax.chain(scale_by_adam(), scale(-1)) followed by p += lr·u
    (JAX train/state.py:28-30, train/steps.py:113-115):

        μ ← β1·μ + (1−β1)·g,  ν ← β2·ν + (1−β2)·g²,  k ← k + 1
        p ← p − lr · (μ / (1−β1^k)) / (√(ν / (1−β2^k)) + ε)

    Moments are kept per parameter path. A parameter that takes no
    gradient (a frozen Date2Vec) keeps zero moments and is not moved, as
    a zero gradient leaves it in optax."""

    def __init__(self, model: nn.Module, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.params = {k.replace(".", "/"): p for k, p in model.named_parameters()}
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, lr: float) -> None:
        self.count += 1
        c1 = 1.0 - self.b1**self.count
        c2 = 1.0 - self.b2**self.count
        for k, p in self.params.items():
            if p.grad is None:
                continue
            g, mu, nu = p.grad, self.mu[k], self.nu[k]
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(lr * ((mu / c1) / ((nu / c2).sqrt() + self.eps)))

    def state_tree(self) -> Dict[str, Any]:
        return {"mu": unflatten(dict(self.mu)), "nu": unflatten(dict(self.nu)),
                "count": self.count}

    @torch.no_grad()
    def load_state_tree(self, tree: Dict[str, Any]) -> None:
        """The inverse of state_tree(): copy the moments onto the live
        parameters' devices and dtypes and set the step count, which sets
        the bias correction. Every parameter path must be given, and no
        other."""
        for name in ("mu", "nu"):
            given = flatten(tree[name])
            missing = sorted(set(self.params) - set(given))
            extra = sorted(set(given) - set(self.params))
            if missing or extra:
                raise ValueError(f"Adam {name}: missing {missing}, extra {extra}")
            for k, dst in getattr(self, name).items():
                if tuple(given[k].shape) != tuple(dst.shape):
                    raise ValueError(f"Adam {name} {k}: shape {tuple(given[k].shape)} given, "
                                     f"{tuple(dst.shape)} wanted")
                dst.copy_(torch.as_tensor(given[k]).to(dst.device, dst.dtype))
        self.count = int(tree["count"])


@dataclass
class TrainState:
    """The model (params + BN running stats), its optimizer and the step
    count. Steps update all three in place."""

    model: nn.Module
    opt: Adam
    step: int = 0


def create_train_state(model: nn.Module) -> TrainState:
    return TrainState(model=model, opt=Adam(model), step=0)


def cosine_annealing_lr(epoch: int, base_lr: float, t_max: int) -> float:
    """torch.optim.lr_scheduler.CosineAnnealingLR with eta_min=0, stepped
    per epoch (JAX train/state.py:33-38):
        lr(e) = base_lr · (1 + cos(π·e / T_max)) / 2
    """
    return base_lr * (1.0 + math.cos(math.pi * epoch / t_max)) / 2.0


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
