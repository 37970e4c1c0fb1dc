"""Regression metrics on tensors (reference lit.py:24-27,36-38: MSELoss +
torchmetrics MAE/MAPE/MSE, RMSE = sqrt(MSE)); final metrics are the mean
of per-batch values (reference lit.py:100-106)."""

from __future__ import annotations

from typing import Dict

import torch

# torchmetrics MeanAbsolutePercentageError clamps |target| at this epsilon.
MAPE_EPS = 1.17e-06


def regression_metrics(
    yhat: torch.Tensor, y: torch.Tensor
) -> Dict[str, torch.Tensor]:
    err = yhat - y
    sq = torch.mean(torch.square(err))
    return {
        "loss": sq,
        "mae": torch.mean(torch.abs(err)),
        "mape": torch.mean(torch.abs(err) / torch.clamp(torch.abs(y), min=MAPE_EPS)),
        "rmse": torch.sqrt(sq),
    }


class MeanAggregator:
    """Host-side running mean of per-batch metric dicts."""

    def __init__(self):
        self._sums: Dict[str, float] = {}
        self._count = 0

    def update(self, metrics: Dict[str, torch.Tensor]) -> None:
        for k, v in metrics.items():
            self._sums[k] = self._sums.get(k, 0.0) + float(v)
        self._count += 1

    @property
    def count(self) -> int:
        return self._count

    def compute(self) -> Dict[str, float]:
        if self._count == 0:
            return {}
        return {k: v / self._count for k, v in self._sums.items()}
