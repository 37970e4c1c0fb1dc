"""Regression metrics on tensors (reference lit.py:24-27,36-38: MSELoss +
torchmetrics MAE/MAPE/MSE, RMSE = sqrt(MSE)); final metrics are the mean
of per-batch values (reference lit.py:100-106). On a mesh,
weighted_regression_metrics reduces its sums over the data and time
ranks, so every rank returns the global batch's values."""

from __future__ import annotations

from typing import Dict

import torch

from multimodal_outage_tpu_torch.core.mesh import TIME_AXIS

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


def weighted_regression_metrics(
    yhat: torch.Tensor, y: torch.Tensor, w: torch.Tensor, mesh=None
) -> Dict[str, torch.Tensor]:
    """regression_metrics with per-sample weights w [B] (1 valid, 0 pad;
    JAX core/metrics.py:52-78): each metric is Σ w·(per-sample mean) /
    max(Σ w, 1), which on a padded tail equals the plain metric of the
    valid rows, the reference's ragged final batch. With a mesh (core/
    mesh.py), yhat, y and w are this rank's rows and T slice: the three
    weighted sums are summed over the data × time ranks and Σ w over the
    data ranks (the time ranks of a row hold the same w), so every rank
    returns the global batch's metrics."""
    w = w.to(y.device, torch.float32)
    err = (yhat - y).reshape(y.shape[0], -1)
    ape = err.abs() / torch.clamp(y.reshape(y.shape[0], -1).abs(), min=MAPE_EPS)
    per = float(err.shape[1]) * (1 if mesh is None else mesh.shape.time)
    sums = torch.stack([
        torch.sum(w * (err.square().sum(1) / per)),
        torch.sum(w * (err.abs().sum(1) / per)),
        torch.sum(w * (ape.sum(1) / per)),
        # Σ w once per row: only time coordinate 0 counts it
        w.sum() if mesh is None or mesh.coord(TIME_AXIS) == 0 else w.sum() * 0,
    ])
    if mesh is not None:
        from multimodal_outage_tpu_torch.parallel.collectives import all_reduce

        sums = all_reduce(sums, mesh.group("data_time"))
    wsum = torch.clamp(sums[3], min=1.0)
    sq = sums[0] / wsum
    return {"loss": sq, "mae": sums[1] / wsum, "mape": sums[2] / wsum, "rmse": torch.sqrt(sq)}


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
