"""The system under test, as the benchmark drives it: the only module of
the benchmark that imports multimodal_outage_tpu_torch. It builds the
program's own objects from the configuration's file and the inputs the
benchmark made, and returns them; the drivers call their entry points.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from multimodal_outage_tpu_torch.core.config import DCRNNConfig, GWNetConfig, ModelConfig
from multimodal_outage_tpu_torch.data.dataset import WindowDataset
from multimodal_outage_tpu_torch.data.pipeline import DevicePipeline
from multimodal_outage_tpu_torch.data.store import NTLStore
from multimodal_outage_tpu_torch.models.fusion import build_model
from multimodal_outage_tpu_torch.serving import ServingModel
from multimodal_outage_tpu_torch.train.state import create_train_state
from multimodal_outage_tpu_torch.train.steps import make_train_step
from multimodal_outage_tpu_torch.weights import load_variables


def model_config(model: Dict) -> ModelConfig:
    """The configuration file's "model" group as the program's ModelConfig
    (every key a field of it; gwnet and dcrnn nested)."""
    top = {k: v for k, v in model.items() if k not in ("gwnet", "dcrnn")}
    return ModelConfig(gwnet=GWNetConfig(**model["gwnet"]), dcrnn=DCRNNConfig(**model["dcrnn"]),
                       **top)


def store(frames: np.ndarray, dates: np.ndarray, n: int) -> NTLStore:
    names = [f"county_{i:03d}" for i in range(n)]
    return NTLStore(frames=frames, dates=dates, county_names=names, meta={"synthetic": True})


def dataset(st: NTLStore, cases, dataset_range: int, horizon: int) -> WindowDataset:
    return WindowDataset.from_case_study(st, cases, dataset_range, horizon)


def pipeline(st: NTLStore, data: Dict, model: Dict, device) -> DevicePipeline:
    """The device-resident store (the program's DevicePipeline), batches in
    the compute dtype."""
    return DevicePipeline(st, data["mean"], data["std"], data["image_size"],
                          getattr(torch, model["compute_dtype"]), torch.device(device))


def engine(model: Dict, variables: Dict, supports: np.ndarray, horizon: int, device) -> ServingModel:
    return ServingModel(model_config(model), variables, supports, horizon=horizon,
                        device=str(device))


def trainer(model: Dict, variables: Dict, horizon: int, n: int, size: int,
            device) -> Tuple[torch.nn.Module, object, object]:
    """(module, train state, train step) as the program's fit builds them."""
    m = build_model(model_config(model), horizon, n, size)
    load_variables(m, variables)
    m.to(device)
    return m, create_train_state(m), make_train_step(m)


def adam_moments(state) -> Dict[str, torch.Tensor]:
    """The optimizer's first moments by slash path."""
    return state.opt.mu


def named_parameters(state) -> Dict[str, torch.Tensor]:
    return state.opt.params

