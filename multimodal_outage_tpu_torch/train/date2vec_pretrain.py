"""Date2Vec pretraining (the port's copy of JAX train/date2vec_pretrain.py).

The reference loads a pretrained Date2Vec checkpoint that is not in its
snapshot (reference utils.py:108-109). This trains a replacement: the
autoencoder (models/date2vec.py Date2VecAutoencoder) learns to
reconstruct normalized [0, 0, 0, y, m, d] vectors over a span of years,
the normalization is folded into fc1/fc2, and the params are saved as a
flat .npz bundle that the fusion model's `date2vec` subtree takes
(`--d2v_bundle`). The bundle's names and layouts are the JAX package's
(`fc1/kernel`, `fc1/bias`, …, Dense kernels [in, out]), so either package
reads the other's bundle.
"""

from __future__ import annotations

import datetime
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from multimodal_outage_tpu_torch.core.device import resolve_device
from multimodal_outage_tpu_torch.models.date2vec import Date2VecAutoencoder
from multimodal_outage_tpu_torch.train.state import Adam
from multimodal_outage_tpu_torch.weights import (
    date2vec_autoencoder,
    flatten,
    init_date2vec,
    unflatten,
)

Tree = Dict[str, Any]


def date_vector_dataset(start_year: int = 2012, end_year: int = 2026) -> np.ndarray:
    """Every [0, 0, 0, y, m, d] vector of the year span, float32."""
    start = datetime.date(start_year, 1, 1)
    n = (datetime.date(end_year, 12, 31) - start).days + 1
    rows = np.zeros((n, 6), np.float32)
    for i in range(n):
        d = start + datetime.timedelta(days=i)
        rows[i, 3:] = (d.year, d.month, d.day)
    return rows


# The date-feature normalization of pretraining only; _fold_normalization
# moves it into fc1/fc2, so the saved encoder takes raw [0,0,0,y,m,d]
# vectors as the reference checkpoint did.
_OFFSET = np.array([0, 0, 0, 2019.0, 6.5, 15.5], np.float32)
_SCALE = np.array([1, 1, 1, 8.0, 3.5, 9.0], np.float32)


def _fold_normalization(params: Tree) -> Tree:
    """numpy params with fc1/fc2 rewritten so that fc(x_raw) ==
    fc_trained((x_raw − off)/sc): W' = W / sc[:, None], b' = b − (off/sc)·W."""
    out = {k: {kk: np.asarray(vv) for kk, vv in v.items()} for k, v in params.items()}
    for layer in ("fc1", "fc2"):
        w, b = out[layer]["kernel"], out[layer]["bias"]
        out[layer] = {"kernel": w / _SCALE[:, None], "bias": b - (_OFFSET / _SCALE) @ w}
    return out


def pretrain_step(model: Date2VecAutoencoder, opt: Adam, batch: torch.Tensor, lr: float,
                  train: bool = True, generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """One step of optax.adam(lr) on the reconstruction MSE of `batch`
    (normalized date vectors); returns the step's loss, not synced."""
    model.zero_grad(set_to_none=True)
    loss = torch.mean(torch.square(model(batch, train=train, generator=generator) - batch))
    loss.backward()
    opt.step(lr)
    return loss.detach()


def pretrain_date2vec(
    k: int = 64,
    steps: int = 2000,
    batch_size: int = 256,
    lr: float = 1e-3,
    seed: int = 42,
    device=None,
) -> Tuple[Tree, float]:
    """Train the autoencoder on normalized dates, then fold the
    normalization into the encoder; returns (numpy params fc1..fc5, the
    last step's loss). The batches are the JAX package's
    (np.random.default_rng(seed).integers); the init (init_date2vec) and
    the dropout masks (a torch generator from `seed`) are the port's. Runs
    on the card unless device="cpu"."""
    dev = resolve_device(device)
    data = torch.from_numpy((date_vector_dataset() - _OFFSET) / _SCALE).to(dev)
    model = date2vec_autoencoder(init_date2vec(k, seed)).to(dev)
    opt = Adam(model)
    gen = torch.Generator(device=dev).manual_seed(seed)
    np_rng = np.random.default_rng(seed)
    loss = torch.tensor(float("inf"))
    for _ in range(steps):
        idx = torch.from_numpy(np_rng.integers(0, data.shape[0], batch_size)).to(dev)
        loss = pretrain_step(model, opt, data[idx], lr, generator=gen)
    trained = unflatten({name.replace(".", "/"): v.detach().cpu().numpy()
                         for name, v in model.named_parameters()})
    return _fold_normalization(trained), float(loss)


def save_bundle(params: Tree, path: str) -> None:
    """Flat .npz of the params, `<layer>/<kernel|bias>` (no pickled code)."""
    np.savez(path, **{k: np.asarray(v) for k, v in flatten(params).items()})


def load_bundle(path: str) -> Tree:
    """.npz → the nested numpy params of the date2vec subtree."""
    with np.load(path) as f:
        return unflatten({name: f[name] for name in f.files})


def install_bundle(params: Tree, bundle: Tree) -> Tree:
    """The model params with date2vec's encoder layers (fc1, fc2, the ones
    the fusion forward uses) replaced by the bundle's, as float32 tensors."""
    d2v = dict(params["date2vec"])
    for key in ("fc1", "fc2"):
        if key in bundle:
            d2v[key] = {p: torch.from_numpy(np.array(v, np.float32))
                        for p, v in bundle[key].items()}
    return {**params, "date2vec": d2v}
