"""Resume in the port (train/loop.py fit with cfg.train.resume,
core/checkpoint.py restore_latest, train/state.py Adam.load_state_tree)
on the CPU, float32, on the tiny store (4 counties, 16², horizon 3, B=2,
dataset_range 6: 7 train steps an epoch).

A resumed run is held to the uninterrupted run bitwise: the dropout
generator and DCRNN's teacher-forcing coins and schedule are functions of
(seed, global step), the batch order of (seed + epoch), and the restored
params, BatchNorm statistics and Adam state are the saved tensors
themselves. The JAX package's own resume test is `slow` and is not run
here; the port's fit is held to the JAX step elsewhere
(tests/test_torch_port_train.py, tests/test_torch_port_dcrnn_train.py).
"""

import json
import os

import pytest
import torch

from multimodal_outage_tpu_torch import weights
from multimodal_outage_tpu_torch.core.checkpoint import CheckpointManager
from multimodal_outage_tpu_torch.core.config import (
    Config,
    DataConfig,
    DCRNNConfig,
    GWNetConfig,
    ModelConfig,
    TrainConfig,
)
from multimodal_outage_tpu_torch.models.date2vec import Date2VecAutoencoder
from multimodal_outage_tpu_torch.train import loop
from multimodal_outage_tpu_torch.train.state import Adam

# narrow models: resume is exact at any width
NARROW = dict(compute_dtype="float32", base_channels=2, depth=2, feature_vector_size=8,
              compression_factor=2, time_embed_size=8)
MODELS = {
    "gwnet": ModelConfig(**NARROW, gwnet=GWNetConfig(
        residual_channels=4, dilation_channels=4, skip_channels=8, end_channels=8,
        blocks=1, layers=2, node_embed_dim=2)),
    "dcrnn_tf": ModelConfig(**NARROW, st_gnn="dcrnn", dcrnn=DCRNNConfig(
        rnn_units=8, teacher_forcing=0.5, tf_decay_steps=3)),
}


def _cfg(store_dir, model, epochs, resume=False):
    return Config(
        data=DataConfig(data_dir=store_dir, image_size=16, horizon=3, dataset_range=6),
        model=model,
        train=TrainConfig(batch_size=2, epochs=epochs, seed=0, resume=resume),
    )


def _fit(cfg, run_dir):
    return loop.fit(cfg, test_case="michael", run_dir=str(run_dir), progress=False,
                    device="cpu")


def _rows(run_dir, phase):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["phase"] == phase]


def _val_metrics(run_dir):
    return [{k: v for k, v in r.items() if k.startswith("val_")} for r in _rows(run_dir, "val")]


def _assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    elif torch.is_tensor(a):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


@pytest.mark.parametrize("name", list(MODELS))
def test_resumed_fit_equals_the_uninterrupted_fit(name, tiny_store_dir, tmp_path):
    """fit straight for 3 epochs == fit for 1 epoch, then resume to 3:
    every checkpoint (params, BN stats, Adam moments and count, step,
    early-stopping meta) and the final metrics bitwise, the val rows
    epochs 0, 1, 2 once each. resume=True with no checkpoint is a fresh
    run: its first epoch is the straight run's."""
    model = MODELS[name]
    straight = _fit(_cfg(tiny_store_dir, model, 3), tmp_path / "straight")
    first = _fit(_cfg(tiny_store_dir, model, 1, resume=True), tmp_path / "resumed")
    assert first["train_steps"] == 7
    assert _val_metrics(tmp_path / "resumed") == _val_metrics(tmp_path / "straight")[:1]
    resumed = _fit(_cfg(tiny_store_dir, model, 3, resume=True), tmp_path / "resumed")

    assert [r["epoch"] for r in _rows(tmp_path / "resumed", "val")] == [0, 1, 2]
    drop = ("eval_forwards",)  # counts this process's eval forwards
    assert {k: v for k, v in resumed.items() if k not in drop} == \
        {k: v for k, v in straight.items() if k not in drop}
    assert resumed["train_steps"] == straight["train_steps"] == 21
    a = CheckpointManager(str(tmp_path / "straight" / "checkpoints"))
    b = CheckpointManager(str(tmp_path / "resumed" / "checkpoints"))
    assert a.latest_step() == b.latest_step() == 2 and a.best_step == b.best_step
    _assert_trees_equal(a.restore_latest(), b.restore_latest())
    _assert_trees_equal(a.restore(), b.restore())
    assert b.restore_latest()["opt_state"]["count"] == 21


def test_resume_of_a_finished_run_trains_no_further(tiny_store_dir, tmp_path):
    """Resuming a run whose epochs are done runs no step and sweeps the
    best checkpoint again: the same metrics, the same global step."""
    cfg = _cfg(tiny_store_dir, MODELS["gwnet"], 1)
    done = _fit(cfg, tmp_path)
    again = _fit(cfg.replace(train=TrainConfig(batch_size=2, epochs=1, seed=0, resume=True)),
                 tmp_path)
    assert again == {**done, "eval_forwards": done["eval_forwards"] - 3}
    assert [r["epoch"] for r in _rows(tmp_path, "val")] == [0]


def _adam_after_steps(seed, steps=2):
    torch.manual_seed(seed)
    model = Date2VecAutoencoder(8)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_()
    opt = Adam(model)
    x = torch.randn(5, 6)
    for _ in range(steps):
        model.zero_grad()
        model(x).square().mean().backward()
        opt.step(1e-2)
    return model, opt, x


def test_adam_state_tree_round_trip():
    """load_state_tree(state_tree()) restores the moments and the count
    exactly: the next step of the restored optimizer equals the
    original's."""
    model, opt, x = _adam_after_steps(0)
    twin = Date2VecAutoencoder(8)
    weights.load_variables(twin, weights.module_variables(model))
    restored = Adam(twin)
    restored.load_state_tree(opt.state_tree())
    assert restored.count == opt.count == 2
    for k in opt.mu:
        assert torch.equal(restored.mu[k], opt.mu[k]) and torch.equal(restored.nu[k], opt.nu[k])
    for m, o in ((model, opt), (twin, restored)):
        m.zero_grad()
        m(x).square().mean().backward()
        o.step(1e-2)
    for (k, p), (_, q) in zip(model.named_parameters(), twin.named_parameters()):
        assert torch.equal(p, q), k


@pytest.mark.parametrize("edit", ["missing", "extra", "shape"])
def test_adam_load_state_tree_rejects_a_tree_of_another_model(edit):
    _, opt, _ = _adam_after_steps(1)
    tree = opt.state_tree()
    flat = weights.flatten(tree["mu"])
    if edit == "missing":
        del flat["fc3/kernel"]
    elif edit == "extra":
        flat["fc6/kernel"] = torch.zeros(2)
    else:
        flat["fc3/kernel"] = torch.zeros(2)
    tree["mu"] = weights.unflatten(flat)
    with pytest.raises(ValueError, match="fc3|fc6"):
        Adam(Date2VecAutoencoder(8)).load_state_tree(tree)


@pytest.mark.parametrize("exists", [True, False], ids=["empty_dir", "no_dir"])
def test_restore_latest_without_a_checkpoint_raises_and_creates_nothing(exists, tmp_path):
    d = tmp_path / "ckpt"
    if exists:
        d.mkdir()
    with pytest.raises(FileNotFoundError, match="latest"):
        CheckpointManager(str(d)).restore_latest()
    assert (sorted(os.listdir(d)) == []) if exists else not d.exists()
