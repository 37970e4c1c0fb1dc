"""DCRNN training end to end in the port on the CPU: fit with teacher
forcing and its checkpoint read back by predict (the run's test metrics
exactly) and as a tree (an exact round trip), and the CLI's train →
evaluate → serve. The one-step parity against the JAX package, the
teacher pass, the coins and the checkpoint index are in
tests/test_torch_port_dcrnn_train.py.
"""

import json
import os

import numpy as np
import pytest
import torch

from multimodal_outage_tpu_torch import cli, weights
from multimodal_outage_tpu_torch.core.checkpoint import CheckpointManager
from multimodal_outage_tpu_torch.core.config import (
    Config,
    DataConfig,
    DCRNNConfig,
    ModelConfig,
    TrainConfig,
)
from multimodal_outage_tpu_torch.models.fusion import build_model
from multimodal_outage_tpu_torch.train import loop

T = 3
KEYS = ("loss", "mae", "mape", "rmse")


@pytest.fixture(scope="module")
def dcrnn_run(tiny_store_dir, tmp_path_factory):
    """fit with teacher_forcing 0.7 and tf_decay_steps 50 on the tiny store
    (4 counties, 16², horizon 3, B=2, two epochs)."""
    run_dir = str(tmp_path_factory.mktemp("dcrnn_run"))
    cfg = Config(
        data=DataConfig(data_dir=tiny_store_dir, image_size=16, horizon=T, dataset_range=12),
        model=ModelConfig(st_gnn="dcrnn", compute_dtype="float32",
                          dcrnn=DCRNNConfig(teacher_forcing=0.7, tf_decay_steps=50)),
        train=TrainConfig(batch_size=2, epochs=2, seed=0),
    )
    out = loop.fit(cfg, test_case="michael", run_dir=run_dir, progress=False, device="cpu")
    return cfg, run_dir, out


def test_fit_with_teacher_forcing_then_evaluate_gives_its_test_metrics(dcrnn_run):
    cfg, run_dir, out = dcrnn_run
    assert out["train_steps"] > 2 and all(
        np.isfinite(out[f"{s}_{k}"]) for s in ("val", "test") for k in KEYS)
    ckpt = os.path.join(run_dir, "checkpoints")
    assert CheckpointManager(ckpt).best_step == out["best_epoch"]
    preds, targets, metrics = loop.predict(cfg, ckpt, "michael", device="cpu")
    assert metrics == {k: out[f"test_{k}"] for k in KEYS}
    assert preds.shape == targets.shape == (len(preds), 4, T, 16, 16, 1)


def test_trained_dcrnn_round_trips(dcrnn_run):
    """A trained DCRNN checkpoint's tree: the module's own paths (no
    st_gnn batch_stats), Adam's moments on the same paths, and a
    load_variables / module_variables / from_flax round trip that is
    exact."""
    cfg, run_dir, _ = dcrnn_run
    tree = CheckpointManager(os.path.join(run_dir, "checkpoints")).restore()
    flat = weights.flatten(tree["params"])
    assert "st_gnn/decoder/proj/kernel" in flat and "st_gnn" not in tree["batch_stats"]
    assert weights.flatten(tree["opt_state"]["mu"]).keys() == flat.keys()
    init = weights.flatten(weights.init_variables(cfg.model, T, 4, seed=0, image_size=16)["params"])
    assert init.keys() == flat.keys()
    moved = [k for k in flat if k.startswith("st_gnn/") and not torch.equal(flat[k], init[k])]
    assert len(moved) == sum(k.startswith("st_gnn/") for k in flat)
    model = weights.load_variables(build_model(cfg.model, T, 4, 16), tree)
    back = weights.module_variables(model)
    again = weights.from_flax({k: {p: v.numpy() for p, v in weights.flatten(back[k]).items()}
                               for k in ("params", "batch_stats")})
    for k in ("params", "batch_stats"):
        for path, v in weights.flatten(tree[k]).items():
            assert torch.equal(weights.flatten(back[k])[path], v), path
            assert torch.equal(again[k][path], v), path


TINY = ["--dataset_range", "12", "--horizon", str(T), "--image_size", "16",
        "--batch_size", "2", "--compute_dtype", "float32", "--st_gnn", "dcrnn"]


def test_cli_train_evaluate_serve_dcrnn_cpu(tiny_store_dir, tmp_path, monkeypatch):
    """train --st_gnn dcrnn --teacher_forcing … --device cpu through
    cli.run, then evaluate --st_gnn dcrnn (== the run's test metrics)
    and serve --checkpoint_path --st_gnn dcrnn (the engine, within 1e-3
    of evaluate as tests/test_torch_port_evaluate.py holds Graph
    WaveNet's)."""
    monkeypatch.chdir(tmp_path)
    run = cli.run(["train", "--data_dir", tiny_store_dir, "--epochs", "1",
                   "--job_id", "d", "--teacher_forcing", "0.5", "--tf_decay_steps", "10",
                   "--device", "cpu", *TINY])
    config = json.load(open(tmp_path / "logs" / "d" / "config.json"))
    assert config["model"]["st_gnn"] == "dcrnn"
    assert config["model"]["dcrnn"] == {**config["model"]["dcrnn"], "teacher_forcing": 0.5,
                                        "tf_decay_steps": 10}
    ckpt = str(tmp_path / "logs" / "d" / "checkpoints")
    base = ["--checkpoint_path", ckpt, "--case", "michael", "--data_dir", tiny_store_dir,
            *TINY, "--device", "cpu"]
    ev = cli.run(["evaluate", *base])
    assert ev["metrics"] == {k: run[f"test_{k}"] for k in KEYS}
    sv = cli.run(["serve", *base])
    for k in ("loss", "mae", "rmse"):
        np.testing.assert_allclose(sv["metrics"][k], ev["metrics"][k], rtol=1e-3, err_msg=k)
