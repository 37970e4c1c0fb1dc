"""tools/export_jax_checkpoint.py on the CPU: a checkpoint directory of
the JAX package (orbax, both stores) exported into one of the port, for
Graph WaveNet and DCRNN. Narrow widths (U-Net depth 2 base 2, 4 counties,
16² frames, horizon 3, B=2, dropout off) keep JAX's compiles short.

The JAX run: create_train_state (op by op, as JAX predict builds it, so
predict's own build finds its ops compiled), then one jitted JAX train
step on a seeded batch. Step 0 (the fresh state) is saved at val_loss 0.5
and step 1 (Adam count 1, non-zero moments) at 0.9 by JAX's
CheckpointManager, so best/ keeps step 0 and latest/ step 1.

Tolerances: the exported trees equal the JAX trees bitwise (the same
float32 values); the port's predict of the export against JAX predict of
the original, preds atol 5e-5 / rtol 1e-4 and metrics rtol 1e-4 (the
CPU eval bar, tests/test_torch_port_evaluate.py). The next train step
from latest/ against JAX's next step from the orbax state, at the bars of
the float32 train-step parity test (tests/test_torch_port_train.py):
loss and metrics rtol 1e-5, BatchNorm running statistics atol 1e-6 /
rtol 1e-5. Its Adam state and parameters follow from a gradient held to
1e-4·max|g_leaf| + 1e-7 there (δ): μ = 0.9·μ₁ + 0.1·g is held to 0.1·δ,
ν = 0.999·ν₁ + 0.001·g² to 0.001·δ·(2|g| + δ), and each parameter to
atol 1e-6 plus lr times the largest change that δ can make in the Adam
direction m̂/(√v̂ + ε) of its leaf.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_outage_tpu.core.checkpoint import CheckpointManager as JaxCheckpointManager
from multimodal_outage_tpu.core.config import DCRNNConfig as JaxDCRNNConfig
from multimodal_outage_tpu.core.config import GWNetConfig as JaxGWNetConfig
from multimodal_outage_tpu.core.config import ModelConfig as JaxModelConfig
from multimodal_outage_tpu.core.config import small_test_config
from multimodal_outage_tpu.train import loop as jax_loop
from multimodal_outage_tpu.train.state import TrainState as JaxTrainState
from multimodal_outage_tpu.train.state import create_train_state as jax_create_train_state
from multimodal_outage_tpu.train.steps import make_train_step as jax_make_train_step
from multimodal_outage_tpu_torch import weights
from multimodal_outage_tpu_torch.core.checkpoint import CheckpointManager
from multimodal_outage_tpu_torch.core.config import (
    Config,
    DataConfig,
    DCRNNConfig,
    GWNetConfig,
    MeshConfig,
    ModelConfig,
    TrainConfig,
)
from multimodal_outage_tpu_torch.data.adjacency import model_supports
from multimodal_outage_tpu_torch.models.fusion import build_model
from multimodal_outage_tpu_torch.train.loop import fit, predict
from multimodal_outage_tpu_torch.train.state import create_train_state
from multimodal_outage_tpu_torch.train.steps import make_train_step

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
import export_jax_checkpoint as exporter  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's small torch ops: with the
    suite's workers sharing the cores, OpenMP's barriers otherwise stall
    each op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, N, T, H = 2, 4, 3, 16
LR = 1e-3
NARROW = dict(compute_dtype="float32", base_channels=2, depth=2, feature_vector_size=8,
              compression_factor=2, encoder_dropout=0.0)
GWNET = dict(residual_channels=4, dilation_channels=4, skip_channels=8, end_channels=8,
             blocks=1, layers=2, node_embed_dim=2, dropout=0.0)
DCRNN = dict(rnn_units=4)


def _configs(st_gnn, store_dir):
    """(JAX Config, port Config) of one narrow model over the tiny store,
    on one device."""
    data = dict(data_dir=store_dir, n_counties=N, image_size=H, horizon=T, dataset_range=12)
    if st_gnn == "gwnet":
        jm = JaxModelConfig(**NARROW, gwnet=JaxGWNetConfig(**GWNET))
        tm = ModelConfig(**NARROW, gwnet=GWNetConfig(**GWNET))
    else:
        jm = JaxModelConfig(**NARROW, st_gnn="dcrnn", dcrnn=JaxDCRNNConfig(**DCRNN))
        tm = ModelConfig(**NARROW, st_gnn="dcrnn", dcrnn=DCRNNConfig(**DCRNN))
    jc = small_test_config(n_counties=N, image_size=H, horizon=T, batch_size=B)
    jc = jc.replace(data=dataclasses.replace(jc.data, **data), model=jm)
    tc = Config(data=DataConfig(**data), model=tm, train=TrainConfig(batch_size=B),
                mesh=MeshConfig(data=1))
    return jc, tc


def _batch(seed):
    rng = np.random.default_rng(seed)
    feats = np.tile(np.array([0, 0, 0, 2022, 9, 26], np.float32), (B, T, 1))
    feats[..., 5] += np.arange(T, dtype=np.float32)
    return {"x": rng.standard_normal((B, N, T, H, H, 1)).astype(np.float32),
            "y": rng.standard_normal((B, N, T, H, H, 1)).astype(np.float32),
            "date_feats": feats}


def _jax_tree(state, epoch, best_val, best_epoch, bad):
    """JAX fit's checkpoint tree (its train/loop.py ckpt_tree)."""
    return {"params": state.params, "batch_stats": state.batch_stats,
            "opt_state": state.opt_state, "step": state.step,
            "meta": {"epoch": jnp.int32(epoch), "best_val": jnp.float32(best_val),
                     "best_epoch": jnp.int32(best_epoch), "bad_epochs": jnp.int32(bad)}}


@pytest.fixture(scope="module", params=["gwnet", "dcrnn"])
def run(request, tiny_store_dir, tmp_path_factory):
    """A JAX checkpoint directory (best/ step 0, latest/ step 1) and its
    export."""
    jc, tc = _configs(request.param, tiny_store_dir)
    model = jax_loop.build_model(jc.model, T)
    sup = jax_loop.build_supports(jc, N)
    sample = {"x": jnp.zeros((1, N, T, H, H, 1)), "date_feats": jnp.zeros((1, T, 6))}
    state0 = jax_create_train_state(model, jax.random.PRNGKey(3), sample, sup)
    step = jax_make_train_step(model, donate=False, compiler_options=None)
    batch = {k: jnp.asarray(v) for k, v in _batch(0).items()}
    state1, _ = step(state0, batch, sup, jnp.float32(LR), jax.random.PRNGKey(0))
    work = tmp_path_factory.mktemp(request.param)
    jax_dir, port_dir = str(work / "jax"), str(work / "port")
    ckpt = JaxCheckpointManager(jax_dir)
    trees = {0: _jax_tree(state0, 0, 0.5, 0, 0), 1: _jax_tree(state1, 1, 0.5, 0, 1)}
    ckpt.save(0, trees[0], metrics={"val_loss": 0.5})
    ckpt.save(1, trees[1], metrics={"val_loss": 0.9})
    ckpt.close()
    info = exporter.export(jc, jax_dir, port_dir)
    return {"jc": jc, "tc": tc, "model": model, "sup": sup, "step": step, "trees": trees,
            "jax_dir": jax_dir, "port_dir": port_dir, "info": info}


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in weights.flatten(jax.device_get(tree)).items()}


def _assert_tree_equal(port, jax_tree):
    """A port checkpoint tree against the JAX tree it was exported from,
    bitwise."""
    adam = jax_tree["opt_state"][0]
    pairs = {"params": jax_tree["params"], "batch_stats": jax_tree["batch_stats"],
             "mu": adam.mu, "nu": adam.nu}
    for name, want in pairs.items():
        got = port["opt_state"][name] if name in ("mu", "nu") else port[name]
        got, want = weights.flatten(got), _flat_np(want)
        assert sorted(got) == sorted(want), name
        for k in want:
            assert got[k].dtype == torch.float32, (name, k)
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=f"{name} {k}")
    assert port["opt_state"]["count"] == int(adam.count)
    assert port["step"] == int(jax_tree["step"])
    meta = {k: np.asarray(v).item() for k, v in jax_tree["meta"].items()}
    assert port["meta"] == meta and all(type(v) is type(meta[k]) for k, v in port["meta"].items())


def test_export_carries_both_stores(run):
    """best/ holds step 0 with its val_loss, latest/ step 1; each tree,
    Adam moments and count included, is the JAX tree's."""
    assert run["info"]["best_steps"] == [0] and run["info"]["latest_step"] == 1
    ckpt = CheckpointManager(run["port_dir"])
    assert ckpt.best_step == 0 and ckpt.latest_step() == 1
    with open(os.path.join(run["port_dir"], "best", "metrics.json")) as f:
        assert json.load(f) == {"0": 0.5}
    assert sorted(os.listdir(os.path.join(run["port_dir"], "latest"))) == ["1.pt"]
    best, latest = ckpt.restore(), ckpt.restore_latest()
    _assert_tree_equal(best, run["trees"][0])
    _assert_tree_equal(latest, run["trees"][1])
    assert best["opt_state"]["count"] == 0 and latest["opt_state"]["count"] == 1
    assert any(v.abs().max() > 0 for v in weights.flatten(latest["opt_state"]["mu"]).values())


def test_evaluate_of_the_export_matches_jax_predict(run):
    """The port's predict (evaluate's sweep) of the export's best/
    against JAX predict of the original directory."""
    jp, jt, jm = jax_loop.predict(run["jc"], run["jax_dir"], "michael")
    tp, tt, tm = predict(run["tc"], run["port_dir"], "michael", device="cpu")
    assert tp.shape == np.shape(jp) == (18, N, T, H, H, 1)
    np.testing.assert_allclose(tt, np.asarray(jt), atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(tp, np.asarray(jp), atol=5e-5, rtol=1e-4)
    for k in ("loss", "mae", "mape", "rmse"):
        np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-4, err_msg=k)


def _adam_direction(mu, nu, count, b1=0.9, b2=0.999, eps=1e-8):
    return (mu / (1 - b1**count)) / (np.sqrt(nu / (1 - b2**count)) + eps)


def test_next_train_step_from_latest_matches_jax(run):
    """The port's train step from the export's latest/ (params, BN
    statistics, Adam moments, count and step restored as fit's resume
    restores them) against JAX's next step from the orbax state,
    restored with JAX fit's template."""
    jax_ckpt = JaxCheckpointManager(run["jax_dir"])
    restored = jax_ckpt.restore_latest(template=run["trees"][1])
    jax_ckpt.close()
    jstate = JaxTrainState(params=restored["params"], batch_stats=restored["batch_stats"],
                           opt_state=restored["opt_state"], step=restored["step"])
    batch = _batch(1)
    jnew, jm = run["step"](jstate, {k: jnp.asarray(v) for k, v in batch.items()}, run["sup"],
                           jnp.float32(LR), jax.random.PRNGKey(0))

    tc = run["tc"]
    tree = CheckpointManager(run["port_dir"]).restore_latest()
    model = weights.load_variables(build_model(tc.model, T, N, H), tree)
    state = create_train_state(model)
    state.opt.load_state_tree(tree["opt_state"])
    state.step = tree["step"]
    sup = torch.from_numpy(model_supports(tc.model, N, seed=tc.train.seed))
    np.testing.assert_array_equal(sup.numpy(), np.asarray(run["sup"]))
    tm = make_train_step(model)(state, {k: torch.from_numpy(v) for k, v in batch.items()}, sup,
                                LR, 0)
    assert state.opt.count == int(jnew.opt_state[0].count) == 2

    for k in ("loss", "mae", "mape", "rmse"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    new = weights.flatten(weights.module_variables(model))
    for k, want in _flat_np(jnew.batch_stats).items():
        np.testing.assert_allclose(new[f"batch_stats/{k}"].numpy(), want, atol=1e-6, rtol=1e-5,
                                   err_msg=k)
    jadam = jnew.opt_state[0]
    mu1, nu1 = _flat_np(restored["opt_state"][0].mu), _flat_np(restored["opt_state"][0].nu)
    mu2, nu2, params = _flat_np(jadam.mu), _flat_np(jadam.nu), _flat_np(jnew.params)
    for k in mu2:
        g = (mu2[k] - 0.9 * mu1[k]) / 0.1  # JAX's gradient, from its moments
        delta = 1e-4 * np.abs(g).max() + 1e-7
        np.testing.assert_allclose(state.opt.mu[k].numpy(), mu2[k], rtol=0,
                                   atol=0.1 * delta + 1e-9, err_msg=f"mu {k}")
        nu_tol = 0.001 * delta * (2 * np.abs(g) + delta) + 1e-12
        assert (np.abs(state.opt.nu[k].numpy() - nu2[k]) <= nu_tol).all(), f"nu {k}"
        # the largest change δ in g can make in the Adam direction of this leaf
        d_near = _adam_direction(mu2[k], nu2[k], 2)
        d_far = _adam_direction(mu2[k] + 0.1 * delta, np.maximum(nu2[k] - nu_tol, 0), 2)
        p_tol = 1e-6 + LR * np.abs(d_far - d_near).max()
        np.testing.assert_allclose(new[f"params/{k}"].numpy(), params[k], rtol=0, atol=p_tol,
                                   err_msg=f"params {k}")


def test_resume_from_the_export_continues_the_run(run):
    """fit --resume from the export starts after latest/'s epoch with its
    early-stopping state, and its first val sweep saves the next epoch."""
    tc = run["tc"]
    run_dir = os.path.join(os.path.dirname(run["port_dir"]), "resumed")
    import shutil

    shutil.copytree(run["port_dir"], os.path.join(run_dir, "checkpoints"))
    cfg = tc.replace(train=dataclasses.replace(tc.train, epochs=3, resume=True))
    out = fit(cfg, run_dir=run_dir, progress=False, device="cpu")
    ckpt = CheckpointManager(os.path.join(run_dir, "checkpoints"))
    assert ckpt.latest_step() == 2
    tree = ckpt.restore_latest()
    assert tree["meta"]["epoch"] == 2 and tree["opt_state"]["count"] == tree["step"]
    assert tree["step"] == out["train_steps"] > 1
    # the resumed best_val (0.5) is beaten or kept, never reset to inf
    assert tree["meta"]["best_val"] <= 0.5


def test_main_raises_on_a_directory_without_stores(tmp_path):
    with pytest.raises(FileNotFoundError, match="no JAX checkpoint store"):
        exporter.main(["--checkpoint_path", str(tmp_path / "nope"), "--out",
                       str(tmp_path / "out"), "--n_counties", "4", "--image_size", "16"])
    assert not (tmp_path / "out").exists()
