"""The port's checkpoint readers on the CPU: train/loop.predict against
the JAX package's predict on shared weights, the CLI round trip train →
evaluate → serve --checkpoint_path, stats, the risk and raster maps, and
the fail-fast paths. Tiny shapes: 4 counties, 16² frames, horizon 3.

Tolerances: predict's preds and targets atol 5e-5 / rtol 1e-4 in
float32 (the JAX serving bar), its metrics rtol 1e-4; serve (BN folded)
against evaluate (BN not folded) rtol 1e-3, as the JAX package's
tests/test_dress_rehearsal.py:153-156 holds them; the map arrays atol
1e-5; stats rtol 1e-12 (both sum the same float64 values in the same
order). Round trips through one code path are held to equality.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_outage_tpu.core.checkpoint import CheckpointManager as JaxCheckpointManager
from multimodal_outage_tpu.data.stats import compute_mean_std as jax_compute_mean_std
from multimodal_outage_tpu.data.store import load_store as jax_load_store
from multimodal_outage_tpu.models.fusion import build_model as jax_build_model
from multimodal_outage_tpu.train import loop as jax_loop
from multimodal_outage_tpu.train.state import create_train_state as jax_create_train_state
from multimodal_outage_tpu.viz import maps as jax_maps
from multimodal_outage_tpu_torch import cli, weights
from multimodal_outage_tpu_torch.core.checkpoint import CheckpointManager, restore_variables
from multimodal_outage_tpu_torch.core.config import Config, DataConfig, ModelConfig, TrainConfig
from multimodal_outage_tpu_torch.data.store import load_store, save_store
from multimodal_outage_tpu_torch.train.loop import predict
from multimodal_outage_tpu_torch.viz import maps


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's small torch ops: with the
    suite's workers sharing the cores, OpenMP's barriers otherwise stall
    each op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


T, H = 3, 16
TINY = ["--dataset_range", "12", "--horizon", str(T), "--image_size", str(H),
        "--batch_size", "2", "--compute_dtype", "float32"]
CPU = ["--device", "cpu"]
KEYS = ("loss", "mae", "mape", "rmse")


@pytest.fixture(scope="module")
def trained(tiny_store_dir, tmp_path_factory):
    """A port `train` run on the CPU: (checkpoint directory, train's output)."""
    work = tmp_path_factory.mktemp("run")
    cwd = os.getcwd()
    os.chdir(work)  # the run directory is ./logs/<job_id>
    try:
        out = cli.run(["train", "--data_dir", tiny_store_dir, "--epochs", "2", "--seed", "0",
                       "--job_id", "ev", *TINY, *CPU])
    finally:
        os.chdir(cwd)
    return str(work / "logs" / "ev" / "checkpoints"), out


def _evaluate(store, ckpt, *extra):
    return cli.run(["evaluate", "--checkpoint_path", ckpt, "--case", "michael",
                    "--data_dir", store, *TINY, *CPU, *extra])


def test_predict_matches_jax_predict(tiny_cfg, tiny_store_dir, tmp_path):
    """A JAX train state (with non-trivial BatchNorm running statistics),
    saved by the JAX CheckpointManager and swept by JAX predict; the same
    params and batch_stats, carried over by weights.from_flax into the
    port's CheckpointManager and swept by the port's predict."""
    cfg = tiny_cfg
    store = jax_load_store(tiny_store_dir)
    *_, test_ds = jax_loop.prepare_datasets(cfg, "michael")
    supports = jax_loop.build_supports(cfg, store.n_counties, store)
    model = jax_build_model(cfg.model, cfg.data.horizon)
    sample = jax_loop._sample_batch(cfg, test_ds, jax_loop.make_pipeline(cfg, store))
    state = jax_create_train_state(model, jax.random.PRNGKey(3), sample, supports)
    batch_stats = jax.tree.map(
        lambda v: v + 0.3 * jnp.arange(v.size, dtype=v.dtype).reshape(v.shape) / v.size,
        state.batch_stats,
    )
    jax_dir = str(tmp_path / "jax")
    ckpt = JaxCheckpointManager(jax_dir)
    ckpt.save(0, {
        "params": state.params, "batch_stats": batch_stats, "opt_state": state.opt_state,
        "step": state.step,
        "meta": {"epoch": jnp.int32(0), "best_val": jnp.float32(0),
                 "best_epoch": jnp.int32(0), "bad_epochs": jnp.int32(0)},
    }, metrics={"val_loss": 1.0})
    ckpt.close()
    jp, jt, jm = jax_loop.predict(cfg, jax_dir, "michael")

    port_dir = str(tmp_path / "port")
    tree = weights.from_flax({"params": jax.device_get(state.params),
                              "batch_stats": jax.device_get(batch_stats)})
    CheckpointManager(port_dir).save(0, tree, metrics={"val_loss": 1.0})
    tcfg = Config(data=DataConfig(data_dir=tiny_store_dir, image_size=H, horizon=T,
                                  dataset_range=12),
                  model=ModelConfig(compute_dtype="float32"), train=TrainConfig(batch_size=2))
    tp, tt, tm = predict(tcfg, port_dir, "michael", device="cpu")

    jp, jt = np.asarray(jp), np.asarray(jt)
    assert tp.shape == jp.shape == (len(test_ds), 4, T, H, H, 1) and tt.shape == jt.shape
    assert tp.dtype == jp.dtype == np.float32 and tt.dtype == jt.dtype
    np.testing.assert_allclose(tt, jt, atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(tp, jp, atol=5e-5, rtol=1e-4)
    for k in KEYS:
        np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-4, err_msg=k)


def test_evaluate_round_trip_and_outputs(trained, tiny_store_dir, tmp_path):
    """evaluate of a train run's checkpoints gives that run's test
    metrics exactly, and writes every file asked for."""
    ckpt, run = trained
    out = _evaluate(tiny_store_dir, ckpt, "--save_preds", str(tmp_path / "p"),
                    "--metrics_json", str(tmp_path / "m" / "test.json"),
                    "--risk_maps", str(tmp_path / "risk"),
                    "--raster_maps", str(tmp_path / "raster"))
    assert out["metrics"] == {k: run[f"test_{k}"] for k in KEYS}
    assert json.load(open(tmp_path / "m" / "test.json")) == out["metrics"]
    preds, targets = (np.load(tmp_path / "p" / f"{n}.npy") for n in ("preds", "targets"))
    assert preds.shape == targets.shape == (out["windows"], 4, T, H, H, 1)
    assert out["forwards"] == -(-out["windows"] // 2)
    # spotlight county 2 only (the others are past N=4): 4 samples × T
    for d in ("risk", "raster"):
        pngs = [f for _, _, fs in os.walk(tmp_path / d) for f in fs if f.endswith(".png")]
        assert len(pngs) == out[f"{d}_maps"] == 4 * T


def test_serve_checkpoint_matches_evaluate_and_weights(trained, tiny_store_dir, tmp_path):
    """serve --checkpoint_path: the engine (BN folded) against evaluate
    (the module) on the same checkpoint, and exactly serve --weights of
    the same tree."""
    ckpt, run = trained
    base = ["serve", "--data_dir", tiny_store_dir, "--case", "michael", *TINY, *CPU]
    served = cli.run(base + ["--checkpoint_path", ckpt, "--save_preds", str(tmp_path / "s")])
    for k in ("loss", "mae", "rmse"):
        np.testing.assert_allclose(served["metrics"][k], run[f"test_{k}"], rtol=1e-3, err_msg=k)
    npz = str(tmp_path / "w.npz")
    weights.save_npz(npz, restore_variables(ckpt))
    assert cli.run(base + ["--weights", npz])["metrics"] == served["metrics"]
    # Michael's 24 store dates at ±12 days give 24 − 2·T windows
    assert np.load(tmp_path / "s" / "preds.npy").shape == (24 - 2 * T, 4, T, H, H, 1)


def test_serve_dcrnn_checkpoint_equals_seed(tiny_store_dir, tmp_path):
    cfg = ModelConfig(st_gnn="dcrnn")
    ckpt = str(tmp_path / "ckpt")
    CheckpointManager(ckpt).save(0, weights.init_variables(cfg, T, 4, seed=5, image_size=H),
                                 metrics={"val_loss": 0.0})
    base = ["serve", "--st_gnn", "dcrnn", "--data_dir", tiny_store_dir, *TINY, *CPU,
            "--max_batches", "2"]
    assert (cli.run(base + ["--checkpoint_path", ckpt])["metrics"]
            == cli.run(base + ["--seed", "5"])["metrics"])


@pytest.mark.parametrize("command", ["evaluate", "serve"])
@pytest.mark.parametrize("device", [[], CPU], ids=["no_device", "cpu"])
def test_missing_checkpoint_raises_and_creates_nothing(command, device, tiny_store_dir, tmp_path):
    missing = tmp_path / "nope"
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        cli.run([command, "--checkpoint_path", str(missing), "--data_dir", tiny_store_dir,
                 *TINY, *device])
    assert not missing.exists()


def test_evaluate_without_device_needs_a_card(trained, tiny_store_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the check is for one without")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.run(["evaluate", "--checkpoint_path", trained[0], "--case", "michael",
                 "--data_dir", tiny_store_dir, *TINY, "--save_preds", str(tmp_path / "p"),
                 "--metrics_json", str(tmp_path / "m.json")])
    assert not os.listdir(tmp_path)


def test_evaluate_dcrnn_raises_until_dcrnn_trains(tiny_cfg, tiny_store_dir, tmp_path):
    """evaluate --st_gnn dcrnn raised until DCRNN trained in the port; now
    DCRNN predict is held to JAX predict as test_predict_matches_jax_predict
    holds Graph WaveNet's: a flax-initialised DCRNN state through the JAX
    CheckpointManager and JAX predict, the same params (DCRNN has no
    batch_stats) through the port's, both over the dual-random-walk
    supports of the synthetic 4-county graph."""
    cfg = tiny_cfg.replace(model=dataclasses.replace(tiny_cfg.model, st_gnn="dcrnn"))
    store = jax_load_store(tiny_store_dir)
    *_, test_ds = jax_loop.prepare_datasets(cfg, "michael")
    supports = jax_loop.build_supports(cfg, store.n_counties, store)
    assert supports.shape == (2, 4, 4)
    model = jax_build_model(cfg.model, cfg.data.horizon)
    sample = jax_loop._sample_batch(cfg, test_ds, jax_loop.make_pipeline(cfg, store))
    state = jax_create_train_state(model, jax.random.PRNGKey(4), sample, supports)
    batch_stats = jax.tree.map(
        lambda v: v + 0.3 * jnp.arange(v.size, dtype=v.dtype).reshape(v.shape) / v.size,
        state.batch_stats,
    )
    jax_dir = str(tmp_path / "jax")
    ckpt = JaxCheckpointManager(jax_dir)
    ckpt.save(0, {
        "params": state.params, "batch_stats": batch_stats, "opt_state": state.opt_state,
        "step": state.step,
        "meta": {"epoch": jnp.int32(0), "best_val": jnp.float32(0),
                 "best_epoch": jnp.int32(0), "bad_epochs": jnp.int32(0)},
    }, metrics={"val_loss": 1.0})
    ckpt.close()
    jp, _, jm = jax_loop.predict(cfg, jax_dir, "michael")

    port_dir = str(tmp_path / "port")
    tree = weights.from_flax({"params": jax.device_get(state.params),
                              "batch_stats": jax.device_get(batch_stats)})
    CheckpointManager(port_dir).save(0, tree, metrics={"val_loss": 1.0})
    out = _evaluate(tiny_store_dir, port_dir, "--st_gnn", "dcrnn",
                    "--save_preds", str(tmp_path / "p"))
    tp = np.load(tmp_path / "p" / "preds.npy")
    assert tp.shape == np.asarray(jp).shape == (len(test_ds), 4, T, H, H, 1)
    np.testing.assert_allclose(tp, np.asarray(jp), atol=5e-5, rtol=1e-4)
    for k in KEYS:
        np.testing.assert_allclose(out["metrics"][k], float(jm[k]), rtol=1e-4, err_msg=k)


def test_checkpoint_reader_writes_nothing(tmp_path):
    """Restoring a missing or checkpoint-less directory raises and
    creates nothing; the first save creates best/ and latest/."""
    missing, empty = tmp_path / "missing", tmp_path / "empty"
    empty.mkdir()
    (empty / "notes.txt").write_text("not a checkpoint")
    for d in (missing, empty):
        with pytest.raises(FileNotFoundError):
            CheckpointManager(str(d)).restore()
        with pytest.raises(FileNotFoundError):
            restore_variables(str(d))
    assert not missing.exists() and os.listdir(empty) == ["notes.txt"]
    mgr = CheckpointManager(str(missing))
    assert mgr.best_step is None and mgr.latest_step() is None and not missing.exists()
    mgr.save(3, {"params": {"w": torch.ones(2)}, "batch_stats": {}}, metrics={"val_loss": 1.0})
    assert sorted(os.listdir(missing)) == ["best", "latest"] and mgr.best_step == 3
    assert torch.equal(restore_variables(str(missing))["params"]["w"], torch.ones(2))


def test_stats_matches_jax(tiny_store_dir):
    out = cli.run(["stats", "--data_dir", tiny_store_dir, "--dataset_range", "12"])
    want = jax_compute_mean_std(jax_load_store(tiny_store_dir), dataset_range=12)
    np.testing.assert_allclose([out["mean"], out["std"]], want, rtol=1e-12)
    with pytest.raises(FileNotFoundError):
        cli.run(["stats", "--data_dir", "/nope"])


@pytest.fixture(scope="module")
def monthly_store(tmp_path_factory):
    """4 counties of 16² daily frames around Michael, with a monthly
    sidecar at `MONTHLY_SIZE`² for June-August 2018."""
    out = str(tmp_path_factory.mktemp("monthly"))
    rng = np.random.default_rng(0)
    dates = np.array([(2018, 10, d) for d in range(1, 21)], np.int32)
    save_store(out, rng.uniform(0, 50, (20, 4, H, H)), dates, [f"c{i}" for i in range(4)],
               monthly=rng.uniform(0, 80, (3, 4, 24, 24)),
               monthly_months=np.array([(2018, 6), (2018, 7), (2018, 8)], np.int32))
    return out


@pytest.mark.parametrize("shape", [(24, 24), (12, 12), (20, 28)],
                         ids=["down", "up", "mixed"])
def test_resize_bilinear_matches_jax(shape):
    """Downscaling antialiases in both packages (jax.image.resize, and
    F.interpolate(antialias=True))."""
    arr = np.random.default_rng(1).uniform(0, 80, shape).astype(np.float32)
    np.testing.assert_allclose(maps._resize_bilinear(arr, H), jax_maps._resize_bilinear(arr, H),
                               atol=1e-5)


def test_map_arrays_match_jax(monthly_store):
    rng = np.random.default_rng(2)
    pred = rng.standard_normal((H, H, 1)).astype(np.float32)
    for denorm in (True, False):
        np.testing.assert_allclose(maps.ntl_to_np(pred, 6.0, 9.0, denorm),
                                   jax_maps.ntl_to_np(pred, 6.0, 9.0, denorm), atol=1e-5)
    a, b = rng.uniform(0, 50, (2, H, H))
    np.testing.assert_allclose(maps.percent_of_normal(a, b), jax_maps.percent_of_normal(a, b),
                               atol=1e-5)
    port, ref = load_store(monthly_store), jax_load_store(monthly_store)
    for c in range(4):
        np.testing.assert_allclose(maps.monthly_normal(port, c, 2018, H),
                                   jax_maps.monthly_normal(ref, c, 2018, H), atol=1e-5)
    np.testing.assert_allclose(maps.average_baseline_ntl(port.frames[:, 0], range(5)),
                               jax_maps.average_baseline_ntl(ref.frames[:, 0], range(5)),
                               atol=1e-5)
    with pytest.raises(ValueError, match="2019"):
        maps.monthly_normal(port, 0, 2019, H)


def test_maps_write_pngs(monthly_store, tmp_path):
    """The monthly-baseline risk maps (named by predicted date) and the
    rasters of two samples, horizon 2, spotlight county 2."""
    preds = np.random.default_rng(3).standard_normal((2, 4, 2, H, H, 1)).astype(np.float32)
    fut = np.array([[(2018, 10, 11), (2018, 10, 12)], [(2018, 10, 12), (2018, 10, 13)]])
    store = load_store(monthly_store)
    risk = maps.save_risk_maps(preds, store, str(tmp_path / "risk"), 6.0, 9.0, future_dates=fut)
    raster = maps.save_prediction_rasters(preds, str(tmp_path / "raster"), 6.0, 9.0,
                                          county_names=store.county_names)
    assert len(risk) == len(raster) == 4 and all(os.path.getsize(p) > 0 for p in risk + raster)
    assert os.path.basename(risk[0]) == "2018_10_11.png"
