"""The port's run options on the CPU (cli.py's train/evaluate/serve
flags, pretrain-d2v, train/date2vec_pretrain.py, fit's debug_nans,
profile_dir and tensorboard), against the JAX package where it has the
same function. Tiny shapes: 4 counties, 16² frames, horizon 3, B=2,
dataset_range 6 (7 train steps an epoch).

Tolerances: Date2Vec encodings atol 1e-6 (float32, [n, 6] @ [6, 32]); one
pretraining step's loss, gradients and Adam-updated params rtol = atol =
1e-6 (float32; the step from the same params on the same batch); a fusion
forward with a bundle installed atol 5e-5 / rtol 1e-4 (the JAX serving
bar); serve against evaluate's module forward the same bar. Configs and
round trips through one code path are held to equality.
"""

import dataclasses
import glob
import json
import os
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_outage_tpu import cli as jax_cli
from multimodal_outage_tpu.core.config import GWNetConfig as JaxGWNetConfig
from multimodal_outage_tpu.core.config import ModelConfig as JaxModelConfig
from multimodal_outage_tpu.models.date2vec import Date2Vec as JaxDate2Vec
from multimodal_outage_tpu.models.fusion import build_model as jax_build_model
from multimodal_outage_tpu.train import date2vec_pretrain as jax_d2v
from multimodal_outage_tpu_torch import cli, weights
from multimodal_outage_tpu_torch.core.checkpoint import CheckpointManager
from multimodal_outage_tpu_torch.core.config import (
    Config,
    DataConfig,
    GWNetConfig,
    ModelConfig,
    TrainConfig,
    asdict,
)
from multimodal_outage_tpu_torch.core.run_logging import RunLogger
from multimodal_outage_tpu_torch.data.adjacency import (
    config_supports,
    default_adjacency_path,
    load_adjacency_csv,
)
from multimodal_outage_tpu_torch.data.store import load_store, save_store
from multimodal_outage_tpu_torch.data.synthetic import generate_store
from multimodal_outage_tpu_torch.models import date2vec
from multimodal_outage_tpu_torch.models.fusion import build_model
from multimodal_outage_tpu_torch.train import date2vec_pretrain as d2v
from multimodal_outage_tpu_torch.train import loop
from multimodal_outage_tpu_torch.train.state import Adam, create_train_state
from multimodal_outage_tpu_torch.train.steps import make_train_step


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's small torch ops: with the
    suite's workers sharing the cores, OpenMP's barriers otherwise stall
    each op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, N, T, H, K = 2, 4, 3, 16, 64
# a narrow fusion model (a full-width one takes ~50 s of XLA CPU compile)
# with the full Date2Vec width K
NARROW = dict(compute_dtype="float32", base_channels=2, depth=2, feature_vector_size=8,
              compression_factor=2, time_embed_size=K)
NARROW_GWNET = dict(residual_channels=4, dilation_channels=4, skip_channels=8, end_channels=8,
                    blocks=1, layers=2, node_embed_dim=2)
TINY = ["--dataset_range", "6", "--horizon", str(T), "--image_size", str(H),
        "--batch_size", "2", "--compute_dtype", "float32", "--device", "cpu"]
FEATS = np.array([[0, 0, 0, y, m, d] for y, m, d in
                  ((2012, 1, 1), (2018, 10, 10), (2022, 9, 28), (2023, 8, 30), (2026, 12, 31))],
                 np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_d2v_params(seed=0):
    return _np(JaxDate2Vec(k=K).init(jax.random.PRNGKey(seed), jnp.zeros((1, 6)))["params"])


def _jax_encode(params):
    return np.asarray(JaxDate2Vec(k=K).apply({"params": params}, jnp.asarray(FEATS),
                                             method=JaxDate2Vec.encode))


def _port_encode(params):
    return date2vec.encode(torch.from_numpy(FEATS), params["date2vec"]).numpy()


def _port_params(seed=0):
    return weights.init_variables(ModelConfig(compute_dtype="float32"), T, N, seed,
                                  image_size=H)["params"]


def test_jax_bundle_installs_in_the_port(tmp_path):
    """A bundle that JAX's save_bundle wrote, read by the port's
    load_bundle and installed: the port encodes dates as JAX's install +
    Date2Vec.encode does."""
    path = str(tmp_path / "jax.npz")
    jax_d2v.save_bundle(jax_d2v._fold_normalization(_jax_d2v_params()), path)
    want = _jax_encode(jax_d2v.install_bundle({"date2vec": _jax_d2v_params(1)},
                                              jax_d2v.load_bundle(path))["date2vec"])
    got = _port_encode(d2v.install_bundle(_port_params(), d2v.load_bundle(path)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert not np.allclose(_port_encode(_port_params()), want, atol=1e-2)


def test_port_bundle_installs_in_jax(tmp_path):
    """The reverse: a bundle the port pretrained and saved, read by JAX's
    load_bundle and installed there, encodes as the port's install does."""
    path = str(tmp_path / "port.npz")
    params, loss = d2v.pretrain_date2vec(k=K, steps=3, batch_size=16, device="cpu")
    assert np.isfinite(loss)
    d2v.save_bundle(params, path)
    assert sorted(np.load(path).files) == sorted(
        f"fc{i}/{p}" for i in range(1, 6) for p in ("kernel", "bias"))
    want = _port_encode(d2v.install_bundle(_port_params(), d2v.load_bundle(path)))
    got = _jax_encode(jax_d2v.install_bundle({"date2vec": _jax_d2v_params()},
                                             jax_d2v.load_bundle(path))["date2vec"])
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_fold_normalization_and_dataset_equal_jax():
    rng = np.random.default_rng(0)
    params = {f"fc{i}": {"kernel": rng.normal(size=(6, 8)).astype(np.float32),
                         "bias": rng.normal(size=(8,)).astype(np.float32)} for i in range(1, 6)}
    got, want = d2v._fold_normalization(params), jax_d2v._fold_normalization(params)
    for layer in params:
        for p in ("kernel", "bias"):
            np.testing.assert_array_equal(got[layer][p], want[layer][p])
    np.testing.assert_array_equal(d2v._OFFSET, jax_d2v._OFFSET)
    np.testing.assert_array_equal(d2v._SCALE, jax_d2v._SCALE)
    np.testing.assert_array_equal(d2v.date_vector_dataset(), jax_d2v.date_vector_dataset())
    np.testing.assert_array_equal(d2v.date_vector_dataset(2020, 2020),
                                  jax_d2v.date_vector_dataset(2020, 2020))


def test_one_pretraining_step_matches_jax():
    """From JAX's init carried across (weights.date2vec_autoencoder), dropout off,
    the batch JAX's pretrain_date2vec draws first: loss, every gradient and
    every optax.adam-updated param."""
    lr, seed, bs = 1e-3, 42, 256
    data = (jax_d2v.date_vector_dataset() - jax_d2v._OFFSET) / jax_d2v._SCALE
    batch = data[np.random.default_rng(seed).integers(0, data.shape[0], bs)]
    model = JaxDate2Vec(k=K)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 6)))["params"]

    def loss_fn(p):
        return jnp.mean(jnp.square(model.apply({"params": p}, jnp.asarray(batch)) - batch))

    loss, grads = jax.value_and_grad(loss_fn)(params)
    tx = optax.adam(lr)
    updates, _ = tx.update(grads, tx.init(params))
    want = weights.flatten(_np(optax.apply_updates(params, updates)))

    port = weights.date2vec_autoencoder(_np(params))
    got_loss = d2v.pretrain_step(port, Adam(port), torch.from_numpy(batch), lr, train=False)
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-6, atol=1e-6)
    grads = weights.flatten(_np(grads))
    for name, p in port.named_parameters():
        path = name.replace(".", "/")
        np.testing.assert_allclose(p.grad.numpy(), grads[path], rtol=1e-6, atol=1e-6,
                                   err_msg=path)
        np.testing.assert_allclose(p.detach().numpy(), want[path], rtol=1e-6, atol=1e-6,
                                   err_msg=path)


def test_pretrain_d2v_cli_prints_out_and_loss(tmp_path):
    out = str(tmp_path / "b" / "d2v.npz")
    res = cli.run(["pretrain-d2v", "--out", out, "--k", "16", "--steps", "5", "--device", "cpu"])
    assert res["out"] == out and np.isfinite(res["final_loss"])
    assert d2v.load_bundle(out)["fc1"]["kernel"].shape == (6, 8)


def test_fusion_forward_with_a_bundle_matches_jax(tmp_path):
    """The same fusion variables (init_variables' tree, which is the flax
    tree) with the same bundle installed in each package: the eval
    forwards agree, and differ from the forward without the bundle."""
    path = str(tmp_path / "d2v.npz")
    jax_d2v.save_bundle(jax_d2v._fold_normalization(_jax_d2v_params(3)), path)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, N, T, H, H, 1)).astype(np.float32)
    feats = np.tile(np.array([0, 0, 0, 2022, 9, 26], np.float32), (B, T, 1))
    feats[..., 5] += np.arange(T, dtype=np.float32)
    sup = np.eye(N, dtype=np.float32)[None]
    cfg = ModelConfig(**NARROW, gwnet=GWNetConfig(**NARROW_GWNET))
    tree = weights.init_variables(cfg, T, N, seed=0, image_size=H)
    variables = jax.tree.map(lambda v: jnp.asarray(v.numpy()), tree)
    jmodel = jax_build_model(JaxModelConfig(**NARROW, gwnet=JaxGWNetConfig(**NARROW_GWNET)), T)
    jparams = jax_d2v.install_bundle(variables["params"], jax_d2v.load_bundle(path))
    want = np.asarray(jmodel.apply({"params": jparams, "batch_stats": variables["batch_stats"]},
                                   jnp.asarray(x), jnp.asarray(feats), jnp.asarray(sup),
                                   train=False))
    model = build_model(cfg, T, N, H)

    def forward(params):
        weights.load_variables(model, {"params": params, "batch_stats": tree["batch_stats"]})
        with torch.no_grad():
            return model(torch.from_numpy(x), torch.from_numpy(feats), torch.from_numpy(sup),
                         train=False).numpy()

    got = forward(d2v.install_bundle(tree["params"], d2v.load_bundle(path)))
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)
    assert np.abs(forward(tree["params"]) - got).max() > 10 * np.abs(got - want).max()


ARGVS = [
    ["train"],
    ["train", "--adjacency", "a.csv", "--adjtype", "doubletransition", "--no_addaptadj",
     "--input_channels", "2", "--output_channels", "3", "--n_counties", "9", "--d2v_bundle",
     "b.npz", "--resume", "--num_runs", "2", "--tensorboard", "--profile_dir", "p",
     "--debug_nans", "--seed", "5", "--job_id", "j", "--epochs", "7", "--pool", "pallas",
     "--bn_two_pass", "--st_gnn", "dcrnn", "--teacher_forcing", "0.5", "--tf_decay_steps", "3",
     "--batch_size", "4", "--compute_dtype", "float32", "--horizon", "5", "--image_size", "32",
     "--dataset_range", "9", "--data_dir", "d"],
    ["train", "--adjtype", "transition"],
    ["evaluate", "--checkpoint_path", "c", "--adjtype", "doubletransition", "--no_addaptadj",
     "--n_counties", "5", "--d2v_bundle", "b.npz", "--adjacency", "a.csv", "--input_channels",
     "2", "--output_channels", "2", "--pool", "pallas"],
    ["serve", "--seed", "3", "--adjtype", "doubletransition", "--d2v_bundle", "b.npz",
     "--adjacency", "a.csv", "--n_counties", "4", "--st_gnn", "dcrnn"],
    ["serve", "--checkpoint_path", "c", "--no_addaptadj", "--input_channels", "3"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: "_".join(a[:2]))
def test_flags_map_onto_the_config_as_jax_build_config(argv):
    """The port's _config and the JAX CLI's _build_config, fed the same
    parsed namespace, give the same Config field by field. serve's --seed
    seeds the weights, not TrainConfig.seed (the JAX serve has none)."""
    ns = cli._parser().parse_args(argv)
    ours = json.dumps(asdict(cli._config(ns)), default=str, sort_keys=True)
    theirs = json.dumps(dataclasses.asdict(jax_cli._build_config(ns)), default=str,
                        sort_keys=True)
    assert ours == theirs
    if argv[0] == "serve":
        assert cli._config(ns).train.seed == 42


def test_num_runs_names_and_seeds_each_run(tiny_store_dir, tmp_path, monkeypatch):
    """--num_runs 2: runs <job_id>_r0 and _r1 at seed and seed + 1, each
    equal to a single run at its seed; {"runs": [...]} is the result."""
    monkeypatch.chdir(tmp_path)
    base = ["train", "--data_dir", tiny_store_dir, "--epochs", "1", *TINY]
    out = cli.run(base + ["--num_runs", "2", "--seed", "3", "--job_id", "nr"])
    assert list(out) == ["runs"] and len(out["runs"]) == 2
    for i in range(2):
        config = json.load(open(tmp_path / "logs" / f"nr_r{i}" / "config.json"))
        assert (config["train"]["job_id"], config["train"]["seed"]) == (f"nr_r{i}", 3 + i)
        single = cli.run(base + ["--seed", str(3 + i), "--job_id", f"single{i}"])
        assert out["runs"][i] == single
    assert out["runs"][0] != out["runs"][1]


@pytest.fixture(scope="module")
def nan_store(tiny_store_dir, tmp_path_factory):
    """The tiny store with every county's frame of one day NaN: the storm
    day of Ian, a training hurricane, which every epoch's batches reach."""
    src = load_store(tiny_store_dir)
    frames = np.array(src.frames)
    day = [tuple(d) for d in np.asarray(src.dates)].index((2022, 9, 28))
    frames[day] = np.nan
    out = str(tmp_path_factory.mktemp("nan_store"))
    save_store(out, frames, np.asarray(src.dates), src.county_names)
    return out


def _fit_cfg(store_dir, **train):
    return Config(
        data=DataConfig(data_dir=store_dir, image_size=H, horizon=T, dataset_range=6),
        model=ModelConfig(**NARROW, gwnet=GWNetConfig(**NARROW_GWNET)),
        train=TrainConfig(batch_size=2, epochs=1, seed=0, **train),
    )


def test_debug_nans_raises_on_a_nan_frame(nan_store, tmp_path):
    with pytest.raises(FloatingPointError, match="non-finite"):
        loop.fit(_fit_cfg(nan_store, debug_nans=True), run_dir=str(tmp_path / "a"),
                 progress=False, device="cpu")


def test_without_debug_nans_a_nan_frame_goes_unnoticed(nan_store, tmp_path):
    out = loop.fit(_fit_cfg(nan_store), run_dir=str(tmp_path / "b"), progress=False,
                   device="cpu")
    assert not all(np.isfinite(out[f"{s}_{k}"]) for s in ("val", "test")
                   for k in ("loss", "mae", "rmse"))


class _NanBackward(torch.nn.Module):
    """A finite forward whose backward is NaN: d√u/du at u = 0 is inf,
    times the 0 of u = 0·w."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(()))

    def forward(self, x, date_feats, supports, train=False, generator=None):
        return x * torch.sqrt(self.w * 0.0)


def test_debug_nans_covers_the_backward():
    batch = {"x": torch.ones(2, 3), "y": torch.zeros(2, 3), "date_feats": torch.zeros(2, 1, 6)}
    model = _NanBackward()
    state = create_train_state(model)
    with pytest.raises(FloatingPointError, match="nan values"):
        make_train_step(model, debug_nans=True)(state, batch, None, 1e-3, 0)
    assert model.w.item() == 1.0 and state.step == 0 and state.opt.count == 0
    make_train_step(model)(state, batch, None, 1e-3, 0)  # no check: the step runs
    assert state.step == 1


@pytest.mark.parametrize("log_every,steps,traced", [(2, 2, True), (5, 10, True), (8, 2, False)],
                         ids=["window", "loop_ends_inside", "never_reached"])
def test_profile_dir_and_tensorboard(log_every, steps, traced, tiny_store_dir, tmp_path):
    """fit with profile_dir writes <profile_dir>/trace.json once the
    process has run log_every steps (7 an epoch here), also when the loop
    ends inside the window; tensorboard writes <run_dir>/tb scalars."""
    prof = tmp_path / "prof"
    cfg = _fit_cfg(tiny_store_dir, log_every=log_every, profile_steps=steps,
                   profile_dir=str(prof), tensorboard=True)
    loop.fit(cfg, run_dir=str(tmp_path / "run"), progress=False, device="cpu")
    assert (prof / "trace.json").exists() == traced
    if traced:
        assert json.load(open(prof / "trace.json"))["traceEvents"]
    assert glob.glob(str(tmp_path / "run" / "tb" / "events.out.tfevents*"))


def _read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_tensorboard_scalars_written(tmp_path):
    lg = RunLogger(str(tmp_path / "run"), tensorboard=True)
    lg.log({"phase": "train", "epoch": 0, "step": 6, "train_loss": 1.25})
    lg.log({"phase": "val", "epoch": 0, "val_loss": 0.75})
    lg.log({"phase": "final", "best_epoch": 2, "note": "not-a-number"})  # skipped, not fatal
    lg.close()
    assert glob.glob(str(tmp_path / "run" / "tb" / "events.out.tfevents*"))
    rows = _read_jsonl(tmp_path / "run" / "metrics.jsonl")
    assert [r["phase"] for r in rows] == ["train", "val", "final"]


def test_tensorboard_degrades_to_jsonl_without_writers(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        lg = RunLogger(str(tmp_path / "run"), tensorboard=True)
    assert any("scalars disabled" in str(x.message) for x in w)
    lg.log({"phase": "train", "epoch": 0, "train_loss": 2.0})
    lg.close()
    assert _read_jsonl(tmp_path / "run" / "metrics.jsonl")[0]["train_loss"] == 2.0
    assert not (tmp_path / "run" / "tb").exists()


@pytest.fixture(scope="module")
def florida_store(tmp_path_factory):
    """67 counties in the packaged CSV's order, 16², ±4 days per storm."""
    out = str(tmp_path_factory.mktemp("florida"))
    generate_store(out, n_counties=67, image_size=H, margin=4, seed=0)
    return out


def _write_csv(path, names, adj):
    with open(path, "w") as f:
        f.write("," + ",".join(names) + "\n")
        for name, row in zip(names, adj):
            f.write(name + "," + ",".join(f"{v:g}" for v in row) + "\n")


@pytest.mark.parametrize("command", ["train", "serve"])
def test_adjacency_in_another_county_order_raises(command, florida_store, tmp_path,
                                                  monkeypatch):
    """--adjacency with the Florida graph in another county order and a
    non-identity adjtype: the county-order ValueError, before any step."""
    monkeypatch.chdir(tmp_path)
    names, adj = load_adjacency_csv()
    perm = np.random.default_rng(0).permutation(len(names))
    path = str(tmp_path / "perm.csv")
    _write_csv(path, [names[i] for i in perm], adj[np.ix_(perm, perm)])
    argv = [command, "--data_dir", florida_store, "--dataset_range", "4", "--horizon", "2",
            "--image_size", str(H), "--batch_size", "2", "--device", "cpu",
            "--adjacency", path, "--adjtype", "transition"]
    argv += ["--epochs", "1"] if command == "train" else ["--seed", "0"]
    with pytest.raises(ValueError, match="county order"):
        cli.run(argv)


def test_adjacency_copy_gives_the_packaged_supports(florida_store, tmp_path):
    names, adj = load_adjacency_csv()
    path = str(tmp_path / "copy.csv")
    _write_csv(path, names, adj)
    store = load_store(florida_store)
    for adjtype in ("transition", "doubletransition"):
        cfg = Config(model=ModelConfig(gwnet=GWNetConfig(adjtype=adjtype)))
        np.testing.assert_array_equal(config_supports(cfg.replace(adjacency_csv=path), store),
                                      config_supports(cfg, store))
    assert os.path.exists(default_adjacency_path())


@pytest.mark.parametrize("flags", [["--adjtype", "doubletransition"], ["--no_addaptadj"]],
                         ids=["doubletransition", "no_addaptadj"])
def test_serve_graph_flags_equal_the_module(flags, tiny_store_dir, tmp_path):
    """serve --seed 0 with the flags (S = 3: two static supports and the
    adaptive one; S = 1: the identity alone) predicts what evaluate's
    eval-mode module predicts from the same variables, and not what the
    default flags predict."""
    args = cli._parser().parse_args(["serve", "--seed", "0", *flags])
    model_cfg = cli._config(args).model
    ckpt = str(tmp_path / "ckpt")
    CheckpointManager(ckpt).save(
        0, weights.init_variables(model_cfg, T, N, seed=0, image_size=H), {"val_loss": 0.0})
    common = ["--data_dir", tiny_store_dir, "--case", "michael", *TINY, *flags]
    cli.run(["evaluate", "--checkpoint_path", ckpt, "--save_preds", str(tmp_path / "ev"),
             *common])
    cli.run(["serve", "--seed", "0", "--save_preds", str(tmp_path / "sv"), *common])
    cli.run(["serve", "--seed", "0", "--save_preds", str(tmp_path / "default"),
             *common[:-len(flags)]])
    ev, sv, default = (np.load(tmp_path / d / "preds.npy") for d in ("ev", "sv", "default"))
    np.testing.assert_allclose(sv, ev, atol=5e-5, rtol=1e-4)
    assert np.abs(default - sv).max() > 1e-3
