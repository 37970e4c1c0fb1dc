"""The port's training path (train/steps.py, train/loop.py, cli train) on
the CPU, against the JAX package's training step.

One-step parity: the same flax-initialised variables (with non-trivial
BatchNorm running statistics), the same numpy batch, float32,
pool="pallas" and dropout rates 0, N=4, T=3, B=2, H=32 (at 32² every
pool's W·C is 128, so each of the four pools takes the JAX kernel path;
at 16² the stem's W·C = 64 would fall back to reduce_window).

Loss, metrics and the new BatchNorm running statistics come from the
JAX package's jitted make_train_step. Gradients and the updated
parameters come from the same step's arithmetic run op by op
(jax.value_and_grad of its loss, then its optimizer and lr update):
several Graph WaveNet gradients are near-cancelling sums, and XLA's fused
CPU program computes them far less accurately. Measured on this input
against the same model in float64: the jitted JAX gradients are off by
up to 4.7% of a leaf's largest entry (st_gnn/skip_conv4_kernel), JAX op
by op by up to 5.2e-5, the port by up to 1.3e-5.

Tolerances: loss and metrics rtol 1e-5; each gradient leaf within
1e-4·max|g_leaf| + 1e-7; BN running stats atol 1e-6 / rtol 1e-5; updated
parameters atol 1e-6 where |g| exceeds that gradient tolerance (and is
large enough that Adam's ε cannot turn the gradient difference into
1e-6), and 2·lr elsewhere: Adam's first step is lr·g/(|g|+ε), so an
entry whose gradient lies within the summation noise moves by ±lr with
the sign of that noise. (A 1e-5·max|g_leaf| line would sit inside the 5.2e-5 noise of
JAX's own gradients.)

The same step with gwnet.use_pallas (the per-layer Graph WaveNet op and
its autograd.Function backward) is held to the same JAX step at the same
bars (test_use_pallas_one_step).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_outage_tpu.core import metrics as jax_metrics
from multimodal_outage_tpu.core.config import Config as JaxConfig
from multimodal_outage_tpu.core.config import DataConfig as JaxDataConfig
from multimodal_outage_tpu.core.config import GWNetConfig as JaxGWNetConfig
from multimodal_outage_tpu.core.config import ModelConfig as JaxModelConfig
from multimodal_outage_tpu.core.config import TrainConfig as JaxTrainConfig
from multimodal_outage_tpu.models.fusion import build_model as jax_build_model
from multimodal_outage_tpu.train import loop as jax_loop
from multimodal_outage_tpu.train.state import create_train_state as jax_create_train_state
from multimodal_outage_tpu.train.state import make_optimizer as jax_make_optimizer
from multimodal_outage_tpu.train.steps import make_train_step as jax_make_train_step
from multimodal_outage_tpu_torch import cli, weights
from multimodal_outage_tpu_torch.core.checkpoint import CheckpointManager
from multimodal_outage_tpu_torch.core.config import (
    Config,
    DataConfig,
    GWNetConfig,
    MeshConfig,
    ModelConfig,
    TrainConfig,
)
from multimodal_outage_tpu_torch.data.pipeline import DevicePipeline
from multimodal_outage_tpu_torch.data.synthetic import generate_store
from multimodal_outage_tpu_torch.models.fusion import build_model
from multimodal_outage_tpu_torch.ops.gwnet_layer import fused_gwnet_layer
from multimodal_outage_tpu_torch.serving import ServingModel
from multimodal_outage_tpu_torch.train import loop
from multimodal_outage_tpu_torch.train.state import create_train_state
from multimodal_outage_tpu_torch.train.steps import make_predict_step, make_train_step

B, N, T, H = 2, 4, 3, 32
LR = 1e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(pool="pallas", dtype="float32"):
    jcfg = JaxModelConfig(compute_dtype=dtype, pool=pool, encoder_dropout=0.0,
                          gwnet=JaxGWNetConfig(dropout=0.0))
    tcfg = ModelConfig(compute_dtype=dtype, pool=pool, encoder_dropout=0.0,
                       gwnet=GWNetConfig(dropout=0.0))
    return jcfg, tcfg


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    feats = np.tile(np.array([0, 0, 0, 2022, 9, 26], np.float32), (B, T, 1))
    feats[..., 5] += np.arange(T, dtype=np.float32)
    return {
        "x": rng.standard_normal((B, N, T, H, H, 1)).astype(np.float32),
        "y": rng.standard_normal((B, N, T, H, H, 1)).astype(np.float32),
        "date_feats": feats,
    }


def _port_state(tcfg, variables):
    model = build_model(tcfg, T, N, H)
    weights.load_variables(model, weights.from_flax(_np(variables)))
    return model, create_train_state(model)


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_one_step():
    jcfg, _ = _configs()
    model = jax_build_model(jcfg, T)
    batch = _batch()
    sup = np.eye(N, dtype=np.float32)[None]
    key = jax.random.PRNGKey(0)
    state = jax_create_train_state(model, key, {k: jnp.asarray(v) for k, v in batch.items()}, sup)
    bs = jax.tree.map(
        lambda v: v + 0.3 * jnp.arange(v.size, dtype=v.dtype).reshape(v.shape) / v.size,
        state.batch_stats,
    )
    state = state.replace(batch_stats=bs)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    step = jax_make_train_step(model, donate=False, compiler_options=None)
    new, jm = step(state, jbatch, jnp.asarray(sup), jnp.float32(LR), key)

    def loss_fn(params):  # the step's loss (JAX train/steps.py:97-108)
        yhat, _ = model.apply(
            {"params": params, "batch_stats": state.batch_stats}, jbatch["x"],
            jbatch["date_feats"], jnp.asarray(sup), train=True, rngs={"dropout": key},
            mutable=["batch_stats"],
        )
        return jax_metrics.mse(yhat, jbatch["y"])

    grads = jax.grad(loss_fn)(state.params)  # op by op: no jit
    updates, _ = jax_make_optimizer().update(grads, state.opt_state, state.params)
    new_params = jax.tree.map(lambda p, u: p + u * jnp.float32(LR), state.params, updates)
    return {
        "variables": {"params": state.params, "batch_stats": bs}, "batch": batch, "sup": sup,
        "jax_metrics": {k: float(v) for k, v in jm.items()},
        "jax_grads": weights.flatten(_np(grads)),
        "jax_new": weights.flatten(_np({"params": new_params, "batch_stats": new.batch_stats})),
        "old": weights.flatten(_np({"params": state.params, "batch_stats": bs})),
    }


def _port_one_step(jax_step, tcfg):
    """The same step in the port, beside the JAX step's results."""
    tmodel, tstate = _port_state(tcfg, jax_step["variables"])
    tm = make_train_step(tmodel)(tstate, _tbatch(jax_step["batch"]),
                                 torch.from_numpy(jax_step["sup"]), LR, 0)
    port_grads = {
        k.replace(".", "/"): (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
        for k, p in tmodel.named_parameters()
    }
    return {
        **jax_step,
        "port_metrics": {k: float(v) for k, v in tm.items()},
        "port_grads": port_grads,
        "port_new": weights.flatten(weights.module_variables(tmodel)),
        "port_model": tmodel,
    }


@pytest.fixture(scope="module")
def one_step(jax_one_step):
    return _port_one_step(jax_one_step, _configs()[1])


@pytest.fixture(scope="module")
def one_step_pallas(jax_one_step):
    """The port's step with gwnet.use_pallas: its Graph WaveNet layers go
    through fused_gwnet_layer (plain forward on the CPU, backward by
    autograd of the plain version). The JAX package runs use_pallas off
    the TPU as forward_reference (models/fusion.py:40), the program of
    jax_one_step, so that step is the reference for both."""
    _, tcfg = _configs()
    tcfg = dataclasses.replace(tcfg, gwnet=dataclasses.replace(tcfg.gwnet, use_pallas=True))
    out = _port_one_step(jax_one_step, tcfg)
    assert out["port_model"].st_gnn._layer is fused_gwnet_layer
    return out


def _check_loss_and_metrics(step):
    j, t = step["jax_metrics"], step["port_metrics"]
    assert set(j) == set(t) == {"loss", "mae", "mape", "rmse"}
    for k in j:
        np.testing.assert_allclose(t[k], j[k], rtol=1e-5, err_msg=k)


def _check_every_gradient_leaf(step):
    jg, tg = step["jax_grads"], step["port_grads"]
    assert set(jg) == set(tg)
    for k in jg:
        bound = 1e-4 * np.abs(jg[k]).max() + 1e-7
        assert np.abs(tg[k] - jg[k]).max() <= bound, k
    # the frozen Date2Vec takes no gradient on either side
    assert not np.abs(jg["date2vec/fc1/kernel"]).any()


def _check_batchnorm_running_stats(step):
    jn, tn, old = step["jax_new"], step["port_new"], step["old"]
    keys = [k for k in jn if k.startswith("batch_stats/")]
    assert len(keys) == 2 * (18 + 8)  # mean, var of 18 U-Net and 8 Graph WaveNet BNs
    for k in keys:
        np.testing.assert_allclose(tn[k].numpy(), jn[k], atol=1e-6, rtol=1e-5, err_msg=k)
        assert not np.array_equal(jn[k], old[k]), k  # the EMA moved


def _check_updated_params(step):
    jn, tn, old, jg = step["jax_new"], step["port_new"], step["old"], step["jax_grads"]
    for k in (k for k in jn if k.startswith("params/")):
        g = np.abs(jg[k[len("params/"):]])
        d = np.abs(tn[k].numpy() - jn[k])
        tol = 1e-4 * g.max() + 1e-7  # the gradient tolerance above
        # above tol both gradients have one sign; Adam's ε then moves the
        # update by at most lr·ε·tol/|g|², kept under 5e-7 here
        signal = (g > tol) & (g * g > LR * 1e-8 * tol / 5e-7)
        assert (d[signal] <= 1e-6).all(), k
        assert (d <= 2 * LR + 1e-7).all(), k
    for k in ("params/date2vec/fc1/kernel", "params/date2vec/fc2/bias"):
        assert np.array_equal(tn[k].numpy(), old[k])  # frozen: unchanged


def test_one_step_loss_and_metrics(one_step):
    _check_loss_and_metrics(one_step)


def test_one_step_every_gradient_leaf(one_step):
    _check_every_gradient_leaf(one_step)


def test_one_step_batchnorm_running_stats(one_step):
    _check_batchnorm_running_stats(one_step)


def test_one_step_updated_params(one_step):
    _check_updated_params(one_step)


@pytest.mark.parametrize(
    "check",
    [_check_loss_and_metrics, _check_every_gradient_leaf, _check_batchnorm_running_stats,
     _check_updated_params],
    ids=["loss_and_metrics", "every_gradient_leaf", "batchnorm_running_stats", "updated_params"],
)
def test_use_pallas_one_step(one_step_pallas, check):
    """The same bars with the per-layer Graph WaveNet op: its backward
    (the autograd.Function's re-materialised VJP) gives every gradient,
    nodevec1/2 through the supports gradient included."""
    check(one_step_pallas)
    assert np.abs(one_step_pallas["port_grads"]["st_gnn/nodevec1"]).max() > 0


@pytest.fixture(scope="module")
def store32(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("store32"))
    generate_store(out, n_counties=N, image_size=H, margin=12, seed=0)
    return out


def test_three_steps_through_both_pipelines(store32):
    """Three shuffled batches drawn through each package's own dataset,
    split and device pipeline from one store, and three steps. The jitted
    JAX step is used here; after the first update the two trajectories
    carry its sign flips of noise-level gradients, so the losses are held
    at rtol 2e-4."""
    jcfg, tcfg = _configs()
    data = dict(data_dir=store32, image_size=H, horizon=T, dataset_range=8)
    jc = JaxConfig(data=JaxDataConfig(**data), model=jcfg,
                   train=JaxTrainConfig(batch_size=B, seed=3))
    tc = Config(data=DataConfig(**data), model=tcfg, train=TrainConfig(batch_size=B, seed=3))
    jds, jtr, _, _ = jax_loop.prepare_datasets(jc, "michael")
    tds, ttr, _, _ = loop.prepare_datasets(tc, "michael")
    np.testing.assert_array_equal(jtr, ttr)
    jpipe = jax_loop.make_pipeline(jc, jds.store)
    tpipe = DevicePipeline(tds.store, tc.data.mean, tc.data.std, H, torch.bfloat16,
                           torch.device("cpu"))
    jbatches = [b for _, b in zip(range(3), jax_loop._epoch_iter(jds, jtr, jc, True, 3, jpipe))]
    tbatches = [b for _, b in zip(range(3), loop._epoch_iter(tds, ttr, tc, True, 3, tpipe))]
    for jb, tb in zip(jbatches, tbatches):
        for k in ("x", "y", "date_feats"):
            np.testing.assert_array_equal(tb[k].float().numpy(), np.asarray(jb[k], np.float32))

    sup = np.eye(N, dtype=np.float32)[None]
    model = jax_build_model(jcfg, T)
    state = jax_create_train_state(model, jax.random.PRNGKey(1), jbatches[0], sup)
    tmodel, tstate = _port_state(tcfg, {"params": state.params, "batch_stats": state.batch_stats})
    jstep = jax_make_train_step(model, donate=False, compiler_options=None)
    tstep = make_train_step(tmodel)
    jl, tl = [], []
    for jb, tb in zip(jbatches, tbatches):
        state, jm = jstep(state, jb, jnp.asarray(sup), jnp.float32(LR), jax.random.PRNGKey(1))
        jl.append(float(jm["loss"]))
        tl.append(float(tstep(tstate, tb, torch.from_numpy(sup), LR, 1)["loss"]))
    assert tstate.step == 3 and tstate.opt.count == 3
    np.testing.assert_allclose(tl, jl, rtol=2e-4)


def test_dropout_steps_are_reproducible_from_the_seed():
    """With the default dropout rates, a step is a function of (seed,
    step): the same seed gives the same update, another seed another."""
    cfg = ModelConfig(compute_dtype="float32")
    var = weights.init_variables(cfg, T, N, seed=0, image_size=H)
    batch, sup = _tbatch(_batch(1)), torch.eye(N)[None]
    losses = []
    for seed in (5, 5, 6):
        model = weights.load_variables(build_model(cfg, T, N, H), var)
        losses.append(float(make_train_step(model)(create_train_state(model), batch, sup, LR, seed)["loss"]))
    assert losses[0] == losses[1] != losses[2]


def test_bf16_step_runs_and_is_finite():
    _, tcfg = _configs(dtype="bfloat16")
    model = weights.load_variables(build_model(tcfg, T, N, H),
                                   weights.init_variables(tcfg, T, N, seed=0, image_size=H))
    state = create_train_state(model)
    m = make_train_step(model)(state, _tbatch(_batch(2)), torch.eye(N)[None], LR, 0)
    assert all(np.isfinite(float(v)) for v in m.values())
    assert all(torch.isfinite(p).all() for p in model.parameters())
    assert model.contraction.inc.conv1.kernel.dtype == torch.float32  # f32 masters


TINY = ["--dataset_range", "8", "--horizon", str(T), "--image_size", str(H),
        "--batch_size", "2", "--seed", "0", "--pool", "pallas", "--compute_dtype", "float32"]


def test_cli_train_cpu_writes_and_restores_checkpoint(store32, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert cli.main(["train", "--data_dir", store32, "--epochs", "2", "--job_id", "tiny",
                     "--device", "cpu", *TINY]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["train_steps"] == 2 * 10 and out["best_epoch"] in (0, 1)
    assert all(np.isfinite(out[f"{s}_{k}"]) for s in ("val", "test")
               for k in ("loss", "mae", "mape", "rmse"))
    ckpt = CheckpointManager(str(tmp_path / "logs" / "tiny" / "checkpoints"))
    assert ckpt.best_step == out["best_epoch"] and ckpt.latest_step() == 1
    tree = ckpt.restore()
    assert tree["meta"]["best_epoch"] == out["best_epoch"] and tree["opt_state"]["count"] > 0
    records = [json.loads(line) for line in open(tmp_path / "logs" / "tiny" / "metrics.jsonl")]
    assert [r["phase"] for r in records if r["phase"] != "train"] == ["val", "val", "final"]

    # a fresh evaluate of the best checkpoint gives the run's test metrics
    tc = Config(data=DataConfig(data_dir=store32, image_size=H, horizon=T, dataset_range=8),
                model=ModelConfig(compute_dtype="float32", pool="pallas"),
                train=TrainConfig(batch_size=2, seed=0))
    _, _, _, test_ds = loop.prepare_datasets(tc, "michael")
    model = weights.load_variables(build_model(tc.model, T, N, H), tree)
    pipe = DevicePipeline(test_ds.store, tc.data.mean, tc.data.std, H, torch.bfloat16,
                          torch.device("cpu"))
    test = loop.evaluate(make_predict_step(model), test_ds, np.arange(len(test_ds)), tc,
                         torch.eye(N)[None], pipe)
    for k, v in test.items():
        assert v == out[f"test_{k}"], k


def test_cli_train_without_device_needs_a_card(store32, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the check is for one without")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.run(["train", "--data_dir", store32, "--epochs", "1", *TINY])
    assert not (tmp_path / "logs").exists()


def test_trained_module_feeds_the_serving_engine():
    """module_variables of a module after a train step is a tree the
    serving engine takes as it is; its BN-folded eval forward equals the
    module's eval forward (the JAX serving bar, atol 5e-5 / rtol 1e-4)."""
    cfg = ModelConfig(compute_dtype="float32")
    model = weights.load_variables(build_model(cfg, T, N, H),
                                   weights.init_variables(cfg, T, N, seed=1, image_size=H))
    sup = torch.eye(N)[None]
    make_train_step(model)(create_train_state(model), _tbatch(_batch(3)), sup, LR, 0)
    batch = _tbatch(_batch(4))
    with torch.no_grad():
        want = model(batch["x"], batch["date_feats"], sup, train=False)
    serve = ServingModel(cfg, weights.module_variables(model), sup, horizon=T, device="cpu")
    got = serve(batch["x"], batch["date_feats"])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize(
    "cfg,match",
    [
        (ModelConfig(remat=True), "grad_accum and remat"),
        (ModelConfig(gwnet=GWNetConfig(gcn_bool=False)), "non-fused Graph WaveNet branches"),
        (ModelConfig(gwnet=GWNetConfig(kernel_size=2)), "non-fused Graph WaveNet branches"),
        (ModelConfig(gwnet=GWNetConfig(reference_view_quirk=True)),
         "non-fused Graph WaveNet branches"),
    ],
)
def test_unported_model_configs_raise(cfg, match):
    """remat raises until it is ported; the Graph WaveNet configs that
    raised before the non-fused branches were ported build, load their
    init_variables tree and give a finite train-mode forward."""
    if match != "non-fused Graph WaveNet branches":
        with pytest.raises(NotImplementedError, match=match):
            build_model(cfg, T, N, H)
        return
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    model = weights.load_variables(build_model(cfg, T, N, H),
                                   weights.init_variables(cfg, T, N, seed=0, image_size=H))
    batch = _tbatch(_batch(5))
    y = model(batch["x"], batch["date_feats"], torch.eye(N)[None], train=True)
    assert tuple(y.shape) == (B, N, T, H, H, 1) and torch.isfinite(y).all()


@pytest.mark.parametrize(
    "train",
    [TrainConfig(grad_accum=2), TrainConfig(grad_accum=0),
     Config(model=ModelConfig(remat=True)), Config(mesh=MeshConfig(model=2)),
     Config(model=ModelConfig(gwnet=GWNetConfig(randomadj=False)))],
)
def test_unported_train_knobs_raise(train):
    """The knobs fit does not run yet (grad_accum, remat, a mesh) raise;
    svd_aptinit (randomadj=False), which raised before the non-fused
    Graph WaveNet branches were ported, is accepted (its nodevecs:
    tests/test_torch_port_gwnet_branches.py); resume, tensorboard,
    profile_dir, debug_nans and d2v_bundle run
    (tests/test_torch_port_resume.py, tests/test_torch_port_run_options.py)."""
    cfg = train if isinstance(train, Config) else Config(train=train)
    if not cfg.model.gwnet.randomadj:
        loop.check_supported(cfg)
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            loop.check_supported(cfg)
    loop.check_supported(Config(train=TrainConfig(resume=True, tensorboard=True,
                                                  profile_dir="p", debug_nans=True)))


def test_d2v_bundle_raises_until_installed(tmp_path):
    """A pretrained Date2Vec bundle is installed at init, or fit raises:
    a bundle that cannot be read never trains with a random Date2Vec."""
    cfg = Config(model=ModelConfig(d2v_bundle=str(tmp_path / "missing.npz")))
    loop.check_supported(cfg)
    with pytest.raises(FileNotFoundError):
        loop._initial_variables(cfg, 4, np.eye(4, dtype=np.float32)[None])


def test_config_copies_match_jax_defaults():
    for ours, theirs in ((TrainConfig(), JaxTrainConfig()), (Config(), JaxConfig())):
        assert json.dumps(dataclasses.asdict(ours), default=str, sort_keys=True) == \
            json.dumps(dataclasses.asdict(theirs), default=str, sort_keys=True)
