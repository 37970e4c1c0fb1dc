"""DCRNN training in the port (models/dcrnn.py scheduled sampling,
models/fusion.py's teacher pass, train/steps.py) on the CPU, against the
JAX package's training step; the crash-safe checkpoint index and the
synthetic store's per-pixel noise. The end-to-end runs (fit and the CLI's
train → evaluate → serve) are in tests/test_torch_port_dcrnn_fit.py.

One-step parity: the same flax-initialised variables (with non-trivial
BatchNorm running statistics), the same numpy batch and the supports the
port's config_supports builds for DCRNN (dual random walk: 2 supports of
the synthetic 4-county graph), float32, pool="pallas", dropout 0, N=4,
T=3, B=2, H=32 (at 32² every pool's W·C is 128, so each of the four
pools takes the JAX kernel path). Loss, metrics and the new BatchNorm
running statistics come from the JAX package's jitted make_train_step;
gradients and updated parameters from the same step run op by op (the
method and bars of tests/test_torch_port_train.py): loss and metrics rtol
1e-5; each gradient leaf within 1e-4·max|g_leaf| + 1e-7; BN running stats
atol 1e-6 / rtol 1e-5; updated parameters atol 1e-6 where |g| is above
the gradient tolerance, 2·lr elsewhere.

The coins cannot match the JAX package's: it draws each decoder step's
coin with jax.random.bernoulli from a threefry key, the port from a CPU
torch.Generator seeded by (seed, step). Both compare a uniform [0, 1)
value with p, so at p = 0 and p = 1 every coin is fixed, and the port is
held to JAX there. At mixed p the coins are tested for reproducibility,
granularity (one per decoder step for the whole batch) and frequency.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_outage_tpu.core import metrics as jax_metrics
from multimodal_outage_tpu.core.config import DCRNNConfig as JaxDCRNNConfig
from multimodal_outage_tpu.core.config import ModelConfig as JaxModelConfig
from multimodal_outage_tpu.data.store import load_store as jax_load_store
from multimodal_outage_tpu.data.synthetic import generate_frames as jax_generate_frames
from multimodal_outage_tpu.data.synthetic import generate_store as jax_generate_store
from multimodal_outage_tpu.data.synthetic import synthetic_dates as jax_synthetic_dates
from multimodal_outage_tpu.models.fusion import build_model as jax_build_model
from multimodal_outage_tpu.train import loop as jax_loop
from multimodal_outage_tpu.train import steps as jax_steps
from multimodal_outage_tpu.train.state import create_train_state as jax_create_train_state
from multimodal_outage_tpu.train.state import make_optimizer as jax_make_optimizer
from multimodal_outage_tpu_torch import cli, weights
from multimodal_outage_tpu_torch.core.checkpoint import CheckpointManager, restore_variables
from multimodal_outage_tpu_torch.core.config import (
    Config,
    DCRNNConfig,
    ModelConfig,
    TrainConfig,
)
from multimodal_outage_tpu_torch.data.adjacency import config_supports, model_supports
from multimodal_outage_tpu_torch.data.store import load_store
from multimodal_outage_tpu_torch.data.synthetic import generate_frames, synthetic_dates
from multimodal_outage_tpu_torch.models.fusion import build_model
from multimodal_outage_tpu_torch.train import loop
from multimodal_outage_tpu_torch.train.state import create_train_state
from multimodal_outage_tpu_torch.train.steps import (
    make_train_step,
    sampling_generator,
    tf_schedule,
    uses_teacher_forcing,
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's small torch ops: with the
    suite's workers sharing the cores, OpenMP's barriers otherwise stall
    each op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, N, T, H = 2, 4, 3, 32
LR = 1e-3
SEED = 42  # TrainConfig's default: draws the synthetic 4-county graph
KEYS = ("loss", "mae", "mape", "rmse")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(tf=0.0, tau=0, dtype="float32"):
    jcfg = JaxModelConfig(st_gnn="dcrnn", compute_dtype=dtype, pool="pallas",
                          encoder_dropout=0.0,
                          dcrnn=JaxDCRNNConfig(teacher_forcing=tf, tf_decay_steps=tau))
    tcfg = ModelConfig(st_gnn="dcrnn", compute_dtype=dtype, pool="pallas", encoder_dropout=0.0,
                       dcrnn=DCRNNConfig(teacher_forcing=tf, tf_decay_steps=tau))
    return jcfg, tcfg


def _supports():
    return model_supports(_configs()[1], N, seed=SEED)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    feats = np.tile(np.array([0, 0, 0, 2022, 9, 26], np.float32), (B, T, 1))
    feats[..., 5] += np.arange(T, dtype=np.float32)
    return {
        "x": rng.standard_normal((B, N, T, H, H, 1)).astype(np.float32),
        "y": rng.standard_normal((B, N, T, H, H, 1)).astype(np.float32),
        "date_feats": feats,
    }


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_model(tcfg, variables):
    model = build_model(tcfg, T, N, H)
    return weights.load_variables(model, weights.from_flax(_np(variables)))


@pytest.fixture(scope="module")
def flax_variables():
    """Flax-initialised DCRNN ModifiedUNet variables with non-trivial
    running statistics (the init does not depend on the knob)."""
    jcfg, _ = _configs()
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    state = jax_create_train_state(jax_build_model(jcfg, T), jax.random.PRNGKey(0), batch,
                                   jnp.asarray(_supports()))
    bs = jax.tree.map(
        lambda v: v + 0.3 * jnp.arange(v.size, dtype=v.dtype).reshape(v.shape) / v.size,
        state.batch_stats,
    )
    return state, {"params": state.params, "batch_stats": bs}


def _jax_one_step(flax_variables, tf):
    state, variables = flax_variables
    state = state.replace(batch_stats=variables["batch_stats"])
    jcfg, _ = _configs(tf)
    model = jax_build_model(jcfg, T)
    batch, sup = _batch(), jnp.asarray(_supports())
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(0)
    step = jax_steps.make_train_step(model, donate=False, compiler_options=None)
    new, jm = step(state, jbatch, sup, jnp.float32(LR), key)

    dropout_rng = jax.random.fold_in(key, state.step)
    tf_kwargs, tf_rngs = jax_steps._teacher_kwargs(model, state, jbatch, dropout_rng)

    def loss_fn(params):  # the step's loss (JAX train/steps.py:97-108)
        yhat, _ = model.apply(
            {"params": params, "batch_stats": state.batch_stats}, jbatch["x"],
            jbatch["date_feats"], sup, train=True, rngs={"dropout": dropout_rng, **tf_rngs},
            mutable=["batch_stats"], **tf_kwargs,
        )
        return jax_metrics.mse(yhat, jbatch["y"])

    grads = jax.grad(loss_fn)(state.params)  # op by op: no jit
    updates, _ = jax_make_optimizer().update(grads, state.opt_state, state.params)
    new_params = jax.tree.map(lambda p, u: p + u * jnp.float32(LR), state.params, updates)
    return {
        "jax_metrics": {k: float(v) for k, v in jm.items()},
        "jax_grads": weights.flatten(_np(grads)),
        "jax_new": weights.flatten(_np({"params": new_params, "batch_stats": new.batch_stats})),
        "old": weights.flatten(_np(variables)),
    }


@pytest.fixture(scope="module", params=[0.0, 1.0], ids=["tf0", "tf1"])
def one_step(request, flax_variables):
    """JAX's step and the port's on the same variables, batch and
    supports, at teacher_forcing p (constant)."""
    tf = request.param
    out = _jax_one_step(flax_variables, tf)
    tmodel = _port_model(_configs(tf)[1], flax_variables[1])
    tstate = create_train_state(tmodel)
    tm = make_train_step(tmodel)(tstate, _tbatch(_batch()), torch.from_numpy(_supports()), LR, 0)
    out.update(
        tf=tf,
        port_metrics={k: float(v) for k, v in tm.items()},
        port_grads={k.replace(".", "/"): (p.grad if p.grad is not None
                                          else torch.zeros_like(p)).numpy()
                    for k, p in tmodel.named_parameters()},
        port_new=weights.flatten(weights.module_variables(tmodel)),
    )
    return out


def _check_loss_and_metrics(step):
    j, t = step["jax_metrics"], step["port_metrics"]
    assert set(j) == set(t) == set(KEYS)
    for k in j:
        np.testing.assert_allclose(t[k], j[k], rtol=1e-5, err_msg=k)


def _check_every_gradient_leaf(step):
    jg, tg = step["jax_grads"], step["port_grads"]
    assert set(jg) == set(tg)
    assert any(k.startswith("st_gnn/encoder/cell1/") for k in jg)
    for k in jg:
        bound = 1e-4 * np.abs(jg[k]).max() + 1e-7
        assert np.abs(tg[k] - jg[k]).max() <= bound, k
    assert not np.abs(jg["date2vec/fc1/kernel"]).any()  # frozen on both sides


def _check_batchnorm_running_stats(step):
    jn, tn, old = step["jax_new"], step["port_new"], step["old"]
    keys = [k for k in jn if k.startswith("batch_stats/")]
    assert len(keys) == 2 * 18  # mean, var of the 18 U-Net BNs; DCRNN has none
    for k in keys:
        np.testing.assert_allclose(tn[k].numpy(), jn[k], atol=1e-6, rtol=1e-5, err_msg=k)
        assert not np.array_equal(jn[k], old[k]), k  # the EMA moved


def _check_updated_params(step):
    jn, tn, old, jg = step["jax_new"], step["port_new"], step["old"], step["jax_grads"]
    for k in (k for k in jn if k.startswith("params/")):
        g = np.abs(jg[k[len("params/"):]])
        d = np.abs(tn[k].numpy() - jn[k])
        tol = 1e-4 * g.max() + 1e-7
        signal = (g > tol) & (g * g > LR * 1e-8 * tol / 5e-7)
        assert (d[signal] <= 1e-6).all(), k
        assert (d <= 2 * LR + 1e-7).all(), k


@pytest.mark.parametrize(
    "check",
    [_check_loss_and_metrics, _check_every_gradient_leaf, _check_batchnorm_running_stats,
     _check_updated_params],
    ids=["loss_and_metrics", "every_gradient_leaf", "batchnorm_running_stats", "updated_params"],
)
def test_one_step_matches_jax(one_step, check):
    check(one_step)


def test_teacher_forcing_reaches_the_decoder(flax_variables):
    """At p = 1 the decoder is fed the encoded targets: the step's loss
    differs from p = 0's, while the eval forward ignores the knob (the
    port's tests/test_teacher_forcing.py:62-92), even when given targets."""
    losses, evals = {}, {}
    batch, sup = _tbatch(_batch()), torch.from_numpy(_supports())
    for tf in (0.0, 1.0):
        model = _port_model(_configs(tf)[1], flax_variables[1])
        with torch.no_grad():
            evals[tf] = model(batch["x"], batch["date_feats"], sup, train=False)
            knob = model(batch["x"], batch["date_feats"], sup, train=False,
                         targets=batch["y"], tf_prob=1.0)
        assert torch.equal(knob, evals[tf])
        losses[tf] = float(make_train_step(model)(create_train_state(model), batch, sup, LR, 0)
                           ["loss"])
    assert torch.equal(evals[0.0], evals[1.0])
    assert losses[0.0] != losses[1.0]


def _teacher_inputs(model, batch, sup):
    """The latent targets the train-mode forward hands the DCRNN."""
    seen = {}

    def grab(module, args, kwargs):
        seen["targets"] = kwargs["targets"].clone()

    h = model.st_gnn.register_forward_pre_hook(grab, with_kwargs=True)
    try:
        model(batch["x"], batch["date_feats"], sup, train=True, targets=batch["y"], tf_prob=1.0)
    finally:
        h.remove()
    return seen["targets"]


def test_teacher_pass_reads_the_updated_running_stats(flax_variables):
    """The teacher pass runs after the train pass, so it normalizes with
    the running statistics that pass has just updated, as flax's one apply
    does (JAX layers.py:150-173): its latent targets equal an eval-mode
    encoding by the model after the step's BN update, and differ from one
    before it by far more than the parity bars."""
    batch, sup = _tbatch(_batch()), torch.from_numpy(_supports())
    _, tcfg = _configs(1.0)
    model = _port_model(tcfg, flax_variables[1])
    before = _port_model(tcfg, flax_variables[1])
    got = _teacher_inputs(model, batch, sup)
    with torch.no_grad():
        after = model.encoder(model.contraction(batch["y"], False)[0], False)
        stale = before.encoder(before.contraction(batch["y"], False)[0], False)
    assert torch.equal(got, after)
    assert float((got - stale).abs().max()) > 1e-2 * float(got.abs().max())


def test_teacher_pass_changes_no_running_stat_and_takes_no_gradient(flax_variables):
    """The teacher pass makes no BN update and adds no gradient: the
    contraction's running statistics after a p = 1 step (whose teacher
    pass runs through the contraction) equal those after a p = 0 step
    from the same state (the expansion's differ: its input does), and
    every gradient equals that of a step whose decoder gets the same
    latent targets as constants."""
    batch, sup = _tbatch(_batch()), torch.from_numpy(_supports())
    stats = {}
    for tf in (0.0, 1.0):
        model = _port_model(_configs(tf)[1], flax_variables[1])
        make_train_step(model)(create_train_state(model), batch, sup, LR, 0)
        stats[tf] = {k: b.clone() for k, b in model.contraction.named_buffers()}
    assert len(stats[1.0]) == 2 * 10 and stats[0.0].keys() == stats[1.0].keys()
    for k in stats[0.0]:
        assert torch.equal(stats[0.0][k], stats[1.0][k]), k

    _, tcfg = _configs(1.0)
    grads = []
    for constant in (False, True):
        model = _port_model(tcfg, flax_variables[1])
        kw = {"tf_prob": 1.0}
        if constant:  # the same latent targets, computed outside the graph
            latent = _teacher_inputs(_port_model(tcfg, flax_variables[1]), batch, sup)
            dcrnn_forward = model.st_gnn.forward
            model.st_gnn.forward = lambda *a, **k: dcrnn_forward(*a, **{**k, "targets": latent})
        yhat = model(batch["x"], batch["date_feats"], sup, train=True, targets=batch["y"], **kw)
        torch.mean(torch.square(yhat - batch["y"])).backward()
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()
                      if p.grad is not None})
    assert grads[0].keys() == grads[1].keys()
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k


@pytest.mark.parametrize("tf,tau,step", [(0.8, 100, 0), (0.8, 100, 100), (0.8, 100, 1000),
                                          (0.5, 0, 123), (0.3, 7, 70)])
def test_tf_schedule_matches_jax(tf, tau, step):
    jmodel = jax_build_model(_configs(tf, tau)[0], T)
    tmodel = build_model(_configs(tf, tau)[1], T, N, H)
    want = float(jax_steps.tf_schedule(jmodel, jnp.int32(step)))
    got = tf_schedule(tmodel, step)
    assert isinstance(got, np.float32)
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    assert uses_teacher_forcing(tmodel) == jax_steps.uses_teacher_forcing(jmodel) is True


def test_coins_are_reproducible_per_decoder_step_and_near_p():
    """horizon coins per step, the same for the same (seed, step) on a
    stream apart from dropout's, and heads at a rate near p."""
    dcrnn = build_model(_configs(0.3)[1], T, N, H).st_gnn
    draw = lambda seed, step, p=0.3: dcrnn.coins(p, sampling_generator(seed, step))
    assert len(draw(0, 0)) == T and all(isinstance(c, bool) for c in draw(0, 0))
    assert all(draw(5, s) == draw(5, s) for s in range(20))
    assert len({tuple(draw(5, s)) for s in range(40)}) > 1
    assert [draw(5, s) for s in range(40)] != [draw(6, s) for s in range(40)]
    heads = np.array([draw(1, s) for s in range(2000)], dtype=np.float64)
    assert abs(heads.mean() - 0.3) < 0.02  # 6000 coins: σ ≈ 0.006
    assert all(draw(2, s, 1.0) == [True] * T and draw(2, s, 0.0) == [False] * T
               for s in range(50))
    # the dropout stream of the same (seed, step) differs
    from multimodal_outage_tpu_torch.train.steps import step_generator
    u = torch.rand(8, generator=sampling_generator(3, 4))
    assert not torch.equal(u, torch.rand(8, generator=step_generator(3, 4, torch.device("cpu"))))


def test_one_coin_per_decoder_step_for_the_whole_batch():
    """Given coins (heads, tails, heads), the module's decoder takes the
    target for the whole batch after step 0 and its own output after
    step 1: the same outputs as a decoder written out by hand."""
    from multimodal_outage_tpu_torch.models.dcrnn import DCRNN

    din, dout = 6, 5
    m = DCRNN(din, dout, horizon=T, rnn_units=4, n_supports=2, teacher_forcing=0.5)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(0.3 * torch.randn(p.shape, generator=g))
    x, y = torch.randn(B, N, T, din, generator=g), torch.randn(B, N, T, dout, generator=g)
    sup = torch.from_numpy(_supports())
    pattern = [True, False, True]
    m.coins = lambda tf_prob, sampling: pattern
    got = m(x, sup, train=True, targets=y)

    states = [x.new_zeros(B, N, 4) for _ in range(2)]
    for t in range(T):
        inp = x[:, :, t]
        for l in range(2):
            states[l] = inp = m.encoder[f"cell{l}"](states[l], inp, sup)
    prev, outs = x.new_zeros(B, N, dout), []
    for t in range(T):
        inp = prev
        for l in range(2):
            states[l] = inp = m.decoder[f"cell{l}"](states[l], inp, sup)
        outs.append(m.decoder["proj"](inp))
        prev = y[:, :, t] if pattern[t] else outs[-1]
    assert torch.equal(got, torch.stack(outs, dim=2))
    with torch.no_grad():  # the last coin is never read, eval never reads one
        assert not torch.equal(m(x, sup, train=False), got)


TINY = ["--dataset_range", "12", "--horizon", str(T), "--image_size", "16",
        "--batch_size", "2", "--compute_dtype", "float32", "--st_gnn", "dcrnn"]


def test_cli_train_dcrnn_without_device_needs_a_card(tiny_store_dir, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the check is for one without")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.run(["train", "--data_dir", tiny_store_dir, "--epochs", "1",
                 "--teacher_forcing", "0.5", *TINY])
    assert not (tmp_path / "logs").exists()


def _save(mgr, step, loss):
    mgr.save(step, {"params": {"w": torch.full((2,), float(step))}, "batch_stats": {}},
             metrics={"val_loss": loss})


@pytest.mark.parametrize("fail", ["json_dump", "index_replace", "prune_unlink"])
def test_interrupted_save_leaves_a_restorable_best(fail, tmp_path, monkeypatch):
    """A save that prunes the previous best and dies while writing the
    index, while renaming it into place, or while deleting the pruned
    files: the index still parses, every step it names has its file, and
    restore() returns a whole checkpoint (the previous best while the new
    index is not in place)."""
    import multimodal_outage_tpu_torch.core.checkpoint as ck

    mgr = CheckpointManager(str(tmp_path))
    _save(mgr, 0, 2.0)
    _save(mgr, 1, 1.0)  # the best so far; step 0 pruned
    assert mgr.best_step == 1

    def boom(*a, **k):
        raise OSError("interrupted")

    if fail == "json_dump":
        monkeypatch.setattr(ck.json, "dump", boom)
    elif fail == "index_replace":
        real = os.replace
        monkeypatch.setattr(ck.os, "replace", lambda a, b: boom() if b.endswith(".json")
                            else real(a, b))
    else:
        monkeypatch.setattr(ck.os, "unlink", boom)
    with pytest.raises(OSError, match="interrupted"):
        _save(mgr, 2, 0.5)  # a new best: would prune step 1
    monkeypatch.undo()

    fresh = CheckpointManager(str(tmp_path))
    best = fresh.best_step
    assert os.path.exists(tmp_path / "best" / f"{best}.pt")
    want = 2 if fail == "prune_unlink" else 1
    assert best == want
    assert torch.equal(restore_variables(str(tmp_path))["params"]["w"],
                       torch.full((2,), float(want)))
    _save(fresh, 3, 3.0)  # the next save completes and cleans up
    assert sorted(os.listdir(tmp_path / "best")) == [f"{want}.pt", "metrics.json"]
    assert os.listdir(tmp_path / "latest") == ["3.pt"]


def test_pixel_noise_frames_are_bitwise_jax():
    dates = synthetic_dates(margin=3)
    np.testing.assert_array_equal(dates, jax_synthetic_dates(margin=3))
    for noise in (0.0, 0.2):
        got = generate_frames(dates, n_counties=3, image_size=16, seed=4, pixel_noise=noise)
        want = jax_generate_frames(dates, n_counties=3, image_size=16, seed=4,
                                   pixel_noise=noise)
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want), noise
    assert not np.array_equal(generate_frames(dates, 3, 16, 4, pixel_noise=0.2),
                              generate_frames(dates, 3, 16, 4))


def test_cli_synth_pixel_noise_store_is_bitwise_jax(tmp_path):
    out = cli.run(["synth", "--out_dir", str(tmp_path / "port"), "--n_counties", "3",
                   "--image_size", "16", "--margin", "4", "--seed", "2", "--cases", "michael",
                   "--pixel_noise", "0.2"])
    from multimodal_outage_tpu.core.registry import HURRICANES as JAX_HURRICANES

    jax_generate_store(str(tmp_path / "jax"), n_counties=3, image_size=16, margin=4, seed=2,
                       hurricanes={"michael": JAX_HURRICANES["michael"]}, pixel_noise=0.2)
    port, ref = load_store(out["out_dir"]), jax_load_store(str(tmp_path / "jax"))
    assert np.array_equal(np.asarray(port.frames), np.asarray(ref.frames))
    assert np.array_equal(np.asarray(port.dates), np.asarray(ref.dates))


def test_config_supports_for_dcrnn_are_dual_random_walk(tiny_store_dir):
    """fit and predict diffuse DCRNN over its own adjtype: 2 supports
    (forward and backward random walk), the JAX package's build_supports."""
    cfg = Config(model=ModelConfig(st_gnn="dcrnn"), train=TrainConfig(seed=SEED))
    got = config_supports(cfg, load_store(tiny_store_dir))
    jcfg = jax_loop.Config(model=JaxModelConfig(st_gnn="dcrnn"))
    want = np.asarray(jax_loop.build_supports(jcfg, 4, jax_load_store(tiny_store_dir)))
    assert got.shape == (2, 4, 4)
    np.testing.assert_array_equal(got, want)
    assert build_model(cfg.model, T, 4, 16).st_gnn.encoder.cell0.gates.proj.kernel.shape[0] == \
        (1 + 2 * cfg.model.dcrnn.max_diffusion_step) * (cfg.model.st_gnn_in_dim + 64)


def test_bf16_dcrnn_teacher_step_runs_and_is_finite():
    _, tcfg = _configs(1.0, dtype="bfloat16")
    model = weights.load_variables(build_model(tcfg, T, N, H),
                                   weights.init_variables(tcfg, T, N, seed=0, image_size=H))
    m = make_train_step(model)(create_train_state(model), _tbatch(_batch(2)),
                               torch.from_numpy(_supports()), LR, 0)
    assert all(np.isfinite(float(v)) for v in m.values())
    assert model.st_gnn.decoder["proj"].kernel.dtype == torch.float32  # f32 masters
    assert all(torch.isfinite(p).all() for p in model.parameters())
