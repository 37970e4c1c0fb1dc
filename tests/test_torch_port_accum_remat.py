"""Gradient accumulation and remat in the port (train/steps.py
make_accum_train_step, train/loop.py's grad_accum block, models/unet.py
and models/layers.py remat, core/oom.py, the CLI flags) on the CPU.

Accumulation is held to the JAX package's make_accum_train_step and to
the port's own one-shot step, with the same flax-initialised variables
(non-trivial BatchNorm running statistics), the same numpy batch of 4 and
K = 2, float32, dropout 0, N = 4, T = 3, 32² frames (at 16² the depth-4
U-Net's bottleneck BatchNorm groups hold 3 values each and the gradients
are so ill-conditioned that even the one-shot steps of the two packages
differ by ~1% of a leaf). As in
tests/test_torch_port_train.py, loss, metrics and the new BatchNorm
running statistics come from JAX's jitted step, the gradients and the
updated parameters from the same step's arithmetic run op by op (XLA's
fused CPU program computes the near-cancelling Graph WaveNet gradients
far less accurately), and the bars are that file's: loss and metrics rtol
1e-5; each gradient leaf within 1e-4·max|g_leaf| + 1e-7; BN running
stats atol 1e-6 / rtol 1e-5; updated parameters atol 1e-6 where |g| is
above the gradient tolerance, 2·lr elsewhere. The port's accumulating
step differs from its one-shot step only in summation order (two
microbatch gradients added, the serial EMA applied twice), and is held
to it at the same bars, for Graph WaveNet. DCRNN's teacher pass is not
the one-shot step's: microbatch j encodes its targets with the running
statistics that microbatches 0..j have updated (JAX's scan does the
same), so there the port is held to JAX only.

Remat is held to no remat bitwise: the blocks recompute the same
arithmetic from the same inputs, and GroupedBatchNorm's recompute reads
the running mean as the forward pass saw it.
"""

import argparse
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_outage_tpu import cli as jax_cli
from multimodal_outage_tpu.core import metrics as jax_metrics
from multimodal_outage_tpu.core.config import DCRNNConfig as JaxDCRNNConfig
from multimodal_outage_tpu.core.config import GWNetConfig as JaxGWNetConfig
from multimodal_outage_tpu.core.config import ModelConfig as JaxModelConfig
from multimodal_outage_tpu.core.oom import is_oom_error as jax_is_oom_error
from multimodal_outage_tpu.models.fusion import build_model as jax_build_model
from multimodal_outage_tpu.train import loop as jax_loop
from multimodal_outage_tpu.train import steps as jax_steps
from multimodal_outage_tpu.train.state import create_train_state as jax_create_train_state
from multimodal_outage_tpu.train.state import make_optimizer as jax_make_optimizer
from multimodal_outage_tpu_torch import cli, weights
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
from multimodal_outage_tpu_torch.core.oom import is_oom_error
from multimodal_outage_tpu_torch.data.adjacency import model_supports
from multimodal_outage_tpu_torch.models import layers, unet
from multimodal_outage_tpu_torch.models.fusion import build_model
from multimodal_outage_tpu_torch.train import loop
from multimodal_outage_tpu_torch.train.state import Adam, create_train_state
from multimodal_outage_tpu_torch.train.steps import (
    make_accum_train_step,
    make_train_step,
    microbatch_generator,
    sampling_generator,
    step_generator,
)
from port_config import jax_fields

B, N, T, H = 4, 4, 3, 32
H_STORE = 16  # the tiny store of tests/conftest.py that fit reads
ACCUM = 2
LR = 1e-3
SEED = 42  # draws the synthetic 4-county graph of DCRNN's supports
KEYS = ("loss", "mae", "mape", "rmse")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's small torch ops: with the
    suite's workers sharing the cores, OpenMP's barriers otherwise stall
    each op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


CASES = {  # name: (st_gnn, bn_single_pass, teacher_forcing)
    "gwnet_single_pass": ("gwnet", True, 0.0),
    "gwnet_two_pass": ("gwnet", False, 0.0),
    "dcrnn_tf1": ("dcrnn", True, 1.0),
}


def _configs(case):
    st_gnn, sp, tf = CASES[case]
    jcfg = JaxModelConfig(st_gnn=st_gnn, compute_dtype="float32", encoder_dropout=0.0,
                          bn_single_pass=sp, gwnet=JaxGWNetConfig(dropout=0.0),
                          dcrnn=JaxDCRNNConfig(teacher_forcing=tf))
    tcfg = ModelConfig(st_gnn=st_gnn, compute_dtype="float32", encoder_dropout=0.0,
                       bn_single_pass=sp, gwnet=GWNetConfig(dropout=0.0),
                       dcrnn=DCRNNConfig(teacher_forcing=tf))
    return jcfg, tcfg


def _batch(b=B, seed=0):
    rng = np.random.default_rng(seed)
    feats = np.tile(np.array([0, 0, 0, 2022, 9, 26], np.float32), (b, T, 1))
    feats[..., 5] += np.arange(T, dtype=np.float32)
    return {
        "x": rng.standard_normal((b, N, T, H, H, 1)).astype(np.float32),
        "y": rng.standard_normal((b, N, T, H, H, 1)).astype(np.float32),
        "date_feats": feats,
    }


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _supports(tcfg):
    return model_supports(tcfg, N, seed=SEED)


def _port_step(tcfg, variables, make):
    """The port's step `make(model)` on the shared variables and batch."""
    model = weights.load_variables(build_model(tcfg, T, N, H), weights.from_flax(variables))
    state = create_train_state(model)
    m = make(model)(state, _tbatch(_batch()), torch.from_numpy(_supports(tcfg)), LR, 0)
    return {
        "metrics": {k: float(v) for k, v in m.items()},
        "grads": {k.replace(".", "/"): (p.grad if p.grad is not None
                                        else torch.zeros_like(p)).numpy()
                  for k, p in model.named_parameters()},
        "new": {k: v.numpy() for k, v in weights.flatten(weights.module_variables(model)).items()},
        "step": state.step,
    }


@functools.lru_cache(maxsize=None)
def _accum_case(case):
    """JAX's accumulating step (jitted, and its arithmetic op by op), the
    port's accumulating step and, for Graph WaveNet, the port's one-shot
    step, K = 2, b = 4."""
    jcfg, tcfg = _configs(case)
    model = jax_build_model(jcfg, T)
    batch, sup = _batch(), jnp.asarray(_supports(tcfg))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(0)
    state = jax_create_train_state(model, key, jbatch, sup)
    bs = jax.tree.map(
        lambda v: v + 0.3 * jnp.arange(v.size, dtype=v.dtype).reshape(v.shape) / v.size,
        state.batch_stats,
    )
    state = state.replace(batch_stats=bs)
    variables = _np({"params": state.params, "batch_stats": bs})
    step = jax_steps.make_accum_train_step(model, ACCUM, donate=False, compiler_options=None)
    new, jm = step(state, jbatch, sup, jnp.float32(LR), key)

    # the step's arithmetic op by op (JAX train/steps.py:171-219)
    mb = B // ACCUM
    grads_sum, cur_bs = None, bs
    for k in range(ACCUM):
        part = {n: v[k * mb:(k + 1) * mb] for n, v in jbatch.items()}
        mb_rng = jax.random.fold_in(jax.random.fold_in(key, state.step), k)
        tf_kwargs, tf_rngs = jax_steps._teacher_kwargs(model, state, part, mb_rng)

        def loss_fn(params, part=part, bstats=cur_bs, mb_rng=mb_rng, tf_kwargs=tf_kwargs,
                    tf_rngs=tf_rngs):
            yhat, mut = model.apply(
                {"params": params, "batch_stats": bstats}, part["x"], part["date_feats"], sup,
                train=True, rngs={"dropout": mb_rng, **tf_rngs}, mutable=["batch_stats"],
                **tf_kwargs,
            )
            return jax_metrics.mse(yhat, part["y"]), mut["batch_stats"]

        g, cur_bs = jax.grad(loss_fn, has_aux=True)(state.params)
        grads_sum = g if grads_sum is None else jax.tree.map(jnp.add, grads_sum, g)
    grads = jax.tree.map(lambda g: g / ACCUM, grads_sum)
    updates, _ = jax_make_optimizer().update(grads, state.opt_state, state.params)
    new_params = jax.tree.map(lambda p, u: p + u * jnp.float32(LR), state.params, updates)
    return {
        "case": case,
        "jax": {
            "metrics": {k: float(v) for k, v in jm.items()},
            "grads": weights.flatten(_np(grads)),
            "new": weights.flatten(_np({"params": new_params,
                                        "batch_stats": new.batch_stats})),
        },
        "old": weights.flatten(variables),
        "accum": _port_step(tcfg, variables, lambda m: make_accum_train_step(m, ACCUM)),
        "one_shot": (_port_step(tcfg, variables, make_train_step)
                     if tcfg.st_gnn == "gwnet" else None),
    }


def _check_loss_and_metrics(want, got, old):
    assert set(want["metrics"]) == set(got["metrics"]) == set(KEYS)
    for k in KEYS:
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=1e-5, err_msg=k)
    # rmse is √ of the full batch's mse, not the mean of the microbatches' rmse
    np.testing.assert_allclose(got["metrics"]["rmse"], np.sqrt(got["metrics"]["loss"]),
                               rtol=1e-6)


def _check_every_gradient_leaf(want, got, old):
    assert set(want["grads"]) == set(got["grads"])
    for k, g in want["grads"].items():
        bound = 1e-4 * np.abs(g).max() + 1e-7
        assert np.abs(got["grads"][k] - g).max() <= bound, k
    assert not np.abs(want["grads"]["date2vec/fc1/kernel"]).any()  # frozen on both sides


def _check_batchnorm_running_stats(want, got, old):
    keys = [k for k in want["new"] if k.startswith("batch_stats/")]
    assert keys and set(keys) == {k for k in got["new"] if k.startswith("batch_stats/")}
    for k in keys:
        np.testing.assert_allclose(np.asarray(got["new"][k]), want["new"][k], atol=1e-6,
                                   rtol=1e-5, err_msg=k)
        assert not np.array_equal(want["new"][k], old[k]), k  # the EMA moved


def _check_updated_params(want, got, old):
    for k in (k for k in want["new"] if k.startswith("params/")):
        g = np.abs(want["grads"][k[len("params/"):]])
        d = np.abs(np.asarray(got["new"][k]) - want["new"][k])
        tol = 1e-4 * g.max() + 1e-7  # the gradient bar
        signal = (g > tol) & (g * g > LR * 1e-8 * tol / 5e-7)
        assert (d[signal] <= 1e-6).all(), k
        assert (d <= 2 * LR + 1e-7).all(), k
    assert got["step"] == 1


CHECKS = [_check_loss_and_metrics, _check_every_gradient_leaf, _check_batchnorm_running_stats,
          _check_updated_params]
CHECK_IDS = ["loss_and_metrics", "every_gradient_leaf", "batchnorm_running_stats",
             "updated_params"]


@pytest.mark.parametrize("check", CHECKS, ids=CHECK_IDS)
@pytest.mark.parametrize("case", list(CASES))
def test_accum_step_matches_jax_accum_step(case, check):
    """The port's K = 2 step against JAX make_accum_train_step(model, 2,
    donate=False) at the bars of tests/test_torch_port_train.py: Graph
    WaveNet with single-pass and two-pass BatchNorm, DCRNN at
    teacher_forcing 1.0 (every coin is the teacher on both sides)."""
    c = _accum_case(case)
    check(c["jax"], c["accum"], c["old"])


@pytest.mark.parametrize("check", CHECKS, ids=CHECK_IDS)
@pytest.mark.parametrize("case", ["gwnet_single_pass", "gwnet_two_pass"])
def test_accum_step_matches_the_one_shot_step(case, check):
    """Graph WaveNet: the port's K = 2 step against its own one-shot step
    on the same batch, at the same bars: the same batch's step up to
    summation order (the one-shot step's metrics are the full batch's:
    rmse = √loss)."""
    c = _accum_case(case)
    check(c["one_shot"], c["accum"], c["old"])


def test_accum_one_is_the_one_shot_step():
    model = build_model(ModelConfig(compute_dtype="float32"), T, N, H)
    assert make_accum_train_step(model, 1).__qualname__ == \
        make_train_step(model).__qualname__


def test_microbatch_generators_differ_by_index():
    """Each microbatch draws dropout (and teacher-forcing coins) from its
    own stream, a function of (seed, step, j), apart from the one-shot
    step's (JAX folds k into the step key)."""
    cpu = torch.device("cpu")
    draw = lambda g: torch.rand(8, generator=g)
    d = [draw(microbatch_generator(3, 5, j, cpu)) for j in range(3)]
    assert not torch.equal(d[0], d[1]) and not torch.equal(d[1], d[2])
    assert torch.equal(d[1], draw(microbatch_generator(3, 5, 1, cpu)))
    assert not torch.equal(d[0], draw(step_generator(3, 5, cpu)))
    c = [draw(sampling_generator(3, 5, j)) for j in range(2)]
    assert not torch.equal(c[0], c[1]) and not torch.equal(c[0], draw(sampling_generator(3, 5)))


def test_accum_step_rejects_an_uneven_batch():
    cfg = ModelConfig(compute_dtype="float32")
    model = weights.load_variables(build_model(cfg, T, N, H),
                                   weights.init_variables(cfg, T, N, seed=0, image_size=H))
    step = make_accum_train_step(model, 3)
    with pytest.raises(ValueError, match="3 equal microbatches"):
        step(create_train_state(model), _tbatch(_batch()), torch.eye(N)[None], LR, 0)


@pytest.mark.parametrize("b", range(1, 65))
def test_split_counts_equal_jax(b):
    """_accum_split_count for every budget and _next_split_count for
    every split count below b, at b <= 64, equal the JAX loop's."""
    for mb in range(1, b + 2):
        assert loop._accum_split_count(b, mb) == jax_loop._accum_split_count(b, mb)
    for k in range(1, b):
        assert loop._next_split_count(b, k) == jax_loop._next_split_count(b, k)


def test_is_oom_error_classifies_as_jax_and_torch():
    """The allocator's error by type, cuBLAS/cuDNN workspace failures and
    JAX's XLA markers by message; other errors are not OOMs."""
    assert is_oom_error(torch.OutOfMemoryError("anything"))
    assert is_oom_error(torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate"))
    assert is_oom_error(RuntimeError("CUDA error: CUBLAS_STATUS_ALLOC_FAILED when calling"))
    assert is_oom_error(RuntimeError("cuDNN error: CUDNN_STATUS_ALLOC_FAILED"))
    assert not is_oom_error(RuntimeError("CUDA error: an illegal memory access"))
    for msg in ("RESOURCE_EXHAUSTED: out of memory", "ResourceExhausted", "Ran out of memory",
                "Largest program allocations", "INVALID_ARGUMENT: shapes"):
        assert is_oom_error(RuntimeError(msg)) == jax_is_oom_error(RuntimeError(msg)), msg


# ------------------------------------------------------------------ remat

def _remat_model(scope, sp, st_gnn="gwnet", tf=0.0):
    """pool="pallas": at 32² every pool's W·C is 128, so the pool's
    autograd.Function runs, and again in the recompute."""
    cfg = ModelConfig(st_gnn=st_gnn, compute_dtype="float32", pool="pallas",
                      remat=scope is not None, remat_scope=scope or "all", bn_single_pass=sp,
                      dcrnn=DCRNNConfig(teacher_forcing=tf))
    var = weights.init_variables(cfg, T, N, seed=0, image_size=H)
    var["batch_stats"] = jax.tree.map(lambda v: v + 0.3, var["batch_stats"])
    return weights.load_variables(build_model(cfg, T, N, H), var)


def _remat_step(scope, sp, monkeypatch, st_gnn="gwnet", tf=0.0):
    """One train step at B = 2 with dropout (the same generator on both
    sides), with the _update_running calls and the bytes held for the
    backward counted."""
    model = _remat_model(scope, sp, st_gnn, tf)
    calls = []
    real_update = layers.GroupedBatchNorm._update_running

    def counted(self, *a):
        calls.append(id(self))
        return real_update(self, *a)

    monkeypatch.setattr(layers.GroupedBatchNorm, "_update_running", counted)
    held = {}

    def hold(t):
        held[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()

    # what remat keeps itself, out of the hooks' sight: each block's inputs,
    # and under "conv" the convolution outputs the policy saves
    real_checkpoint, real_policy = layers.checkpoint, layers._save_conv_outputs

    def checkpoint(fn, *args, **kw):
        for a in args:
            if isinstance(a, torch.Tensor):
                hold(a)
        return real_checkpoint(fn, *args, **kw)

    def policy(ctx, op, *args, **kwargs):
        decision = real_policy(ctx, op, *args, **kwargs)
        if decision == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE \
                and not ctx.is_recompute:
            out = op(*args, **kwargs)
            held[("conv", len(held))] = out.numel() * out.element_size()
        return decision

    monkeypatch.setattr(layers, "checkpoint", checkpoint)
    monkeypatch.setattr(layers, "_save_conv_outputs", policy)
    b = _batch(b=2, seed=1)
    batch = _tbatch(b)
    sup = torch.from_numpy(model_supports(model.cfg, N, seed=SEED))

    def pack(t):
        hold(t)
        return t

    kw = {}
    if tf:
        kw = {"targets": batch["y"], "tf_prob": tf, "sampling": sampling_generator(0, 0)}
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        yhat = model(batch["x"], batch["date_feats"], sup, train=True,
                     generator=step_generator(0, 0, torch.device("cpu")), **kw)
    loss = torch.mean(torch.square(yhat - batch["y"]))
    bytes_held = sum(held.values())
    loss.backward()
    n_bn = sum(isinstance(m, layers.GroupedBatchNorm) for m in model.modules())
    return {
        "y": yhat.detach(), "bytes": bytes_held, "calls": calls, "n_bn": n_bn,
        "grads": {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None},
        "buffers": {k: v.clone() for k, v in model.named_buffers()},
        "keys": list(model.state_dict()),
    }


_PLAIN = {}


def _plain(sp, monkeypatch, st_gnn="gwnet", tf=0.0):
    key = (sp, st_gnn, tf)
    if key not in _PLAIN:
        _PLAIN[key] = _remat_step(None, sp, monkeypatch, st_gnn, tf)
    return _PLAIN[key]


@pytest.mark.parametrize("sp", [True, False], ids=["single_pass", "two_pass"])
@pytest.mark.parametrize("scope", ["all", "stem", "conv"])
def test_remat_is_bitwise_no_remat(scope, sp, monkeypatch):
    """Each scope, each BatchNorm mode: the train forward, every gradient
    and the BN running statistics are bitwise those without remat; each
    GroupedBatchNorm updates its running statistics once; fewer bytes are
    held for the backward; the state_dict keys are the same."""
    want = _plain(sp, monkeypatch)
    got = _remat_step(scope, sp, monkeypatch)
    assert torch.equal(got["y"], want["y"])
    assert got["grads"].keys() == want["grads"].keys()
    for k, g in want["grads"].items():
        assert torch.equal(got["grads"][k], g), k
    for k, v in want["buffers"].items():
        assert torch.equal(got["buffers"][k], v), k
    assert len(got["calls"]) == len(set(got["calls"])) == got["n_bn"] == 26
    assert got["bytes"] < want["bytes"], (got["bytes"], want["bytes"])
    assert got["keys"] == want["keys"]


def test_remat_scopes_hold_bytes_in_order(monkeypatch):
    """all < stem < none and conv < none (the memory order phase 11 checks
    on the card)."""
    none = _plain(True, monkeypatch)["bytes"]
    held = {s: _remat_step(s, True, monkeypatch)["bytes"] for s in ("all", "stem", "conv")}
    assert held["all"] < held["stem"] < none and held["conv"] < none, (held, none)


def test_remat_dcrnn_teacher_step_is_bitwise_no_remat(monkeypatch):
    """DCRNN at teacher_forcing 1.0 under the all scope: the teacher pass
    (eval mode, no grad) runs plainly after the remat'd train pass and
    reads the running statistics it updated, as without remat."""
    want = _plain(True, monkeypatch, "dcrnn", 1.0)
    got = _remat_step("all", True, monkeypatch, "dcrnn", 1.0)
    assert torch.equal(got["y"], want["y"])
    for k, g in want["grads"].items():
        assert torch.equal(got["grads"][k], g), k
    for k, v in want["buffers"].items():
        assert torch.equal(got["buffers"][k], v), k
    assert len(got["calls"]) == got["n_bn"]


@pytest.mark.parametrize("scope", ["all", "stem", "conv"])
def test_remat_leaves_eval_and_no_grad_forwards_plain(scope):
    """An eval forward, and a train forward without grad, run no block
    under checkpoint and give the plain model's output."""
    plain, rem = _remat_model(None, True), _remat_model(scope, True)
    batch = _tbatch(_batch(b=2, seed=2))
    sup = torch.eye(N)[None]
    with torch.no_grad():
        assert torch.equal(rem(batch["x"], batch["date_feats"], sup, train=False),
                           plain(batch["x"], batch["date_feats"], sup, train=False))
        g = lambda: step_generator(0, 0, torch.device("cpu"))
        assert torch.equal(rem(batch["x"], batch["date_feats"], sup, train=True, generator=g()),
                           plain(batch["x"], batch["date_feats"], sup, train=True,
                                 generator=g()))


def test_conv_policy_keeps_conv_transpose_and_conv_outputs(monkeypatch):
    """F.conv_transpose2d and F.conv2d both reach the policy as
    aten.convolution: an Up block under the conv scope saves three
    outputs (the ConvTranspose and the two 3×3 convolutions) and the
    recompute reruns no convolution."""
    decisions = []
    real = layers._save_conv_outputs

    def policy(ctx, op, *args, **kwargs):
        d = real(ctx, op, *args, **kwargs)
        decisions.append((op, d))
        return d

    monkeypatch.setattr(layers, "_save_conv_outputs", policy)
    up = layers.Up(16, 8, 8)
    with torch.no_grad():
        for p in up.parameters():
            p.copy_(torch.randn(p.shape))
    x = torch.randn(2, 4, 4, 16, requires_grad=True)
    skip = torch.randn(2, 8, 8, 8)
    y = layers.remat(up, x, skip, True, None, save_convs=True)
    saved = [op for op, d in decisions
             if d == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE]
    assert saved == [torch.ops.aten.convolution.default] * 3
    convs = []

    class Count(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.convolution.default:
                convs.append(func)
            return func(*args, **(kwargs or {}))

    with Count():
        y.sum().backward()
    assert convs == [] and x.grad is not None


# --------------------------------------------------------------- fit, auto


def _fit_cfg(store_dir, tmp_path, job, **train):
    return Config(
        data=DataConfig(data_dir=store_dir, image_size=H_STORE, horizon=T, dataset_range=12,
                        n_counties=N),
        model=ModelConfig(compute_dtype="float32"),
        train=TrainConfig(epochs=1, checkpoint_dir=str(tmp_path), job_id=job, seed=0,
                          **train),
    )


def _record_splits(monkeypatch, oom_rows=None):
    """Record the split count of every accumulating step fit builds; with
    oom_rows, a forward of a microbatch of at least that many rows raises
    the allocator's error after the contraction has advanced its running
    statistics in place."""
    built = []
    real = loop.make_accum_train_step

    def make(model, accum, debug_nans=False):
        built.append(accum)
        return real(model, accum, debug_nans)

    monkeypatch.setattr(loop, "make_accum_train_step", make)
    if oom_rows is not None:
        real_fwd = unet.Expansion.forward

        def forward(self, x, skips, train, sample_weight=None):
            if train and x.shape[0] >= oom_rows:
                raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB "
                                             "(simulated)")
            return real_fwd(self, x, skips, train, sample_weight)

        monkeypatch.setattr(unet.Expansion, "forward", forward)
    return built


@pytest.mark.parametrize("bs,ga,built_want", [(4, 2, [2]), (8, 4, [4, 3])])
def test_fit_grad_accum_with_a_ragged_tail(bs, ga, built_want, tiny_store_dir, tmp_path,
                                          monkeypatch):
    """The fixture's 30 train windows: batch 4 in 2 microbatches of 2 and
    the last batch of 2 one-shot (_accum_split_count(2, 2) = 1); batch 8
    in 4 of 2 and the last batch of 6 in 3 of 2. fit counts whole steps."""
    built = _record_splits(monkeypatch)
    cfg = _fit_cfg(tiny_store_dir, tmp_path, "ga", batch_size=bs, grad_accum=ga)
    n_train = len(loop.prepare_datasets(cfg, "michael")[1])
    assert n_train == 30
    out = loop.fit(cfg, progress=False, device="cpu")
    assert built == built_want
    assert out["train_steps"] == -(-n_train // bs)
    assert all(np.isfinite(out[f"{s}_{k}"]) for s in ("val", "test") for k in KEYS)
    with pytest.raises(ValueError, match="batch_size 4 not divisible by grad_accum 3"):
        loop.fit(_fit_cfg(tiny_store_dir, tmp_path, "ga3", batch_size=4, grad_accum=3),
                 progress=False, device="cpu")


def test_fit_auto_walks_splits_and_equals_explicit(tiny_store_dir, tmp_path, monkeypatch,
                                                   capsys):
    """batch 6 with microbatches of 3 or more 'out of memory': auto mode
    walks the split count 1 → 2 → 3 (not the byte budget, which would skip
    3), prints the fallback line, and the finished run, its checkpoint
    included, equals an explicit grad_accum=3 run bitwise (the failed
    attempts' BatchNorm updates are undone)."""
    built = _record_splits(monkeypatch, oom_rows=3)
    auto = loop.fit(_fit_cfg(tiny_store_dir, tmp_path, "auto", batch_size=6, grad_accum=0),
                    progress=False, device="cpu")
    err = capsys.readouterr().err
    assert built[:2] == [2, 3] and 6 not in built
    assert "[auto grad_accum] step OOM'd; retrying with microbatch <= 3 (2 microbatches at " \
        "batch 6)" in err
    assert "microbatch <= 2 (3 microbatches at batch 6)" in err
    explicit = loop.fit(_fit_cfg(tiny_store_dir, tmp_path, "ga3", batch_size=6, grad_accum=3),
                        progress=False, device="cpu")
    assert auto == explicit
    a = CheckpointManager(str(tmp_path / "auto" / "checkpoints")).restore()
    b = CheckpointManager(str(tmp_path / "ga3" / "checkpoints")).restore()
    fa, fb = weights.flatten(a), weights.flatten(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        if isinstance(fa[k], torch.Tensor):
            assert torch.equal(fa[k], fb[k]), k


def test_fit_auto_reraises_other_errors(tiny_store_dir, tmp_path, monkeypatch):
    def forward(self, *a, **k):
        raise RuntimeError("shapes are wrong")

    monkeypatch.setattr(unet.Expansion, "forward", forward)
    with pytest.raises(RuntimeError, match="shapes are wrong"):
        loop.fit(_fit_cfg(tiny_store_dir, tmp_path, "bad", batch_size=2, grad_accum=0),
                 progress=False, device="cpu")


def test_fit_auto_does_not_retry_an_oom_in_the_update(tiny_store_dir, tmp_path, monkeypatch):
    """An OOM after Adam began may have moved some parameters: no retry,
    a RuntimeError naming the --grad_accum that would fit."""
    real = Adam.step

    def step(self, lr):
        real(self, lr)
        raise torch.OutOfMemoryError("CUDA out of memory (simulated)")

    monkeypatch.setattr(Adam, "step", step)
    with pytest.raises(RuntimeError, match=r"cannot retry.*--grad_accum >= 2"):
        loop.fit(_fit_cfg(tiny_store_dir, tmp_path, "upd", batch_size=2, grad_accum=0),
                 progress=False, device="cpu")


def test_mesh_with_grad_accum_raises_as_jax():
    for ga in (2, 0):
        with pytest.raises(ValueError, match="single-device-path feature"):
            loop.check_supported(Config(train=TrainConfig(grad_accum=ga),
                                        mesh=MeshConfig(model=2)))
    loop.check_supported(Config(mesh=MeshConfig(model=2)))  # a mesh alone runs


# ------------------------------------------------------------------- CLI

ARGVS = [
    ["train", "--grad_accum", "auto"],
    ["train", "--grad_accum", "4", "--batch_size", "8", "--remat", "--remat_scope", "conv",
     "--xla_vmem_limit_kib", "0"],
    ["train", "--remat", "--remat_scope", "stem", "--grad_accum", "AUTO"],
    ["evaluate", "--checkpoint_path", "c", "--remat", "--grad_accum", "2"],
    ["serve", "--seed", "0", "--remat", "--remat_scope", "all", "--grad_accum", " auto ",
     "--xla_vmem_limit_kib", "32768"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: "_".join(a[:3]))
def test_memory_flags_map_onto_the_config_as_jax_build_config(argv):
    """--grad_accum (an int or auto → 0), --remat, --remat_scope and the
    recorded --xla_vmem_limit_kib on train, evaluate and serve: the
    port's Config equals the JAX CLI's _build_config of the same namespace."""
    ns = cli._parser().parse_args(argv)
    ours = json.dumps(jax_fields(cli._config(ns)), default=str, sort_keys=True)
    theirs = json.dumps(dataclasses.asdict(jax_cli._build_config(ns)), default=str,
                        sort_keys=True)
    assert ours == theirs


@pytest.mark.parametrize("v", ["auto", "Auto", " auto ", "0", "1", "7", "x", "2.5", ""])
def test_grad_accum_arg_equals_jax(v):
    try:
        want = jax_cli._grad_accum_arg(v)
    except argparse.ArgumentTypeError as e:
        with pytest.raises(argparse.ArgumentTypeError, match=str(e)[:20]):
            cli._grad_accum_arg(v)
    else:
        assert cli._grad_accum_arg(v) == want


def test_cli_train_grad_accum_and_remat(tiny_store_dir, tmp_path, monkeypatch, capsys):
    """train --batch_size 4 --grad_accum 2 --remat --remat_scope stem on the
    CPU runs and prints finite final metrics."""
    monkeypatch.chdir(tmp_path)
    assert cli.main(["train", "--data_dir", tiny_store_dir, "--dataset_range", "12",
                     "--horizon", str(T), "--image_size", str(H_STORE), "--batch_size", "4",
                     "--epochs", "1", "--grad_accum", "2", "--remat", "--remat_scope", "stem",
                     "--compute_dtype", "float32", "--device", "cpu", "--job_id", "cli"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert all(np.isfinite(out[f"{s}_{k}"]) for s in ("val", "test") for k in KEYS)
