"""SPMD in the port (core/mesh.py, parallel/, the mesh branches of the
models and steps) against the JAX package's and against the port's own
one-device step, on the CPU: ranks are gloo processes spawned by
parallel/launch.py, one intra-op thread each.

Bars, float32:
- metrics rtol 1e-5; BatchNorm running statistics rtol 1e-4 / atol 1e-5
  (JAX tests/test_sharding.py:270-330, the weighted ragged step);
- gradients (mesh step against the one-device port step): each leaf
  within GRAD_RTOL of its largest entry, floored at 1e-3 of the largest
  gradient of all (a leaf whose true gradient is ~0 holds summation
  noise); a mesh step sums each gradient over the ranks in another
  order, nothing else. Where the step itself is that sensitive, the bar
  is NOISE_RATIO times its own response to its input perturbed by 1e-7
  relative (_noise, test_torch_port_spmd_mesh.py): the tiny Graph
  WaveNet's gradients move by up to 1.6e-2 of a leaf's largest entry
  under it (measured), and a time-sharded mesh sums its BatchNorm
  moments in another order, which is such a perturbation;
- parameters after the Adam step, against JAX's sharded step: 99% of
  all entries within JAX's own bar rtol 1e-2 / atol 5e-4
  (test_sharding.py:104-110) and every entry within 2·lr: Adam's first
  step is lr·g/(|g|+ε), so an entry whose gradient is summation noise
  moves by ±lr with the noise's sign (_close_params).
The model is the tiny fixture's (N=4, T=2, 32² frames: four pools down
to a 2² bottleneck) with the two-pass BatchNorm: with the single sweep,
a time-sharded mesh's moments are summed in another order and at this
width the network amplifies a 1e-7 input change ~100× (measured: a
1e-7 relative input perturbation moves the output by 4.6e-4 with the
single sweep, 5e-6 two-pass at 32²), so the bars would test chaos, not
the mesh. Dropout is off where JAX is the reference (its random bits are
not torch's) and on where the port's one-device step is: a mesh cuts
its masks from the global batch's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_outage_tpu.core import metrics as jax_metrics
from multimodal_outage_tpu.core.config import GWNetConfig as JaxGWNetConfig
from multimodal_outage_tpu.core.config import ModelConfig as JaxModelConfig
from multimodal_outage_tpu.core.mesh import make_mesh as jax_make_mesh
from multimodal_outage_tpu.models import layers as jl
from multimodal_outage_tpu.models.fusion import build_model as jax_build_model
from multimodal_outage_tpu.parallel import sharding as jax_sharding
from multimodal_outage_tpu.train.state import TrainState as JaxTrainState
from multimodal_outage_tpu.train.state import make_optimizer as jax_make_optimizer
from multimodal_outage_tpu_torch import weights
from multimodal_outage_tpu_torch.core import mesh as mesh_mod
from multimodal_outage_tpu_torch.core.config import MeshConfig
from multimodal_outage_tpu_torch.core.mesh import MeshShape
from multimodal_outage_tpu_torch.core.metrics import weighted_regression_metrics
from multimodal_outage_tpu_torch.models import layers as tl
from multimodal_outage_tpu_torch.parallel import launch
from multimodal_outage_tpu_torch.parallel import sharding

import spmd_rank_steps as R

T, N, H = 2, 4, 32
GRAD_RTOL = 1e-4
NOISE_RATIO = 4.0


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(b, seed=0):
    rng = np.random.default_rng(seed)
    feats = np.tile(np.array([0, 0, 0, 2022, 9, 26], np.float32), (b, T, 1))
    feats[..., 5] += np.arange(T, dtype=np.float32)
    return {"x": rng.standard_normal((b, N, T, H, H, 1)).astype(np.float32),
            "y": rng.standard_normal((b, N, T, H, H, 1)).astype(np.float32),
            "date_feats": feats}


def _jax_cfg(st_gnn):
    return JaxModelConfig(compute_dtype="float32", st_gnn=st_gnn, bn_single_pass=False,
                          encoder_dropout=0.0, gwnet=JaxGWNetConfig(dropout=0.0))


def _jax_supports(st_gnn):
    return jnp.asarray(R.supports_for(st_gnn, N).numpy())


def _jax_state(st_gnn):
    """JAX's model and a TrainState of the port's init_variables (the JAX
    tree's paths and shapes; flax's init is not run), with non-trivial
    running statistics."""
    var = weights.init_variables(R.model_config(st_gnn, False), T, N, 3, H)
    params = jax.tree.map(lambda v: jnp.asarray(v.numpy()), var["params"])
    stats = jax.tree.map(
        lambda v: jnp.asarray(v.numpy() + 0.3 * np.arange(v.numel(), dtype=np.float32)
                              .reshape(tuple(v.shape)) / v.numel()),
        var["batch_stats"])
    state = JaxTrainState(params=params, batch_stats=stats,
                          opt_state=jax_make_optimizer().init(params),
                          step=jnp.zeros((), jnp.int32))
    return jax_build_model(_jax_cfg(st_gnn), horizon=T), state


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _variables(state):
    return weights.from_flax({"params": _np(state.params), "batch_stats": _np(state.batch_stats)})


def _close_stats(got, want):
    want = weights.flatten(want)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-4, atol=1e-5, err_msg=k)


def _close_metrics(got, want):
    for k in ("loss", "mae", "mape", "rmse"):
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-5, err_msg=k)


def _close_params(got, want):
    inside = total = 0
    for k, v in weights.flatten(want).items():
        d = np.abs(got[k] - v)
        assert float(d.max()) <= 2 * R.LR + 1e-6, k
        inside += int(np.sum(d <= 5e-4 + 1e-2 * np.abs(v)))
        total += d.size
    assert inside >= 0.99 * total


def _grad_gap(got, want):
    """The worst leaf's gap, over its largest entry (floored at 1e-3 of the
    largest gradient of all)."""
    g_all = max(float(np.abs(v).max()) for v in want.values())
    return max(float(np.abs(got[k] - w).max()) / max(float(np.abs(w).max()), 1e-3 * g_all)
               for k, w in want.items())


def _close_grads(got, want, noise: float = 0.0):
    assert _grad_gap(got, want) <= max(GRAD_RTOL, NOISE_RATIO * noise)


# ---------------------------------------------------- GroupedBatchNorm


def _bn_case(serial_ema, single_pass, w, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((len(w), 3, 2, 5, 5, 4)).astype(np.float32) * 2 + 0.5
    jmod = jl.GroupedBatchNorm(num_group_axes=2, serial_ema=serial_ema, single_pass=single_pass)
    var = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), True)
    var = {"params": var["params"],
           "batch_stats": {"mean": jnp.linspace(-0.2, 0.3, 4), "var": jnp.linspace(0.5, 1.5, 4)}}
    tmod = tl.GroupedBatchNorm(4, 2, serial_ema=serial_ema, single_pass=single_pass)
    weights.load_variables(tmod, weights.from_flax(_np(var)))
    return x, jmod, var, tmod


@pytest.mark.parametrize("serial_ema", [True, False], ids=["serial", "group_mean"])
@pytest.mark.parametrize("single_pass", [True, False], ids=["single_pass", "two_pass"])
@pytest.mark.parametrize("w", [[1, 0, 1, 0, 1], [1, 1, 1, 0, 0], [1, 1, 1, 1, 1]],
                         ids=["pads_in_the_middle", "padded_tail", "all_valid"])
def test_sample_weight_batchnorm_matches_jax(serial_ema, single_pass, w):
    """GroupedBatchNorm(sample_weight=) against JAX's on both EMA paths:
    the output and the masked running statistics."""
    w = np.asarray(w, np.float32)
    x, jmod, var, tmod = _bn_case(serial_ema, single_pass, w)
    yj, mut = jmod.apply(var, jnp.asarray(x), True, sample_weight=jnp.asarray(w),
                         mutable=["batch_stats"])
    yt = tmod(torch.from_numpy(x), True, sample_weight=torch.from_numpy(w))
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), atol=1e-5, rtol=1e-4)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(tmod, k).numpy(), np.asarray(mut["batch_stats"][k]),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("serial_ema", [True, False], ids=["serial", "group_mean"])
def test_sample_weight_guards(serial_ema):
    """ADVICE.md's two guards: an all-zero w leaves both EMA paths as
    they were (JAX's group-mean path would decay them), and w is
    binarised (w > 0), so 0.5 and 2 count as a valid row."""
    x, _, _, tmod = _bn_case(serial_ema, False, np.zeros(3, np.float32))
    before = (tmod.mean.clone(), tmod.var.clone())
    tmod(torch.from_numpy(x), True, sample_weight=torch.zeros(3))
    assert torch.equal(tmod.mean, before[0]) and torch.equal(tmod.var, before[1])
    x, _, _, a = _bn_case(serial_ema, False, np.zeros(3, np.float32))
    _, _, _, b = _bn_case(serial_ema, False, np.zeros(3, np.float32))
    a(torch.from_numpy(x), True, sample_weight=torch.tensor([0.5, 0.0, 2.0]))
    b(torch.from_numpy(x), True, sample_weight=torch.tensor([1.0, 0.0, 1.0]))
    assert torch.equal(a.mean, b.mean) and torch.equal(a.var, b.var)


# ----------------------------------------------------- pad_batch, metrics


@pytest.mark.parametrize("b,size", [(3, 4), (3, 8), (4, 4), (1, 5)])
def test_pad_batch_is_jaxs_bit_for_bit(b, size):
    batch = _batch(b, seed=b)
    ours, theirs = sharding.pad_batch(batch, size), jax_sharding.pad_batch(batch, size)
    assert set(ours) == set(theirs)
    for k in theirs:
        assert ours[k].dtype == theirs[k].dtype and np.array_equal(ours[k], theirs[k]), k


@pytest.mark.parametrize("w", [[1, 1, 1, 1], [1, 1, 0, 0], [0, 0, 0, 0]])
def test_weighted_regression_metrics_match_jax(w):
    rng = np.random.default_rng(1)
    yhat, y = (rng.standard_normal((4, 3, 2, 5, 5, 1)).astype(np.float32) for _ in range(2))
    w = np.asarray(w, np.float32)
    ours = weighted_regression_metrics(*(torch.from_numpy(a) for a in (yhat, y, w)))
    theirs = jax_metrics.weighted_regression_metrics(yhat, y, w)
    for k in theirs:
        np.testing.assert_allclose(float(ours[k]), float(theirs[k]), rtol=1e-6, err_msg=k)


# ------------------------------------------------------------- TP rules


@pytest.mark.parametrize("st_gnn", ["gwnet", "dcrnn"])
def test_tp_rules_match_jax_tree_shardings(st_gnn):
    """The port's _TP_RULES give JAX's PartitionSpec on every leaf of the
    full variable tree and of an Adam-moment tree under the same paths."""
    from multimodal_outage_tpu_torch.core.config import ModelConfig

    tree = weights.init_variables(ModelConfig(st_gnn=st_gnn), 7, 67, 0)
    tree = {"params": tree["params"], "opt": {"mu": tree["params"]},
            "batch_stats": tree["batch_stats"]}
    np_tree = jax.tree.map(lambda v: np.asarray(v), tree)
    mesh = jax_make_mesh(data=2, model=2, time=2)
    theirs = weights.flatten(jax.tree.map(lambda s: tuple(s.spec),
                                          jax_sharding.tree_shardings(mesh, np_tree)))
    ours = sharding.tree_specs(tree)
    assert ours == theirs
    assert sum(1 for s in ours.values() if s) == (18 if st_gnn == "gwnet" else 12)


# ------------------------------------------------- mesh resolution


def test_mesh_resolution_and_errors_are_jaxs(monkeypatch):
    monkeypatch.setenv(mesh_mod.VIRTUAL_DEVICES_ENV, "8")
    assert mesh_mod.mesh_from_config(MeshConfig(data=-1, model=2), "cpu") == MeshShape(4, 2, 1)
    assert mesh_mod.mesh_from_config(MeshConfig(data=1), "cpu") is None
    assert mesh_mod.mesh_from_config(MeshConfig(data=2, time=2), "cpu") == MeshShape(2, 1, 2)
    for kw in (dict(data=-1, model=3), dict(data=4, model=4)):
        with pytest.raises(ValueError) as ours:
            mesh_mod.mesh_from_config(MeshConfig(**kw), "cpu")
        with pytest.raises(ValueError) as theirs:
            jax_make_mesh(**kw)
        assert str(ours.value) == str(theirs.value)
    monkeypatch.delenv(mesh_mod.VIRTUAL_DEVICES_ENV)
    assert mesh_mod.mesh_from_config(MeshConfig(), "cpu") is None  # one CPU device


# ------------------------------------------- the weighted ragged step


def test_weighted_padded_step_matches_jax_and_the_ragged_step():
    """The port of JAX tests/test_sharding.py:270-330: B=3 padded to 4 with
    w masking the pad row on a 2x1x1 mesh of gloo ranks equals the plain
    ragged B=3 step (the port's) and JAX's make_sharded_train_step(
    weighted=True) on the same padded batch: metrics rtol 1e-5, BN stats
    rtol 1e-4 / atol 1e-5, gradients and parameters at the bars above."""
    model, state = _jax_state("gwnet")
    variables = _variables(state)
    batch = _batch(3, seed=7)
    r = launch.run(R.mesh_steps, MeshShape(2, 1, 1), "cpu",
                   ([("ragged", "gwnet", (2, 1, 1), False, "b3", 4)], {"gwnet": variables},
                    {"b3": batch}, (T, N, H)), progress=False)["ragged"]
    ref = R.one_device_step(R.model_config("gwnet", False), variables, batch, T, N, H)
    _close_metrics(r["metrics"], ref["metrics"])
    _close_stats(r["stats"], ref["stats"])
    _close_grads(r["grads"], ref["grads"])
    mesh = jax_make_mesh(data=2)
    sh_state = jax_sharding.shard_state(mesh, state)
    step = jax_sharding.make_sharded_train_step(model, mesh, sh_state, donate=False,
                                                weighted=True)
    new_state, metrics = step(sh_state,
                              jax_sharding.shard_batch(mesh, jax_sharding.pad_batch(batch, 4)),
                              _jax_supports("gwnet"), jnp.float32(R.LR), jax.random.PRNGKey(0))
    _close_metrics(r["metrics"], metrics)
    _close_stats(r["stats"], _np(new_state.batch_stats))
    _close_params(r["params"], _np(new_state.params))
