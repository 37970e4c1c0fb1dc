"""The port's SPMD steps on meshes of gloo ranks on the CPU (2x1x1,
1x2x1 and 1x1x2 for Graph WaveNet and DCRNN, dropout on across the model
and time axes, and 2x2x2), against the port's one-device step and JAX's
sharded step, at the bars and on the model of test_torch_port_spmd.py;
the tree moves (shard_tree / gather_tree) and a failing rank."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_outage_tpu.core.mesh import make_mesh as jax_make_mesh
from multimodal_outage_tpu.parallel import sharding as jax_sharding
from multimodal_outage_tpu_torch import weights
from multimodal_outage_tpu_torch.core.mesh import MeshShape
from multimodal_outage_tpu_torch.parallel import launch

import spmd_rank_steps as R
from test_torch_port_spmd import (
    H,
    N,
    T,
    _batch,
    _close_grads,
    _grad_gap,
    _close_metrics,
    _close_params,
    _close_stats,
    _jax_state,
    _jax_supports,
    _np,
    _variables,
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MESHES = {"2x1x1": (2, 1, 1), "1x2x1": (1, 2, 1), "1x1x2": (1, 1, 2)}


@pytest.fixture(scope="module")
def jax_states():
    return {st: _jax_state(st) for st in ("gwnet", "dcrnn")}


@pytest.fixture(scope="module")
def two_ranks(jax_states):
    """One world of two ranks runs every 2-rank case; the one-device port
    steps are computed here."""
    variables = {st: _variables(s) for st, (_, s) in jax_states.items()}
    batches = {"b4": _batch(4)}
    cases = [(f"{st}_{name}", st, shape, False, "b4", 4)
             for st in ("gwnet", "dcrnn") for name, shape in MESHES.items()]
    cases += [("gwnet_1x2x1_dropout", "gwnet", (1, 2, 1), True, "b4", 4),
              ("gwnet_1x1x2_dropout", "gwnet", (1, 1, 2), True, "b4", 4)]
    remat = [(f"{st}_1x1x2_remat", st, (1, 1, 2), False, "b4", 4,
              {"remat_scope": "all", "backward_thread": True}) for st in ("gwnet", "dcrnn")]
    got = launch.run(R.mesh_steps, MeshShape(2, 1, 1), "cpu",
                     (cases + remat, variables, batches, (T, N, H)), progress=False)
    ref, noise = {}, {}
    for key, st, _, dropout, bname, _ in cases:
        ref[key] = R.one_device_step(R.model_config(st, dropout), variables[st],
                                     batches[bname], T, N, H)
    for st in ("gwnet", "dcrnn"):
        noise[st] = _noise(st, variables[st], ref[f"{st}_2x1x1"])
    return got, ref, noise


def _noise(st, variables, ref):
    """How far the one-device step's gradients move when its input is
    perturbed by 1e-7 relative: the step's own conditioning."""
    b = _batch(4)
    b["x"] = b["x"] * (1 + 1e-7 * np.random.default_rng(9).standard_normal(b["x"].shape)
                       ).astype(np.float32)
    return _grad_gap(R.one_device_step(R.model_config(st, False), variables, b, T, N, H)["grads"],
                     ref["grads"])


@pytest.mark.parametrize("st_gnn", ["gwnet", "dcrnn"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_step_equals_one_device_step(two_ranks, st_gnn, mesh):
    got, ref, noise = two_ranks
    key = f"{st_gnn}_{mesh}"
    _close_metrics(got[key]["eval"], ref[key]["eval"])  # make_sharded_eval_step, before it
    _close_metrics(got[key]["metrics"], ref[key]["metrics"])
    _close_stats(got[key]["stats"], ref[key]["stats"])
    _close_grads(got[key]["grads"], ref[key]["grads"], noise[st_gnn])


@pytest.mark.parametrize("mesh", ["1x2x1", "1x1x2"])
def test_mesh_dropout_masks_are_the_one_device_steps(two_ranks, mesh):
    """Dropout on: a rank cuts its block (hidden columns on the model
    axis, T on the time axis) from the global mask, so the step is the
    one-device step's."""
    got, ref, noise = two_ranks
    key = f"gwnet_{mesh}_dropout"
    _close_metrics(got[key]["metrics"], ref[key]["metrics"])
    _close_grads(got[key]["grads"], ref[key]["grads"], noise["gwnet"])


@pytest.mark.parametrize("st_gnn", ["gwnet", "dcrnn"])
def test_remat_on_a_time_split_mesh_equals_the_mesh_step(two_ranks, st_gnn):
    """remat_scope all on 1x1x2, its backward on a thread where no mesh is
    active (as on the card, where autograd runs it on the device thread):
    the recompute normalises with the time-summed moments the forward
    used, so the step equals the same mesh's step without remat bitwise,
    as a remat'd step equals the plain one on one device."""
    got, _, _ = two_ranks
    r, want = got[f"{st_gnn}_1x1x2_remat"], got[f"{st_gnn}_1x1x2"]
    assert r["metrics"] == want["metrics"]
    for part in ("stats", "grads", "params"):
        for k, v in want[part].items():
            assert np.array_equal(r[part][k], v), (part, k)


def test_shard_and_gather_tree_round_trip():
    """shard_tree then gather_tree of params and both Adam moments on a
    1x2x1 mesh gives the full tree back bitwise; a rank holds half of
    each TP leaf."""
    from multimodal_outage_tpu_torch.core.config import ModelConfig

    p = weights.init_variables(ModelConfig(), 7, 8, 0, 32)["params"]
    rng = np.random.default_rng(0)
    tree = {"params": p,
            "mu": weights.unflatten({k: torch.from_numpy(rng.standard_normal(v.shape)
                                                         .astype(np.float32))
                                     for k, v in weights.flatten(p).items()}),
            "nu": weights.unflatten({k: torch.from_numpy(rng.random(v.shape).astype(np.float32))
                                     for k, v in weights.flatten(p).items()})}
    out = launch.run(R.round_trip, MeshShape(1, 2, 1), "cpu", (tree,), progress=False)
    flat = weights.flatten(tree)
    assert set(out["back"]) == set(flat)
    for k, v in flat.items():
        assert np.array_equal(out["back"][k], np.asarray(v)), k
    assert out["shapes"]["params/encoder/fc1/kernel"] == (256, 32)
    assert out["shapes"]["mu/st_gnn/end_conv_2/kernel"] == (256, 256)
    assert out["shapes"]["nu/decoder/fc1/bias"] == (512,)
    assert out["shapes"]["nu/decoder/fc2/bias"] == (256,)


# --------------------------------------------------------- the 2x2x2 mesh


def test_2x2x2_step_equals_one_device_and_jax(jax_states):
    """Every axis at once on 8 gloo ranks, both st-GNNs: the step equals
    the port's one-device step (the bars of test_torch_port_spmd.py), and
    for Graph WaveNet JAX's sharded step on a (2, 2, 2) mesh (metrics, BN
    stats, parameters; one JAX step, whose CPU compile takes ~20 s)."""
    variables = {st: _variables(s) for st, (_, s) in jax_states.items()}
    cases = [(st, st, (2, 2, 2), False, "b4", 4) for st in ("gwnet", "dcrnn")]
    got = launch.run(R.mesh_steps, MeshShape(2, 2, 2), "cpu",
                     (cases, variables, {"b4": _batch(4)}, (T, N, H)), progress=False)
    mesh = jax_make_mesh(data=2, model=2, time=2)
    for st in ("gwnet", "dcrnn"):
        ref = R.one_device_step(R.model_config(st, False), variables[st], _batch(4), T, N, H)
        _close_metrics(got[st]["metrics"], ref["metrics"])
        _close_stats(got[st]["stats"], ref["stats"])
        _close_grads(got[st]["grads"], ref["grads"], _noise(st, variables[st], ref))
        if st != "gwnet":
            continue
        model, state = jax_states[st]
        sh_state = jax_sharding.shard_state(mesh, state)
        step = jax_sharding.make_sharded_train_step(model, mesh, sh_state, donate=False,
                                                    weighted=True)
        padded = jax_sharding.pad_batch(_batch(4), 4)
        new_state, metrics = step(sh_state, jax_sharding.shard_batch(mesh, padded),
                                  _jax_supports(st), jnp.float32(R.LR), jax.random.PRNGKey(0))
        _close_metrics(got[st]["metrics"], metrics)
        _close_stats(got[st]["stats"], _np(new_state.batch_stats))
        _close_params(got[st]["params"], _np(new_state.params))


def test_a_failing_rank_fails_the_run():
    """A rank that raises makes launch.run raise the rank's exception (its
    traceback in the message); no rank is left running."""
    with pytest.raises(ValueError, match=r"\[rank 1\]"):
        launch.run(R.fail_on_rank_1, MeshShape(2, 1, 1), "cpu", (), progress=False)
