"""The port's importer of reference PyTorch/Lightning checkpoints
(parity/torch_import.py and `import-torch`) on the CPU, against the JAX
package's (its parity/torch_import.py).

Reference state_dicts are built in memory in the reference's key layout
(the JAX or the port's export_state_dict). JAX variable trees take their
key paths and shapes from the JAX model itself (jax.eval_shape of its
init, no compile) and seeded values, with BatchNorm running statistics
in [0.5, 1.5] so that a mean/var mix-up shows.

Tolerances: both importers and the round trips are held to bitwise
equality (one rule table, exact layout transforms); the upsampler against
nn.ConvTranspose2d atol 1e-5 (float32, 2×2 kernels, sums of ≤ 16
products); `evaluate` of an import against JAX convert_checkpoint + JAX
predict of the same file at the CPU eval bar, preds atol 5e-5 / rtol
1e-4 and metrics rtol 1e-4 (float32).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_outage_tpu.core.config import Config as JaxConfig
from multimodal_outage_tpu.core.config import DataConfig as JaxDataConfig
from multimodal_outage_tpu.core.config import GWNetConfig as JaxGWNetConfig
from multimodal_outage_tpu.core.config import MeshConfig as JaxMeshConfig
from multimodal_outage_tpu.core.config import ModelConfig as JaxModelConfig
from multimodal_outage_tpu.core.config import TrainConfig as JaxTrainConfig
from multimodal_outage_tpu.models.fusion import build_model as jax_build_model
from multimodal_outage_tpu.parity import torch_import as jax_ti
from multimodal_outage_tpu.train import loop as jax_loop
from multimodal_outage_tpu_torch import cli, weights
from multimodal_outage_tpu_torch.core.checkpoint import CheckpointManager
from multimodal_outage_tpu_torch.core.config import GWNetConfig, ModelConfig
from multimodal_outage_tpu_torch.models.fusion import build_model
from multimodal_outage_tpu_torch.parity import torch_import as ti


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's small torch ops: with the
    suite's workers sharing the cores, OpenMP's barriers otherwise stall
    each op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N, T, H = 4, 3, 16
VARIANTS = {
    "default": {},
    "kernel_size2_no_gcn": dict(kernel_size=2, gcn_bool=False),
    "no_addaptadj": dict(addaptadj=False),
}


def _jax_variables(gwnet, seed=0):
    """A {"params", "batch_stats"} tree with the JAX model's own key
    paths and shapes (eval_shape of its init, float32) and seeded values."""
    model = jax_build_model(JaxModelConfig(compute_dtype="float32",
                                           gwnet=JaxGWNetConfig(**gwnet)), T)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(
        lambda: model.init({"params": key, "dropout": key}, jnp.zeros((1, N, T, H, H, 1)),
                           jnp.zeros((1, T, 6)), jnp.eye(N)[None], train=False))
    rng = np.random.default_rng(seed)
    tree = {
        "params": jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32),
                               shapes["params"]),
        "batch_stats": jax.tree.map(
            lambda s: rng.uniform(0.5, 1.5, s.shape).astype(np.float32),
            shapes["batch_stats"]),
    }
    return jax.tree.map(np.asarray, tree)


def _port_variables(model_cfg=None, seed=0):
    """init_variables with BatchNorm statistics drawn in [0.5, 1.5]."""
    v = weights.init_variables(model_cfg or ModelConfig(), T, N, seed, H)
    g = torch.Generator().manual_seed(seed)
    v["batch_stats"] = weights.unflatten({
        k: 0.5 + torch.rand(t.shape, generator=g)
        for k, t in weights.flatten(v["batch_stats"]).items()})
    return v


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in weights.flatten(tree).items()}


def _assert_trees_bitwise(got, want):
    for c in ("params", "batch_stats"):
        g, w = _flat_np(got[c]), _flat_np(want[c])
        assert sorted(g) == sorted(w), c
        for k in w:
            assert g[k].dtype == w[k].dtype == np.float32, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{c}/{k}")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_jax_export_imports_bitwise_as_the_jax_importer(variant):
    """JAX export_state_dict of JAX variables, imported by the port into
    its own template (init_variables of the same config), gives the
    leaves that JAX's import_state_dict gives into the JAX tree, and the
    source's."""
    jv = _jax_variables(VARIANTS[variant])
    sd = jax_ti.export_state_dict(jv)
    theirs = jax_ti.import_state_dict(sd, jv, strict=True)
    template = weights.init_variables(ModelConfig(gwnet=GWNetConfig(**VARIANTS[variant])),
                                      T, N, 1, H)
    ours = ti.import_state_dict(sd, template, strict=True)
    # the template's Date2Vec stands on both sides: the reference keeps it
    # in its own pickle
    for tree in (ours, theirs, jv):
        tree["params"].pop("date2vec")
    _assert_trees_bitwise(ours, jax.tree.map(np.asarray, theirs))
    _assert_trees_bitwise(ours, jv)
    assert sorted(ti.export_state_dict(ours)) == sorted(sd)


def test_port_export_import_round_trip_bitwise():
    v = _port_variables()
    sd = ti.export_state_dict(v)
    # the reference's layouts: conv OIHW, Linear [out, in], 1×1 [out, in, 1, 1]
    assert sd["contraction.inc.double_conv.0.weight"].shape == (4, 1, 3, 3)
    assert sd["encoder.fc1.weight"].shape[0] < sd["encoder.fc1.weight"].shape[1]
    assert sd["st_gnn.start_conv.weight"].shape == (32, 320, 1, 1)
    assert sd["st_gnn.gconv.0.mlp.mlp.weight"].shape[1] == 160
    assert sd["expansion.up1.up.weight"].shape == (64, 32, 2, 2)
    out = ti.import_state_dict(sd, weights.init_variables(ModelConfig(), T, N, 9, H))
    out["params"]["date2vec"] = v["params"]["date2vec"]
    _assert_trees_bitwise(out, {c: {k: t.numpy() for k, t in weights.flatten(v[c]).items()}
                                for c in ("params", "batch_stats")})
    # and the same keys and arrays as the JAX package's export of that tree
    theirs = jax_ti.export_state_dict(_flat_tree_np(v))
    assert sorted(theirs) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(sd[k], theirs[k], err_msg=k)


def _flat_tree_np(v):
    return {c: weights.unflatten(_flat_np(v[c])) for c in ("params", "batch_stats")}


def _lightning(sd):
    """What every reference Lightning checkpoint carries beyond the
    tree: the `model.` prefix, BN counters, the dead residual_convs
    (reference graph_wavenet.py:159,239-245)."""
    out = {f"model.{k}": torch.from_numpy(a) for k, a in sd.items()}
    out["model.contraction.inc.double_conv.1.num_batches_tracked"] = torch.tensor(7)
    out["model.st_gnn.bn.0.num_batches_tracked"] = torch.tensor(7)
    out["model.st_gnn.residual_convs.0.weight"] = torch.zeros(32, 32, 1, 1)
    out["model.st_gnn.residual_convs.0.bias"] = torch.zeros(32)
    return out


def test_lightning_prefix_counters_and_dead_residual_convs():
    v = _port_variables()
    sd = _lightning(ti.export_state_dict(v))
    out = ti.import_state_dict(sd, v, strict=True)
    _assert_trees_bitwise(out, {c: _flat_np(v[c]) for c in ("params", "batch_stats")})


def _raised(fn, *args, **kw):
    with pytest.raises(Exception) as e:
        fn(*args, **kw)
    return e.value


@pytest.mark.parametrize("case", ["missing", "extra", "shape", "dcrnn"])
def test_errors_match_jax(case):
    """The same bad input raises the same exception, with the same
    message, in both importers; the patterns are JAX's tests'
    (tests/test_torch_import.py)."""
    if case == "dcrnn":
        v = weights.init_variables(ModelConfig(st_gnn="dcrnn"), T, N, 0, H)
        sd, pattern = {}, "DCRNN"
    else:
        v = _port_variables()
        sd = ti.export_state_dict(v)
        if case == "missing":
            del sd["encoder.fc1.weight"]
            pattern = "missing keys.*encoder.fc1"
        elif case == "extra":
            sd["st_gnn.mystery.weight"] = np.zeros((3,), np.float32)
            pattern = "unconsumed.*mystery"
        else:
            sd["decoder.fc1.weight"] = np.zeros((7, 7), np.float32)
            pattern = "shape mismatch.*decoder"
    strict = case != "dcrnn"
    ours = _raised(ti.import_state_dict, sd, v, strict=strict)
    theirs = _raised(jax_ti.import_state_dict, sd, _flat_tree_np(v), strict=strict)
    assert type(ours) is type(theirs) is ValueError
    assert str(ours) == str(theirs)
    with pytest.raises(ValueError, match=pattern):
        raise ours
    if case in ("missing", "extra"):
        # --no_strict tolerates both: the template's leaf stands for a
        # missing key, an extra key is dropped
        out = ti.import_state_dict(sd, v, strict=False)
        _assert_trees_bitwise(out, {c: _flat_np(v[c]) for c in ("params", "batch_stats")})


def test_date2vec_pth_module_pickle_loads_and_merges(tmp_path):
    """A whole-module Date2Vec pickle, as the reference ships it. The
    class comes from sys.modules: the JAX package's shim may have been
    registered first in this process, and pickling needs the registered
    object."""
    ti._register_date2vec_shim()
    d2v = sys.modules["date2vec"].Date2Vec(k=64)
    pth = tmp_path / "d2v.pth"
    torch.save(d2v, str(pth))
    got = ti.date2vec_params_from_pth(str(pth))
    assert got["fc1"]["kernel"].shape == (6, 32)
    np.testing.assert_array_equal(got["fc2"]["kernel"], d2v.fc2.weight.detach().numpy().T)
    theirs = jax_ti.date2vec_params_from_pth(str(pth))
    for fc in ("fc1", "fc2"):
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(got[fc][leaf], theirs[fc][leaf])
    v = _port_variables()
    merged = ti.merge_date2vec(v["params"], got)
    np.testing.assert_array_equal(merged["date2vec"]["fc1"]["bias"],
                                  d2v.fc1.bias.detach().numpy())
    np.testing.assert_array_equal(merged["encoder"]["fc1"]["kernel"],
                                  v["params"]["encoder"]["fc1"]["kernel"].numpy())
    # a k that does not match time_embed_size: the same error as JAX's
    small = ti.date2vec_params_from_pth(str(_saved(tmp_path, 32)))
    ours = _raised(ti.merge_date2vec, v["params"], small)
    theirs = _raised(jax_ti.merge_date2vec, _flat_tree_np(v)["params"], small)
    assert type(ours) is type(theirs) is ValueError and str(ours) == str(theirs)
    assert "k must match time_embed_size" in str(ours)


def _saved(tmp_path, k):
    path = tmp_path / f"d2v{k}.pth"
    torch.save(sys.modules["date2vec"].Date2Vec(k=k), str(path))
    return path


def test_load_torch_checkpoint_fallback_is_narrow(tmp_path):
    """weights_only=True first; the full unpickler only on its policy
    refusal ("Unsupported global"), never on a corrupt file."""
    plain = tmp_path / "plain.pth"
    torch.save({"state_dict": {"w": torch.ones(2, 3)}}, str(plain))
    assert ti.load_torch_checkpoint(str(plain))["w"].shape == (2, 3)
    bad = tmp_path / "corrupt.pth"
    bad.write_bytes(b"this is not a torch checkpoint")
    err = _raised(ti.load_torch_checkpoint, str(bad))
    assert "Unsupported global" not in str(err)
    ti._register_date2vec_shim()
    mod = tmp_path / "module.pth"
    torch.save(sys.modules["date2vec"].Date2Vec(k=64), str(mod))
    assert any("fc1" in k for k in ti.load_torch_checkpoint(str(mod)))


def test_imported_upsampler_equals_nn_convtranspose2d():
    """A reference ConvTranspose2d weight, imported (one flip) and run by
    the port's module (the flip back in weights.conv_transpose_weight),
    gives what nn.ConvTranspose2d gives fed that weight directly: a
    missing or doubled flip scrambles the 2×2 output blocks."""
    v = _port_variables()
    sd = ti.export_state_dict(v)
    g = torch.Generator().manual_seed(3)
    ref = torch.nn.ConvTranspose2d(64, 32, 2, stride=2)
    with torch.no_grad():
        ref.weight.copy_(torch.randn(ref.weight.shape, generator=g))
        ref.bias.copy_(torch.randn(ref.bias.shape, generator=g))
    sd["expansion.up1.up.weight"] = ref.weight.detach().numpy().copy()
    sd["expansion.up1.up.bias"] = ref.bias.detach().numpy().copy()
    model = build_model(ModelConfig(compute_dtype="float32"), T, N, H)
    weights.load_variables(model, ti.import_state_dict(sd, v))
    x = torch.randn(2, 3, 5, 64, generator=g)  # NHWC
    got = model.expansion.up1.up(x)
    want = ref(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 6, 10, 32)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


TINY = ["--dataset_range", "12", "--horizon", str(T), "--image_size", str(H),
        "--batch_size", "2", "--compute_dtype", "float32"]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """A Lightning .ckpt of seeded variables and a Date2Vec .pth."""
    work = tmp_path_factory.mktemp("ref")
    v = _port_variables(seed=4)
    ckpt = str(work / "reference.ckpt")
    torch.save({"state_dict": _lightning(ti.export_state_dict(v)), "epoch": 3}, ckpt)
    ti._register_date2vec_shim()
    return {"variables": v, "ckpt": ckpt, "d2v": str(_saved(work, 64)), "work": work}


def _import(reference, out, *extra):
    return cli.run(["import-torch", "--checkpoint", reference["ckpt"], "--d2v_pth",
                    reference["d2v"], "--out", out, "--n_counties", str(N), *TINY, *extra])


def test_import_torch_cli_evaluates_as_jax_convert_and_predict(reference, tiny_store_dir,
                                                                capsys):
    """import-torch --device cpu, then the port's evaluate of the result,
    against JAX convert_checkpoint, then JAX predict, of the same files."""
    out = str(reference["work"] / "port")
    info = _import(reference, out, "--device", "cpu")
    printed = capsys.readouterr().out
    n_keys = len(ti.load_torch_checkpoint(reference["ckpt"]))
    assert info == {"out": out, "torch_keys": n_keys, "leaves": info["leaves"]}
    assert f"imported {n_keys} reference tensors -> {info['leaves']} framework leaves at {out}" \
        in printed
    tree = CheckpointManager(out).restore()
    assert tree["step"] == 0 and tree["opt_state"]["count"] == 0
    assert tree["meta"] == {"epoch": 0, "best_val": float("inf"), "best_epoch": -1,
                            "bad_epochs": 0}
    ev = cli.run(["evaluate", "--checkpoint_path", out, "--case", "michael", "--data_dir",
                  tiny_store_dir, "--save_preds", str(reference["work"] / "preds"), *TINY,
                  "--device", "cpu"])

    jcfg = JaxConfig(data=JaxDataConfig(data_dir=tiny_store_dir, n_counties=N, image_size=H,
                                        horizon=T, dataset_range=12),
                     model=JaxModelConfig(compute_dtype="float32"),
                     train=JaxTrainConfig(batch_size=2), mesh=JaxMeshConfig(data=1))
    jax_dir = str(reference["work"] / "jax")
    jinfo = jax_ti.convert_checkpoint(jcfg, reference["ckpt"], jax_dir, d2v_pth=reference["d2v"])
    assert jinfo == {"leaves": info["leaves"], "torch_keys": n_keys}
    jp, jt, jm = jax_loop.predict(jcfg, jax_dir, "michael")
    preds = np.load(str(reference["work"] / "preds" / "preds.npy"))
    assert preds.shape == np.shape(jp) == (18, N, T, H, H, 1)
    np.testing.assert_allclose(preds, np.asarray(jp), atol=5e-5, rtol=1e-4)
    for k in ("loss", "mae", "mape", "rmse"):
        np.testing.assert_allclose(ev["metrics"][k], float(jm[k]), rtol=1e-4, err_msg=k)


def test_resume_from_an_import_trains_and_demotes_the_sentinel(reference, tiny_store_dir,
                                                               tmp_path, monkeypatch):
    """train --resume from logs/<job>/checkpoints written by import-torch:
    the run starts after the import's epoch 0 at step 0, trains one
    epoch, and best/ then holds that epoch, not the 1e30 sentinel."""
    monkeypatch.chdir(tmp_path)
    ckpt = os.path.join("logs", "imp", "checkpoints")
    _import(reference, ckpt, "--device", "cpu")
    assert _index(ckpt) == {"0": 1e30}
    out = cli.run(["train", "--resume", "--job_id", "imp", "--epochs", "2", "--data_dir",
                   tiny_store_dir, *TINY, "--device", "cpu"])
    assert out["best_epoch"] == 1
    assert _index(ckpt) == {"1": out["val_loss"]} and out["val_loss"] < 1e30
    assert sorted(os.listdir(os.path.join(ckpt, "best"))) == ["1.pt", "metrics.json"]
    tree = CheckpointManager(ckpt).restore_latest()
    assert tree["step"] == out["train_steps"] == tree["opt_state"]["count"] > 0


def _index(ckpt):
    with open(os.path.join(ckpt, "best", "metrics.json")) as f:
        return json.load(f)


def test_import_torch_without_device_needs_a_card(reference, tmp_path):
    out = tmp_path / "imported"
    with pytest.raises(RuntimeError, match="CUDA"):
        _import(reference, str(out))
    assert not out.exists()


def test_import_torch_dcrnn_raises_as_jax(reference, tmp_path):
    out = tmp_path / "imported"
    with pytest.raises(ValueError, match="no reference mapping for a DCRNN st-GNN"):
        _import(reference, str(out), "--st_gnn", "dcrnn", "--device", "cpu")
    assert not out.exists()
