"""The port's mesh entry points on the CPU, on gloo ranks: train on a
2-rank mesh against one device (the CLI), a checkpoint written on one
mesh resumed on another and read by one-device predict, mesh predict and
serve against one device, the date-sharded device store against the
replicated one, two host processes (--coordinator_address) against one
process of two ranks, and JAX's validation errors.

Bars: fit's val/test metrics within JAX's rtol 8e-3 of the one-device
run (tests/test_fit_spmd.py:84-87: a mesh sums gradients and BatchNorm
statistics in another order, and a run of steps amplifies that);
predict's and serve's metrics rtol 1e-5 and predictions atol 1e-5 (an
eval forward of one row is the same arithmetic on any rank; the metrics
are summed in another order); store batches bitwise."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from multimodal_outage_tpu.core.config import Config as JaxConfig
from multimodal_outage_tpu.core.config import DataConfig as JaxDataConfig
from multimodal_outage_tpu.core.config import ModelConfig as JaxModelConfig
from multimodal_outage_tpu.core.config import TrainConfig as JaxTrainConfig
from multimodal_outage_tpu.core.mesh import make_mesh as jax_make_mesh
from multimodal_outage_tpu.serving import ServingModel as JaxServingModel
from multimodal_outage_tpu.train import loop as jax_loop
from multimodal_outage_tpu_torch import cli, weights
from multimodal_outage_tpu_torch.core import mesh as mesh_mod
from multimodal_outage_tpu_torch.core.config import (
    Config,
    DataConfig,
    MeshConfig,
    ModelConfig,
    TrainConfig,
)
from multimodal_outage_tpu_torch.core.mesh import MeshShape
from multimodal_outage_tpu_torch.parallel import launch
from multimodal_outage_tpu_torch.serving import ServingModel
from multimodal_outage_tpu_torch.train import loop

import spmd_rank_steps as R

ENV = mesh_mod.VIRTUAL_DEVICES_ENV


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(store, batch=4, horizon=2):
    """The CLI flags of a tiny run. At horizon 2: 31 train windows (a
    ragged tail of 3 at batch 4), 13 val and 20 test windows (a tail of 2
    at batch 6); at horizon 3: 30 train windows."""
    return ["--data_dir", store, "--dataset_range", "12", "--horizon", str(horizon),
            "--image_size", "16", "--batch_size", str(batch), "--compute_dtype", "float32",
            "--device", "cpu"]


def _cfg(store, mesh=MeshConfig(data=1), job="j", epochs=1, resume=False, tmp="", batch=4):
    return Config(data=DataConfig(data_dir=store, dataset_range=12, horizon=2, image_size=16),
                  model=ModelConfig(compute_dtype="float32"),
                  train=TrainConfig(batch_size=batch, epochs=epochs, job_id=job, resume=resume,
                                    checkpoint_dir=os.path.join(tmp, "logs")),
                  mesh=mesh)


def test_train_on_two_ranks_matches_one_device(tiny_store_dir, tmp_path, monkeypatch):
    """`train --mesh_data 2` on two gloo ranks trains the tiny store end to
    end and lands within JAX's rtol 8e-3 of the one-device run (measured:
    1.3e-3). 30 windows at batch 6 leave no tail: a padded tail step draws
    its dropout masks for 6 rows where the ragged one draws them for its
    own, so the two runs would part there (the masked tail step is held to
    the ragged one with dropout off in test_torch_port_spmd.py)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv(ENV, "2")
    argv = ["train", *_tiny(tiny_store_dir, batch=6, horizon=3), "--epochs", "2"]
    one = cli.run(argv + ["--job_id", "one", "--mesh_data", "1"])
    two = cli.run(argv + ["--job_id", "two", "--mesh_data", "2"])
    assert two["mesh"] == "2x1x1" and len(two["ranks"]) == 2
    assert two["train_steps"] == one["train_steps"] == 10
    for k in ("val_loss", "val_mae", "test_loss", "test_mae"):
        np.testing.assert_allclose(two[k], one[k], rtol=8e-3, err_msg=k)
    rows = [json.loads(x) for x in open(tmp_path / "logs" / "two" / "metrics.jsonl")]
    assert [r["epoch"] for r in rows if r["phase"] == "val"] == [0, 1]


def test_checkpoint_resumes_on_another_mesh_and_serves_one_device(tiny_store_dir, tmp_path,
                                                                  monkeypatch):
    """A run written on 1x2x1 (tensor parallel: the checkpoint holds the
    gathered full tree) resumes on 2x1x1 for its second epoch, and
    one-device predict reads it (JAX tests/test_fit_spmd.py:90-124)."""
    monkeypatch.setenv(ENV, "2")
    a = loop.fit(_cfg(tiny_store_dir, MeshConfig(data=1, model=2), "remesh", tmp=str(tmp_path)),
                 progress=False, device="cpu")
    assert a["mesh"] == "1x2x1"
    b = loop.fit(_cfg(tiny_store_dir, MeshConfig(data=2), "remesh", epochs=2, resume=True,
                      tmp=str(tmp_path)), progress=False, device="cpu")
    assert b["mesh"] == "2x1x1" and np.isfinite(b["val_loss"]) and b["train_steps"] == 16
    run = tmp_path / "logs" / "remesh"
    rows = [json.loads(x) for x in open(run / "metrics.jsonl")]
    assert [r["epoch"] for r in rows if r["phase"] == "val"] == [0, 1]
    tree = torch.load(run / "checkpoints" / "latest" / "1.pt", weights_only=True)
    assert tuple(tree["params"]["encoder"]["fc1"]["kernel"].shape) == (64, 16)
    assert tuple(tree["opt_state"]["mu"]["st_gnn"]["end_conv_1"]["kernel"].shape) == (256, 512)
    preds, targets, metrics = loop.predict(_cfg(tiny_store_dir), str(run / "checkpoints"),
                                           "michael", device="cpu")
    assert preds.shape == targets.shape == (20, 4, 2, 16, 16, 1)
    assert np.isfinite(metrics["loss"])


@pytest.fixture(scope="module")
def trained(tiny_store_dir, tmp_path_factory):
    """A one-device checkpoint of the tiny run."""
    tmp = str(tmp_path_factory.mktemp("spmd_ckpt"))
    loop.fit(_cfg(tiny_store_dir, job="ckpt", tmp=tmp), progress=False, device="cpu")
    return os.path.join(tmp, "logs", "ckpt", "checkpoints")


@pytest.mark.parametrize("mesh,pipeline", [(MeshConfig(data=2), "auto"),
                                           (MeshConfig(data=1, time=2), "auto"),
                                           (MeshConfig(data=2, time=2), "host")],
                         ids=["2x1x1", "1x1x2", "2x1x2_host_path"])
def test_mesh_predict_equals_one_device(tiny_store_dir, trained, mesh, pipeline, monkeypatch):
    """evaluate's sweep on a mesh: the 20 test windows at batch 6 (the tail
    of 2 padded and masked, then trimmed off the arrays) equal one device's
    on the same input path, also the host path (each rank gathers its
    rows, then takes its T slice; its mean/std stay float32 where the
    device path rounds them to the compute dtype)."""
    monkeypatch.setenv(ENV, "4")

    def cfg(m):
        c = _cfg(tiny_store_dir, m, batch=6)
        return c.replace(data=dataclasses.replace(c.data, pipeline=pipeline))

    p1, t1, m1 = loop.predict(cfg(MeshConfig(data=1)), trained, "michael", device="cpu")
    p2, t2, m2 = loop.predict(cfg(mesh), trained, "michael", device="cpu")
    assert p2.shape == p1.shape == (20, 4, 2, 16, 16, 1)
    np.testing.assert_array_equal(t2, t1)
    np.testing.assert_allclose(p2, p1, atol=1e-5)
    for k in m1:
        np.testing.assert_allclose(m2[k], m1[k], rtol=1e-5, err_msg=k)


def test_mesh_serve_equals_one_device(tiny_store_dir, trained, tmp_path, monkeypatch):
    """`serve --mesh_data 2` (ServingModel(mesh=), the module path) against
    the one-device engine: metrics and the saved, trimmed predictions."""
    monkeypatch.setenv(ENV, "2")
    argv = ["serve", *_tiny(tiny_store_dir, batch=6), "--checkpoint_path", trained,
            "--case", "michael"]
    one = cli.run(argv + ["--save_preds", str(tmp_path / "one")])
    two = cli.run(argv + ["--mesh_data", "2", "--save_preds", str(tmp_path / "two")])
    for k in one["metrics"]:
        np.testing.assert_allclose(two["metrics"][k], one["metrics"][k], rtol=1e-5, err_msg=k)
    a, b = (np.load(tmp_path / d / "preds.npy") for d in ("one", "two"))
    assert a.shape == b.shape == (20, 4, 2, 16, 16, 1)
    np.testing.assert_allclose(b, a, atol=1e-5)


def test_sharded_store_batches_are_the_replicated_stores(tiny_store_dir):
    """--shard_store: each of two ranks holds only its half of the dates
    (rows of the memmap, zero past the end), and its batches are bitwise
    those of the replicated store on the same mesh."""
    idx = [np.array([0, 5, 9, 17]), np.array([3, 3, 1, 40])]
    out = launch.run(R.pipeline_batches, MeshShape(2, 1, 1), "cpu",
                     (tiny_store_dir, 2, 16, idx), progress=False)
    assert out["ranks_ok"] == [[1.0, 1.0], [1.0, 1.0]]
    assert out["held"] == -(-out["dates"] // 2)


def test_two_processes_equal_one_process_of_two_ranks(tiny_store_dir, tmp_path):
    """Two "host" processes through --coordinator_address 127.0.0.1:<port>
    --num_processes 2 --process_id {0,1}, one device each, give the run
    of one process of two ranks."""
    env = {**os.environ, "PYTHONPATH": os.getcwd(), "OMP_NUM_THREADS": "1"}
    argv = [sys.executable, "-m", "multimodal_outage_tpu_torch", "train",
            *_tiny(tiny_store_dir), "--epochs", "1", "--mesh_data", "2"]
    one = subprocess.run(argv + ["--job_id", "one"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env={**env, ENV: "2"})
    assert one.returncode == 0, one.stderr[-2000:]
    port = str(launch._free_port())
    procs = [subprocess.Popen(argv + ["--job_id", "two", "--coordinator_address",
                                      f"127.0.0.1:{port}", "--num_processes", "2",
                                      "--process_id", str(i)],
                              cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env={**env, ENV: "1"})
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-2000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    want = json.loads(one.stdout.strip().splitlines()[-1])
    for got in outs:
        for k in ("val_loss", "test_loss", "test_mae", "train_steps"):
            assert got[k] == want[k], k


# ------------------------------------------------------------- errors


def _jax_error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("case", ["batch", "horizon", "pallas"])
def test_validation_errors_are_jaxs_word_for_word(case):
    """_validate_mesh_cfg raises JAX's three errors (train/loop.py:
    1011-1032): batch not divisible by data, horizon by time, and
    pool='pallas' on a multi-device mesh."""
    kw = {"batch": (dict(batch_size=3), {}, dict(data=2)),
          "horizon": ({}, dict(horizon=7), dict(data=1, time=2)),
          "pallas": ({}, {}, dict(data=2))}[case]
    model = dict(pool="pallas") if case == "pallas" else {}
    theirs = JaxConfig(train=JaxTrainConfig(**kw[0]), data=JaxDataConfig(**kw[1]),
                       model=JaxModelConfig(**model))
    ours = Config(train=TrainConfig(**kw[0]), data=DataConfig(**kw[1]),
                  model=ModelConfig(**model))
    jmesh = jax_make_mesh(**kw[2])
    shape = MeshShape(kw[2].get("data", 1), 1, kw[2].get("time", 1))
    assert (_jax_error(lambda: loop._validate_mesh_cfg(ours, shape))
            == _jax_error(lambda: jax_loop._validate_mesh_cfg(theirs, jmesh)))


def test_serving_model_mesh_errors_are_jaxs():
    """ServingModel(mesh=) rejects the kernel flags with the JAX engine's
    ValueError (its serving.py:124-131), and a request batch the data
    axis does not divide with its message (:476-486)."""
    cfg = ModelConfig(compute_dtype="float32")
    var = weights.init_variables(cfg, 2, 4, 0, 16)
    jvar = {"params": weights.flatten(var["params"]), "batch_stats": {}}
    theirs = _jax_error(lambda: JaxServingModel(JaxModelConfig(), jvar, None,
                                                mesh=jax_make_mesh(data=2), gwnet_stack=True))
    for flag in (dict(gwnet_stack=True), dict(gwnet_pallas=True), dict(dcrnn_stack=True)):
        assert _jax_error(lambda: ServingModel(cfg, var, torch.eye(4)[None], horizon=2,
                                               mesh=object(), **flag)) == theirs

    class _Mesh:  # a data-2 mesh; the request is refused before any collective
        shape, coords, device = MeshShape(2, 1, 1), (0, 0, 0), torch.device("cpu")

    serve = ServingModel(cfg, var, torch.eye(4)[None], horizon=2, mesh=_Mesh())
    with pytest.raises(ValueError, match=r"request batch 3 not divisible by the mesh data "
                                         r"axis 2 — pad the batch"):
        serve(torch.zeros(3, 4, 2, 16, 16, 1), torch.zeros(3, 2, 6))
