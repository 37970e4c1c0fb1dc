"""The port's command line on the shared tiny store."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from multimodal_outage_tpu_torch import cli, weights
from multimodal_outage_tpu_torch.core.config import ModelConfig

TINY = ["--dataset_range", "12", "--horizon", "3", "--image_size", "16", "--batch_size", "2"]


def test_serve_cpu_prints_metrics(tiny_store_dir, capsys):
    assert cli.main(
        ["serve", "--data_dir", tiny_store_dir, *TINY, "--seed", "0", "--device", "cpu",
         "--compute_dtype", "float32", "--latency_stats", "--max_batches", "2"]
    ) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out["metrics"]) == {"loss", "mae", "mape", "rmse"}
    assert all(np.isfinite(v) for v in out["metrics"].values())
    assert out["device"] == "cpu"
    # 2 sweep batches + 1 warm-up + 3 timed repeats of each full batch
    assert out["forwards"] == 2 + 1 + 3 * 2
    assert out["latency"]["p90_ms"] >= out["latency"]["p50_ms"] > 0


def test_serve_weights_file_equals_seed(tiny_store_dir, tmp_path):
    """--weights loads what weights.save_npz wrote: the same metrics as
    --seed with the seed that made them."""
    path = str(tmp_path / "w.npz")
    weights.save_npz(path, weights.init_variables(ModelConfig(), 3, 4, seed=7, image_size=16))
    base = ["serve", "--data_dir", tiny_store_dir, *TINY, "--device", "cpu", "--max_batches", "2"]
    a = cli.run(base + ["--weights", path])
    b = cli.run(base + ["--seed", "7"])
    assert a["metrics"] == b["metrics"]


def test_serve_without_device_needs_a_card(tiny_store_dir):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the check is for one without")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.run(["serve", "--data_dir", tiny_store_dir, *TINY, "--seed", "0"])


def test_module_entry_point_synth(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "multimodal_outage_tpu_torch", "synth",
         "--out_dir", str(tmp_path), "--n_counties", "2", "--image_size", "8",
         "--margin", "2", "--cases", "michael"],
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)["frames"] == [5, 2, 8, 8]


def test_synth_rejects_unknown_storm(tmp_path):
    with pytest.raises(ValueError, match="katrina"):
        cli.run(["synth", "--out_dir", str(tmp_path), "--cases", "katrina"])


def test_serve_feeds_frames_in_device_dtype(tiny_store_dir):
    """serve_eval builds its pipeline in DataConfig.device_dtype, as the
    JAX package's serve_eval does, whatever the engine computes in: a
    float32 engine is fed bfloat16-rounded frames by default."""
    from multimodal_outage_tpu_torch.core.config import DataConfig
    from multimodal_outage_tpu_torch.data.store import load_store
    from multimodal_outage_tpu_torch.serving import serve_eval

    class Recorder:
        dtype, device = torch.float32, torch.device("cpu")

        def __init__(self):
            self.seen = []

        def __call__(self, x, date_feats):
            self.seen.append(x.dtype)
            return x.float()

    store = load_store(tiny_store_dir)
    for device_dtype, want in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        data_cfg = DataConfig(data_dir=tiny_store_dir, image_size=16, n_counties=4, horizon=3,
                              dataset_range=12, device_dtype=device_dtype)
        rec = Recorder()
        serve_eval(data_cfg, rec, store, "michael", 2, max_batches=2)
        assert rec.seen == [want, want]
