"""The port's data path and metrics against the JAX package's functions,
on the shared tiny store and numpy inputs."""

import datetime

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_outage_tpu.core import metrics as jmetrics
from multimodal_outage_tpu.core.registry import HURRICANES as J_HURRICANES
from multimodal_outage_tpu.data import adjacency as jadj
from multimodal_outage_tpu.data import pipeline as jpipe
from multimodal_outage_tpu.data.dataset import WindowDataset as JWindowDataset
from multimodal_outage_tpu.data.synthetic import generate_store as j_generate_store
from multimodal_outage_tpu_torch.core import metrics
from multimodal_outage_tpu_torch.core.config import DEFAULT_NTL_MEAN, DEFAULT_NTL_STD
from multimodal_outage_tpu_torch.core.registry import HURRICANES, leave_one_out
from multimodal_outage_tpu_torch.data import adjacency, pipeline
from multimodal_outage_tpu_torch.data.dataset import WindowDataset
from multimodal_outage_tpu_torch.data.store import load_store
from multimodal_outage_tpu_torch.data.synthetic import generate_store


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's small torch ops: with the
    suite's workers sharing the cores, OpenMP's barriers otherwise stall
    each op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("size", [16, 8, 24])  # no resize, shrink, grow
def test_frame_transform_matches_jax(size):
    win = np.random.default_rng(size).uniform(0, 40, (2, 3, 2, 16, 16)).astype(np.float32)
    mean, std = np.float32(DEFAULT_NTL_MEAN), np.float32(DEFAULT_NTL_STD)
    want = jpipe.default_frame_transform(jnp.asarray(win), mean, std, size)
    got = pipeline.default_frame_transform(
        torch.from_numpy(win), torch.tensor(mean), torch.tensor(std), size
    )
    assert tuple(got.shape) == (2, 3, 2, size, size, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_window_gather_matches_jax(tiny_store, dtype):
    """Same windows, layout and normalization as the JAX device gather;
    x in the compute dtype (mean/std held in it too), y float32."""
    _, cases = leave_one_out("michael")
    ds = WindowDataset.from_case_study(tiny_store, cases, 12, 3)
    jds = JWindowDataset.from_case_study(tiny_store, {"michael": J_HURRICANES["michael"]}, 12, 3)
    np.testing.assert_array_equal(ds.indices, jds.indices)
    assert len(ds) == len(jds) > 2
    idx = np.array([0, 2])
    np.testing.assert_array_equal(ds.window_positions(idx), jds.window_positions(idx))
    np.testing.assert_array_equal(ds.window_date_feats(idx), jds.window_date_feats(idx))

    jdt = jnp.dtype(dtype)
    want = jpipe.device_gather_batch(
        jnp.asarray(np.asarray(tiny_store.frames)),
        jnp.asarray(jds.window_positions(idx), jnp.int32),
        jnp.asarray(jds.window_date_feats(idx)),
        jnp.asarray(DEFAULT_NTL_MEAN, jdt), jnp.asarray(DEFAULT_NTL_STD, jdt), 3, 16,
    )
    pipe = pipeline.DevicePipeline(
        tiny_store, DEFAULT_NTL_MEAN, DEFAULT_NTL_STD, 16, getattr(torch, dtype),
        torch.device("cpu"),
    )
    got = pipe.batch(ds, idx)
    assert got["x"].dtype == getattr(torch, dtype) and got["y"].dtype == torch.float32
    for k in ("x", "y", "date_feats"):
        np.testing.assert_allclose(
            got[k].float().numpy(), np.asarray(want[k].astype(jnp.float32)),
            rtol=1e-6, atol=1e-6,
        )


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    yhat = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    y = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    y[0, 0, 0, 0] = 0.0  # MAPE's clamp
    want = jmetrics.regression_metrics(jnp.asarray(yhat), jnp.asarray(y))
    got = metrics.regression_metrics(torch.from_numpy(yhat), torch.from_numpy(y))
    assert metrics.MAPE_EPS == jmetrics.MAPE_EPS
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)
    agg, jagg = metrics.MeanAggregator(), jmetrics.MeanAggregator()
    for s in (1.0, 3.0):
        agg.update(metrics.regression_metrics(torch.from_numpy(yhat * s), torch.from_numpy(y)))
        jagg.update(jmetrics.regression_metrics(jnp.asarray(yhat * s), jnp.asarray(y)))
    for k, v in jagg.compute().items():
        np.testing.assert_allclose(agg.compute()[k], v, rtol=1e-6)


def test_synthetic_store_matches_jax(tmp_path):
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    frames, dates = generate_store(a, n_counties=3, image_size=8, margin=3, seed=1)
    jframes, jdates = j_generate_store(b, n_counties=3, image_size=8, margin=3, seed=1)
    np.testing.assert_array_equal(frames, jframes)
    np.testing.assert_array_equal(dates, jdates)
    sa, sb = load_store(a), load_store(b)
    np.testing.assert_array_equal(np.asarray(sa.frames), np.asarray(sb.frames))
    np.testing.assert_array_equal(sa.monthly, sb.monthly)
    assert sa.county_names == sb.county_names


def test_one_storm_store_covers_only_that_storm(tmp_path):
    _, dates = generate_store(
        str(tmp_path), n_counties=2, image_size=4, margin=2, seed=0,
        hurricanes={"ian": HURRICANES["ian"]},
    )
    assert len(dates) == 5 and tuple(dates[2]) == (2022, 9, 26)


@pytest.mark.parametrize("adjtype", ["identity", "transition", "doubletransition"])
def test_static_supports_match_jax(adjtype):
    names, adj = adjacency.load_adjacency_csv()
    jnames, jadj_m = jadj.load_adjacency_csv()
    assert names == jnames and len(names) == 67
    got = adjacency.static_supports(67, adjtype, sorted(names) if adjtype == "identity" else names)
    np.testing.assert_array_equal(got, np.stack(jadj.build_supports(jadj_m, adjtype)))
    small = adjacency.static_supports(5, adjtype)
    np.testing.assert_array_equal(
        small, np.stack(jadj.build_supports(jadj.synthetic_adjacency(5, seed=42), adjtype))
    )


def test_registry_matches_jax():
    assert HURRICANES == J_HURRICANES
    with pytest.raises(ValueError):
        leave_one_out("katrina")
    train_val, test = leave_one_out("ian")
    assert test == {"ian": datetime.date(2022, 9, 26)} and "ian" not in train_val
