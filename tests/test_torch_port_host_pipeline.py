"""The port's host input path on the CPU, held against the JAX package:
the native gather (data/native.py, built from csrc/gather.cpp), the
dataset's gather_batch, preprocess_batch, PrefetchIterator, the input
path make_pipeline picks, a float32 fit through each path, and the two
transform hooks on fit, predict and serve_eval. Tiny shapes: 4 counties,
16² frames.

Tolerances: the gathers and the path choice are held to equality (a copy
is a copy); preprocess_batch atol 1e-5 against the JAX package's (both
normalize in float32, and the antialiased resize of jax.image.resize and
F.interpolate sum their taps in another order); the host-path fit to the
device-path fit bitwise (the same float32 ops on the same values); JAX
against the port's predictions under a frame transform atol 5e-5 / rtol
1e-4 (the JAX serving bar). Every wait on a thread is bounded.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_outage_tpu.core.config import small_test_config
from multimodal_outage_tpu.data import native as jax_native
from multimodal_outage_tpu.data import pipeline as jax_pipeline
from multimodal_outage_tpu.data.dataset import WindowDataset as JaxWindowDataset
from multimodal_outage_tpu.data.store import load_store as jax_load_store
from multimodal_outage_tpu.train import loop as jax_loop
from multimodal_outage_tpu_torch import weights
from multimodal_outage_tpu_torch.core.checkpoint import CheckpointManager, restore_variables
from multimodal_outage_tpu_torch.core.config import (
    DEFAULT_NTL_MEAN,
    DEFAULT_NTL_STD,
    Config,
    DataConfig,
    GWNetConfig,
    ModelConfig,
    TrainConfig,
)
from multimodal_outage_tpu_torch.core.registry import HURRICANES
from multimodal_outage_tpu_torch.data import native
from multimodal_outage_tpu_torch.data.adjacency import config_supports
from multimodal_outage_tpu_torch.data.dataset import WindowDataset
from multimodal_outage_tpu_torch.data.pipeline import (
    DevicePipeline,
    PrefetchIterator,
    default_frame_transform,
    denormalize,
    preprocess_batch,
)
from multimodal_outage_tpu_torch.data.store import load_store
from multimodal_outage_tpu_torch.serving import ServingModel, serve_eval
from multimodal_outage_tpu_torch.train import loop

WAIT = 60.0  # seconds: every wait on a thread in this file is bounded
H, T, B = 16, 2, 4
MEAN, STD = DEFAULT_NTL_MEAN, DEFAULT_NTL_STD  # DataConfig's, in both packages


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """One intra-op torch thread and two gather threads: with the suite's
    workers sharing the cores, more only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "default_threads", lambda: 2)
        yield
    torch.set_num_threads(n)


def _drain(iterable, limit=None):
    """Consume `iterable` (up to `limit` items) in a thread joined with a
    timeout: (items, exception raised or None)."""
    out, err = [], []

    def run():
        try:
            for item in iterable:
                out.append(item)
                if limit is not None and len(out) >= limit:
                    break
        except Exception as e:  # handed to the test
            err.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(WAIT)
    assert not t.is_alive(), "consumer did not finish"
    return out, (err[0] if err else None)


def _dataset(store, dataset_range=12, horizon=T):
    return WindowDataset.from_case_study(store, HURRICANES, dataset_range, horizon)


# ---------------------------------------------------------------- native gather


@pytest.mark.parametrize("case", ["repeated", "boundary", "empty", "memmap"])
def test_native_gather_matches_numpy_and_jax(case, tiny_store):
    frames = np.ascontiguousarray(tiny_store.frames)
    d = frames.shape[0]
    idx = {"repeated": [3, 3, 1, 3, 0, 1], "boundary": [0, d - 1, 0, d - 1],
           "empty": [], "memmap": [d - 1, 2, 5, 2]}[case]
    idx = np.asarray(idx, np.int64)
    src = tiny_store.frames if case == "memmap" else frames
    assert isinstance(tiny_store.frames, np.memmap)
    got = native.gather_frames(src, idx)
    assert got.dtype == np.float32 and got.shape == (len(idx),) + frames.shape[1:]
    np.testing.assert_array_equal(got, native.gather_frames_reference(src, idx))
    np.testing.assert_array_equal(got, jax_native.gather_frames(src, idx))
    out = np.full_like(got, np.nan)
    assert native.gather_frames(src, idx, out=out) is out
    np.testing.assert_array_equal(out, got)


def test_native_gather_other_dtypes_take_numpy(tiny_store):
    """A store that is not float32 or not C-contiguous goes through numpy
    fancy indexing, cast to float32, as the JAX gather's fallback does."""
    idx = np.array([4, 0, 4])
    for src in (np.asarray(tiny_store.frames, np.float64), tiny_store.frames[:, :, ::2]):
        got = native.gather_frames(src, idx)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jax_native.gather_frames(src, idx))


def test_native_gather_rejects_bad_positions_and_out(tiny_store):
    d = tiny_store.frames.shape[0]
    for bad in ([d], [-1], [0, d + 5]):
        with pytest.raises(IndexError):
            native.gather_frames(tiny_store.frames, np.asarray(bad))
    with pytest.raises(ValueError, match="out must be"):
        native.gather_frames(tiny_store.frames, np.array([0, 1]),
                             out=np.empty((3,) + tiny_store.frames.shape[1:], np.float32))


def test_native_gather_builds_from_the_ports_source():
    path = native.library_path()
    assert native.SOURCE.name == "gather.cpp"
    assert native.SOURCE.parent.name == "csrc"
    assert native.SOURCE.parent.parent.name == "multimodal_outage_tpu_torch"
    assert path.parent.name == "_build" and path.name.startswith("gather-")
    native.load_library()
    assert path.exists()


def test_broken_compiler_raises_with_its_output(tmp_path, monkeypatch):
    fake = tmp_path / "broken-cxx"
    fake.write_text("#!/bin/sh\necho 'gather.cpp:1: error: no such compiler' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(native, "_cxx", lambda: str(fake))
    with pytest.raises(RuntimeError, match="no such compiler"):
        native.build(tmp_path / "build")
    assert not any((tmp_path / "build").glob("*.so"))


# ---------------------------------------------------------------- gather_batch


def test_gather_batch_matches_jax(tiny_store_dir):
    store, jstore = load_store(tiny_store_dir), jax_load_store(tiny_store_dir)
    ds = _dataset(store, 5, 3)
    jds = JaxWindowDataset.from_case_study(jstore, HURRICANES, 5, 3)
    for idx in (np.array([0, 2, 3]), np.array([len(ds) - 1])):
        got, want = ds.gather_batch(idx), jds.gather_batch(idx)
        assert set(got) == set(want) == {"past", "future", "date_feats"}
        for k in got:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            np.testing.assert_array_equal(got[k], want[k])
        out = np.empty((len(idx) * 6,) + store.frames.shape[1:], np.float32)
        into = ds.gather_batch(idx, out=out)
        assert np.shares_memory(into["past"], out) and np.shares_memory(into["future"], out)
        for k in got:
            np.testing.assert_array_equal(into[k], want[k])


# ---------------------------------------------------------------- preprocess


def _host_batch(b=2, t=3, n=4, s=16, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "past": rng.gamma(2.0, 5.0, (b, t, n, s, s)).astype(np.float32),
        "future": rng.gamma(2.0, 5.0, (b, t, n, s, s)).astype(np.float32),
        "date_feats": rng.uniform(0, 30, (b, t, 6)).astype(np.float32),
    }


@pytest.mark.parametrize("s,size", [(16, 16), (16, 8), (12, 16), (20, 16)],
                         ids=["none", "down", "up", "down-odd"])
def test_preprocess_batch_matches_jax(s, size):
    host = _host_batch(s=s)
    want = jax_pipeline.preprocess_batch(jax.device_put(host), jnp.float32(MEAN),
                                         jnp.float32(STD), size)
    mean, std = torch.tensor(MEAN), torch.tensor(STD)
    got = preprocess_batch({k: torch.from_numpy(v) for k, v in host.items()}, mean, std, size)
    for k in ("x", "y", "date_feats"):
        assert got[k].dtype == torch.float32 and got[k].is_contiguous()
        assert tuple(got[k].shape) == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, rtol=0)
    x = got["x"]
    np.testing.assert_allclose(denormalize(x, MEAN, STD).numpy(),
                               np.asarray(jax_pipeline.denormalize(want["x"], MEAN, STD)),
                               atol=1e-4)


# ---------------------------------------------------------------- PrefetchIterator


def _expected(ds, idx_batches, image_size=H):
    mean, std = torch.tensor(MEAN), torch.tensor(STD)
    out = []
    for idx in idx_batches:
        host = ds.gather_batch(idx)
        out.append(preprocess_batch({k: torch.from_numpy(np.ascontiguousarray(v))
                                     for k, v in host.items()}, mean, std, image_size))
    return out


def test_prefetch_iterator_yields_all_batches_in_order(tiny_store):
    ds = _dataset(tiny_store)
    idx_batches = [np.array([0, 1, 2]), np.array([5, 3, 4]), np.array([7])]
    it = PrefetchIterator(ds, iter(idx_batches), MEAN, STD, H, "cpu", depth=2)
    got, err = _drain(it)
    assert err is None and len(got) == 3
    for g, w in zip(got, _expected(ds, idx_batches)):
        for k in ("x", "y", "date_feats"):
            assert torch.equal(g[k], w[k]), k
    it._thread.join(WAIT)
    assert not it._thread.is_alive()


def test_prefetch_iterator_batches_outlive_buffer_reuse(tiny_store):
    """More batches than buffers (depth + 1), all held: a batch handed out
    must not change when its host buffer is refilled."""
    ds = _dataset(tiny_store)
    idx_batches = [np.array([i, i + 1]) for i in range(8)]
    got, err = _drain(PrefetchIterator(ds, iter(idx_batches), MEAN, STD, H, "cpu", depth=1))
    assert err is None
    for g, w in zip(got, _expected(ds, idx_batches)):
        assert torch.equal(g["x"], w["x"]) and torch.equal(g["y"], w["y"])


def test_prefetch_iterator_propagates_errors(tiny_store):
    ds = _dataset(tiny_store)

    def gen():
        yield np.array([0, 1])
        raise RuntimeError("boom")

    it = PrefetchIterator(ds, gen(), MEAN, STD, H, "cpu")
    got, err = _drain(it)
    assert len(got) == 1 and isinstance(err, RuntimeError) and "boom" in str(err)
    it._thread.join(WAIT)
    assert not it._thread.is_alive()


def test_prefetch_iterator_abandoned_consumer_shuts_down(tiny_store):
    """A consumer that stops early must not leave the producer blocked on
    a full queue; close() is idempotent."""
    ds = _dataset(tiny_store)
    it = PrefetchIterator(ds, (np.array([i % 3]) for i in range(50)), MEAN, STD, H,
                          "cpu", depth=1)
    got, err = _drain(iter(it), limit=1)
    assert err is None and len(got) == 1
    it.close()
    it.close()
    it._thread.join(WAIT)
    assert not it._thread.is_alive()


def test_prefetch_iterator_rejects_depth_zero(tiny_store):
    with pytest.raises(ValueError, match="depth"):
        PrefetchIterator(_dataset(tiny_store), iter([]), MEAN, STD, H, "cpu", depth=0)


# ---------------------------------------------------------------- make_pipeline


def _jax_cfg(store_dir, pipeline="auto", budget=4096, device_dtype="bfloat16"):
    cfg = small_test_config(n_counties=4, image_size=H, horizon=T, batch_size=B)
    return cfg.replace(data=dataclasses.replace(
        cfg.data, data_dir=store_dir, dataset_range=12, horizon=T, pipeline=pipeline,
        device_store_budget_mb=budget, device_dtype=device_dtype))


def _port_cfg(store_dir, pipeline="auto", budget=4096, device_dtype="bfloat16", **train):
    model = ModelConfig(compute_dtype="float32", depth=2,
                        gwnet=GWNetConfig(blocks=1, layers=1))
    return Config(
        data=DataConfig(data_dir=store_dir, image_size=H, n_counties=4, horizon=T,
                        dataset_range=12, pipeline=pipeline, device_store_budget_mb=budget,
                        device_dtype=device_dtype),
        model=model,
        train=TrainConfig(**{"batch_size": B, "epochs": 1, **train}),
    )


@pytest.mark.parametrize("pipeline", ["auto", "device", "host"])
@pytest.mark.parametrize("budget", [0, 4096], ids=["store-past-budget", "store-fits"])
def test_make_pipeline_choice_matches_jax(pipeline, budget, tiny_store_dir):
    store = load_store(tiny_store_dir)
    assert 0 < store.frames.size * 4 / 1e6 < 4096
    jax_pipe = jax_loop.make_pipeline(_jax_cfg(tiny_store_dir, pipeline, budget),
                                      jax_load_store(tiny_store_dir))
    cfg = _port_cfg(tiny_store_dir, pipeline, budget)
    want = "host" if jax_pipe is None else "device"
    assert loop.pipeline_choice(cfg, store) == want
    pipe = loop.make_pipeline(cfg, store, torch.device("cpu"))
    assert (pipe is None) == (want == "host")
    if pipe is not None:
        assert isinstance(pipe, DevicePipeline)
        np.testing.assert_array_equal(pipe.frames.numpy(), np.asarray(store.frames))


def test_make_pipeline_rejects_unknown_value(tiny_store_dir):
    with pytest.raises(ValueError, match="pipeline"):
        loop.pipeline_choice(_port_cfg(tiny_store_dir, "hbm"), load_store(tiny_store_dir))


def test_device_store_uploads_in_chunks_bitwise(tiny_store):
    from multimodal_outage_tpu_torch.data.pipeline import upload_frames

    for chunk in (1, 3 * tiny_store.frames[0].nbytes, 1 << 30):
        got = upload_frames(tiny_store.frames, torch.device("cpu"), chunk_bytes=chunk)
        np.testing.assert_array_equal(got.numpy(), np.asarray(tiny_store.frames))


# ---------------------------------------------------------------- the two paths


def test_host_path_batches_match_jax_host_path(tiny_store_dir):
    """bf16 compute: the host path keeps x in float32, with float32
    mean/std, as JAX's does; the device path casts x to bfloat16."""
    store = load_store(tiny_store_dir)
    ds = _dataset(store)
    idx = np.arange(len(ds))
    cfg = _port_cfg(tiny_store_dir, "host")
    jcfg = _jax_cfg(tiny_store_dir, "host")
    jds = JaxWindowDataset.from_case_study(jax_load_store(tiny_store_dir), HURRICANES, 12, T)
    want, _ = _drain(jax_loop._epoch_iter(jds, idx, jcfg, False, 0, device_pipe=None))
    got, err = _drain(loop._epoch_iter(ds, idx, cfg, False, 0, None, torch.device("cpu")))
    assert err is None and len(got) == len(want) == -(-len(ds) // B)
    for g, w in zip(got, want):
        assert g["x"].dtype == torch.float32 and w["x"].dtype == jnp.float32
        for k in ("x", "y", "date_feats"):
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]), atol=1e-5, rtol=0)
    dev = loop._epoch_iter(ds, idx, cfg, False, 0, loop.make_pipeline(
        _port_cfg(tiny_store_dir, "device"), store, torch.device("cpu")), torch.device("cpu"))
    first = next(dev)
    dev.close()
    assert first["x"].dtype == torch.bfloat16 and first["y"].dtype == torch.float32


def test_float32_fit_host_path_equals_device_path(tiny_store_dir, tmp_path):
    out = {}
    for path in ("host", "device"):
        cfg = _port_cfg(tiny_store_dir, path, device_dtype="float32", epochs=2,
                        checkpoint_dir=str(tmp_path / path), job_id="run")
        out[path] = loop.fit(cfg, "michael", progress=False, device="cpu")
    assert out["host"] == out["device"]
    trees = [CheckpointManager(str(tmp_path / p / "run" / "checkpoints")).restore()
             for p in ("host", "device")]
    for k, v in weights.flatten(trees[0]["params"]).items():
        assert torch.equal(v, weights.flatten(trees[1]["params"])[k]), k


def test_host_path_accum_remat_and_resume_equal_the_device_path(tiny_store_dir, tmp_path):
    """float32, --grad_accum 2 with remat: one epoch, then resumed to two,
    through each path; the two runs end bitwise equal."""
    out = {}
    for path in ("host", "device"):
        cfg = _port_cfg(tiny_store_dir, path, device_dtype="float32", grad_accum=2,
                        checkpoint_dir=str(tmp_path / path), job_id="r")
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, remat=True))
        loop.fit(cfg, "michael", progress=False, device="cpu")
        resumed = cfg.replace(train=dataclasses.replace(cfg.train, epochs=2, resume=True))
        out[path] = loop.fit(resumed, "michael", progress=False, device="cpu")
    n_train = len(loop.prepare_datasets(cfg, "michael")[1])
    assert out["host"]["train_steps"] == 2 * -(-n_train // B)
    assert out["host"] == out["device"]


# ---------------------------------------------------------------- the hooks


class _Spy:
    """A dict→dict transform that counts its calls (optionally zeroing x)."""

    def __init__(self, zero=False):
        self.calls, self.zero = 0, zero

    def __call__(self, batch):
        self.calls += 1
        return {**batch, "x": batch["x"] * 0} if self.zero else batch


def _jax_double(win):
    return 2.0 * jax_pipeline.default_frame_transform(win, jnp.float32(MEAN),
                                                      jnp.float32(STD), H)


class _DoubleFrames:
    """A frame transform that replaces the default with 2 × the default
    (float32 mean/std) and counts its calls."""

    def __init__(self):
        self.calls = 0

    def __call__(self, win):
        self.calls += 1
        return 2.0 * default_frame_transform(win, torch.tensor(MEAN), torch.tensor(STD), H)


@pytest.fixture(scope="module")
def jax_hook_counts(tiny_store_dir, tmp_path_factory):
    """The JAX package's fit, predict and serve_eval with a counting
    transform: ({stream: batches}, {path: predict's targets through that
    input path}, the targets of predict with a ×2 frame transform)."""
    work = tmp_path_factory.mktemp("jax_hooks")
    cfg = _jax_cfg(tiny_store_dir)
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, depth=2, gwnet=dataclasses.replace(
            cfg.model.gwnet, blocks=1, layers=1)),
        train=dataclasses.replace(cfg.train, checkpoint_dir=str(work), job_id="j"))
    counts = {}
    spy = _Spy()
    jax_loop.fit(cfg, "michael", progress=False, transform=spy)
    counts["fit"] = spy.calls
    ckpt = str(work / "j" / "checkpoints")
    spy = _Spy()
    _, device_targets, _ = jax_loop.predict(cfg, ckpt, "michael", transform=spy)
    counts["predict"] = spy.calls
    host = cfg.replace(data=dataclasses.replace(cfg.data, pipeline="host"))
    _, host_targets, _ = jax_loop.predict(host, ckpt, "michael")
    targets = {"device": np.asarray(device_targets), "host": np.asarray(host_targets)}
    _, doubled, _ = jax_loop.predict(cfg, ckpt, "michael", frame_transform=_jax_double)
    spy = _Spy()
    jax_loop.serve_eval(cfg, ckpt, "michael", transform=spy)
    counts["serve_eval"] = spy.calls
    return counts, targets, np.asarray(doubled)


@pytest.mark.parametrize("path", ["host", "device"])
def test_hooks_reach_every_stream_as_in_jax(path, jax_hook_counts, tiny_store_dir, tmp_path):
    counts, jax_targets, jax_doubled = jax_hook_counts
    assert min(counts.values()) > 0
    cfg = _port_cfg(tiny_store_dir, path, checkpoint_dir=str(tmp_path), job_id="p")
    spy, frames = _Spy(), _DoubleFrames()
    res = loop.fit(cfg, "michael", progress=False, device="cpu", transform=spy,
                   frame_transform=frames)
    assert np.isfinite(res["val_loss"])
    assert spy.calls == counts["fit"]
    assert frames.calls == 2 * counts["fit"]  # x and y of each batch
    ckpt = str(tmp_path / "p" / "checkpoints")

    spy = _Spy()
    p_plain, t_plain, m_plain = loop.predict(cfg, ckpt, "michael", device="cpu", transform=spy)
    assert spy.calls == counts["predict"]
    # the device path normalizes with bf16-rounded mean/std, the host path
    # with float32 ones, in both packages
    np.testing.assert_allclose(t_plain, jax_targets[path], atol=5e-5, rtol=1e-4)
    p_zero, t_zero, m_zero = loop.predict(cfg, ckpt, "michael", device="cpu",
                                          transform=_Spy(zero=True))
    assert not np.allclose(p_zero, p_plain)
    np.testing.assert_array_equal(t_zero, t_plain)
    assert m_zero["loss"] != m_plain["loss"]
    frames = _DoubleFrames()
    _, t_double, _ = loop.predict(cfg, ckpt, "michael", device="cpu", frame_transform=frames)
    assert frames.calls == 2 * counts["predict"]
    if path == "host":  # float32 mean/std, as the frame transform's
        np.testing.assert_allclose(t_double, 2.0 * t_plain, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t_double, jax_doubled, atol=5e-5, rtol=1e-4)

    store = load_store(tiny_store_dir)
    engine = ServingModel(cfg.model, restore_variables(ckpt),
                          config_supports(cfg, store), horizon=T, device="cpu")
    spy, frames = _Spy(), _DoubleFrames()
    serve_eval(cfg.data, engine, store, "michael", B, transform=spy, frame_transform=frames)
    assert spy.calls == counts["serve_eval"]
    assert frames.calls == 2 * counts["serve_eval"]


def test_frame_transform_gives_the_same_batches_on_both_paths(tiny_store_dir):
    """float32: a frame transform (the default, then ×2) gives the same
    batches through the host path and the device path."""
    store = load_store(tiny_store_dir)
    ds = _dataset(store)
    idx = np.arange(len(ds))
    cpu = torch.device("cpu")
    mean, std = torch.tensor(MEAN), torch.tensor(STD)
    default = lambda w: default_frame_transform(w, mean, std, H)  # noqa: E731
    for tf in (default, _DoubleFrames()):
        streams = {}
        for path in ("host", "device"):
            cfg = _port_cfg(tiny_store_dir, path, device_dtype="float32")
            pipe = loop.make_pipeline(cfg, store, cpu, tf)
            streams[path], err = _drain(loop._epoch_iter(ds, idx, cfg, False, 0, pipe, cpu,
                                                          frame_transform=tf))
            assert err is None
        for h, d in zip(streams["host"], streams["device"]):
            for k in ("x", "y", "date_feats"):
                assert torch.equal(h[k], d[k]), k
    plain, _ = _drain(loop._epoch_iter(ds, idx, _port_cfg(tiny_store_dir, "host"), False, 0,
                                       None, cpu))
    for p, d in zip(plain, streams["host"]):
        torch.testing.assert_close(d["x"], 2.0 * p["x"], rtol=1e-6, atol=1e-6)
