"""The port's spans (core/tracing.py) on the CPU: nothing is recorded
without a torch profiler; under one, the serving engine, the device
pipeline and the train step (one-shot and accumulating) record their
spans, each child inside its parent and sharing its root's id; outputs
are bitwise the same either way; spans share the profiler's clock; the
buffer is bounded; and an unrecorded span costs under half a microsecond.
Imports nothing of JAX."""

import datetime
import json
import timeit

import numpy as np
import pytest
import torch

from multimodal_outage_tpu_torch import weights
from multimodal_outage_tpu_torch.core import tracing
from multimodal_outage_tpu_torch.core.config import ModelConfig
from multimodal_outage_tpu_torch.data.dataset import WindowDataset
from multimodal_outage_tpu_torch.data.pipeline import DevicePipeline
from multimodal_outage_tpu_torch.data.store import NTLStore
from multimodal_outage_tpu_torch.models.fusion import build_model
from multimodal_outage_tpu_torch.serving import ServingModel
from multimodal_outage_tpu_torch.train.loop import merge_spans
from multimodal_outage_tpu_torch.train.state import create_train_state
from multimodal_outage_tpu_torch.train.steps import make_accum_train_step

N, T, H, B = 4, 2, 16, 2
CFG = ModelConfig(compute_dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's small torch ops: with the
    suite's workers sharing the cores, OpenMP's barriers otherwise stall
    each op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _empty_buffer():
    tracing.clear()
    yield
    tracing.clear()


def _profiled(fn):
    """fn() under a CPU-only torch profiler → (its result, the profiler)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, N, T, H, H, 1)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((B, N, T, H, H, 1)).astype(np.float32))
    feats = torch.from_numpy(np.tile(np.array([0, 0, 0, 2022, 9, 26], np.float32), (B, T, 1)))
    return {"x": x, "y": y, "date_feats": feats}


def _serve():
    engine = ServingModel(CFG, weights.init_variables(CFG, T, N, seed=0, image_size=H),
                          torch.eye(N)[None], horizon=T, device="cpu")
    batch = _inputs()
    return lambda: engine(batch["x"], batch["date_feats"])


def _pipeline():
    day0 = datetime.date(2022, 9, 16)
    days = [day0 + datetime.timedelta(days=d) for d in range(20)]
    dates = np.asarray([(d.year, d.month, d.day) for d in days], np.int32)
    frames = np.random.default_rng(1).uniform(0, 40, (20, N, H, H)).astype(np.float32)
    store = NTLStore(frames=frames, dates=dates, county_names=[f"c{i}" for i in range(N)],
                     meta={})
    ds = WindowDataset.from_case_study(store, {"ian": datetime.date(2022, 9, 26)}, 8, T)
    pipe = DevicePipeline(store, 3.0, 10.0, H, torch.float32, torch.device("cpu"))
    return lambda: pipe.batch(ds, np.array([0, 3]))


def _train(accum):
    def make():
        model = build_model(CFG, T, N, H)
        weights.load_variables(model, weights.init_variables(CFG, T, N, seed=0, image_size=H))
        return model, create_train_state(model), make_accum_train_step(model, accum)

    model, state, step = make()
    batch = _inputs(2)
    sup = torch.eye(N)[None]

    def run():
        step(state, batch, sup, 1e-3, 5)
        return {k: v.detach().clone() for k, v in model.state_dict().items()}

    return run, make


CALLERS = {
    "serve": (_serve, "engine.forward",
              ["engine.contraction", "engine.st_gnn", "engine.expansion"]),
    "pipeline": (_pipeline, "pipeline.batch", ["pipeline.upload"]),
    "train": (lambda: _train(1)[0], "train.step",
              ["train.forward", "train.backward", "train.optimizer"]),
    "train_accum2": (lambda: _train(2)[0], "train.step",
                     ["train.forward", "train.backward"] * 2 + ["train.optimizer"]),
}


@pytest.mark.parametrize("caller", sorted(CALLERS))
def test_nothing_recorded_without_a_profiler(caller):
    CALLERS[caller][0]()()
    assert tracing.spans() == []


@pytest.mark.parametrize("caller", sorted(CALLERS))
def test_spans_under_the_profiler(caller):
    make, root_name, children = CALLERS[caller]
    run = make()
    for _ in range(2):
        _profiled(run)
    got = sorted(tracing.spans(), key=lambda s: s.start_ns)
    roots = [s for s in got if s.parent is None]
    assert [s.name for s in roots] == [root_name] * 2
    for root in roots:
        assert root.root == root.id
        kids = [s for s in got if s.root == root.id and s is not root]
        assert [s.name for s in kids] == children
        for s in kids:
            assert s.parent == root.id
            assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
            assert s.device_ms is None  # off the card
    assert len(got) == 2 * (1 + len(children))
    assert len({s.id for s in got}) == len(got)


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    else:
        assert torch.equal(a, b)


@pytest.mark.parametrize("caller", ["serve", "pipeline", "train"])
def test_outputs_bitwise_the_same_under_the_profiler(caller):
    if caller == "train":
        run, make = _train(1)
        batch, sup = _inputs(2), torch.eye(N)[None]
        outs = []
        for traced in (False, True):
            model, state, step = make()
            go = lambda: (step(state, batch, sup, 1e-3, 5), model.state_dict())
            outs.append(_profiled(go)[0] if traced else go())
        _same(outs[0][0], outs[1][0])
        _same(outs[0][1], outs[1][1])
        return
    run = CALLERS[caller][0]()
    _same(run(), _profiled(run)[0])


def test_spans_share_the_profilers_clock():
    """A span around record_function("probe") holds the profiler's probe
    event on the shared clock, within 50 µs at each end."""

    def probe(i):
        with tracing.span(f"around{i}"):
            with torch.profiler.record_function(f"probe{i}"):
                torch.ones(3).add_(1)

    def run():
        for i in range(4):  # the first record_function pays its own set-up
            probe(i)

    _, prof = _profiled(run)
    ours = {s.name[len("around"):]: s for s in tracing.spans()}
    theirs = {e.name()[len("probe"):]: e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("probe")}
    assert set(theirs) == set(ours) == {"0", "1", "2", "3"}
    s, e = ours["3"], theirs["3"]
    assert 0 <= e.start_ns() - s.start_ns <= 50_000
    assert 0 <= s.end_ns - (e.start_ns() + e.duration_ns()) <= 50_000


def test_buffer_drops_its_oldest_records_and_counts_them():
    tr = tracing.Tracer(capacity=3)

    def run():
        for i in range(5):
            with tr.span(f"s{i}"):
                pass

    _profiled(run)
    assert [s.name for s in tr.spans()] == ["s2", "s3", "s4"]
    assert tr.dropped == 2
    tr.clear()
    assert tr.spans() == [] and tr.dropped == 0


def test_an_unrecorded_span_costs_under_half_a_microsecond():
    """span() with no profiler: one flag check and a shared no-op object.
    (The `with` statement around it costs what any `with` costs: entering
    and leaving the no-op object runs no Python frame.)"""
    n = 20_000
    per_call = min(timeit.repeat(lambda: tracing.span("engine.st_gnn", device=True),
                                 number=n, repeat=30)) / n
    assert per_call <= 0.5e-6, f"{per_call * 1e9:.0f} ns a call"
    assert tracing.span("a") is tracing.span("b", device=True)
    with tracing.span("engine.st_gnn", device=True):
        pass
    assert tracing.spans() == []


def test_merge_spans_puts_them_on_the_files_time_base(tmp_path):
    """Spans merged into a profiler's Chrome trace sit on their own track,
    at the trace's time base: the probe event and its span line up."""

    def run():
        for i in range(3):  # the first record_function pays its own set-up
            with tracing.span(f"around{i}"):
                with torch.profiler.record_function(f"probe{i}"):
                    torch.ones(3).add_(1)

    _, prof = _profiled(run)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    merge_spans(path, tracing.spans())
    events = json.load(open(path))["traceEvents"]
    (probe,) = [e for e in events if e.get("name") == "probe2"]
    ours = [e for e in events if e.get("cat") == "program_span"]
    assert [e["name"] for e in ours] == ["around0", "around1", "around2"]
    ours = ours[-1]
    assert ours["pid"] == "program spans"
    assert 0 <= probe["ts"] - ours["ts"] <= 50
    assert ours["ts"] + ours["dur"] >= probe["ts"] + probe["dur"]
