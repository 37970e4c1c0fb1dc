"""The readers of the program's spans (outage_bench/spans.py) on the CPU:
the interval arithmetic on synthetic device intervals, runtime calls and
spans; every span metric left out (None) where nothing was recorded or
the program has no tracer; and a tiny traced run that reads the engine's
host split.

    python -m pytest outage_bench/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest

from multimodal_outage_tpu_torch.core import tracing
from outage_bench import spans, spec
from outage_bench.run import run_cell
from outage_bench.tests.tiny import tiny_cell
from outage_bench.trace import Trace

SEED = 2**31 + 977
NEW = ["engine_host_ms.contraction", "engine_host_ms.st_gnn", "engine_host_ms.expansion",
       "idle_in_engine.forecast", "idle_in_pipeline.forecast", "launches_per_forward.forecast",
       "engine_device_ms.contraction.sweep", "engine_device_ms.expansion.sweep",
       "pipeline_wait_ms.sweep", "train_device_ms.forward", "train_device_ms.backward",
       "train_device_ms.optimizer", "pipeline_wait_ms.train"]


def _span(i, name, s, e, root=None, device_ms=None):
    """A span of [s, e) seconds."""
    return tracing.Span(i, None if root is None else root, root or i, name,
                        int(s * 1e9), int(e * 1e9), device_ms)


# two forwards on [1, 3) and [5, 8); the device runs [0, 1.5), [2, 6) and
# [2.5, 2.8) (inside the second); idle in forwards: [1.5, 2) and [6, 8)
DEV = [("k", 0.0, 1.5), ("k", 2.0, 6.0), ("k", 2.5, 2.8)]
HOST = [("cudaLaunchKernel", 1.1, 1.2), ("cudaLaunchKernelExC", 2.0, 2.1),
        ("cuLaunchKernel", 4.0, 4.1), ("cudaMemcpyAsync", 5.5, 5.6),
        ("cudaMemsetAsync", 7.0, 7.1), ("cudaStreamSynchronize", 7.2, 7.9),
        ("cudaLaunchKernel", 9.0, 9.1)]
SPANS = [_span(1, "engine.forward", 1.0, 3.0), _span(2, "engine.st_gnn", 1.2, 1.4, 1, 0.5),
         _span(3, "engine.forward", 5.0, 8.0), _span(4, "engine.st_gnn", 5.5, 6.5, 3, 1.5),
         _span(5, "pipeline.batch", 3.5, 4.5)]


def _ctx(monkeypatch, recorded=SPANS, dev=DEV):
    monkeypatch.setattr(tracing, "spans", lambda: list(recorded))
    return SimpleNamespace(trace=Trace(window_s=10.0, device=list(dev), host=list(HOST)))


def test_idle_inside_spans():
    dev = [(s, e) for _, s, e in DEV]
    fwd = spans.intervals([s for s in SPANS if s.name == "engine.forward"])
    assert spans.idle_inside(dev, fwd) == pytest.approx(0.5 + 2.0)
    # overlapping spans count once; a span no device interval touches is all idle
    assert spans.idle_inside(dev, [(6.0, 7.0), (6.5, 7.5), (9.0, 9.5)]) == pytest.approx(2.0)
    assert spans.idle_inside(dev, []) == 0.0


def test_launches_per_span():
    fwd = spans.intervals([s for s in SPANS if s.name == "engine.forward"])
    times = [s for n, s, _ in HOST if n.startswith(spans.LAUNCHES)]
    # 1.1, 2.0 in the first forward; 5.5, 7.0 in the second; 4.0, 9.0 outside;
    # the synchronise is no launch
    assert spans.starts_inside(times, fwd) == 4


def test_ms_per_root():
    assert spans.per_root(SPANS, "engine.st_gnn", "device_ms") == pytest.approx(1.0)
    assert spans.per_root(SPANS, "engine.st_gnn", "host_ms") == pytest.approx(600.0)
    # an accumulating step: two forward spans under one root are summed
    acc = [_span(1, "train.step", 0, 4), _span(2, "train.forward", 0, 1, 1, 10.0),
           _span(3, "train.forward", 1, 2, 1, 12.0), _span(4, "train.step", 4, 6),
           _span(5, "train.forward", 4, 5, 4, 20.0)]
    assert spans.per_root(acc, "train.forward", "device_ms") == pytest.approx(21.0)
    assert spans.per_root(SPANS, "engine.contraction", "host_ms") is None
    assert spans.per_root([_span(1, "train.forward", 0, 1)], "train.forward", "device_ms") is None


def test_readers_on_synthetic_spans(monkeypatch):
    ctx = _ctx(monkeypatch)
    read = lambda m: spec.reader(m)(ctx)
    assert read("idle_in_engine.forecast") == pytest.approx(100.0 * 2.5 / 10.0)
    assert read("idle_in_pipeline.forecast") == pytest.approx(0.0)
    assert read("launches_per_forward.forecast") == pytest.approx(2.0)
    assert spans.device_ms(ctx, "engine.st_gnn") == pytest.approx(1.0)
    # spans from before the traced segment (a process that traced earlier) are left out
    old = [_span(9, "engine.forward", -50.0, -49.0)]
    ctx = _ctx(monkeypatch, SPANS + old)
    assert read("launches_per_forward.forecast") == pytest.approx(2.0)


@pytest.mark.parametrize("metric", NEW)
def test_a_metric_without_spans_is_left_out(metric, monkeypatch):
    assert metric in {m["name"] for m in spec.load_cell(_cell_of(metric)).per_layer}
    assert spec.reader(metric)(_ctx(monkeypatch, recorded=[])) is None
    # a program without the tracer (an older commit): left out, no error
    import multimodal_outage_tpu_torch.core as core

    monkeypatch.delattr(core, "tracing")
    monkeypatch.setitem(sys.modules, "multimodal_outage_tpu_torch.core.tracing", None)
    assert spec.reader(metric)(_ctx(monkeypatch)) is None


def _cell_of(metric: str) -> str:
    if metric.startswith(("train_", "pipeline_wait_ms.train")):
        return "gwnet.train_b16"
    if metric.endswith(".sweep"):
        return "dcrnn.sweep_b16"
    return "gwnet.forecast_b1"


def test_a_tiny_traced_run_reads_the_engines_host_split():
    tracing.clear()
    r = run_cell(tiny_cell("gwnet.forecast_b1"), SEED, 0.3, True, device="cpu")
    got = {k: v["value"] for k, v in r["metrics"].items()}
    split = ["engine_host_ms.contraction", "engine_host_ms.st_gnn", "engine_host_ms.expansion"]
    assert all(got[k] > 0 for k in split)
    # the root holds its stages: their sum is under its own host ms
    forward = spans.per_root(spans.program_spans(), "engine.forward", "host_ms")
    assert sum(got[k] for k in split) < forward
    # off the card the device readers find nothing
    assert "idle_in_engine.forecast" not in got and "launches_per_forward.forecast" not in got
