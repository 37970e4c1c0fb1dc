"""The port's spans (core/tracing.py) on the card, at full width (67
counties x 7 days x 128² frames, bf16, random weights): they record under
a CUDA-only profiler, their CUDA events add up to the forward's device
time, they line up with the kernels they launch on the profiler's clock,
and they add no host-device synchronisation.

Imports nothing of JAX, so it runs on a machine with the card and no JAX:

    python -m pytest tests/test_torch_port_tracing_cuda.py -m cuda --noconftest -q

Tests marked `cuda` skip where torch.cuda.is_available() is False."""

import pytest
import torch

from multimodal_outage_tpu_torch.core import tracing
from multimodal_outage_tpu_torch.core.config import ModelConfig
from multimodal_outage_tpu_torch.data.adjacency import model_supports
from multimodal_outage_tpu_torch.ops import double_conv as dcm
from multimodal_outage_tpu_torch.serving import ServingModel
from multimodal_outage_tpu_torch.weights import init_variables

STAGES = ("engine.contraction", "engine.st_gnn", "engine.expansion")
SYNCS = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize")


@pytest.fixture(scope="module")
def engines():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (README: the port's tests on the H100)")
    out = {}
    for st in ("gwnet", "dcrnn"):
        cfg = ModelConfig(st_gnn=st)
        out[st] = ServingModel(cfg, init_variables(cfg, 7, 67, seed=0), model_supports(cfg, 67))
    return out


def _request(b):
    gen = torch.Generator(device="cuda").manual_seed(b)
    x = torch.randn(b, 67, 7, 128, 128, 1, generator=gen, device="cuda").to(torch.bfloat16)
    feats = torch.tensor([0, 0, 0, 2018, 10, 1], dtype=torch.float32, device="cuda").repeat(b, 7, 1)
    return x, feats


def _traced(fn):
    """fn() under a CUDA-only profiler, as the benchmark traces → (its
    result, the raw profiler events, the spans)."""
    tracing.clear()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    spans = tracing.spans()
    tracing.clear()
    return out, events, spans


def _launches(events):
    """{correlation id: (runtime call name, its start ns)} and the device
    kernels as (name, start ns, end ns, correlation id)."""
    dev = torch.autograd.DeviceType.CUDA
    calls = {e.correlation_id(): (e.name(), e.start_ns()) for e in events
             if e.device_type() != dev}
    kernels = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.correlation_id())
               for e in events if e.device_type() == dev]
    return calls, kernels


def _inside(t, span):
    return span.start_ns <= t <= span.end_ns


@pytest.mark.cuda
@pytest.mark.parametrize("st", ["gwnet", "dcrnn"])
def test_spans_record_under_a_cuda_only_profiler(engines, st):
    x, feats = _request(1)
    engines[st](x, feats)
    tracing.clear()
    on = []
    _, _, spans = _traced(lambda: on.append(torch._C._autograd._profiler_enabled())
                          or engines[st](x, feats))
    assert on == [True]
    assert sorted(s.name for s in spans) == sorted(("engine.forward",) + STAGES)
    for s in spans:
        assert (s.device_ms is not None) == (s.name in STAGES)
    engines[st](x, feats)
    assert tracing.spans() == []  # profiler off: nothing recorded


@pytest.mark.cuda
@pytest.mark.parametrize("st", ["gwnet", "dcrnn"])
def test_stage_device_ms_add_up_to_the_forward(engines, st):
    """At B=16 (device-bound) the three stages' CUDA-event ms sum to within
    5% of an event pair around the whole forward, less the root's self
    time: the device time of the kernels it launched outside its stages."""
    x, feats = _request(16)
    engine = engines[st]
    engine(x, feats)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def forward():
        ev[0].record()
        engine(x, feats)
        ev[1].record()

    _, events, spans = _traced(forward)
    whole = ev[0].elapsed_time(ev[1])
    (root,) = [s for s in spans if s.name == "engine.forward"]
    stages = [s for s in spans if s.name in STAGES]
    calls, kernels = _launches(events)
    self_ms = 0.0
    for _, ks, ke, cid in kernels:
        t = calls.get(cid, (None, None))[1]
        if t is not None and _inside(t, root) and not any(_inside(t, s) for s in stages):
            self_ms += (ke - ks) / 1e6
    staged = sum(s.device_ms for s in stages)
    assert 0 < self_ms < 0.25 * whole
    assert abs(staged - (whole - self_ms)) <= 0.05 * (whole - self_ms), (staged, whole, self_ms)


@pytest.mark.cuda
@pytest.mark.parametrize("st", ["gwnet", "dcrnn"])
def test_double_conv_launches_lie_inside_their_stages(engines, st):
    """Spans and kernel launches share one clock: each of a B=1 forward's
    9 DoubleConv kernels was launched inside engine.contraction (5) or
    engine.expansion (4). Two forwards are traced and the second is read:
    the profiler may miss the first kernel after it starts."""
    x, feats = _request(1)
    engines[st](x, feats)
    before = dcm.fused_double_conv.launches
    _, events, spans = _traced(lambda: [engines[st](x, feats) for _ in range(2)])
    assert dcm.fused_double_conv.launches - before == 18
    calls, kernels = _launches(events)
    root = max((s for s in spans if s.name == "engine.forward"), key=lambda s: s.start_ns)
    stages = {s.name: s for s in spans if s.root == root.id and s is not root}
    where = {"engine.contraction": 0, "engine.expansion": 0}
    dc = [calls[cid][1] for name, _, _, cid in kernels if "double_conv_kernel" in name]
    for t in dc:
        if _inside(t, root):
            (stage,) = [n for n in where if _inside(t, stages[n])]
            where[stage] += 1
    assert where == {"engine.contraction": 5, "engine.expansion": 4}, (len(dc), where)


@pytest.mark.cuda
@pytest.mark.parametrize("st", ["gwnet", "dcrnn"])
def test_spans_add_no_synchronisation(engines, st, monkeypatch):
    """A traced forward makes as many synchronising runtime calls with
    spans as with every span off."""
    x, feats = _request(1)
    engines[st](x, feats)

    def syncs():
        _, events, _ = _traced(lambda: engines[st](x, feats))
        return sorted(e.name() for e in events if e.name().startswith(SYNCS))

    with_spans = syncs()
    monkeypatch.setattr(tracing, "span", lambda name, device=False: tracing._OFF)
    assert syncs() == with_spans
