"""The program's own spans (multimodal_outage_tpu_torch/core/tracing.py),
read for the per-layer metrics of source "program_span": the one module
of the benchmark that reads the tracer. Spans record only while a
profiler records, so in a --trace 1 run they are the traced segment's;
those that overlap the segment's profiler events are kept (a process that
traced before keeps older spans in the buffer).

Spans and the profiler's events share one clock (time.time_ns(), the
Unix epoch the raw events are stamped on), so the arithmetic here sets
them side by side: device-idle time inside spans, runtime calls started
inside spans, and a span's time per call of its root. Every function
returns None where there is nothing to read: a program without the
tracer (an older commit), no span of the name, or no device activity.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import List, Optional, Sequence, Tuple

from outage_bench.readers import note
from outage_bench.trace import Interval, gaps

# the runtime calls that put work on the device: kernel launches, copies, sets
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync")


def program_spans(trace=None) -> Optional[list]:
    """The tracer's spans, those of the traced segment where `trace` is
    given; None where the program has no tracer."""
    try:
        from multimodal_outage_tpu_torch.core import tracing
    except ImportError:
        note("the program has no tracer (core/tracing.py)")
        return None
    out = tracing.spans()
    if trace is not None:
        events = trace.device + trace.host
        if not events:
            return []
        lo = min(s for _, s, _ in events)
        hi = max(e for _, _, e in events)
        out = [s for s in out if s.end_ns / 1e9 >= lo and s.start_ns / 1e9 <= hi]
    return out


def named(spans, name: str) -> list:
    out = [s for s in spans or () if s.name == name]
    if not out:
        note(f"no span named {name!r} in the traced segment")
    return out


def intervals(spans) -> List[Interval]:
    """The spans as (start, end) seconds on the profiler's clock."""
    return [(s.start_ns / 1e9, s.end_ns / 1e9) for s in spans]


def idle_inside(device: Sequence[Interval], within: Sequence[Interval]) -> float:
    """Seconds inside the union of `within` in which no device interval
    runs (overlaps count once on both sides)."""
    spans = _merged(within)
    if not spans:
        return 0.0
    idle = gaps(device, spans[0][0], spans[-1][1])
    total, j = 0.0, 0
    for lo, hi in spans:  # both lists sorted and disjoint: one sweep
        while j < len(idle) and idle[j][1] <= lo:
            j += 1
        k = j
        while k < len(idle) and idle[k][0] < hi:
            total += min(hi, idle[k][1]) - max(lo, idle[k][0])
            k += 1
    return total


def starts_inside(times: Sequence[float], within: Sequence[Interval]) -> int:
    """How many of `times` lie inside some interval of `within`."""
    spans = _merged(within)
    starts = [s for s, _ in spans]
    n = 0
    for t in times:
        i = bisect.bisect_right(starts, t) - 1
        n += i >= 0 and t <= spans[i][1]
    return n


def per_root(spans, name: str, field: str) -> Optional[float]:
    """The sum of `field` ("host_ms" or "device_ms") over the spans named
    `name` of each root, averaged over the roots that have one: ms per
    forward, per batch or per step. None where a span has no reading."""
    by_root = defaultdict(float)
    for s in named(spans, name):
        v = getattr(s, field)
        if v is None:
            note(f"span {name!r} has no {field}")
            return None
        by_root[s.root] += v
    return sum(by_root.values()) / len(by_root) if by_root else None


def _merged(within: Sequence[Interval]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(within):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


# the readers the metric files call


def host_ms(ctx, name: str) -> Optional[float]:
    """Mean host ms of the span `name` per call of its root."""
    if ctx.trace is None:
        return None
    return per_root(program_spans(ctx.trace), name, "host_ms")


def device_ms(ctx, name: str) -> Optional[float]:
    """Mean device ms (the span's CUDA events) of `name` per call of its
    root; None off the card."""
    if ctx.trace is None or not ctx.trace.device:
        return None
    return per_root(program_spans(ctx.trace), name, "device_ms")


def idle_in(ctx, name: str) -> Optional[float]:
    """% of the traced window in which the device idled inside spans named
    `name`."""
    if ctx.trace is None or not ctx.trace.device:
        return None
    within = named(program_spans(ctx.trace), name)
    if not within:
        return None
    dev = [(s, e) for _, s, e in ctx.trace.device]
    return 100.0 * idle_inside(dev, intervals(within)) / ctx.trace.window_s


def launches_per(ctx, name: str) -> Optional[float]:
    """Runtime calls that put work on the device (LAUNCHES) started inside
    the spans named `name`, per span."""
    if ctx.trace is None or not ctx.trace.device:
        return None
    within = named(program_spans(ctx.trace), name)
    if not within:
        return None
    times = [s for n, s, _ in ctx.trace.host if n.startswith(LAUNCHES)]
    return starts_inside(times, intervals(within)) / len(within)
