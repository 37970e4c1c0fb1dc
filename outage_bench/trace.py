"""The traced segment of a --trace 1 run, read from torch.profiler.

Device busy time is the union of the intervals in which any kernel, copy
or set ran on the device, so overlapping operations count once; the idle
share is 1 - busy / the traced window. Idle gaps are named by the host
operation that was running when the gap opened.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence, Tuple

Interval = Tuple[float, float]


def union_length(intervals: Sequence[Interval]) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    """The stretches of [lo, hi) that no interval covers."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [g for g in out if g[1] > g[0]]


@dataclass
class Trace:
    """Device and host events of the traced window, times in seconds."""

    window_s: float
    device: List[Tuple[str, float, float]]  # (name, start, end)
    host: List[Tuple[str, float, float]]

    @property
    def busy_s(self) -> float:
        return union_length([(s, e) for _, s, e in self.device])

    def kernel_s(self, patterns: Sequence[str]) -> Tuple[float, int]:
        """(device seconds, launches) of the kernels whose name holds any of
        `patterns`."""
        hits = [e - s for name, s, e in self.device if any(p in name for p in patterns)]
        return sum(hits), len(hits)

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        by_op: Dict[str, float] = defaultdict(float)
        for name, s, e in self.device:
            by_op[name[:120]] += e - s
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        if not self.device:
            return {"device_ops": [list(o) for o in ops], "idle_gaps": []}
        lo = min(s for _, s, _ in self.device)
        hi = max(e for _, _, e in self.device)
        by_host: Dict[str, float] = defaultdict(float)
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        for gs, ge in gaps([(s, e) for _, s, e in self.device], lo, hi):
            # the host call open when the gap opened, else the last one ended
            i = bisect.bisect_right(starts, gs) - 1
            name = "no host call"
            if i >= 0:
                hn, _, he = host[i]
                name = hn if he >= gs else f"after {hn}"
            by_host[name[:120]] += ge - gs
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [list(o) for o in ops], "idle_gaps": [list(g) for g in idle]}


def record(run: Callable[[], object], device) -> Trace:
    """Profile run() (which ends with the device synchronised) and return
    its events. On the card only
    the CUDA activity is traced: the kernels, copies and sets, and on the
    host the CUDA runtime calls, which name the idle gaps; tracing every
    host operator as well would add its own cost to the gaps it measures.
    The raw events are read, not the profiler's event tree, which takes
    minutes to build for a few seconds of B=1 requests."""
    import torch

    cuda = torch.device(device).type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CUDA if cuda else torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        window = time.perf_counter() - t0
    dev, host = [], []
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns() / 1e9
        item = (ev.name(), s, s + ev.duration_ns() / 1e9)
        (dev if ev.device_type() == torch.autograd.DeviceType.CUDA else host).append(item)
    return Trace(window_s=window, device=dev, host=host)
