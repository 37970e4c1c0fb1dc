"""Spans inside the port, on the profiler's clock.

A span marks one stage of a layer: the serving engine's forward and its
contraction / st-GNN / expansion (serving.py), the device pipeline's
batch and its host→device upload (data/pipeline.py), the train step and
its forward / backward / optimizer phases (train/steps.py). Readers are
the benchmark's per-layer metrics (outage_bench/spans.py) and
`train --profile_dir`, which merges the window's spans into its
trace.json (train/loop.py _StepTrace).

    with tracing.span("engine.st_gnn", device=True):
        z = st_gnn(z)

Spans record only while a torch profiler session records: outside one a
span is a single check of the profiler's flag, with no allocation, no
record and no CUDA call. Inside one, each span records (id, parent id,
root id, name, host start ns, host end ns), stamped with time.time_ns(),
the clock of the profiler's raw events, so spans and the device trace
line up. Children carry their root's id: the spans of one call share an
identifier. A device span also records a pair of CUDA events on the
current stream, never synchronising; its device ms are read by spans(),
once the caller has synchronised (None off the card, or while the end
event is still pending). The buffer is bounded: past `capacity` records
the oldest are dropped and counted in `dropped`.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, List, Optional, Tuple

import torch

_profiler_on = torch._C._autograd._profiler_enabled


@dataclass
class Span:
    id: int
    parent: Optional[int]
    root: int
    name: str
    start_ns: int
    end_ns: int
    device_ms: Optional[float] = None
    events: Optional[Tuple] = None  # the CUDA event pair, until read

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class _Off:
    """The span returned while no profiler records. Entering and leaving it
    runs no Python frame: both are the C function "".format, which takes
    any arguments and returns "" (falsy, so an exception propagates)."""

    __slots__ = ()
    __enter__ = __exit__ = staticmethod("".format)


_OFF = _Off()


class _On:
    __slots__ = ("tracer", "name", "device", "id", "parent", "root", "start_ns", "events")

    def __init__(self, tracer: "Tracer", name: str, device: bool):
        self.tracer, self.name, self.device = tracer, name, device

    def __enter__(self) -> None:
        tr = self.tracer
        stack = tr._stack()
        self.id = next(tr._ids)
        self.parent = stack[-1].id if stack else None
        self.root = stack[0].id if stack else self.id
        stack.append(self)
        self.events = tr._event_pair() if self.device else None
        if self.events is not None:
            self.events[0].record()
        self.start_ns = time.time_ns()

    def __exit__(self, *exc) -> None:
        end_ns = time.time_ns()
        if self.events is not None:
            self.events[1].record()
        tr = self.tracer
        tr._stack().pop()
        tr._append(Span(self.id, self.parent, self.root, self.name, self.start_ns, end_ns,
                        events=self.events))


class Tracer:
    """A bounded buffer of spans with its own ids and CUDA event pool."""

    def __init__(self, capacity: int = 1 << 16):
        self.capacity = capacity
        self.dropped = 0
        self._buf: Deque[Span] = deque()
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._pool: List[Tuple] = []
        self._cuda: Optional[bool] = None

    def span(self, name: str, device: bool = False):
        """A context manager: the span `name` while a profiler records,
        else a no-op. device=True: the caller's work runs on the card, and
        the span also times it with CUDA events on the current stream."""
        if not _profiler_on():
            return _OFF
        return _On(self, name, device)

    def spans(self) -> List[Span]:
        """The recorded spans, oldest first, their device ms read where
        the end event has completed."""
        with self._lock:
            out = list(self._buf)
        for s in out:
            if s.events is not None and s.events[1].query():
                s.device_ms = s.events[0].elapsed_time(s.events[1])
                self._pool.append(s.events)
                s.events = None
        return out

    def clear(self) -> None:
        with self._lock:
            for s in self._buf:
                if s.events is not None:
                    self._pool.append(s.events)
            self._buf.clear()
            self.dropped = 0

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _event_pair(self) -> Optional[Tuple]:
        if self._cuda is None:
            self._cuda = torch.cuda.is_available()
        if not self._cuda:
            return None
        if not self._pool:
            self._pool.extend(tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
                              for _ in range(64))
        return self._pool.pop()

    def _append(self, s: Span) -> None:
        with self._lock:
            if len(self._buf) >= self.capacity:
                old = self._buf.popleft()
                if old.events is not None:
                    self._pool.append(old.events)
                self.dropped += 1
            self._buf.append(s)


TRACER = Tracer()
span = TRACER.span
spans = TRACER.spans
clear = TRACER.clear
