"""CUDA timing helpers shared by chip_smoke.py and the kernel timing tools
(tools/time_gwnet_stack.py, tools/time_gwnet_layer.py):

  events_ms       CUDA events around `reps` back-to-back calls, per call
                  (the host's enqueue included where it is the longer)
  events_ms_cold  CUDA events around each call, the L2 flushed before it
  device_ms       torch.profiler's device time of the kernels whose name
                  holds a string, per call; raises unless the profile
                  caught exactly the launches the calls made
  card            the card's name and power limit, as nvidia-smi gives them
  Rows            JSON rows of one timing run, printed and appended to a file

Each takes one warm-up call first. Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
from typing import Callable, List, Optional

import torch

FLUSH_BYTES = 128 << 20  # zeroed to flush the H100's 50 MB L2


def card() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def flush_buffer() -> torch.Tensor:
    return torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")


def events_ms(fn: Callable, reps: int) -> float:
    """Mean ms per call over `reps` back-to-back calls, CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def events_ms_cold(fn: Callable, reps: int, flush: torch.Tensor) -> float:
    """Mean ms per call over `reps` calls, each timed alone with CUDA
    events after the L2 is flushed (`flush` zeroed)."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def kernel_times(prof, kernel: str) -> List[float]:
    """Device ms of each CUDA kernel in the profile whose name holds
    `kernel`."""
    return [ev.time_range.elapsed_us() / 1e3 for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA and kernel in ev.name]


def device_ms(fn: Callable, reps: int, kernel: str, flush: Optional[torch.Tensor] = None,
              per_call: int = 1, tries: int = 3) -> float:
    """Mean device ms per call of the kernels whose name holds `kernel`
    (`per_call` launches a call), from torch.profiler over `reps` calls,
    the L2 flushed before each where `flush` is given. A profile that
    caught another count than reps·per_call launches is taken again, up
    to `tries` times, then raises: a dropped event would lower the mean."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    counts = []
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                if flush is not None:
                    flush.zero_()
                fn()
            torch.cuda.synchronize()
        times = kernel_times(prof, kernel)
        if len(times) == reps * per_call:
            return sum(times) / reps
        counts.append(len(times))
    raise RuntimeError(f"device_ms: profiles caught {counts} launches of {kernel!r}, "
                       f"{reps * per_call} made")


class Rows:
    """The JSON rows of one timing run, each tagged with the port's
    directory and the card: printed as they come, appended to `out` (if
    given) by write()."""

    def __init__(self, port_dir: str, out: Optional[str] = None):
        self.port_dir, self.out, self.card, self.rows = os.path.abspath(port_dir), out, card(), []
        print(self.card, flush=True)

    def emit(self, row: dict) -> None:
        row = {"port_dir": self.port_dir, "card": self.card, **row}
        self.rows.append(row)
        print(json.dumps(row), flush=True)

    def write(self) -> int:
        if self.out:
            os.makedirs(os.path.dirname(os.path.abspath(self.out)), exist_ok=True)
            with open(self.out, "a") as f:
                f.writelines(json.dumps(r) + "\n" for r in self.rows)
        return 0
