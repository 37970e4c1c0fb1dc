"""Run logging: config.json and an append-only metrics.jsonl per run
directory (JAX core/run_logging.py:39-88, without TensorBoard), and the
card's allocator statistics."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict

import torch


class RunLogger:
    def __init__(self, run_dir: str, config: Dict[str, Any] | None = None):
        self.run_dir = os.path.abspath(run_dir)
        os.makedirs(self.run_dir, exist_ok=True)
        self._f = open(os.path.join(self.run_dir, "metrics.jsonl"), "a")
        if config is not None:
            with open(os.path.join(self.run_dir, "config.json"), "w") as cf:
                json.dump(config, cf, indent=2, default=str)

    def log(self, record: Dict[str, Any]) -> None:
        record = {"time": time.time(), **record}
        self._f.write(json.dumps(record, default=float) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def device_memory_stats(device: torch.device) -> Dict[str, float]:
    """Bytes in use and their peak on a CUDA device, from
    torch.cuda.memory_stats (the JAX package's HBM probe); empty for the
    CPU, which has no device memory to report."""
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": float(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": float(stats.get("allocated_bytes.all.peak", 0)),
    }
