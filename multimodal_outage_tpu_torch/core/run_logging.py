"""Run logging: config.json and an append-only metrics.jsonl per run
directory, with optional TensorBoard scalars (JAX core/run_logging.py:
19-88), and the card's allocator statistics."""

from __future__ import annotations

import json
import os
import time
import warnings
from typing import Any, Dict

import torch


def _make_summary_writer(log_dir: str):
    """The first importable SummaryWriter, tensorboardX then torch's, or
    None with a warning when neither is (metrics.jsonl is written either
    way)."""
    try:
        from tensorboardX import SummaryWriter  # type: ignore
    except ImportError:
        try:
            from torch.utils.tensorboard import SummaryWriter  # type: ignore
        except ImportError:
            warnings.warn(
                "tensorboard=True but neither tensorboardX nor "
                "torch.utils.tensorboard is importable; scalars disabled "
                "(metrics.jsonl is unaffected)",
                stacklevel=3,
            )
            return None
    return SummaryWriter(log_dir)


class RunLogger:
    """JSONL always; with tensorboard=True also scalars under <run_dir>/tb,
    tagged "<phase>/<key>" and stepped by the record's "step", else its
    "epoch", else a count of records."""

    def __init__(self, run_dir: str, config: Dict[str, Any] | None = None,
                 tensorboard: bool = False):
        self.run_dir = os.path.abspath(run_dir)
        os.makedirs(self.run_dir, exist_ok=True)
        self._f = open(os.path.join(self.run_dir, "metrics.jsonl"), "a")
        self._tb = _make_summary_writer(os.path.join(self.run_dir, "tb")) if tensorboard else None
        self._n_records = 0
        if config is not None:
            with open(os.path.join(self.run_dir, "config.json"), "w") as cf:
                json.dump(config, cf, indent=2, default=str)

    def log(self, record: Dict[str, Any]) -> None:
        record = {"time": time.time(), **record}
        self._f.write(json.dumps(record, default=float) + "\n")
        self._f.flush()
        if self._tb is not None:
            phase = record.get("phase", "run")
            step = record.get("step", record.get("epoch", self._n_records))
            for k, v in record.items():
                if k in ("time", "phase", "step", "epoch"):
                    continue
                try:
                    v = float(v)
                except (TypeError, ValueError):
                    continue
                self._tb.add_scalar(f"{phase}/{k}", v, int(step))
        self._n_records += 1

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()


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
