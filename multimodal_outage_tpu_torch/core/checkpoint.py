"""Checkpoints of the port, in torch format (the JAX package's
core/checkpoint.py keeps the same retention with orbax; its orbax
checkpoints convert into this format with tools/export_jax_checkpoint.py,
and reference Lightning checkpoints with `import-torch`).

Two stores under the checkpoint directory, each a directory of
<step>.pt files written with torch.save:
  best/    the top-k steps by val_loss (min), for the end-of-fit sweeps
  latest/  the most recent step, which `train --resume` continues from
           (restore_latest)
A tree is nested dicts of tensors and Python numbers; tensors are saved
from the CPU. The stores are created by the first save: reading a
directory never writes to it.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    return tree


class CheckpointManager:
    """Best-k retention keyed on val_loss (min) plus a latest-step store
    (JAX core/checkpoint.py:33-110)."""

    def __init__(self, directory: str, keep_top_k: int = 1):
        self._dir = os.path.abspath(directory)
        self._best = os.path.join(self._dir, "best")
        self._latest = os.path.join(self._dir, "latest")
        self._keep = keep_top_k
        self._index = os.path.join(self._best, "metrics.json")

    def _metrics(self) -> Dict[int, float]:
        if not os.path.exists(self._index):
            return {}
        with open(self._index) as f:
            return {int(k): v for k, v in json.load(f).items()}

    @staticmethod
    def _steps(d: str):
        if not os.path.isdir(d):
            return []
        return sorted(int(f[:-3]) for f in os.listdir(d) if f.endswith(".pt"))

    def save(self, step: int, tree: Any, metrics: dict) -> None:
        """Commit `step` so that a crash at any point leaves a directory
        restore() reads: each file is written to a temporary name and
        renamed (a reader never sees a partial file), the index names only
        files that exist, and a file is deleted only after the index that
        drops it is in place."""
        tree = _to_cpu(tree)
        for d in (self._best, self._latest):
            os.makedirs(d, exist_ok=True)
            self._replace(os.path.join(d, f"{step}.pt"), lambda p: torch.save(tree, p))
        scores = self._metrics()
        scores[step] = float(metrics["val_loss"])
        keep = sorted(scores, key=lambda s: (scores[s], s))[: self._keep]
        scores = {s: scores[s] for s in keep}
        self._replace(self._index, lambda p: self._dump(scores, p))
        # files of a save that died before its index are pruned here too
        for d, keep_d in ((self._best, keep), (self._latest, [step])):
            for old in self._steps(d):
                if old not in keep_d:
                    os.unlink(os.path.join(d, f"{old}.pt"))

    def save_latest(self, step: int, tree: Any) -> None:
        """Commit `step` to the latest store only, as save commits it
        there: a step that the best store does not keep (tools/
        export_jax_checkpoint.py, a run's newest step past its best)."""
        tree = _to_cpu(tree)
        os.makedirs(self._latest, exist_ok=True)
        self._replace(os.path.join(self._latest, f"{step}.pt"), lambda p: torch.save(tree, p))
        for old in self._steps(self._latest):
            if old != step:
                os.unlink(os.path.join(self._latest, f"{old}.pt"))

    @staticmethod
    def _replace(path: str, write) -> None:
        tmp = os.path.join(os.path.dirname(path), f".{os.path.basename(path)}.tmp")
        write(tmp)
        os.replace(tmp, path)

    @staticmethod
    def _dump(scores: Dict[int, float], path: str) -> None:
        with open(path, "w") as f:
            json.dump({str(k): v for k, v in scores.items()}, f)

    @property
    def best_step(self) -> Optional[int]:
        scores = self._metrics()
        return min(scores, key=lambda s: (scores[s], s)) if scores else None

    def latest_step(self) -> Optional[int]:
        steps = self._steps(self._latest)
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None) -> Any:
        """The best checkpoint, or an explicit step from either store."""
        if step is None:
            step = self.best_step
            if step is None:
                step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self._dir}")
        for d in (self._best, self._latest):
            path = os.path.join(d, f"{step}.pt")
            if os.path.exists(path):
                return torch.load(path, map_location="cpu", weights_only=True)
        raise FileNotFoundError(f"no checkpoint of step {step} in {self._dir}")

    def restore_latest(self) -> Any:
        """The tree of latest_step(), the resume path (JAX
        core/checkpoint.py:92-102); FileNotFoundError if there is none."""
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no latest checkpoint in {self._dir}")
        path = os.path.join(self._latest, f"{step}.pt")
        return torch.load(path, map_location="cpu", weights_only=True)


def require_checkpoints(directory: str) -> None:
    """Raise FileNotFoundError unless `directory` exists and holds
    something: the readers' check before any other work (JAX
    train/loop.py:795-796, 918-921)."""
    if not os.path.isdir(directory) or not os.listdir(directory):
        raise FileNotFoundError(f"no checkpoints found in {directory!r}")


def restore_variables(directory: str, step: Optional[int] = None) -> Dict[str, Any]:
    """The {"params", "batch_stats"} of the best checkpoint (or of `step`)
    under `directory`, as CPU tensors."""
    tree = CheckpointManager(directory).restore(step)
    return {"params": tree["params"], "batch_stats": tree["batch_stats"]}
