"""Sliding-window dataset over the packed NTL store (numpy only).

Same index math as the JAX package's data/dataset.py (reference
utils.py:13-105):
  len    = n_selected_dates − 2·horizon
  past   = frames[i : i+horizon]
  future = frames[i+horizon : i+2·horizon]
  date features from the PAST window's dates.
The device pipeline (pipeline.py DevicePipeline) gathers frames on the
card from the positions this class computes; the host path gathers them
here (gather_batch, through the threaded native gather of native.py) for
pipeline.py PrefetchIterator to copy to the card.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from multimodal_outage_tpu_torch.data.native import gather_frames
from multimodal_outage_tpu_torch.data.store import NTLStore


def find_case_study_indices(
    dates: np.ndarray,
    case_study: Dict[str, datetime.date],
    dataset_range: int,
) -> np.ndarray:
    """Positions into `dates` within ±dataset_range of each case date
    (reference utils.py:139-146: python-slice semantics, union, sorted)."""
    date_list = [datetime.date(*map(int, row)) for row in dates]
    pos = {d: i for i, d in enumerate(date_list)}
    selected: set[int] = set()
    for d in case_study.values():
        if d not in pos:
            raise KeyError(f"case-study date {d} not present in store dates")
        p = pos[d]
        start = max(p - dataset_range, 0)
        end = min(p + dataset_range, len(date_list))
        selected.update(range(start, end))
    return np.asarray(sorted(selected), dtype=np.int64)


def date_features(dates: np.ndarray) -> np.ndarray:
    """[K, 3] (y,m,d) → [K, 6] float32 Date2Vec input [0,0,0,y,m,d]
    (reference utils.py:124-126)."""
    out = np.zeros((dates.shape[0], 6), dtype=np.float32)
    out[:, 3:] = dates.astype(np.float32)
    return out


@dataclass
class WindowDataset:
    store: NTLStore
    indices: np.ndarray  # positions into store.frames, sorted
    horizon: int

    @classmethod
    def from_case_study(
        cls,
        store: NTLStore,
        case_study: Dict[str, datetime.date],
        dataset_range: int,
        horizon: int,
    ) -> "WindowDataset":
        idx = find_case_study_indices(store.dates, case_study, dataset_range)
        return cls(store=store, indices=idx, horizon=horizon)

    def __len__(self) -> int:
        return max(len(self.indices) - 2 * self.horizon, 0)

    def window_positions(self, batch_idx: np.ndarray) -> np.ndarray:
        """[B, 2·horizon] store-frame positions of each sample's
        past+future window."""
        batch_idx = np.asarray(batch_idx, dtype=np.int64)
        win = batch_idx[:, None] + np.arange(2 * self.horizon)[None, :]
        return self.indices[win]

    def future_window_dates(self, batch_idx: np.ndarray) -> np.ndarray:
        """[B, horizon, 3] (y, m, d) dates of each sample's future window,
        the predicted frames' dates (JAX data/dataset.py:103-109)."""
        pos = self.window_positions(batch_idx)[:, self.horizon :]
        dates = self.store.dates[pos.reshape(-1)]
        return dates.reshape(len(np.atleast_1d(batch_idx)), self.horizon, 3)

    def window_date_feats(self, batch_idx: np.ndarray) -> np.ndarray:
        """[B, horizon, 6] Date2Vec inputs for each sample's past window."""
        pos = self.window_positions(batch_idx)[:, : self.horizon]
        dates = self.store.dates[pos.reshape(-1)]
        return date_features(dates).reshape(len(batch_idx), self.horizon, 6)

    def gather_batch(
        self, batch_idx: np.ndarray, out: Optional[np.ndarray] = None
    ) -> Dict[str, np.ndarray]:
        """Host batch assembly (JAX data/dataset.py:117-137): past
        [B, T, N, H, W] and future [B, T, N, H, W] float32 raw radiance,
        date_feats [B, T, 6] float32 (the past window's Date2Vec inputs).

        Each sample's 2·T frames are copied from the store in one native
        gather, into `out` when given: a float32 C-contiguous
        [B·2T, N, H, W] buffer (the prefetcher's pinned buffer), which
        past and future are then views of."""
        h = self.horizon
        batch_idx = np.asarray(batch_idx, dtype=np.int64)
        store_pos = self.window_positions(batch_idx)  # [B, 2h]
        frames = gather_frames(self.store.frames, store_pos.reshape(-1), out=out)
        b = batch_idx.shape[0]
        frames = frames.reshape((b, 2 * h) + frames.shape[1:])
        dates = self.store.dates[store_pos[:, :h].reshape(-1)]
        feats = date_features(dates).reshape(b, h, 6)
        return {"past": frames[:, :h], "future": frames[:, h:], "date_feats": feats}


def train_val_split(n: int, val_fraction: float, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic random split, the JAX package's (data/dataset.py:140-148;
    reference lit.py:161-163): (sorted train positions, sorted val
    positions)."""
    n_val = int(n * val_fraction)
    perm = np.random.default_rng(seed).permutation(n)
    return np.sort(perm[n_val:]), np.sort(perm[:n_val])


def batch_indices(
    n: int, batch_size: int, shuffle: bool = False, seed: int = 0,
    drop_last: bool = False,
) -> Iterator[np.ndarray]:
    """Index batches, the JAX package's (data/dataset.py:151-164): in order,
    or a numpy permutation from `seed` when shuffle=True; the last batch
    may be ragged unless drop_last."""
    order = np.random.default_rng(seed).permutation(n) if shuffle else np.arange(n)
    end = (n // batch_size) * batch_size if drop_last else n
    for s in range(0, end, batch_size):
        yield order[s : s + batch_size]
