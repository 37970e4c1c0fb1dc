"""Input pipelines: the device-resident store and the host prefetch path.

Both end in the same model batch: the [B,T,N,…]→[B,N,T,…] permute
(reference lit.py:31) and the reference's per-image Resize + Normalize
(reference utils.py:35-38), run on the device, with a `frame_transform`
([B,N,T,H,W] float32 → [B,N,T,s,s,C]) in place of that default when the
caller gives one (the reference dataset's injectable transform slot,
utils.py:14,35-38). They are the counterparts of the JAX package's
data/pipeline.py:

- DevicePipeline keeps the packed float32 store on the device; a batch
  is an index_select of its windows, and only small index and date
  arrays cross from the host. The model input `x` is cast to the compute
  dtype, and mean/std are held in it (JAX pipeline.py:100-117).
- PrefetchIterator is the host path, for a store past the device budget
  (train/loop.py make_pipeline): a background thread gathers each batch
  from the memmap (dataset.py gather_batch, the native gather) straight
  into a pinned buffer, copies it to the card and preprocesses it there
  on a side CUDA stream, `depth` batches ahead of the consumer. As in
  the JAX host path, mean/std are float32 and `x` stays float32
  (preprocess_batch casts nothing).
"""

from __future__ import annotations

import contextlib
import queue
import threading
from functools import partial
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

FrameTransform = Callable[[torch.Tensor], torch.Tensor]


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """[..., H, W] float32 → [..., size, size]: bilinear with half-pixel
    centres, antialiased when an axis shrinks (the triangle filter
    widened by the scale, each axis on its own), as
    jax.image.resize(method="bilinear") is. The port's one resize: the
    default frame transform, ingest (acquisition.py) and the risk-map
    baseline (viz/maps.py) all call it. A tensor already at size is
    returned as it is."""
    h, w = x.shape[-2:]
    if (h, w) == (size, size):
        return x
    lead = x.shape[:-2]
    return F.interpolate(
        x.reshape(-1, 1, h, w), size=(size, size), mode="bilinear",
        align_corners=False, antialias=True,
    ).reshape(*lead, size, size)


def default_frame_transform(
    win: torch.Tensor, mean: torch.Tensor, std: torch.Tensor, image_size: int
) -> torch.Tensor:
    """Resize(image_size) + Normalize(mean, std) on a [B, N, T, H, W]
    float32 window → [B, N, T, s, s, 1] float32. mean/std may be rounded
    to the compute dtype (the device path holds them so); the arithmetic
    is float32 either way."""
    return (resize_bilinear(win, image_size)[..., None] - mean.float()) / std.float()


def gather_windows(
    frames: torch.Tensor,  # [D, N, H, W] float32 store on the device
    pos: torch.Tensor,  # [B, 2·horizon] int64 frame positions
    date_feats: torch.Tensor,  # [B, horizon, 6] float32
    mean: torch.Tensor,
    std: torch.Tensor,
    horizon: int,
    image_size: int,
    dtype: torch.dtype,
    frame_transform: Optional[FrameTransform] = None,
) -> Dict[str, torch.Tensor]:
    """Window gather + layout + normalize. The model input `x` is in the
    compute dtype; the target `y` stays float32 — MAPE's near-zero
    denominators amplify target quantization (JAX pipeline.py:107-110).
    A frame_transform replaces Resize + Normalize; its `x` is cast all
    the same, as the JAX device gather casts it."""
    b = pos.shape[0]
    raw = frames.index_select(0, pos.reshape(-1))  # [B·2h, N, H, W]
    return layout_windows(raw, b, date_feats, mean, std, horizon, image_size, dtype,
                          frame_transform)


def layout_windows(
    raw: torch.Tensor,  # [B·2·horizon, N, H, W] gathered frames, past then future per row
    b: int,
    date_feats: torch.Tensor,
    mean: torch.Tensor,
    std: torch.Tensor,
    horizon: int,
    image_size: int,
    dtype: torch.dtype,
    frame_transform: Optional[FrameTransform] = None,
) -> Dict[str, torch.Tensor]:
    """gather_windows after its gather: the [B,T,N,…]→[B,N,T,…] layout and
    the transform of each row's past (x, in dtype) and future (y)."""
    tf = frame_transform or partial(
        default_frame_transform, mean=mean, std=std, image_size=image_size
    )
    rows = raw.reshape(b, 2 * horizon, *raw.shape[1:])

    def window(win: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
        return tf(win.permute(0, 2, 1, 3, 4)).to(out_dtype).contiguous()

    return {
        "x": window(rows[:, :horizon], dtype),
        "y": window(rows[:, horizon:], torch.float32),
        "date_feats": date_feats,
    }


def upload_frames(src: np.ndarray, device: torch.device, chunk_bytes: int = 256 << 20) -> torch.Tensor:
    """A [D, ...] host array (the store's memmap) as a float32 tensor on
    `device`, copied in chunks of dates through one reused buffer (pinned
    for a card): the store never has a whole second copy in host memory.
    Values are those of np.asarray(src, np.float32), bitwise."""
    cuda = device.type == "cuda"
    dst = torch.empty(src.shape, dtype=torch.float32, device=device)
    per = max(1, chunk_bytes // max(1, src[:1].size * 4))  # dates per chunk
    buf = torch.empty((min(per, src.shape[0]),) + tuple(src.shape[1:]),
                      dtype=torch.float32, pin_memory=cuda)
    host = buf.numpy()
    for s in range(0, src.shape[0], per):
        n = min(per, src.shape[0] - s)
        host[:n] = src[s : s + n]
        dst[s : s + n].copy_(buf[:n], non_blocking=cuda)
        if cuda:  # the buffer is refilled next: wait for this copy
            torch.cuda.current_stream(device).synchronize()
    return dst


class DevicePipeline:
    """Keeps the packed frame store on the device; batches are device
    gathers driven by small host index arrays.

    With a mesh (core/mesh.py, JAX pipeline.py:135-230) batch() takes the
    global (padded) index batch and gives this rank its rows and T slice,
    gathering only those. shard_store: each rank holds only its data
    coordinate's block of the date axis, D/dp dates (the axis padded to a
    multiple of dp with zero dates no window reads, JAX :181), uploaded
    from the memmap's rows alone; a batch then gathers every row's
    frames (this rank's T slice) from the local block, zero where a date
    lies outside it, sums the raw frames over the data group (each date
    is held by one rank, so the sum is the frame, bitwise) and keeps its
    rows."""

    def __init__(
        self,
        store,
        mean: float,
        std: float,
        image_size: int,
        dtype: torch.dtype,
        device: torch.device,
        frame_transform: Optional[FrameTransform] = None,
        mesh=None,
        shard_store: bool = False,
    ):
        self.device = torch.device(device)
        self.mesh = mesh
        self.shard = mesh is not None and shard_store and mesh.shape.data > 1
        src = store.frames
        if self.shard:
            dp = mesh.shape.data
            d_true = src.shape[0]
            per = (d_true + (-d_true) % dp) // dp
            self.offset = mesh.coords[0] * per
            stop = min(self.offset + per, d_true)
            self.frames = torch.zeros((per,) + tuple(src.shape[1:]), dtype=torch.float32,
                                      device=self.device)
            if stop > self.offset:
                self.frames[: stop - self.offset] = upload_frames(src[self.offset:stop],
                                                                  self.device)
        else:
            self.frames = upload_frames(src, self.device)
        # held in the compute dtype, like the JAX pipeline's mean/std
        self.mean = torch.tensor(mean, dtype=dtype, device=device)
        self.std = torch.tensor(std, dtype=dtype, device=device)
        self.image_size = image_size
        self.dtype = dtype
        self.frame_transform = frame_transform

    def batch(self, dataset, batch_idx: np.ndarray) -> Dict[str, torch.Tensor]:
        if self.mesh is not None:
            return self._mesh_batch(dataset, np.asarray(batch_idx))
        pos = torch.from_numpy(dataset.window_positions(batch_idx)).to(
            self.device
        )
        feats = torch.from_numpy(dataset.window_date_feats(batch_idx)).to(
            self.device
        )
        return gather_windows(
            self.frames, pos, feats, self.mean, self.std,
            dataset.horizon, self.image_size, self.dtype, self.frame_transform,
        )

    def _mesh_batch(self, dataset, batch_idx: np.ndarray) -> Dict[str, torch.Tensor]:
        from multimodal_outage_tpu_torch.core.mesh import DATA_AXIS, TIME_AXIS, local_batch_slice
        from multimodal_outage_tpu_torch.parallel.collectives import all_reduce

        mesh, h = self.mesh, dataset.horizon
        tl = h // mesh.shape.time
        t0 = mesh.coord(TIME_AXIS) * tl
        rows = local_batch_slice(len(batch_idx), mesh)
        cols = np.r_[t0:t0 + tl, h + t0:h + t0 + tl]  # this T slice of past, future
        feats = dataset.window_date_feats(batch_idx[rows])[:, t0:t0 + tl]
        feats = torch.from_numpy(np.ascontiguousarray(feats)).to(self.device)
        if not self.shard:
            pos = dataset.window_positions(batch_idx[rows])[:, cols]
            return gather_windows(self.frames, torch.from_numpy(pos).to(self.device), feats,
                                  self.mean, self.std, tl, self.image_size, self.dtype,
                                  self.frame_transform)
        pos = torch.from_numpy(dataset.window_positions(batch_idx)[:, cols]).to(self.device)
        local = pos - self.offset
        inside = (local >= 0) & (local < self.frames.shape[0])
        raw = self.frames.index_select(0, local.clamp(0, self.frames.shape[0] - 1).reshape(-1))
        raw = raw * inside.reshape(-1, 1, 1, 1)
        raw = all_reduce(raw, mesh.group(DATA_AXIS))
        raw = raw.reshape(len(batch_idx), 2 * tl, *raw.shape[1:])[rows].reshape(-1, *raw.shape[1:])
        return layout_windows(raw, rows.stop - rows.start, feats, self.mean, self.std, tl,
                              self.image_size, self.dtype, self.frame_transform)


def preprocess_batch(
    batch: Dict[str, torch.Tensor],
    mean: torch.Tensor,
    std: torch.Tensor,
    image_size: int,
    frame_transform: Optional[FrameTransform] = None,
) -> Dict[str, torch.Tensor]:
    """Raw [B,T,N,H,W] past/future on the device → model inputs (JAX
    pipeline.py:36-71): x, y [B,N,T,s,s,C] from the default Resize +
    Normalize or `frame_transform`, contiguous; date_feats as given.
    Nothing is cast: the host path's x stays float32, as JAX's does."""
    tf = frame_transform or partial(
        default_frame_transform, mean=mean, std=std, image_size=image_size
    )

    def layout(v: torch.Tensor) -> torch.Tensor:
        return tf(v.permute(0, 2, 1, 3, 4)).contiguous()

    return {"x": layout(batch["past"]), "y": layout(batch["future"]),
            "date_feats": batch["date_feats"]}


def denormalize(x: torch.Tensor, mean: float, std: float) -> torch.Tensor:
    """Inverse of normalization (reference utils.py:40-44)."""
    return x * std + mean


class PrefetchIterator:
    """Background-thread batch producer for the host path (JAX
    pipeline.py:243-325), `depth` batches ahead of the consumer.

    For each index batch the producer thread gathers the windows' frames
    from the store's memmap straight into a pinned host buffer (one of
    depth + 1, a buffer reused only after the event of its last copy has
    completed), copies it to the card and runs preprocess_batch there,
    all on its own CUDA stream, and queues the batch with an event
    recorded after it. The consumer makes its current stream wait on
    that event and calls record_stream on every tensor it hands out, so
    the caching allocator does not give a batch's memory back to the
    producer's stream while the consumer's kernels may still read it.

    As in the JAX iterator: the queue put is bounded and gives up once
    close() is called; an exception in the producer is raised in the
    consumer; a consumer that stops iterating closes the iterator, which
    stops the thread; close() is idempotent. On the CPU the same code
    runs without streams, events or pinned memory."""

    def __init__(
        self,
        dataset,
        index_batches: Iterable[np.ndarray],
        mean: float,
        std: float,
        image_size: int,
        device,
        depth: int = 2,
        frame_transform: Optional[FrameTransform] = None,
    ):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._ds = dataset
        self._it = iter(index_batches)
        self._device = torch.device(device)
        self._cuda = self._device.type == "cuda"
        self._mean = torch.tensor(mean, dtype=torch.float32, device=self._device)
        self._std = torch.tensor(std, dtype=torch.float32, device=self._device)
        self._image_size = image_size
        self._frame_transform = frame_transform
        self._stream = torch.cuda.Stream(self._device) if self._cuda else None
        # host buffers, each with the event of the last copy out of it
        self._slots: List[Tuple[Optional[torch.Tensor], Optional[torch.cuda.Event]]] = [
            (None, None)
        ] * (depth + 1)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Bounded put that aborts when close() is signalled — a consumer
        abandoning iteration must not leave the producer blocked on a full
        queue holding device batches and the memmap."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _load(self, slot: int, idx: np.ndarray):
        """Gather, copy and preprocess one batch on the producer's stream;
        returns (batch, event recorded after it or None)."""
        frame_shape = tuple(self._ds.store.frames.shape[1:])
        n = len(idx) * 2 * self._ds.horizon
        host, copied = self._slots[slot]
        if copied is not None:
            copied.synchronize()  # its last copy to the card has read it
        if host is None or host.shape[0] < n:
            host = torch.empty((n,) + frame_shape, dtype=torch.float32,
                               pin_memory=self._cuda)
        raw = self._ds.gather_batch(idx, out=host[:n].numpy())
        frames = torch.empty((n,) + frame_shape, dtype=torch.float32, device=self._device)
        frames.copy_(host[:n], non_blocking=self._cuda)
        copied = None
        if self._cuda:
            copied = torch.cuda.Event()
            copied.record(self._stream)
        self._slots[slot] = (host, copied)
        h = self._ds.horizon
        win = frames.view((len(idx), 2 * h) + frame_shape)
        feats = torch.from_numpy(raw["date_feats"]).to(self._device, non_blocking=self._cuda)
        batch = preprocess_batch(
            {"past": win[:, :h], "future": win[:, h:], "date_feats": feats},
            self._mean, self._std, self._image_size, self._frame_transform,
        )
        ready = None
        if self._cuda:
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return batch, ready

    def _produce(self):
        try:
            with torch.cuda.stream(self._stream) if self._cuda else contextlib.nullcontext():
                for k, idx in enumerate(self._it):
                    if self._stop.is_set():
                        return
                    if not self._put(self._load(k % len(self._slots), idx)):
                        return
        except Exception as e:  # surface producer errors to the consumer
            self._put(e)
        finally:
            self._put(None)

    def close(self) -> None:
        """Stop the producer and release its queue slots. Idempotent;
        called when a consumer abandons iteration early."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10.0)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        try:
            while True:
                item = self._q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                batch, ready = item
                if ready is not None:
                    stream = torch.cuda.current_stream(self._device)
                    stream.wait_event(ready)
                    for t in batch.values():
                        t.record_stream(stream)
                yield batch
        finally:
            self.close()
