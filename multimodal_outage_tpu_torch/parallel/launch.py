"""Starting the ranks of a mesh run.

run(entry, shape, device_type, args) calls entry(mesh, *args) on every
rank of a `shape` mesh and returns the result of this process's first
rank (global rank 0 on one host):

- under an initialised process group this process is one rank: it
  builds its Mesh and runs entry itself; in torchrun's environment (RANK,
  WORLD_SIZE, MASTER_ADDR) it first joins the group (init_method env://,
  its device cuda:LOCAL_RANK) and leaves it after;
- else this host's ranks are spawned (torch.multiprocessing, start
  method spawn), one process each, one intra-op thread each on the CPU.
  On one host they meet at tcp://127.0.0.1:<free port>; after
  core/mesh.py initialize_distributed, at its coordinator, as ranks
  process_id × local + local_rank of num_processes × local.

Rank r runs on cuda:(r % device_count()) or on the CPU. Backend: gloo on
the CPU and where ranks share a card (said on the run's first line),
else NCCL (backend_for). A rank that raises makes run raise (the rank's exception,
with its traceback in the message); the other ranks are terminated, so
none is left waiting in a collective, whose waits are bounded by
TIMEOUT_S; the group is destroyed in `finally`. entry and args must
pickle (module-level functions; a transform hook must be one too).
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue
import socket
import traceback
from typing import Any, Callable, Optional, Sequence

import torch

from multimodal_outage_tpu_torch.core.mesh import (
    VIRTUAL_DEVICES_ENV,
    Mesh,
    MeshShape,
    local_device_count,
    multihost,
    torchrun_env,
)

# bound of every collective wait and of a rank's silence
TIMEOUT_S = 600


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def backend_for(device_type: str, ranks_here: int, multi_host: bool = False) -> str:
    """gloo on the CPU and when this host's ranks outnumber its cards; on
    several hosts also under the virtual-device variable, since processes
    that give themselves virtual devices may share a card (NCCL refuses
    two ranks on one card); else NCCL."""
    if device_type != "cuda" or ranks_here > torch.cuda.device_count():
        return "gloo"
    if multi_host and os.environ.get(VIRTUAL_DEVICES_ENV):
        return "gloo"
    return "nccl"


def rank_device(rank: int, device_type: str) -> torch.device:
    if device_type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _to_host(out: Any) -> Any:
    """Tensors as numpy arrays: a tensor sent through the queue would be
    shared by a handle that dies with the rank's process."""
    if torch.is_tensor(out):
        return out.detach().cpu().numpy()
    if isinstance(out, dict):
        return {k: _to_host(v) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(_to_host(v) for v in out)
    return out


def _rank_main(local_rank: int, first_rank: int, world: int, init_method: str, backend: str,
               shape: MeshShape, device_type: str, entry: Callable, args: Sequence[Any],
               results) -> None:
    import torch.distributed as dist

    rank = first_rank + local_rank
    if device_type != "cuda":
        torch.set_num_threads(1)
    device = rank_device(rank, device_type)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    try:
        dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=TIMEOUT_S))
        results.put((rank, True, _to_host(entry(Mesh(shape, device), *args))))
    except BaseException as e:  # report (before the group goes), then exit non-zero
        text = traceback.format_exc()
        try:
            blob = pickle.dumps(e)
        except Exception:
            blob = None
        results.put((rank, False, (blob, text)))
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _secondary(text: str) -> bool:
    """A failure that only reports another rank's: a collective whose peer
    went away."""
    return any(w in text for w in ("Connection reset", "Connection closed", "gloo",
                                   "NCCL", "DistBackendError", "Broken pipe"))


def _raise_from(rank: int, blob: Optional[bytes], text: str):
    exc = None
    if blob is not None:
        try:
            exc = pickle.loads(blob)
        except Exception:
            exc = None
    if isinstance(exc, Exception):
        try:
            exc.args = (f"{exc.args[0] if exc.args else ''}\n[rank {rank}]\n{text}",
                        *exc.args[1:])
        except Exception:
            pass
        raise exc
    raise RuntimeError(f"rank {rank} failed:\n{text}")


def run(entry: Callable, shape: MeshShape, device_type: str, args: Sequence[Any] = (),
        progress: bool = True) -> Any:
    """entry(mesh, *args) on every rank of `shape` (a shape of one device
    is a group of one); the result of this process's first rank. See the
    module docstring."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        rank = dist.get_rank()
        return entry(Mesh(shape, rank_device(rank, device_type)), *args)
    if torchrun_env():
        local = int(os.environ.get("LOCAL_RANK", 0))
        device = rank_device(local, device_type)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        here = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
        dist.init_process_group(backend_for(device_type, here), init_method="env://",
                                timeout=datetime.timedelta(seconds=TIMEOUT_S))
        try:
            return entry(Mesh(shape, device), *args)
        finally:
            dist.destroy_process_group()
    mh = multihost()
    if mh is None:
        first, world, here = 0, shape.size, shape.size
        init_method = f"tcp://127.0.0.1:{_free_port()}"
    else:
        local = local_device_count(device_type)
        world = shape.size
        if world > mh.num_processes * local:
            raise ValueError(f"mesh {shape} needs {world} devices, "
                             f"have {mh.num_processes * local}")
        first = mh.process_id * local
        here = max(0, min(local, world - first))
        init_method = f"tcp://{mh.coordinator}"
    backend = backend_for(device_type, here, mh is not None)
    if progress:
        cards = torch.cuda.device_count() if device_type == "cuda" else 0
        per_card = -(-here // cards) if cards else 0
        print(f"SPMD mesh: {{'data': {shape.data}, 'model': {shape.model}, "
              f"'time': {shape.time}}} ({shape}); {world} ranks, {here} here; "
              f"{cards} cards, {per_card} ranks per card; backend {backend}", flush=True)
    if here == 0:
        return None
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=False,
                         args=(i, first, world, init_method, backend, shape, device_type,
                               entry, tuple(args), results))
             for i in range(here)]
    env_threads = os.environ.get("OMP_NUM_THREADS")
    if device_type != "cuda":
        os.environ["OMP_NUM_THREADS"] = "1"
    try:
        for p in procs:
            p.start()
    finally:
        if device_type != "cuda":
            if env_threads is None:
                os.environ.pop("OMP_NUM_THREADS", None)
            else:
                os.environ["OMP_NUM_THREADS"] = env_threads
    got = {}
    try:
        while len(got) < here:
            try:
                rank, ok, payload = results.get(timeout=5.0)
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    # a rank that died without reporting (killed, or a crash
                    # in the interpreter): give a report in flight a moment
                    try:
                        rank, ok, payload = results.get(timeout=5.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"a rank exited with code {dead[0].exitcode} without a result"
                        ) from None
                else:
                    continue
            if not ok:
                failures = [(rank, payload)]
                # a peer's report may follow: raise the cause, not the echo
                while _secondary(failures[0][1][1]):
                    try:
                        r2, ok2, p2 = results.get(timeout=3.0)
                    except queue.Empty:
                        break
                    if not ok2:
                        failures.append((r2, p2))
                        failures.sort(key=lambda f: _secondary(f[1][1]))
                _raise_from(failures[0][0], *failures[0][1])
            got[rank] = payload
        for p in procs:
            p.join(timeout=TIMEOUT_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
        results.close()
    return got[min(got)]

