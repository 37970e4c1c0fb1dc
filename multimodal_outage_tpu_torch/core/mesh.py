"""The device mesh of the port (JAX core/mesh.py), on torch.distributed.

JAX is single-controller: one process drives every chip and GSPMD writes
the collectives. The port is multi-process SPMD: one process per rank,
each owning one device, with the collectives written out
(parallel/collectives.py). The ranks sit in a (data, model, time) grid
in C order, as JAX's np.asarray(devices).reshape(data, model, time):

  data  — the batch is split over ranks; gradients are all-reduced
  model — tensor parallelism over the bottleneck MLPs' hidden dims
  time  — the window T is split over ranks (sequence parallelism): the
          U-Net, the bottleneck, Date2Vec and the kernel_size-1 Graph
          WaveNet are pointwise in T, so only the BatchNorm moments are
          all-reduced; DCRNN and the kernel_size > 1 TCN gather T

Each rank belongs to one group along each axis, and to the group of
every rank with its model coordinate (the data × time ranks, over which
gradients are summed).

The devices a mesh may take: the cards of this host (one rank each,
NCCL), or the CPU (one, gloo). The environment variable
MULTIMODAL_OUTAGE_TORCH_VIRTUAL_DEVICES=K plays the part of JAX's
--xla_force_host_platform_device_count: K devices per host, rank r on
cuda:(r % device_count()) or on the CPU. Ranks that share a card run
over gloo. Multi-host runs (initialize_distributed) have P × K.

A Mesh exists only inside a rank (parallel/launch.py starts them);
mesh_from_config resolves the axes beforehand.
"""

from __future__ import annotations

import contextlib
import os
import threading
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
TIME_AXIS = "time"
AXES = (DATA_AXIS, MODEL_AXIS, TIME_AXIS)

VIRTUAL_DEVICES_ENV = "MULTIMODAL_OUTAGE_TORCH_VIRTUAL_DEVICES"


class MeshShape(NamedTuple):
    data: int
    model: int
    time: int

    @property
    def size(self) -> int:
        return self.data * self.model * self.time

    def __str__(self) -> str:
        return f"{self.data}x{self.model}x{self.time}"


@dataclass(frozen=True)
class MultiHost:
    """The multi-host launch of initialize_distributed: this process is
    process_id of num_processes, all meeting at coordinator (host:port)."""

    coordinator: str
    num_processes: int
    process_id: int


_MULTIHOST: Optional[MultiHost] = None


def local_device_count(device_type: str) -> int:
    """The devices this host gives a mesh: the virtual-device variable
    when set, else the cards (cuda) or one (cpu)."""
    env = os.environ.get(VIRTUAL_DEVICES_ENV)
    if env:
        n = int(env)
        if n < 1:
            raise ValueError(f"{VIRTUAL_DEVICES_ENV} must be >= 1, got {env!r}")
        return n
    return torch.cuda.device_count() if device_type == "cuda" else 1


def torchrun_env() -> bool:
    """True in a process that torchrun started (RANK, WORLD_SIZE and
    MASTER_ADDR set): it is one rank of a group of WORLD_SIZE."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"))


def device_count(device_type: str) -> int:
    """The global device count: the ranks of an initialised group (or of
    torchrun's environment), else this host's devices times the processes
    of initialize_distributed."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_world_size()
    if torchrun_env():
        return int(os.environ["WORLD_SIZE"])
    n = local_device_count(device_type)
    return n * (_MULTIHOST.num_processes if _MULTIHOST is not None else 1)


def resolve(data: int, model: int, time: int, n: int) -> MeshShape:
    """JAX make_mesh's axis resolution and errors: data -1 takes every
    device left over by model × time."""
    if data == -1:
        if n % (model * time) != 0:
            raise ValueError(f"{n} devices not divisible by model*time={model * time}")
        data = n // (model * time)
    if data * model * time > n:
        raise ValueError(
            f"mesh {data}x{model}x{time} needs {data * model * time} devices, have {n}"
        )
    return MeshShape(data, model, time)


def mesh_from_config(mesh_cfg, device_type: str = "cuda") -> Optional[MeshShape]:
    """The mesh of a MeshConfig (JAX mesh_from_config): None when it
    resolves to one device, and the plain one-device path then runs."""
    s = resolve(mesh_cfg.data, mesh_cfg.model, mesh_cfg.time, device_count(device_type))
    return None if s.size <= 1 else s


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device_type: str = "cuda") -> int:
    """Multi-host setup (JAX core/mesh.py:72-91): record that this process
    is process_id of num_processes meeting at coordinator_address
    (host:port). A mesh run then starts this host's ranks, rank
    process_id × local + local_rank of num_processes × local, under
    init_process_group(init_method="tcp://host:port"). No-op without an
    address. Returns the global device count."""
    global _MULTIHOST
    if coordinator_address is not None:
        p = int(num_processes or 1)
        i = int(process_id or 0)
        if not 0 <= i < p:
            raise ValueError(f"process_id {i} out of range for {p} processes")
        _MULTIHOST = MultiHost(coordinator_address, p, i)
    return device_count(device_type)


def multihost() -> Optional[MultiHost]:
    return _MULTIHOST


def local_batch_slice(global_batch: int, mesh: "Mesh") -> slice:
    """This rank's rows of a [global_batch, ...] array (JAX
    core/mesh.py:94-100, per data coordinate: the ranks of one data
    coordinate hold the same rows)."""
    per = global_batch // mesh.shape.data
    d = mesh.coords[0]
    return slice(d * per, (d + 1) * per)


class Mesh:
    """This rank's place in the (data, model, time) grid of an initialised
    process group, with its groups along each axis (None where the axis
    has one rank) and over the data × time ranks of its model coordinate.
    Every rank creates every group, in the same order."""

    def __init__(self, shape: MeshShape, device: torch.device):
        import torch.distributed as dist

        world = dist.get_world_size()
        if world != shape.size:
            raise ValueError(f"mesh {shape} needs {shape.size} ranks, the group has {world}")
        self.shape = shape
        self.rank = dist.get_rank()
        self.device = torch.device(device)
        self.backend = dist.get_backend()
        grid = np.arange(shape.size).reshape(tuple(shape))
        self.coords: Tuple[int, int, int] = tuple(int(c) for c in np.unravel_index(self.rank, tuple(shape)))
        self.groups: Dict[str, object] = {}
        for axis, k in enumerate(AXES):
            self.groups[k] = self._axis_group(grid, [axis])
        self.groups["data_time"] = self._axis_group(grid, [0, 2])

    def _axis_group(self, grid: np.ndarray, axes: List[int]):
        """The group of this rank's line (plane) along `axes`, creating
        those of every other line too; None for a group of one."""
        import torch.distributed as dist

        keep = [a for a in range(3) if a not in axes]
        lines = np.moveaxis(grid, keep + axes, list(range(3)))
        lines = lines.reshape(-1, int(np.prod([grid.shape[a] for a in axes])))
        if lines.shape[1] == 1:
            return None
        mine = None
        for ranks in lines:
            g = dist.new_group(ranks=[int(r) for r in ranks])
            if self.rank in ranks:
                mine = g
        return mine

    def size(self, axis: str) -> int:
        return getattr(self.shape, axis)

    def coord(self, axis: str) -> int:
        return self.coords[AXES.index(axis)]

    def group(self, axis: str):
        return self.groups[axis]

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def barrier(self) -> None:
        """A barrier of every rank, as an all_reduce (the collectives that
        gloo runs on CUDA tensors: all_reduce, all_gather, broadcast)."""
        import torch.distributed as dist

        dist.all_reduce(torch.zeros(1, device=self.device))

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank} at {self.coords}, {self.device}, "
                f"{self.backend})")


# the mesh the model runs under on this thread (use_mesh), and whether the
# T axis of the activations is this rank's slice (False inside a region
# that gathered it)
_ACTIVE = threading.local()


def active_mesh() -> Optional[Mesh]:
    return getattr(_ACTIVE, "mesh", None)


def mesh_state() -> Tuple[Optional[Mesh], bool]:
    """This thread's (mesh, full_t): what use_mesh then full_time enter
    again on another thread."""
    return active_mesh(), getattr(_ACTIVE, "full_t", False)


def time_sharded() -> bool:
    """True when the activations' T axis is split over the time group."""
    mesh = active_mesh()
    return mesh is not None and mesh.shape.time > 1 and not getattr(_ACTIVE, "full_t", False)


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Run the model's forward (and backward) on `mesh`: BatchNorm,
    dropout, the tensor-parallel Dense layers and the T gathers read it."""
    prev = (active_mesh(), getattr(_ACTIVE, "full_t", False))
    _ACTIVE.mesh, _ACTIVE.full_t = mesh, False
    try:
        yield mesh
    finally:
        _ACTIVE.mesh, _ACTIVE.full_t = prev


@contextlib.contextmanager
def full_time(on: bool = True):
    """Inside: the activations hold the whole window (gathered over T)."""
    prev = getattr(_ACTIVE, "full_t", False)
    _ACTIVE.full_t = prev or on
    try:
        yield
    finally:
        _ACTIVE.full_t = prev
