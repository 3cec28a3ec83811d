"""Multi-process bootstrap: one `torch.distributed` process group.

The port of the JAX package's `parallel/bootstrap.py`. After
`initialize()`, `parallel.mesh.make_mesh()` / `make_multislice_mesh()`
span every process of the group (each process's devices, in rank order),
`Sharded` planes hold only this process's shards, and the mesh's
collectives move data between processes; the sharded step, the engine and
the sharded render run unchanged on top. Every process draws the same
seed-made state and keeps its own columns of it, as the JAX engine does.

On a single host `initialize()` is a no-op, so the same entry script runs
everywhere.

The group is a gloo group (the control plane: the device list a mesh is
built from); the data of the collectives goes over a second group whose
backend one rule picks, from the devices the processes name:

- NCCL when every process owns a distinct CUDA device;
- gloo otherwise: CPU ranks, or processes that share one card (NCCL
  refuses two ranks on one GPU, "Duplicate GPU detected"); CUDA tensors
  are then staged through host memory for each exchange.

A failure to create the group raises; nothing drops to one process or to
another backend.
"""

from __future__ import annotations

import os
import socket
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist


class ProcessGroup:
    """This process's membership: its rank in a group of `world`
    processes, its own `device`, and the group the collectives' data goes
    over (`data_group`, of `backend`, chosen for `reason`)."""

    __slots__ = ("rank", "world", "device", "backend", "reason",
                 "data_group")

    def __init__(self, rank: int, world: int, device: torch.device,
                 backend: str, reason: str, data_group):
        self.rank = rank
        self.world = world
        self.device = device
        self.backend = backend
        self.reason = reason
        self.data_group = data_group

    @property
    def staged(self) -> bool:
        """CUDA tensors go through host memory (gloo moves CPU tensors)."""
        return self.backend == "gloo"

    def __repr__(self):
        return (f"ProcessGroup(rank={self.rank}, world={self.world}, "
                f"device={self.device}, backend={self.backend!r})")


_group: Optional[ProcessGroup] = None


def _env_int(name: str) -> int:
    value = os.environ.get(name)
    if value is None:
        raise ValueError(f"a coordinator is named but {name} is not set "
                         "(pass it as an argument or set it, as torchrun "
                         "does)")
    return int(value)


def _own_cuda_device() -> torch.device:
    """cuda:<LOCAL_RANK or 0>; raises where there is no CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: name this process's device "
                           "(device='cpu' for CPU ranks)")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def _identity(device: torch.device) -> Tuple[str, str, str]:
    """(host, device kind, the card's UUID) naming a process's device."""
    if device.type != "cuda":
        return socket.gethostname(), device.type, ""
    props = torch.cuda.get_device_properties(device)
    return (socket.gethostname(), "cuda",
            str(getattr(props, "uuid", device.index)))


def choose_backend(identities: List[Tuple[str, str, str]]
                   ) -> Tuple[str, str]:
    """The data plane's backend for the processes' device identities (one
    `_identity` a process, in rank order) -> (backend, reason)."""
    if any(kind != "cuda" for _, kind, _ in identities):
        return "gloo", "the ranks are CPU tensors"
    if len(set(identities)) < len(identities):
        return "gloo", ("processes share one card (NCCL refuses two ranks "
                        "on one GPU): CUDA tensors staged through host "
                        "memory")
    return "nccl", "every process owns a distinct CUDA device"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> bool:
    """Join the process group of `num_processes` processes as
    `process_id`, meeting at `coordinator_address` ("host:port"); returns
    True. A no-op returning False when no coordinator is named.

    The arguments default to torchrun's environment: `MASTER_ADDR` and
    `MASTER_PORT` name the coordinator, `WORLD_SIZE` and `RANK` the rest.
    `device` is this process's own device (default cuda:<LOCAL_RANK or
    0>; the CPU only when named)."""
    # Launched iff a coordinator is named (argument or MASTER_ADDR), never
    # on RANK alone: rank "0" looks like a plain single host, and a
    # half-initialised group hangs at startup.
    address = coordinator_address
    if address is None and os.environ.get("MASTER_ADDR"):
        address = (f"{os.environ['MASTER_ADDR']}:"
                   f"{_env_int('MASTER_PORT')}")
    if address is None:
        return False
    world = _env_int("WORLD_SIZE") if num_processes is None else num_processes
    rank = _env_int("RANK") if process_id is None else process_id
    if not 0 <= int(rank) < int(world):
        raise ValueError(f"process {rank} of a group of {world}")
    own = _own_cuda_device() if device is None else torch.device(device)
    global _group
    if _group is not None or dist.is_initialized():
        raise RuntimeError("a process group already exists")
    if own.type == "cuda":
        torch.cuda.set_device(own)
    dist.init_process_group("gloo", init_method=f"tcp://{address}",
                            world_size=int(world), rank=int(rank))
    try:
        identities: List = [None] * int(world)
        dist.all_gather_object(identities, _identity(own))
        backend, reason = choose_backend(identities)
        data_group = None  # the default (gloo) group
        if backend == "nccl":
            data_group = dist.new_group(backend="nccl")
            # a first collective over every rank, before any send / recv
            dist.all_reduce(torch.zeros(1, device=own), group=data_group)
    except BaseException:
        dist.destroy_process_group()
        raise
    _group = ProcessGroup(int(rank), int(world), own, backend, reason,
                          data_group)
    return True


def process_group() -> Optional[ProcessGroup]:
    """This process's group, or None before `initialize` (one process)."""
    return _group


def is_primary() -> bool:
    """True on the process that owns the render role and IO: rank 0, or
    the only process."""
    return _group is None or _group.rank == 0


def local_render_device() -> torch.device:
    """This process's own device: the one `initialize` was given, else
    cuda:<LOCAL_RANK or 0> (raises where there is no CUDA device)."""
    return _group.device if _group is not None else _own_cuda_device()


def shutdown() -> None:
    """Leave the process group (every process calls it)."""
    global _group
    if _group is None:
        return
    _group = None
    dist.destroy_process_group()
