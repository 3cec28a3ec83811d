"""The device mesh, the sharded tensor layout and the mesh's collectives.

The port of the JAX package's `parallel/mesh.py`. A `Mesh` is a list of
torch devices with one logical axis, `"particles"`, or two, (`"slices"`,
`"particles"`), in slice-major order. Rank r is the r-th entry of that
list. A device may appear more than once: each entry is one shard, so a
CPU test or a single card runs a mesh of D shards on one device, the role
the JAX suite's virtual CPU devices play.

Rank r owns columns [r N/D, (r+1) N/D) of the SoA planes `position[4, Np]`
and `velocity[3, Np]` (`particle_sharding`); a `Sharded` holds those
shards, each a contiguous tensor on its rank's device. Padding stays
parked at 1e9, so shards need no masks.

The collectives the sharded step and the sharded render use are the
functions below, and nothing else moves data between ranks, so a process
group can take their place: all-gather in rank order, all-reduce summed
in rank order, reduce-scatter, all-to-all and a ring rotation. Each takes
one tensor a member of a group, in group order, and returns one a member,
on that member's device. No float atomics and no order that depends on
timing: every member computes its result in the same order, so members
on devices of one kind hold the same bits, and a run is the same from run
to run (the determinism promise of `config.py`). Members that share a
device share the result tensor (read only).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

AXIS = "particles"
OUTER_AXIS = "slices"  # the outer (slower) dimension of multi-slice layouts

Tensor = torch.Tensor


class Mesh:
    """Devices over the axes `axis_names` (sizes `shape`), flattened
    slice-major into `devices`: rank = slice * shape[AXIS] + inner."""

    def __init__(self, devices: Sequence, axis_names: Tuple[str, ...],
                 shape: Tuple[int, ...]):
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, shape))
        size = 1
        for s in shape:
            size *= s
        if size != len(self.devices) or size < 1:
            raise ValueError(f"mesh shape {shape} does not hold "
                             f"{len(self.devices)} devices")

    @property
    def size(self) -> int:
        return len(self.devices)

    def groups(self, axis: Optional[str] = None) -> List[List[int]]:
        """Rank groups of `axis` (each the ranks that differ only in that
        axis' index, in axis order); None = one group of every rank."""
        if axis is None or self.size == 1:
            return [list(range(self.size))]
        inner = self.shape[AXIS]
        outer = self.shape.get(OUTER_AXIS, 1)
        if axis == AXIS:
            return [[s * inner + c for c in range(inner)]
                    for s in range(outer)]
        if axis == OUTER_AXIS:
            return [[s * inner + c for s in range(outer)]
                    for c in range(inner)]
        raise ValueError(f"unknown mesh axis {axis!r}")

    def _key(self):
        return (tuple(self.devices), self.axis_names,
                tuple(self.shape.values()))

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(d) for d in self.devices]})"


def _cuda_devices() -> List[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError("no GPU: name the mesh's devices")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(devices: Optional[Sequence] = None,
              n_devices: Optional[int] = None) -> Mesh:
    """1-D mesh over the given devices (default: every GPU)."""
    if devices is None:
        devices = _cuda_devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(devices, (AXIS,), (len(devices),))


def make_multislice_mesh(num_slices: int,
                         devices: Optional[Sequence] = None) -> Mesh:
    """2-D (slices, particles) mesh: the ring of the sharded all-pairs step
    rotates blocks along the inner axis and makes one outer rotation per
    full inner cycle."""
    devices = list(_cuda_devices() if devices is None else devices)
    if len(devices) % num_slices:
        raise ValueError(
            f"{len(devices)} devices not divisible into {num_slices} slices")
    return Mesh(devices, (OUTER_AXIS, AXIS),
                (num_slices, len(devices) // num_slices))


def mesh_devices(mesh: Mesh) -> List[torch.device]:
    return list(mesh.devices)


def particle_spec(mesh: Mesh) -> Tuple[str, ...]:
    """The mesh axes the particle (column) axis is split over, outer
    first: the slice-major order of the ranks."""
    return tuple(a for a in (OUTER_AXIS, AXIS) if a in mesh.axis_names)


def particle_sharding(mesh: Mesh, n: int) -> List[Tuple[int, int]]:
    """Rank r's column range [lo, hi) of an n-column plane."""
    d = mesh.size
    if n % d:
        raise ValueError(f"padded count {n} not divisible by mesh size {d}")
    w = n // d
    return [(r * w, (r + 1) * w) for r in range(d)]


class Sharded:
    """A [C, N] plane split along its columns over a mesh: `shards[r]`
    holds rank r's columns on `mesh.devices[r]`."""

    __slots__ = ("shards", "mesh")

    def __init__(self, shards: Sequence[Tensor], mesh: Mesh):
        if len(shards) != mesh.size:
            raise ValueError(f"{len(shards)} shards for a mesh of "
                             f"{mesh.size}")
        self.shards = tuple(shards)
        self.mesh = mesh

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.shards[0].shape[0],
                sum(s.shape[1] for s in self.shards))

    def gather(self, device, cols: Optional[int] = None) -> Tensor:
        """The first `cols` columns (default all) as one tensor on
        `device`, in global column order."""
        device = torch.device(device)
        cols = self.shape[1] if cols is None else cols
        parts, left = [], cols
        for s in self.shards:
            if left <= 0:
                break
            parts.append(s[:, :left].to(device))
            left -= s.shape[1]
        return torch.cat(parts, dim=1)


def shard(x: Tensor, mesh: Mesh) -> Sharded:
    """Split plane x [C, N] over the mesh: each shard a fresh contiguous
    copy of its columns on its rank's device (bits moved, never
    recomputed)."""
    out = []
    for (lo, hi), dev in zip(particle_sharding(mesh, x.shape[1]),
                             mesh.devices):
        buf = torch.empty((x.shape[0], hi - lo), dtype=x.dtype, device=dev)
        out.append(buf.copy_(x[:, lo:hi]))
    return Sharded(out, mesh)


# -- collectives ---------------------------------------------------------------
# Each takes xs (one tensor a member, group order) and the members' devices,
# and returns one tensor a member on its device.


def _per_device(devices: Sequence[torch.device],
                make: Callable[[torch.device], Tensor]) -> List[Tensor]:
    """make(device) once per distinct device, handed to every member on it."""
    done: Dict[torch.device, Tensor] = {}
    out = []
    for dev in devices:
        if dev not in done:
            done[dev] = make(dev)
        out.append(done[dev])
    return out


def _ordered_sum(xs: Sequence[Tensor], dev: torch.device) -> Tensor:
    """x_0 + x_1 + ... in member order, on `dev`."""
    total = xs[0].to(dev)
    for x in xs[1:]:
        total = total + x.to(dev)
    return total


def all_gather(xs: Sequence[Tensor], devices: Sequence[torch.device],
               dim: int = 1) -> List[Tensor]:
    """Every member gets the members' tensors concatenated along `dim` in
    member order."""
    return _per_device(
        devices, lambda dev: torch.cat([x.to(dev) for x in xs], dim=dim))


def all_reduce(xs: Sequence[Tensor],
               devices: Sequence[torch.device]) -> List[Tensor]:
    """Every member gets the sum of the members' tensors, summed in member
    order."""
    return _per_device(devices, lambda dev: _ordered_sum(xs, dev))


def reduce_scatter(xs: Sequence[Tensor], devices: Sequence[torch.device],
                   dim: int = 0) -> List[Tensor]:
    """Member k gets chunk k (of len(xs) equal chunks along `dim`) of the
    member-ordered sum."""
    k = len(xs)
    return [_ordered_sum([x.chunk(k, dim=dim)[m] for x in xs], devices[m])
            for m in range(k)]


def all_to_all(xs: Sequence[Tensor], devices: Sequence[torch.device],
               split_dim: int, concat_dim: int) -> List[Tensor]:
    """Member m gets chunk m (along `split_dim`) of every member's tensor,
    concatenated along `concat_dim` in member order."""
    k = len(xs)
    return [torch.cat([x.chunk(k, dim=split_dim)[m].to(devices[m])
                       for x in xs], dim=concat_dim) for m in range(k)]


def ring_rotate(xs: Sequence[Tensor],
                devices: Sequence[torch.device]) -> List[Tensor]:
    """One ring step: member i's tensor moves to member i + 1 (mod the
    group), so member m gets member m - 1's."""
    k = len(xs)
    return [xs[(m - 1) % k].to(devices[m]) for m in range(k)]


def over_groups(mesh: Mesh, axis: Optional[str], fn: Callable,
                xs: Sequence[Tensor], **kw) -> List[Tensor]:
    """Apply collective `fn` within each group of `axis` (None = all ranks)
    to per-rank tensors xs; -> per-rank results."""
    out: List[Optional[Tensor]] = [None] * mesh.size
    for g in mesh.groups(axis):
        res = fn([xs[r] for r in g], [mesh.devices[r] for r in g], **kw)
        for r, t in zip(g, res):
            out[r] = t
    return out
