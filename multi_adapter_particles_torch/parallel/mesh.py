"""The device mesh, the sharded tensor layout and the mesh's collectives.

The port of the JAX package's `parallel/mesh.py`. A `Mesh` is a list of
torch devices with one logical axis, `"particles"`, or two, (`"slices"`,
`"particles"`), in slice-major order. Rank r is the r-th entry of that
list. A device may appear more than once: each entry is one shard, so a
CPU test or a single card runs a mesh of D shards on one device, the role
the JAX suite's virtual CPU devices play.

A mesh may span the processes of a `parallel.bootstrap` group: `owners[r]`
is the process that holds rank r (each process's ranks contiguous, in
process order), and a process touches only its own ranks
(`local_ranks`); the other entries of `devices` name other processes'
devices. With no group every rank is local.

Rank r owns columns [r N/D, (r+1) N/D) of the SoA planes `position[4, Np]`
and `velocity[3, Np]` (`particle_sharding`); a `Sharded` holds this
process's shards, each a contiguous tensor on its rank's device. Padding
stays parked at 1e9, so shards need no masks.

The collectives the sharded step and the sharded render use are the
functions below, and nothing else moves data between ranks: all-gather in
rank order, all-reduce summed in rank order, reduce-scatter, all-to-all
and a ring rotation. Each takes this process's members of one group (in
group order) and returns one tensor a member, on that member's device.
Between processes they only move bits (one packed buffer for each pair of
processes an exchange, `_swap`); every sum is taken where its result
lives, in member order (`_ordered_sum`). No float atomics and no order
that depends on timing, so members on devices of one kind hold the same
bits, a run is the same from run to run (the determinism promise of
`config.py`), and a mesh over processes gives the bits of the same mesh
in one process. Members that share a device share the result tensor (read
only).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from multi_adapter_particles_torch.parallel import bootstrap

AXIS = "particles"
OUTER_AXIS = "slices"  # the outer (slower) dimension of multi-slice layouts

Tensor = torch.Tensor


class Mesh:
    """Devices over the axes `axis_names` (sizes `shape`), flattened
    slice-major into `devices`: rank = slice * shape[AXIS] + inner.
    `owners[r]` is the process of rank r in `comm` (default: every rank in
    this one process, no group)."""

    def __init__(self, devices: Sequence, axis_names: Tuple[str, ...],
                 shape: Tuple[int, ...], owners: Optional[Sequence] = None,
                 comm: Optional[bootstrap.ProcessGroup] = None):
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, shape))
        size = 1
        for s in shape:
            size *= s
        if size != len(self.devices) or size < 1:
            raise ValueError(f"mesh shape {shape} does not hold "
                             f"{len(self.devices)} devices")
        self.owners = tuple(owners) if owners is not None else (0,) * size
        if len(self.owners) != size:
            raise ValueError(f"{len(self.owners)} owners for {size} ranks")
        self.comm = comm
        me = comm.rank if comm is not None else 0
        self.local_ranks = [r for r, o in enumerate(self.owners) if o == me]
        if not self.local_ranks:
            raise ValueError("a mesh with no rank on this process")
        self._local_index = {r: i for i, r in enumerate(self.local_ranks)}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def local_devices(self) -> List[torch.device]:
        """This process's ranks' devices, in rank order."""
        return [self.devices[r] for r in self.local_ranks]

    def local_index(self, r: int) -> int:
        """Rank r's position among this process's ranks."""
        try:
            return self._local_index[r]
        except KeyError:
            raise ValueError(f"rank {r} is held by process "
                             f"{self.owners[r]}, not this one") from None

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
                tuple(self.shape.values()), self.owners)

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __repr__(self):
        procs = (f", {len(set(self.owners))} processes"
                 if self.comm is not None else "")
        return f"Mesh({self.shape}, {[str(d) for d in self.devices]}{procs})"


def _default_devices() -> List[torch.device]:
    """This process's own device within a process group, else every GPU."""
    if bootstrap.process_group() is not None:
        return [bootstrap.local_render_device()]
    if not torch.cuda.is_available():
        raise RuntimeError("no GPU: name the mesh's devices")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _span(devices: Sequence) -> Tuple[List, Optional[List[int]],
                                      Optional[bootstrap.ProcessGroup]]:
    """(devices, owners, group): within a process group, every process's
    `devices` in process order (a collective: every process calls it);
    else these devices alone."""
    comm = bootstrap.process_group()
    if comm is None:
        return list(devices), None, None
    lists: List = [None] * comm.world
    dist.all_gather_object(lists, [str(d) for d in devices])
    return ([d for part in lists for d in part],
            [p for p, part in enumerate(lists) for _ in part], comm)


def make_mesh(devices: Optional[Sequence] = None,
              n_devices: Optional[int] = None) -> Mesh:
    """1-D mesh over the given devices (default: every GPU). Within a
    process group the devices are this process's own (default: its
    `local_render_device`) and the mesh spans every process's, in
    process order."""
    if devices is None:
        devices = _default_devices()[:n_devices]
    devices, owners, comm = _span(devices)
    return Mesh(devices, (AXIS,), (len(devices),), owners, comm)


def make_multislice_mesh(num_slices: int,
                         devices: Optional[Sequence] = None) -> Mesh:
    """2-D (slices, particles) mesh: the ring of the sharded all-pairs step
    rotates blocks along the inner axis and makes one outer rotation per
    full inner cycle. Spans a process group as `make_mesh` does."""
    devices, owners, comm = _span(_default_devices() if devices is None
                                  else devices)
    if len(devices) % num_slices:
        raise ValueError(
            f"{len(devices)} devices not divisible into {num_slices} slices")
    return Mesh(devices, (OUTER_AXIS, AXIS),
                (num_slices, len(devices) // num_slices), owners, comm)


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
    """A [C, N] plane split along its columns over a mesh: `shards[i]`
    holds the columns of rank `mesh.local_ranks[i]` on its device (every
    rank, in rank order, when the mesh is one process's)."""

    __slots__ = ("shards", "mesh")

    def __init__(self, shards: Sequence[Tensor], mesh: Mesh):
        if len(shards) != len(mesh.local_ranks):
            raise ValueError(f"{len(shards)} shards for the "
                             f"{len(mesh.local_ranks)} ranks of this "
                             f"process (mesh of {mesh.size})")
        self.shards = tuple(shards)
        self.mesh = mesh

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.shards[0].shape[0],
                self.shards[0].shape[1] * self.mesh.size)

    def gather(self, device, cols: Optional[int] = None) -> Tensor:
        """The first `cols` columns (default all) as one tensor on
        `device`, in global column order (the JAX package's
        `gather_positions`: across processes an all-gather, which every
        process calls)."""
        device = torch.device(device)
        cols = self.shape[1] if cols is None else cols
        parts, left = [], cols
        for s in gather_ranks(self.mesh, self.shards):
            if left <= 0:
                break
            parts.append(s[:, :left].to(device))
            left -= s.shape[1]
        return torch.cat(parts, dim=1)


def shard(x: Tensor, mesh: Mesh) -> Sharded:
    """Split plane x [C, N] over the mesh: each of this process's shards a
    fresh contiguous copy of its columns on its rank's device (bits moved,
    never recomputed)."""
    cols = particle_sharding(mesh, x.shape[1])
    out = []
    for r in mesh.local_ranks:
        lo, hi = cols[r]
        buf = torch.empty((x.shape[0], hi - lo), dtype=x.dtype,
                          device=mesh.devices[r])
        out.append(buf.copy_(x[:, lo:hi]))
    return Sharded(out, mesh)


# -- moves between processes ---------------------------------------------------


def _as_bytes(t: Tensor) -> Tensor:
    t = t.contiguous()
    if t.is_complex():
        t = torch.view_as_real(t)
    return t.reshape(-1).view(torch.uint8)


def _from_bytes(b: Tensor, shape, dtype) -> Tensor:
    if dtype.is_complex:
        real = torch.empty((), dtype=dtype).real.dtype
        return torch.view_as_complex(b.view(real).reshape(*shape, 2))
    return b.view(dtype).reshape(shape)


def _nbytes(shape, dtype) -> int:
    n = torch.empty((), dtype=dtype).element_size()
    for s in shape:
        n *= s
    return n


def _swap(comm: bootstrap.ProcessGroup, sends: Dict[int, List[Tensor]],
          recvs: Dict[int, List[Tuple[torch.Size, torch.dtype]]]
          ) -> Dict[int, List[Tensor]]:
    """One exchange between processes: process q gets `sends[q]` packed in
    one buffer, and the pieces `recvs[q]` (shape, dtype) come back from q
    in the order q packs them. Staged through host memory under gloo."""
    dev = torch.device("cpu") if comm.staged else comm.device
    ops, inbox = [], {}
    for q in sorted(set(sends) | set(recvs)):
        if sends.get(q):
            buf = torch.cat([_as_bytes(t.to(dev)) for t in sends[q]])
            ops.append(dist.P2POp(dist.isend, buf, q, group=comm.data_group))
        if recvs.get(q):
            size = sum(_nbytes(s, d) for s, d in recvs[q])
            inbox[q] = torch.empty(size, dtype=torch.uint8, device=dev)
            ops.append(dist.P2POp(dist.irecv, inbox[q], q,
                                  group=comm.data_group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    out = {}
    for q, buf in inbox.items():
        pieces, off = [], 0
        for shape, dtype in recvs[q]:
            n = _nbytes(shape, dtype)
            pieces.append(_from_bytes(buf[off:off + n], shape, dtype))
            off += n
        out[q] = pieces
    return out


def _gather_all(mesh: Mesh, group: Sequence[int],
                xs: Sequence[Tensor]) -> List[Tensor]:
    """Every member's tensor of `group` (member order) on this process:
    its own members' as given (xs, group order), the others' received
    (each sent once to each process that holds a member)."""
    local = [r for r in group if r in mesh._local_index]
    have = dict(zip(local, xs))
    if len(local) == len(group):
        return [have[r] for r in group]
    me, ref = mesh.comm.rank, xs[0]
    peers = {mesh.owners[r] for r in group} - {me}
    sends = {q: list(xs) for q in peers}
    recvs = {q: [(ref.shape, ref.dtype) for r in group if mesh.owners[r] == q]
             for q in peers}
    got = _swap(mesh.comm, sends, recvs)
    for q in peers:
        have.update(zip([r for r in group if mesh.owners[r] == q], got[q]))
    return [have[r] for r in group]


def _pieces(mesh: Mesh, group: Sequence[int], xs: Sequence[Tensor],
            piece: Callable[[Tensor, int], Tensor],
            sources: Callable[[int], Sequence[int]]) -> List[List[Tensor]]:
    """For each of this process's members m of `group` (xs: their tensors,
    group order; m a member index), the pieces `piece(x_i, m)` of the
    members i in `sources(m)`, in that order, on m's device. Each piece
    crosses between processes once."""
    k = len(group)
    xi = {i: x for i, x in zip([i for i in range(k)
                                if group[i] in mesh._local_index], xs)}
    owner = [mesh.owners[r] for r in group]
    me = mesh.comm.rank if mesh.comm is not None else 0
    sends: Dict[int, List[Tensor]] = {}
    recvs: Dict[int, List] = {}
    for m in range(k):
        for i in sources(m):
            if owner[m] != me and owner[i] == me:
                sends.setdefault(owner[m], []).append(piece(xi[i], m))
            elif owner[m] == me and owner[i] != me:
                p = piece(xs[0], m)
                recvs.setdefault(owner[i], []).append((p.shape, p.dtype))
    got = _swap(mesh.comm, sends, recvs) if sends or recvs else {}
    out = []
    for m in sorted(xi):
        dev = mesh.devices[group[m]]
        row = []
        for i in sources(m):
            if owner[i] == me:
                row.append(piece(xi[i], m).to(dev))
            else:
                row.append(got[owner[i]].pop(0).to(dev))
        out.append(row)
    return out


# -- collectives ---------------------------------------------------------------
# Each takes the mesh, a rank group (member order) and xs (this process's
# members' tensors, in that order), and returns one tensor a member of
# this process, on its device.


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


def _local_devices(mesh: Mesh, group: Sequence[int]) -> List[torch.device]:
    return [mesh.devices[r] for r in group if r in mesh._local_index]


def all_gather(mesh: Mesh, group: Sequence[int], xs: Sequence[Tensor],
               dim: int = 1) -> List[Tensor]:
    """Every member gets the members' tensors concatenated along `dim` in
    member order."""
    full = _gather_all(mesh, group, xs)
    return _per_device(_local_devices(mesh, group),
                       lambda dev: torch.cat([x.to(dev) for x in full],
                                             dim=dim))


def all_reduce(mesh: Mesh, group: Sequence[int],
               xs: Sequence[Tensor]) -> List[Tensor]:
    """Every member gets the sum of the members' tensors, summed in member
    order."""
    full = _gather_all(mesh, group, xs)
    return _per_device(_local_devices(mesh, group),
                       lambda dev: _ordered_sum(full, dev))


def reduce_scatter(mesh: Mesh, group: Sequence[int], xs: Sequence[Tensor],
                   dim: int = 0) -> List[Tensor]:
    """Member m gets chunk m (of len(group) equal chunks along `dim`) of
    the member-ordered sum."""
    k = len(group)
    rows = _pieces(mesh, group, xs, lambda x, m: x.chunk(k, dim=dim)[m],
                   lambda m: range(k))
    return [_ordered_sum(row, dev)
            for row, dev in zip(rows, _local_devices(mesh, group))]


def all_to_all(mesh: Mesh, group: Sequence[int], xs: Sequence[Tensor],
               split_dim: int, concat_dim: int) -> List[Tensor]:
    """Member m gets chunk m (along `split_dim`) of every member's tensor,
    concatenated along `concat_dim` in member order."""
    k = len(group)
    rows = _pieces(mesh, group, xs,
                   lambda x, m: x.chunk(k, dim=split_dim)[m],
                   lambda m: range(k))
    return [torch.cat(row, dim=concat_dim) for row in rows]


def ring_rotate(mesh: Mesh, group: Sequence[int],
                xs: Sequence[Tensor]) -> List[Tensor]:
    """One ring step: member i's tensor moves to member i + 1 (mod the
    group), so member m gets member m - 1's."""
    k = len(group)
    rows = _pieces(mesh, group, xs, lambda x, m: x,
                   lambda m: [(m - 1) % k])
    return [row[0] for row in rows]


def over_groups(mesh: Mesh, axis: Optional[str], fn: Callable,
                xs: Sequence[Tensor], **kw) -> List[Tensor]:
    """Apply collective `fn` within each group of `axis` (None = all ranks)
    to this process's ranks' tensors xs (in `mesh.local_ranks` order); ->
    their results, in that order."""
    out: List[Optional[Tensor]] = [None] * len(mesh.local_ranks)
    for g in mesh.groups(axis):
        mine = [r for r in g if r in mesh._local_index]
        if not mine:
            continue
        res = fn(mesh, g, [xs[mesh.local_index(r)] for r in mine], **kw)
        for r, t in zip(mine, res):
            out[mesh.local_index(r)] = t
    return out


def gather_ranks(mesh: Mesh, xs: Sequence[Tensor]) -> List[Tensor]:
    """Every rank's tensor, in rank order, on this process (xs: this
    process's ranks' tensors); its own as given, the others' received.
    Across processes every process calls it."""
    return _gather_all(mesh, list(range(mesh.size)), xs)
