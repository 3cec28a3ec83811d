"""The sharded simulation step: every force model over a mesh.

The port of the JAX package's `parallel/sharded.py` (`shard_map` + ring
position exchange). Each rank steps its own columns; the force terms that
need other ranks' particles get them through the collectives of
`parallel/mesh.py`, and the per-rank force math goes through the same
kernels as one device:

- **central_well**: no communication. On a CUDA shard the fused kernel
  (`ops/central_well.py`), else the plain step; the result is bitwise the
  one-device step (every column is independent).
- **all_pairs, `bit_stable=True` (the default)**: all-gather the positions,
  then each rank runs the rectangle kernel (`ops/allpairs.all_pairs_accel`)
  on its targets against the full [4, N] source set. Every target sums its
  sources in the same global order as the one-device directed step
  (`-rectpair`), so trajectories are bitwise the same at every mesh size,
  including 1, and across live rescale.
- **all_pairs, `bit_stable=False`**: the ring. Each stage rotates the
  block a rank holds one rank on (issued before the stage's force) and
  adds the force of the block it held; on a 2-D mesh the inner ring makes
  a full cycle per outer rotation (the hierarchical ring). The sum order
  depends on the mesh size: trajectories agree to float32 tolerance.
- **pm_grid**: each rank deposits its own particles; the grids are
  all-reduced and every rank solves the same field for its particles, or,
  where `SimConfig.pm_distributed_fft` holds and `dist_fft.supports` the
  grid, the slab-decomposed solve of `parallel/dist_fft.py`.
- **p3m**: the far field as pm_grid's default path; the near field on the
  gathered positions. Tree mode owns target blocks round-robin (block b
  belongs to rank b mod D): each rank sweeps the pairs of its blocks
  (`treeforce.near_field_tree(block_owner_fn=...)`) and the partial fields
  are all-reduced; slots mode runs the whole slot sweep on every rank.
  Either way a rank keeps its own columns.
- **num_sim freeze**: particles at or past num_sim, rounded up to 64,
  keep their old state bit for bit, by global column index.

The step returns a new `ShardedState`, or writes into `out` (the other
half of a caller's ping-pong pair, never the input). After each p3m step
`step.overflow` holds the near field's count: the slot overflow (a 0-d
tensor) or the tree's dropped block pairs (an int, the same on every
rank).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Union

import torch

from multi_adapter_particles_torch.config import SimConfig
from multi_adapter_particles_torch.models import integrator
from multi_adapter_particles_torch.models.state import ParticleState
from multi_adapter_particles_torch.ops import allpairs, p3m, pm
from multi_adapter_particles_torch.ops.central_well import central_well_step
from multi_adapter_particles_torch.parallel import dist_fft
from multi_adapter_particles_torch.parallel import mesh as M

Tensor = torch.Tensor


class ShardedState:
    """Particle state split over a mesh: `position` [4, Np] and `velocity`
    [3, Np] as `Sharded` planes (rank r: columns [r Np/D, (r+1) Np/D))."""

    __slots__ = ("position", "velocity")

    def __init__(self, position: M.Sharded, velocity: M.Sharded):
        self.position = position
        self.velocity = velocity

    @property
    def mesh(self) -> M.Mesh:
        return self.position.mesh

    @property
    def padded_count(self) -> int:
        return self.position.shape[1]

    def shard(self, r: int) -> ParticleState:
        """Rank r's columns as a one-device state (the same tensors)."""
        return ParticleState(self.position.shards[r],
                             self.velocity.shards[r])

    def gather(self, device) -> ParticleState:
        """The whole state on `device` (a copy), in global order."""
        return ParticleState(self.position.gather(device),
                             self.velocity.gather(device))

    def empty_like(self) -> "ShardedState":
        mesh = self.mesh
        return ShardedState(
            M.Sharded([torch.empty_like(s) for s in self.position.shards],
                      mesh),
            M.Sharded([torch.empty_like(s) for s in self.velocity.shards],
                      mesh))


def shard_state(state: Union[ParticleState, ShardedState],
                mesh: M.Mesh) -> ShardedState:
    """Place a state (one device, or another mesh) on `mesh`, particle-axis
    sharded: a copy of the bits."""
    if isinstance(state, ShardedState):
        state = state.gather(mesh.devices[0])
    return ShardedState(M.shard(state.position, mesh),
                        M.shard(state.velocity, mesh))


def _partial_accel_fn(cfg: SimConfig) -> Callable[[Tensor, Tensor], Tensor]:
    """(targets [4, ni], sources [4, nj]) -> accel [3, ni]: the rectangle
    kernel on CUDA tensors, its plain twin on CPU ones."""
    def f(targets: Tensor, sources: Tensor) -> Tensor:
        return allpairs.all_pairs_accel(
            targets, mass=cfg.mass, softening_squared=cfg.softening_squared,
            interaction_scale=cfg.interaction_scale, sources=sources)[:3]
    return f


def _freeze(new_pos: Tensor, new_vel: Tensor, old: ParticleState,
            live: int, out: Optional[ParticleState]) -> ParticleState:
    """Columns at or past `live` keep `old`'s values; into `out` if given."""
    n = new_pos.shape[1]
    if live < n:
        keep = (torch.arange(n, device=new_pos.device) < live)[None, :]
        new_pos = torch.where(keep, new_pos, old.position)
        new_vel = torch.where(keep, new_vel, old.velocity)
    if out is None:
        return ParticleState(new_pos, new_vel)
    out.position.copy_(new_pos)
    out.velocity.copy_(new_vel)
    return out


def make_sharded_step(
    cfg: SimConfig,
    mesh: M.Mesh,
    bit_stable: Optional[bool] = None,
) -> Callable[..., ShardedState]:
    """The `step(state, num_sim=None, out=None) -> ShardedState` of
    `cfg`'s force model on `mesh` (see the module docstring). The padded
    count must divide by the mesh size. `bit_stable` (all_pairs only;
    default True) picks the all-gather schedule over the ring."""
    ndev = mesh.size
    n_inner = mesh.shape[M.AXIS]
    multislice = M.OUTER_AXIS in mesh.axis_names
    n_outer = mesh.shape[M.OUTER_AXIS] if multislice else 1
    if bit_stable is None:
        bit_stable = True
    partial = _partial_accel_fn(cfg)
    g_const = cfg.mass * cfg.interaction_scale
    grid, box = cfg.pm_grid_size, cfg.pm_box
    use_dist_fft = (cfg.force_model == "pm_grid" and cfg.pm_distributed_fft
                    and dist_fft.supports(grid, n_inner))
    kernel_slabs = (dist_fft.make_kernel_slabs(mesh, grid, box,
                                               cfg.softening_squared)
                    if use_dist_fft else None)

    def gathered(pos: List[Tensor]) -> List[Tensor]:
        """The full [4, N] source set in global order on every rank."""
        return M.over_groups(mesh, None, M.all_gather, pos, dim=1)

    def ring(pos: List[Tensor]) -> List[Tensor]:
        """The (hierarchical) ring: D partial forces a rank, rotating the
        held blocks along the inner axis, one outer hop a full cycle."""
        acc = [torch.zeros_like(p[:3]) for p in pos]
        block = list(pos)

        def cycle(acc, block, final: bool):
            for _ in range(n_inner - 1):
                nxt = M.over_groups(mesh, M.AXIS, M.ring_rotate, block)
                acc = [a + partial(p, b) for a, p, b in zip(acc, pos, block)]
                block = nxt
            acc = [a + partial(p, b) for a, p, b in zip(acc, pos, block)]
            if not final and n_inner > 1:  # every block home again
                block = M.over_groups(mesh, M.AXIS, M.ring_rotate, block)
            return acc, block

        acc, block = cycle(acc, block, final=(n_outer == 1))
        for s in range(n_outer - 1):
            block = M.over_groups(mesh, M.OUTER_AXIS, M.ring_rotate, block)
            acc, block = cycle(acc, block, final=(s == n_outer - 2))
        return acc

    def pm_accel(pos: List[Tensor]) -> List[Tensor]:
        rho = [pm.deposit_cic(p, grid, box) for p in pos]
        if use_dist_fft:
            if multislice:
                rho = M.over_groups(mesh, M.OUTER_AXIS, M.all_reduce, rho)
            phi = dist_fft.convolve_mesh(rho, kernel_slabs, grid, mesh)
            return [pm._interp(pm._grad(f * pm._f32(g_const), grid, box),
                               p, grid, box) for f, p in zip(phi, pos)]
        rho = M.over_groups(mesh, None, M.all_reduce, rho)
        return [pm.solve_and_gather(r, p, grid, box, g_const,
                                    cfg.softening_squared)
                for r, p in zip(rho, pos)]

    def p3m_accel(pos: List[Tensor]) -> List[Tensor]:
        from multi_adapter_particles_torch.ops.treeforce import (
            near_field_tree,
        )

        r_c, gn = p3m.near_grid_for(grid, box, cfg.p3m_cutoff_cells)
        rho = M.over_groups(mesh, None, M.all_reduce,
                            [pm.deposit_cic(p, grid, box) for p in pos])
        a_far = [pm._interp(p3m._accel_long(r, grid, box, g_const, r_c), p,
                            grid, box) for r, p in zip(rho, pos)]
        full = gathered(pos)
        near = []
        for r, f in enumerate(full):
            if cfg.p3m_near_mode == "tree":
                a, step.overflow = near_field_tree(
                    f, box, g_const, cfg.softening_squared, r_c, gn,
                    pair_budget=cfg.p3m_pair_budget,
                    sub_pair_budget=cfg.p3m_sub_pair_budget,
                    block_owner_fn=lambda ids, r=r: ids % ndev == r)
            else:  # "slots" / "auto" (the data-free default)
                a, step.overflow = p3m.near_field_correction(
                    f, box, g_const, cfg.softening_squared, r_c, gn,
                    cfg.p3m_capacity)
            near.append(a)
        if cfg.p3m_near_mode == "tree":
            near = M.over_groups(mesh, None, M.all_reduce, near)
        out = []
        for r, (af, an, p) in enumerate(zip(a_far, near, pos)):
            w = p.shape[1]
            out.append(af + an[:, r * w:(r + 1) * w])
        return out

    def accel(pos: List[Tensor]) -> List[Tensor]:
        if cfg.force_model == "pm_grid":
            return pm_accel(pos)
        if cfg.force_model == "p3m":
            return p3m_accel(pos)
        if bit_stable:
            return [partial(p, f) for p, f in zip(pos, gathered(pos))]
        return ring(pos)

    def step(state: ShardedState, num_sim: Optional[int] = None,
             out: Optional[ShardedState] = None) -> ShardedState:
        if state.mesh != mesh:
            raise ValueError("the state is not on this step's mesh")
        n = state.padded_count
        if n % ndev:
            raise ValueError(f"padded count {n} not divisible by mesh size "
                             f"{ndev}")
        w = n // ndev
        eff = integrator.live_count(num_sim, n)
        olds = [state.shard(r) for r in range(ndev)]
        outs = [out.shard(r) if out is not None else None
                for r in range(ndev)]
        lives = [max(0, min(eff - r * w, w)) for r in range(ndev)]
        if cfg.force_model == "central_well":
            new = [_central_well(cfg, o, dst, live)
                   for o, dst, live in zip(olds, outs, lives)]
        else:
            acc = accel([o.position for o in olds])
            new = []
            for o, a, dst, live in zip(olds, acc, outs, lives):
                p, v = integrator.euler_update(o.position, o.velocity, a,
                                               cfg.dt, cfg.damping)
                new.append(_freeze(p, v, o, live, dst))
        if out is not None:
            return out
        return ShardedState(M.Sharded([s.position for s in new], mesh),
                            M.Sharded([s.velocity for s in new], mesh))

    step.overflow = None
    return step


def _central_well(cfg: SimConfig, old: ParticleState,
                  out: Optional[ParticleState], live: int) -> ParticleState:
    """A rank's central-well step: the fused kernel on CUDA, else the
    one-device plain step (accel, Euler, freeze)."""
    if old.device.type == "cuda":
        if out is None:
            out = old.empty_like()
        central_well_step(
            old.position, old.velocity, dt=cfg.dt, damping=cfg.damping,
            mass=cfg.mass, softening_squared=cfg.softening_squared,
            num_live=live, out=(out.position, out.velocity))
        return out
    a = integrator.central_well_accel(old.position, cfg.mass,
                                      cfg.softening_squared)
    p, v = integrator.euler_update(old.position, old.velocity, a, cfg.dt,
                                   cfg.damping)
    return _freeze(p, v, old, live, out)
