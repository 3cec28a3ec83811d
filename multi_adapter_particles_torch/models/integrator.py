"""Integrators over SoA ParticleState (plain torch around the kernels).

The reference's `Compute::Simulate` dispatch (`Compute.cpp:1009-1055`) is a
step `state -> state`. The JAX package donates the input buffer to the
output; here the caller may pass `out`, the other half of a preallocated
pair (see `runtime/compute_engine.py`), and the step writes the new state
there instead of into the state it reads.

Force models:

- `central_well_accel`: the shipped CSMain math (`nBodyGravityCS.hlsl:92-101`).
  With the Euler tail below it is the plain path of the central well — the
  one the compute engine runs on the CPU and the twin of the fused CUDA
  kernel in `ops/central_well.py`.
- `all_pairs_accel`: the O(N^2) `bodyBodyInteraction` sum
  (`nBodyGravityCS.hlsl:44-57`), the twin of the JAX package's XLA blocked
  sum with its padding mask. The engine runs the kernels of
  `ops/allpairs.py` instead (on the CPU, their plain twins), as the JAX
  engine runs its Pallas kernels; `make_accel_fn_for` makes the same choice.
- `pm_grid` (`ops/pm.py`) and `p3m` (`ops/p3m.py`: the tree near field of
  `ops/treeforce.py`, whose sweep kernels run on a CUDA state and their
  plain twins on a CPU state, or the slot near field, torch ops) with
  g_const = mass * interaction_scale, as the JAX package's
  `make_accel_fn_for` passes it. `p3m_near_mode` "auto" means slots until
  the CLI's startup probe resolves it, as in the JAX package.

The op order is the JAX package's (`models/integrator.py:39-139`), so a CPU
run tracks the JAX package's to float32 rounding.

The `num_sim` knob (`Particles.cpp:265`, `Compute.cpp:1041`: dispatch
ceil(numSim/64) groups, the rest of the buffer keeps its old values) is a
lane mask: particles past num_sim rounded up to 64 keep their old state
bit for bit, and are copied into the fresh buffer.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from multi_adapter_particles_torch import constants as C
from multi_adapter_particles_torch.config import SimConfig
from multi_adapter_particles_torch.models.state import ParticleState
from multi_adapter_particles_torch.ops import allpairs, p3m, pm

Tensor = torch.Tensor

def central_well_accel(position: Tensor, mass: float,
                       softening_squared: float) -> Tensor:
    """accel = r * (-mass / (|r|^2 + eps^2)^{3/2}), r = pos.xyz
    (`nBodyGravityCS.hlsl:92-101`)."""
    r = position[:3]
    dist_sqr = torch.sum(r * r, dim=0) + softening_squared
    inv_dist = -torch.rsqrt(dist_sqr)
    s = (inv_dist * inv_dist * inv_dist) * mass
    return r * s


def all_pairs_accel(
    position: Tensor,
    mass: float,
    softening_squared: float,
    interaction_scale: float = 1.0,
    mask: Optional[Tensor] = None,
    j_tile: int = 1024,
    sources: Optional[Tensor] = None,
) -> Tensor:
    """accel_i = sum_j (p_j - p_i) * mass*scale / (|p_j - p_i|^2 + eps^2)^{3/2}.

    The blocked sum over j-tiles; `mask` (float 0/1 per j) excludes padding
    from the sum; `sources` ([4, Nj], default = position) selects the j-side
    bodies (the split form of the multi-device ring). Self pairs contribute
    exactly zero. position [4, Np] -> accel [3, Np]."""
    p = position[:3]
    src = p if sources is None else sources[:3]
    n = src.shape[1]
    if n % j_tile != 0:
        j_tile = n  # one tile for odd sizes, as the JAX package does
    if mask is None:
        mask = torch.ones((n,), dtype=p.dtype, device=p.device)
    scale = (torch.tensor(mass, dtype=torch.float32)
             * torch.tensor(interaction_scale, dtype=torch.float32))
    acc = torch.zeros_like(p)
    for j0 in range(0, n, j_tile):
        pj = src[:, j0:j0 + j_tile]
        dx = pj[0][None, :] - p[0][:, None]
        dy = pj[1][None, :] - p[1][:, None]
        dz = pj[2][None, :] - p[2][:, None]
        d2 = dx * dx + dy * dy + dz * dz + softening_squared
        inv = torch.rsqrt(d2)
        s = (inv * inv * inv) * mask[None, j0:j0 + j_tile]
        acc = acc + torch.stack([(dx * s).sum(1), (dy * s).sum(1),
                                 (dz * s).sum(1)])
    return acc * scale


def euler_update(position: Tensor, velocity: Tensor, accel: Tensor,
                 dt: float, damping: float):
    """v += a*dt; v *= damping; p += v*dt; pos.w = |a|."""
    vel = (velocity + accel * dt) * damping
    pos_xyz = position[:3] + vel * dt
    accel_mag = torch.sqrt(torch.sum(accel * accel, dim=0))
    return torch.cat([pos_xyz, accel_mag[None, :]], dim=0), vel


def live_count(num_sim: Optional[int], padded: int) -> int:
    """Columns a num_sim step writes: num_sim rounded UP to whole 64-wide
    groups (`Compute.cpp:1041`, BLOCK_SIZE `defines.h:37`); None = all."""
    if num_sim is None:
        return padded
    return min(-(-int(num_sim) // C.BLOCK_SIZE) * C.BLOCK_SIZE, padded)


def _apply_num_sim_mask(new_pos: Tensor, new_vel: Tensor, old: ParticleState,
                        num_sim: Optional[int]) -> ParticleState:
    """Freeze particles beyond num_sim (rounded up to 64), like a short
    dispatch: their old values, bit for bit."""
    if num_sim is None:
        return ParticleState(new_pos, new_vel)
    live = torch.arange(new_pos.shape[-1], device=new_pos.device) < (
        live_count(num_sim, new_pos.shape[-1])
    )
    return ParticleState(
        torch.where(live[None, :], new_pos, old.position),
        torch.where(live[None, :], new_vel, old.velocity),
    )


def make_accel_fn_for(config: SimConfig) -> Callable[[Tensor], Tensor]:
    """The run's own accel function (position [4, Np] -> accel [3, Np]):
    exactly the force the compute engine applies each step. For all_pairs
    that is the kernel `config.all_pairs_half` selects (the half-pair or the
    rectangle schedule of `ops/allpairs.py`) on a CUDA tensor, and that
    kernel's plain twin on a CPU tensor, as the JAX package's mirrors its
    engine's Pallas choice (`models/integrator.py:183-200`)."""
    if config.force_model == "central_well":
        return functools.partial(
            central_well_accel, mass=config.mass,
            softening_squared=config.softening_squared,
        )
    if config.force_model == "pm_grid":
        return pm.make_accel_fn(
            mass=config.mass * config.interaction_scale,
            softening_squared=config.softening_squared,
            grid=config.pm_grid_size,
            box=config.pm_box,
        )
    if config.force_model == "p3m":
        return p3m.make_accel_fn(
            mass=config.mass * config.interaction_scale,
            softening_squared=config.softening_squared,
            grid=config.pm_grid_size,
            box=config.pm_box,
            cutoff_cells=config.p3m_cutoff_cells,
            capacity=config.p3m_capacity,
            near_mode=config.p3m_near_mode,
            pair_budget=config.p3m_pair_budget,
            sub_pair_budget=config.p3m_sub_pair_budget,
            half_force=config.tree_half_force,
        )
    return allpairs.make_accel_fn(
        mass=config.mass,
        softening_squared=config.softening_squared,
        interaction_scale=config.interaction_scale,
        half=config.all_pairs_half,
    )


def make_step(
    config: SimConfig,
    accel_fn: Optional[Callable[[Tensor], Tensor]] = None,
) -> Callable[..., ParticleState]:
    """The `step(state, num_sim=None, out=None) -> ParticleState` of a
    config's force model (`accel_fn` overrides it: position [4, Np] ->
    accel [3, Np]). With `out` the result is written into that state's
    tensors (which must not be `state`'s). `step.accel_fn` is the force
    function (the slot near field keeps its overflow count there)."""
    if accel_fn is None:
        accel_fn = make_accel_fn_for(config)

    def step(state: ParticleState, num_sim: Optional[int] = None,
             out: Optional[ParticleState] = None) -> ParticleState:
        accel = accel_fn(state.position)
        new_pos, new_vel = euler_update(state.position, state.velocity,
                                        accel, config.dt, config.damping)
        new = _apply_num_sim_mask(new_pos, new_vel, state, num_sim)
        if out is None:
            return new
        out.position.copy_(new.position)
        out.velocity.copy_(new.velocity)
        return out

    step.accel_fn = accel_fn
    return step
