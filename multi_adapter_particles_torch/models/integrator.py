"""Central-well integrator over SoA ParticleState (plain torch).

The reference's `Compute::Simulate` dispatch (`Compute.cpp:1009-1055`) is a
step `state -> state`. The JAX package donates the input buffer to the
output; here the caller may pass `out`, the other half of a preallocated
pair (see `runtime/compute_engine.py`), and the step writes the new state
there instead of into the state it reads.

This is the plain path — the one the compute engine runs on the CPU and
the twin of the fused CUDA kernel in `ops/central_well.py` — with the JAX
package's op order (`models/integrator.py:39-48,109-139`), so a CPU run
tracks the JAX package's to float32 rounding.

The `num_sim` knob (`Particles.cpp:265`, `Compute.cpp:1041`: dispatch
ceil(numSim/64) groups, the rest of the buffer keeps its old values) is a
lane mask: particles past num_sim rounded up to 64 keep their old state
bit for bit, and are copied into the fresh buffer.

Only `central_well` is ported; the self-gravity models raise.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from multi_adapter_particles_torch import constants as C
from multi_adapter_particles_torch.config import SimConfig
from multi_adapter_particles_torch.models.state import ParticleState

Tensor = torch.Tensor

# ROADMAP queue 1 items that port the other force models.
NOT_PORTED_FORCE = {
    "all_pairs": "queue 1 item 8",
    "pm_grid": "queue 1 item 9",
    "p3m": "queue 1 items 10-11",
}


def require_ported_force(config: SimConfig) -> None:
    """Raise for a force model this package does not run yet."""
    if config.force_model != "central_well":
        raise NotImplementedError(
            f"force model {config.force_model!r} is not ported to "
            f"multi_adapter_particles_torch yet (ROADMAP "
            f"{NOT_PORTED_FORCE[config.force_model]})"
        )


def central_well_accel(position: Tensor, mass: float,
                       softening_squared: float) -> Tensor:
    """accel = r * (-mass / (|r|^2 + eps^2)^{3/2}), r = pos.xyz
    (`nBodyGravityCS.hlsl:92-101`)."""
    r = position[:3]
    dist_sqr = torch.sum(r * r, dim=0) + softening_squared
    inv_dist = -torch.rsqrt(dist_sqr)
    s = (inv_dist * inv_dist * inv_dist) * mass
    return r * s


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


def make_step(config: SimConfig) -> Callable[..., ParticleState]:
    """The plain `step(state, num_sim=None, out=None) -> ParticleState`.
    With `out` the result is written into that state's tensors (which must
    not be `state`'s)."""
    require_ported_force(config)

    def step(state: ParticleState, num_sim: Optional[int] = None,
             out: Optional[ParticleState] = None) -> ParticleState:
        accel = central_well_accel(state.position, config.mass,
                                   config.softening_squared)
        new_pos, new_vel = euler_update(state.position, state.velocity,
                                        accel, config.dt, config.damping)
        new = _apply_num_sim_mask(new_pos, new_vel, state, num_sim)
        if out is None:
            return new
        out.position.copy_(new.position)
        out.velocity.copy_(new.velocity)
        return out

    return step
