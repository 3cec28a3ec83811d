"""Elastic re-sharding: move live particle state between device layouts.

The port of the JAX package's `parallel/resharding.py`: the reference's
live adapter re-assignment (`Particles.cpp:458-537` + `Compute::CopyState`,
`Compute.cpp:303-410`) generalized to meshes. The caller drains first;
`reshard_state` then moves bits, never recomputes them, so a trajectory
continues bitwise across it. Between two meshes of one process group the
bits move through the process all-gather and each process's own shards
(as `jax.device_put` does on a pod), so every process calls it.
"""

from __future__ import annotations

from typing import Union

import torch

from multi_adapter_particles_torch.models.state import ParticleState
from multi_adapter_particles_torch.parallel.mesh import Mesh
from multi_adapter_particles_torch.parallel.sharded import (
    ShardedState,
    shard_state,
)


def reshard_state(state: Union[ParticleState, ShardedState],
                  target: Union[Mesh, torch.device, str]
                  ) -> Union[ParticleState, ShardedState]:
    """Re-place a state (on one device or a mesh) onto a new mesh
    (particle-sharded) or onto one device; always a copy."""
    if isinstance(target, Mesh):
        return shard_state(state, target)
    if isinstance(state, ShardedState):
        return state.gather(target)
    return state.to(target)
