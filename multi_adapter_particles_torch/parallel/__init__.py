"""One-process multi-device parallelism: mesh sharding, the ring force
exchange, the distributed FFT solve, resharding and the mesh engine.

The port of the JAX package's `parallel/` (its multi-process bootstrap
aside). The reference's multi-adapter mode (compute on one GPU, render on
another, a copy queue between — `Compute.cpp:163-251`,
`Render.cpp:789-831`) maps to:

- particle state sharded over a `Mesh` of devices along the particle
  axis (a device may repeat: D shards of one card);
- the all-pairs force as an all-gather of the positions (bitwise the
  one-device directed step) or a ring that rotates position blocks;
- the render feed as a gather of the shards onto the render device, or
  the render itself sharded (`Renderer.render_mesh`);
- elastic resharding between meshes as the live adapter re-assignment.
"""

from multi_adapter_particles_torch.parallel.mesh import (
    Mesh,
    Sharded,
    make_mesh,
    make_multislice_mesh,
    mesh_devices,
)
from multi_adapter_particles_torch.parallel.sharded import (
    ShardedState,
    make_sharded_step,
    shard_state,
)
from multi_adapter_particles_torch.parallel.mesh_engine import (
    MeshComputeEngine,
)
from multi_adapter_particles_torch.parallel.resharding import reshard_state

__all__ = [
    "Mesh",
    "Sharded",
    "ShardedState",
    "make_mesh",
    "make_multislice_mesh",
    "mesh_devices",
    "make_sharded_step",
    "shard_state",
    "MeshComputeEngine",
    "reshard_state",
]
