"""Mesh-backed compute engine: the multi-device "compute adapter".

The port of the JAX package's `parallel/mesh_engine.py`. It presents the
interface of `runtime/compute_engine.ComputeEngine` (simulate / positions
/ wait_for_gpu / fence / snapshot-restore / overflow / outside), so the
orchestrator treats a whole mesh as one adapter:

- `sharded` is the live `ShardedState`; each step writes the other half
  of a ping-pong pair of sharded states, never in place, so the render
  may read `positions` (the `Sharded` position planes) stale-by-one;
- `state` is the whole state gathered onto this process's first rank's
  device (a copy, made once per step when asked for): what
  `-diagnostics`, `-checkpoint` and the debug layer read, as the JAX
  package's gauges read its global array;
- construction with `prev=` migrates the state of any other engine (one
  device or a mesh): the live adapter re-assignment and the elastic
  rescale (`Compute::CopyState`, `Compute.cpp:303-410`), bits moved, not
  recomputed.

Over a mesh that spans a process group every process builds the engine
from the same seed (the same whole state, each keeping its own ranks'
columns) and calls `simulate` in step; `state`, `snapshot` and a
migration gather across processes, so every process calls them too.

A step runs inside the `step` span, a drain inside `wait`
(`runtime/trace.py`).
"""

from __future__ import annotations

from typing import Optional

import torch

from multi_adapter_particles_torch.config import SimConfig
from multi_adapter_particles_torch.models import init as pinit
from multi_adapter_particles_torch.models.state import ParticleState
from multi_adapter_particles_torch.parallel import sharded as shmod
from multi_adapter_particles_torch.parallel.mesh import Mesh, Sharded
from multi_adapter_particles_torch.runtime import trace
from multi_adapter_particles_torch.runtime.compute_engine import interactions
from multi_adapter_particles_torch.utils.metrics import MetricsRegistry


class MeshComputeEngine:
    def __init__(
        self,
        sim_config: SimConfig,
        mesh: Mesh,
        metrics: Optional[MetricsRegistry] = None,
        prev=None,
        seed: int = 0,
        bit_stable: Optional[bool] = None,
    ):
        self.config = sim_config
        self.mesh = mesh
        self.metrics = metrics or MetricsRegistry()
        self._step = shmod.make_sharded_step(sim_config, mesh,
                                             bit_stable=bit_stable)
        self.step_count = 0
        if prev is not None:
            prev.wait_for_gpu()
            source = getattr(prev, "sharded", None)
            state = shmod.shard_state(
                source if source is not None else prev.state, mesh)
            self.step_count = prev.get_fence_value()
        else:
            # born on this process's first rank's device, as one device
            # would be, then sharded (a one-time cost)
            gen = torch.Generator(device=self.device).manual_seed(seed)
            state = shmod.shard_state(pinit.initialize_particles_device(
                sim_config.num_particles, generator=gen, device=self.device
            ), mesh)
        self._set_state(state)

    def _set_state(self, state: shmod.ShardedState) -> None:
        self.sharded = state
        self._spare = state.empty_like()
        self._gathered = None

    # -- engine interface ------------------------------------------------------
    @property
    def device(self) -> torch.device:
        """This process's first rank's device."""
        return self.mesh.local_devices[0]

    def simulate(self, num_sim: Optional[int] = None,
                 stage_timer=None) -> shmod.ShardedState:
        """One async step of every shard into the spare state, then swap.
        `stage_timer` gets the "simulate" mark after the last shard."""
        with trace.span("step"):
            out = self._spare
            self._step(self.sharded, num_sim, out=out)
            if stage_timer is not None:
                stage_timer.mark("simulate")
            self._spare, self.sharded = self.sharded, out
            self._gathered = None
            self.step_count += 1
            self.metrics.count("interactions", interactions(
                self.config, num_sim, self.sharded.padded_count))
            return self.sharded

    @property
    def positions(self) -> Sharded:
        """The sharded positions the render side consumes."""
        return self.sharded.position

    @property
    def state(self) -> ParticleState:
        """The whole state on `device` (gathered at most once a step)."""
        if self._gathered is None:
            self._gathered = self.sharded.gather(self.device)
        return self._gathered

    @property
    def overflow(self):
        """The near field's count of the last p3m step (slots: a 0-d
        tensor; tree: dropped block pairs), None for the other models."""
        return self._step.overflow

    @property
    def outside(self):
        """None: the sharded mesh step keeps no count of particles outside
        the mesh."""
        return None

    def get_fence_value(self) -> int:
        return self.step_count

    def wait_for_gpu(self) -> None:
        """Drain this process's CUDA devices of the mesh."""
        with trace.span("wait"):
            for dev in set(self.mesh.local_devices):
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)

    def snapshot(self) -> ParticleState:
        """Host-side copy of the whole state."""
        self.wait_for_gpu()
        return self.sharded.gather("cpu")

    def restore(self, host_state: ParticleState) -> None:
        self.wait_for_gpu()
        state = shmod.shard_state(host_state, self.mesh)
        if state.padded_count != self.sharded.padded_count:
            raise ValueError("the restored state's padded count differs")
        self._set_state(state)
