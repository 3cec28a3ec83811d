"""Compute engine: owns the sim device, the step, and the particle state.

The reference's `class Compute` (`Particles/Compute.{h,cpp}`) owns a compute
queue, ping-pong UAV buffers, the compiled CSMain PSO, and a shared fence.
Here:

- the "queue" is the device's current CUDA stream (eager launches return
  before the device finishes);
- the ping-pong pair is two preallocated states that swap every step: the
  step reads `state` and writes the other one, never in place — the render
  engine may hold a zero-copy alias of `state` (async mode) and draws it
  stale-by-one;
- the "PSO" is the fused CUDA kernel (`ops/central_well.py`) iff the device
  is CUDA, else the plain torch step (`models/integrator.py`);
- the shared fence is stream order: `positions` handed to the render engine
  is the fence value (`Compute::GetFenceValue`, `Compute.cpp:446`);
- `wait_for_gpu` is a hard device sync;
- constructing with `prev=` migrates state from a dying engine on another
  device — the `Compute::CopyState` live-reassignment path
  (`Compute.cpp:303-410`) as one tensor copy per plane.

The Intel queue-throttle extension (`ExtensionHelper`) has no CUDA
meaning; `use_queue_extension` is accepted and does nothing.
"""

from __future__ import annotations

from typing import Optional

import torch

from multi_adapter_particles_torch.config import SimConfig
from multi_adapter_particles_torch.models import init as pinit
from multi_adapter_particles_torch.models import integrator
from multi_adapter_particles_torch.models.state import ParticleState
from multi_adapter_particles_torch.ops.central_well import central_well_step
from multi_adapter_particles_torch.utils.metrics import MetricsRegistry
from multi_adapter_particles_torch.utils.timers import sync


class ComputeEngine:
    """Simulation role bound to one torch device.

    `simulate()` is fire-and-forget (async launches), mirroring
    `Compute::Simulate`'s ExecuteCommandLists + Signal (`Compute.cpp:1009-1055`).
    """

    def __init__(
        self,
        sim_config: SimConfig,
        device,
        metrics: Optional[MetricsRegistry] = None,
        prev: Optional["ComputeEngine"] = None,
        seed: int = 0,
    ):
        self.config = sim_config
        self.device = torch.device(device)
        self.metrics = metrics or MetricsRegistry()
        self.use_kernel = self.device.type == "cuda"
        # raises for a force model not ported yet
        self._plain_step = integrator.make_step(sim_config)
        self.step_count = 0  # the shared fence value analog

        if prev is not None:
            # CopyState: drain the old engine, then migrate the state
            prev.wait_for_gpu()
            state = prev.state.to(self.device)
            self.step_count = prev.step_count
        else:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            state = pinit.initialize_particles_device(
                sim_config.num_particles, generator=gen, device=self.device
            )
        self._set_state(state)

    def _set_state(self, state: ParticleState) -> None:
        self.state = state
        self._spare = state.empty_like()  # the other half of the pair

    # -- frame ops ---------------------------------------------------------------
    def simulate(self, num_sim: Optional[int] = None) -> ParticleState:
        """One async step into the spare buffer, then swap. Returns the new
        state (also kept on self)."""
        cfg = self.config
        out = self._spare
        if self.use_kernel:
            central_well_step(
                self.state.position, self.state.velocity,
                dt=cfg.dt, damping=cfg.damping, mass=cfg.mass,
                softening_squared=cfg.softening_squared,
                num_live=integrator.live_count(
                    num_sim, self.state.padded_count
                ),
                out=(out.position, out.velocity),
            )
        else:
            self._plain_step(self.state, num_sim, out=out)
        self._spare, self.state = self.state, out
        self.step_count += 1
        self.metrics.count(
            "interactions",
            float(num_sim if num_sim is not None else cfg.num_particles),
        )
        return self.state

    @property
    def positions(self) -> torch.Tensor:
        """The shared-buffer handle the render side consumes
        (`Compute::GetSharedHandles` analog)."""
        return self.state.position

    def get_fence_value(self) -> int:
        return self.step_count

    def wait_for_gpu(self) -> None:
        """Drain: hard device sync (`Compute::WaitForGpu`)."""
        sync(self.state.position)

    # -- snapshots ---------------------------------------------------------------
    def snapshot(self) -> ParticleState:
        """Host-side copy of the state (positions + velocities)."""
        self.wait_for_gpu()
        return self.state.to("cpu")

    def restore(self, host_state: ParticleState) -> None:
        self.wait_for_gpu()
        self._set_state(host_state.to(self.device))
