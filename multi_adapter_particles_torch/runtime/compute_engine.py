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
- the "PSO" is, for the central well, the fused CUDA kernel
  (`ops/central_well.py`) iff the device is CUDA, else the plain torch step
  (`models/integrator.py`); for all_pairs, the step of
  `integrator.make_step`: the accel kernel `all_pairs_half` selects
  (`ops/allpairs.py`; its plain twin for a CPU state), then the Euler tail
  with the num_sim freeze, written into the spare state; for pm_grid and
  p3m, the same `make_step` around the mesh solve (`ops/pm.py`,
  `ops/p3m.py`) and, for p3m, the tree near field's sweep kernel
  (`ops/treeforce.py`; the twins on a CPU state);
- the shared fence is stream order: `positions` handed to the render engine
  is the fence value (`Compute::GetFenceValue`, `Compute.cpp:446`);
- `wait_for_gpu` is a hard device sync;
- constructing with `prev=` migrates state from a dying engine on another
  device — the `Compute::CopyState` live-reassignment path
  (`Compute.cpp:303-410`) as one tensor copy per plane.

The Intel queue-throttle extension (`ExtensionHelper`,
`utils/extension.py`): while it is active on a CUDA device the step runs
on a stream of the highest priority. That stream waits for the event
recorded at the end of the previous step, which follows everything queued
on the current stream before it (the previous frame's render, the last
reader of the buffer this step writes), and the current stream waits for
the step, so the render of state N runs beside the step to N+1 and the
next render sees N+1. A new state (`restore`, migration), and the first
step on that stream after steps on the current one (a toggle), wait for
everything queued before them. A stage timer's "simulate" stage is timed
on that stream, from the step's start to its end.

A step runs inside the `step` span, a drain inside `wait`
(`runtime/trace.py`).
"""

from __future__ import annotations

from typing import Optional

import torch

from multi_adapter_particles_torch.config import SimConfig
from multi_adapter_particles_torch.models import init as pinit
from multi_adapter_particles_torch.models import integrator
from multi_adapter_particles_torch.models.state import ParticleState
from multi_adapter_particles_torch.ops.central_well import central_well_step
from multi_adapter_particles_torch.runtime import trace
from multi_adapter_particles_torch.utils.extension import ExtensionHelper
from multi_adapter_particles_torch.utils.metrics import MetricsRegistry
from multi_adapter_particles_torch.utils.timers import sync


def step_into(config: SimConfig, step, state: ParticleState,
              out: ParticleState, num_sim: Optional[int]) -> None:
    """One step of `state` written into `out`: the fused central-well
    kernel on a CUDA state, else `step` (`integrator.make_step(config)`)."""
    if config.force_model == "central_well" and state.device.type == "cuda":
        central_well_step(
            state.position, state.velocity,
            dt=config.dt, damping=config.damping, mass=config.mass,
            softening_squared=config.softening_squared,
            num_live=integrator.live_count(num_sim, state.padded_count),
            out=(out.position, out.velocity),
        )
    else:
        step(state, num_sim, out=out)


def interactions(config: SimConfig, num_sim: Optional[int],
                 padded: int) -> float:
    """A step's `interactions` count: pairs for all_pairs (n_sim targets x
    every padded source, the same count for both schedules), particles for
    the other models."""
    n_sim = float(num_sim if num_sim is not None else config.num_particles)
    if config.force_model == "all_pairs":
        n_sim *= padded
    return n_sim


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
        extension: Optional[ExtensionHelper] = None,
    ):
        self.config = sim_config
        self.device = torch.device(device)
        self.metrics = metrics or MetricsRegistry()
        self.extension = extension
        self._events = None  # (stepped, released), made at first use
        self._step = integrator.make_step(sim_config)
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
        self._ordered = False  # the next prioritized step waits for all

    def _stream(self) -> Optional[torch.cuda.Stream]:
        if self.extension is None or self.device.type != "cuda":
            return None
        return self.extension.stream()

    # -- frame ops ---------------------------------------------------------------
    def simulate(self, num_sim: Optional[int] = None,
                 stage_timer=None) -> ParticleState:
        """One async step into the spare buffer, then swap. Returns the new
        state (also kept on self). `stage_timer` (an `EventStageTimer`
        whose frame is open) gets the "simulate" mark where the step ran."""
        with trace.span("step"):
            return self._simulate(num_sim, stage_timer)

    def _simulate(self, num_sim: Optional[int],
                  stage_timer) -> ParticleState:
        out = self._spare
        stream = self._stream()
        if stream is None:
            step_into(self.config, self._step, self.state, out, num_sim)
            if stage_timer is not None:
                stage_timer.mark("simulate")
            self._ordered = False  # a step after a toggle waits for all
        else:
            cur = torch.cuda.current_stream(self.device)
            if self._events is None:
                self._events = (torch.cuda.Event(), torch.cuda.Event())
            stepped, released = self._events
            if self._ordered:
                stream.wait_event(released)
            else:
                stream.wait_stream(cur)
            with torch.cuda.stream(stream):
                if stage_timer is not None:
                    stage_timer.begin()
                step_into(self.config, self._step, self.state, out, num_sim)
                if stage_timer is not None:
                    stage_timer.mark("simulate")
            # two events recorded again every step: a wait takes the
            # event's last record when it is queued
            stepped.record(stream)
            cur.wait_event(stepped)
            released.record(cur)
            self._ordered = True
        self._spare, self.state = self.state, out
        self.step_count += 1
        self.metrics.count("interactions", interactions(
            self.config, num_sim, self.state.padded_count))
        return self.state

    @property
    def positions(self) -> torch.Tensor:
        """The shared-buffer handle the render side consumes
        (`Compute::GetSharedHandles` analog)."""
        return self.state.position

    def get_fence_value(self) -> int:
        return self.step_count

    @property
    def overflow(self) -> Optional[torch.Tensor]:
        """The slot near field's overflow count of the last step (a 0-d
        device tensor), None for the other force models."""
        return getattr(self._step.accel_fn, "overflow", None)

    def wait_for_gpu(self) -> None:
        """Drain: hard device sync (`Compute::WaitForGpu`)."""
        with trace.span("wait"):
            sync(self.state.position)

    # -- snapshots ---------------------------------------------------------------
    def snapshot(self) -> ParticleState:
        """Host-side copy of the state (positions + velocities)."""
        self.wait_for_gpu()
        return self.state.to("cpu")

    def restore(self, host_state: ParticleState) -> None:
        self.wait_for_gpu()
        self._set_state(host_state.to(self.device))
