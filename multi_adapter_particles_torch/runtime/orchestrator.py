"""Orchestrator — the `class Particles` analog (`Particles/Particles.cpp`).

Owns both engines, brokers the shared-positions handle between them, runs
the per-frame pipeline, and handles live reconfiguration (device
re-assignment with drain + state migration — `Particles.cpp:458-537`).

Frame pipeline (`Particles::Draw`, `Particles.cpp:432-456`):

    1. render.draw(display_positions)   # consumes the *last completed* sim
    2. compute.simulate()               # next step, into the other buffer
    3. display_positions <- new state
    4. present()                        # the single host block per frame

Step 1 launches before step 2 on the same stream, and the step writes the
buffer the draw does not read, so the render shows frame N while N+1
simulates — the reference's stale-by-one contract (fences `Render.cpp:925`,
`Compute.cpp:1012`). With one GPU both roles share it (async-compute mode).

Not ported yet, and raising: the fused single-program mode (ROADMAP queue 1
item 7), mesh compute and sharded render (item 14), the debug validation
layer (item 13).
"""

from __future__ import annotations

import time
from typing import List, Optional

from multi_adapter_particles_torch.config import AppConfig, RenderConfig, SimConfig
from multi_adapter_particles_torch.runtime import devices as devmod
from multi_adapter_particles_torch.runtime.compute_engine import ComputeEngine
from multi_adapter_particles_torch.runtime.gputimer import EventStageTimer
from multi_adapter_particles_torch.runtime.pacing import FrameLatencyQueue
from multi_adapter_particles_torch.runtime.render_engine import RenderEngine
from multi_adapter_particles_torch.render.renderer import Renderer
from multi_adapter_particles_torch.utils.metrics import MetricsRegistry


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to multi_adapter_particles_torch yet "
        f"(ROADMAP queue 1 {item})"
    )


class ParticlesApp:
    def __init__(
        self,
        app_config: Optional[AppConfig] = None,
        sim_config: Optional[SimConfig] = None,
        render_config: Optional[RenderConfig] = None,
        compute_adapter: Optional[int] = None,
        render_adapter: Optional[int] = None,
        seed: int = 0,
        draw_enabled: bool = True,
        profile_every: int = 0,
        mesh_devices: int = 0,
        debug: bool = False,
        fused: bool = False,
        async_timers: bool = False,
        shard_render: bool = False,
    ):
        """`async_timers` turns on the non-stalling CUDA-event stage timer
        ("simulate ms" / "render ms", `runtime/gputimer.py`) when the
        compute device is a GPU. `profile_every` K > 0 instead times both
        stages with a hard sync every K-th frame."""
        if fused:
            raise _not_ported("fused mode", "item 7")
        if mesh_devices > 1 or shard_render:
            raise _not_ported("mesh compute / sharded render", "item 14")
        if debug:
            raise _not_ported("the debug validation layer", "item 13")
        self.app = app_config or AppConfig()
        self.sim_config = sim_config or SimConfig(
            num_particles=self.app.num_particles
        )
        self.render_config = render_config or RenderConfig()
        self.metrics = MetricsRegistry()
        self.seed = seed
        # SPACE-toggle analog (`Main-Particles.cpp:83-88`).
        self.draw_enabled = draw_enabled
        # Every K frames, time sim/render with a hard sync (precise but
        # pipeline-perturbing); 0 = never.
        self.profile_every = profile_every
        # Bounded launch-ahead for -novsync (SetMaximumFrameLatency analog,
        # Render.cpp:298-308).
        self.pacing = FrameLatencyQueue(self.app.max_frame_latency)

        self.adapters: List[devmod.AdapterInfo] = devmod.enumerate_adapters()
        compute_ad, render_ad = devmod.assign_adapters(
            self.adapters, compute_adapter, render_adapter
        )
        self.compute_adapter = compute_ad
        self.render_adapter = render_ad
        # prev-value change detection (`Particles.cpp:162-166,458-463`)
        self._prev_compute_index = compute_ad.index
        self._prev_render_index = render_ad.index
        self._prev_fullscreen = self.app.fullscreen

        self.compute = ComputeEngine(
            self.sim_config, compute_ad.device, self.metrics, seed=seed
        )
        self.render = RenderEngine(
            self._active_render_config(), render_ad.device, self.metrics
        )
        self.stage_timer = (
            EventStageTimer(self.metrics, compute_ad.device)
            if async_timers and compute_ad.device.type == "cuda"
            else None
        )
        self.share_handles()
        self.frame_count = 0

    def _active_render_config(self) -> RenderConfig:
        """The windowed config, or its fullscreen-resolution variant when
        the runtime fullscreen toggle is on (`Render.cpp:287-413`)."""
        return self.render_config.resolved(self.app.fullscreen)

    # -- handle brokering (`Particles::ShareHandles`, Particles.cpp:191-208) ----
    def share_handles(self) -> None:
        self._display_positions = self.compute.positions
        self.async_mode = (
            self.compute_adapter.device == self.render_adapter.device
        )
        self.metrics.gauge(
            "mode_banner",
            devmod.mode_banner(self.compute_adapter, self.render_adapter),
        )
        self.metrics.gauge("compute_device", self.compute_adapter.description)
        self.metrics.gauge("render_device", self.render_adapter.description)

    # -- per-frame pipeline -------------------------------------------------------
    def draw(self) -> None:
        """One frame: draw N, simulate N+1, present (`Particles.cpp:432-456`)."""
        self.metrics.frame_tick()
        num_sim, num_copy, num_draw = self.app.resolved_counts()
        sim_arg = num_sim if num_sim < self.sim_config.num_particles else None
        timer = self.stage_timer
        # profile on the LAST frame of each window so the first sample is
        # past the first-frame costs
        profile = (
            self.profile_every > 0
            and self.frame_count % self.profile_every
            == self.profile_every - 1
        )
        if timer is not None:
            timer.begin_frame()

        if self.draw_enabled:
            if profile:
                st = self.metrics.stage("render")
                st.begin()
                self.render.draw(
                    self._display_positions, self.app, num_copy, num_draw
                )
                self.render.present()
                st.end()
            else:
                self.render.draw(
                    self._display_positions, self.app, num_copy, num_draw
                )
        if timer is not None:
            timer.mark("render")

        if profile:
            st = self.metrics.stage("simulate")
            self.compute.wait_for_gpu()
            st.begin()
            self.compute.simulate(sim_arg)
            self.compute.wait_for_gpu()
            st.end()
        else:
            self.compute.simulate(sim_arg)
        if timer is not None:
            timer.mark("simulate")
            timer.end_frame()

        self._display_positions = self.compute.positions

        if not profile:
            if self.app.vsync and self.draw_enabled:
                # present: the only host block per frame (Particles.cpp:452-456)
                self.render.present()
            else:
                # -novsync (or draw-off): launch ahead, bounded to
                # max_frame_latency unfinished frames
                src = (
                    self.render.last_frame
                    if self.draw_enabled and self.render.last_frame is not None
                    else self._display_positions
                )
                self.pacing.push(src)

        self.frame_count += 1
        self._handle_reconfiguration()

    # -- live reconfiguration (`Particles.cpp:458-537`) ---------------------------
    def set_compute_adapter(self, index: int) -> None:
        self.compute_adapter = self.adapters[index]

    def set_render_adapter(self, index: int) -> None:
        self.render_adapter = self.adapters[index]

    def _handle_reconfiguration(self) -> None:
        cchange = self.compute_adapter.index != self._prev_compute_index
        rchange = self.render_adapter.index != self._prev_render_index
        # fullscreen/resolution change: drain + render-engine rebuild at
        # the new resolution (`Particles.cpp:458-463,488-509`)
        fschange = self.app.fullscreen != self._prev_fullscreen
        if not (cchange or rchange or fschange):
            return

        # Drain all in-flight work on both engines (Particles.cpp:467-471).
        self.pacing.drain()
        self.render.wait_for_gpu()
        self.compute.wait_for_gpu()

        if rchange or fschange:
            # Rebuild the render engine on the (possibly new) device at the
            # active resolution; camera and learned dup window survive.
            old_rend = self.render.renderer
            rcfg = self._active_render_config()
            renderer = Renderer(
                rcfg,
                seg_q=old_rend.seg_q,
                dup_y=old_rend.dup_y,
                dup_x=old_rend.dup_x,
                blend=old_rend.blend,
                auto_raise_dup=old_rend.auto_raise_dup,
            )
            self.render = RenderEngine(
                rcfg,
                self.render_adapter.device,
                self.metrics,
                camera=self.render.camera,
                renderer=renderer,
            )
            self._prev_render_index = self.render_adapter.index
            self._prev_fullscreen = self.app.fullscreen

        if cchange:
            # New engine on the new device, migrating state (CopyState).
            if self.stage_timer is not None:
                self.stage_timer.close()
            self.compute = ComputeEngine(
                self.sim_config,
                self.compute_adapter.device,
                self.metrics,
                prev=self.compute,
            )
            if self.stage_timer is not None:
                self.stage_timer = (
                    EventStageTimer(self.metrics, self.compute_adapter.device)
                    if self.compute_adapter.device.type == "cuda" else None
                )
            self._prev_compute_index = self.compute_adapter.index

        self.share_handles()

    # -- run loop (the message-pump analog, Main-Particles.cpp:76-90) -------------
    def run(
        self,
        num_frames: int,
        frame_callback=None,
        target_fps: Optional[float] = None,
    ) -> None:
        """Drive `num_frames` frames. `target_fps` is the vsync analog."""
        interval = 1.0 / target_fps if target_fps else 0.0
        for _ in range(num_frames):
            t0 = time.perf_counter()
            self.draw()
            if frame_callback is not None:
                frame_callback(self)
            if interval:
                left = interval - (time.perf_counter() - t0)
                if left > 0:
                    time.sleep(left)

    def shutdown(self) -> None:
        """Drain everything (`~Particles`, Particles.cpp:174-185)."""
        self.pacing.close()
        if self.stage_timer is not None:
            self.stage_timer.close()
        self.render.wait_for_gpu()
        self.compute.wait_for_gpu()
