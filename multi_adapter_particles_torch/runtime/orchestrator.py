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

`fused=True` runs the fused single-program frame instead
(`runtime/fused.py`): one engine in both roles on one device.

Live reconfiguration counts each rebuild in the `reconfigurations` counter
and keeps its drain + rebuild + migrate host milliseconds (synced at both
ends) in the `reconfig_ms` gauge. `debug=True` runs the validation layer
(`utils/debug.py`) after every frame. The queue-throttle extension
(`utils/extension.py`) follows `AppConfig.use_queue_extension`, picked up
at the next split step (fused frames run on the current stream). At
`shutdown` the slot near field's overflow count of the last step is
published as the `p3m_overflow` gauge, and pm_grid's count of particles
the last step left outside the mesh as `pm_outside` (fused frames also
publish it at every `present()`, in its one read).

`mesh_devices` > 1 runs the compute role on a mesh of that many devices of
the compute adapter's platform (`parallel.MeshComputeEngine`); the render
role gathers the shards, or with `shard_render` renders sharded over the
same mesh (`Renderer.render_mesh`). `set_mesh_devices` (the `meshdevices`
control) rescales the mesh live: drain, reshard, resume. A compute-adapter
change collapses the mesh back to one device.

A frame runs inside the `frame` span (with the frame count), a live
reconfiguration or mesh rescale inside `reconfigure` (`runtime/trace.py`).
"""

from __future__ import annotations

import time
from typing import List, Optional

from multi_adapter_particles_torch.config import AppConfig, RenderConfig, SimConfig
from multi_adapter_particles_torch.parallel import (
    MeshComputeEngine,
    Sharded,
    make_mesh,
)
from multi_adapter_particles_torch.runtime import devices as devmod
from multi_adapter_particles_torch.runtime import trace
from multi_adapter_particles_torch.runtime.compute_engine import ComputeEngine
from multi_adapter_particles_torch.runtime.fused import FusedEngine
from multi_adapter_particles_torch.runtime.pacing import FrameLatencyQueue
from multi_adapter_particles_torch.runtime.render_engine import RenderEngine
from multi_adapter_particles_torch.render.renderer import Renderer
from multi_adapter_particles_torch.utils import debug as dbg
from multi_adapter_particles_torch.utils.extension import ExtensionHelper
from multi_adapter_particles_torch.utils.metrics import MetricsRegistry


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
        ("simulate ms" / "render ms", `runtime/trace.py`) when the
        compute device is a GPU. `profile_every` K > 0 instead times both
        stages with a hard sync every K-th frame (split mode only). `fused`
        runs the fused single-program frame on one device. `debug` checks
        the state and the buffer hand-off after every frame (one host read
        a frame; `DebugValidationError` on a fault). `mesh_devices` > 1
        and `shard_render`: see the module docstring."""
        self.debug = debug
        self.mesh_devices = mesh_devices
        self.shard_render = shard_render
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
        if fused and compute_adapter is None and render_adapter is None:
            # fused = the single-adapter async-compute analog: an
            # unspecified assignment binds both roles to one device
            render_ad = compute_ad
        if fused and (mesh_devices > 1
                      or compute_ad.device != render_ad.device):
            raise ValueError("fused mode needs a single shared device (the "
                             "async-compute analog)")
        self.compute_adapter = compute_ad
        self.render_adapter = render_ad
        # prev-value change detection (`Particles.cpp:162-166,458-463`)
        self._prev_compute_index = compute_ad.index
        self._prev_render_index = render_ad.index
        self._prev_fullscreen = self.app.fullscreen
        self._prev_use_extension = self.app.use_queue_extension
        self.extension = ExtensionHelper(
            compute_ad.device, enabled=self.app.use_queue_extension)

        self.fused_engine: Optional[FusedEngine] = None
        if fused:
            # one object serves both roles (zero copies, one frame program)
            self.fused_engine = FusedEngine(
                self.sim_config, self._active_render_config(),
                compute_ad.device, self.metrics, seed=seed)
            self.compute = self.render = self.fused_engine
        else:
            if mesh_devices > 1:
                self.compute = MeshComputeEngine(
                    self.sim_config, self._make_mesh(mesh_devices),
                    self.metrics, seed=seed)
            else:
                self.compute = ComputeEngine(
                    self.sim_config, compute_ad.device, self.metrics,
                    seed=seed, extension=self.extension,
                )
            self.render = RenderEngine(
                self._active_render_config(), render_ad.device, self.metrics
            )
        self.stage_timer = (
            trace.EventStageTimer(self.metrics, compute_ad.device)
            if async_timers and compute_ad.device.type == "cuda"
            else None
        )
        self.share_handles()
        self.frame_count = 0

    def _active_render_config(self) -> RenderConfig:
        """The windowed config, or its fullscreen-resolution variant when
        the runtime fullscreen toggle is on (`Render.cpp:287-413`)."""
        return self.render_config.resolved(self.app.fullscreen)

    def _make_mesh(self, k: int):
        """A k-rank mesh over the adapters of the compute platform."""
        found = [a.device for a in self.adapters
                 if a.platform == self.compute_adapter.platform][:k]
        if len(found) < k:
            raise ValueError(
                f"mesh of {k} requested but only {len(found)} "
                f"{self.compute_adapter.platform} devices exist")
        return make_mesh(found)

    # -- handle brokering (`Particles::ShareHandles`, Particles.cpp:191-208) ----
    def share_handles(self) -> None:
        self._display_positions = self.compute.positions
        if self.mesh_devices > 1:
            self.async_mode = False
            sharded_render = self.shard_render and isinstance(
                self.render, RenderEngine)
            if sharded_render:
                self.render.mesh = self.compute.mesh
            self.metrics.gauge(
                "mode_banner",
                f"Multi-Chip Mesh Compute ({self.mesh_devices} devices)"
                + (" + sharded render" if sharded_render
                   else " + render consume"))
            self.metrics.gauge("mesh", f"{self.mesh_devices}x1 particles-axis")
        else:
            if isinstance(self.render, RenderEngine):
                self.render.mesh = None  # one device again: the gather path
            self.async_mode = (
                self.compute_adapter.device == self.render_adapter.device
            )
            self.metrics.gauge(
                "mode_banner",
                "Single Adapter with Async Compute (fused single-program)"
                if self.fused_engine is not None
                else devmod.mode_banner(self.compute_adapter,
                                        self.render_adapter),
            )
        self.metrics.gauge("compute_device", self.compute_adapter.description)
        self.metrics.gauge("render_device", self.render_adapter.description)

    # -- elastic mesh rescale (the JAX package's runtime shard rebalancing) -----
    def set_mesh_devices(self, k: int) -> None:
        """Live-rescale the compute role to a k-device mesh (or back to one
        device with k <= 1): drain, reshard, resume. Counted like any
        reconfiguration (`reconfigurations`, `reconfig_ms`)."""
        if self.fused_engine is not None:
            raise ValueError("fused mode needs a single shared device (the "
                             "async-compute analog)")
        mesh = self._make_mesh(k) if k > 1 else None
        with trace.span("reconfigure"):
            t0 = time.perf_counter()
            self.pacing.drain()
            self.render.wait_for_gpu()
            self.compute.wait_for_gpu()
            if mesh is not None:
                self.compute = MeshComputeEngine(
                    self.sim_config, mesh, self.metrics, prev=self.compute)
            else:
                self.compute = ComputeEngine(
                    self.sim_config, self.compute_adapter.device,
                    self.metrics, prev=self.compute,
                    extension=self.extension)
            self.mesh_devices = k
            self.share_handles()
            self._count_reconfiguration(t0)

    # -- per-frame pipeline -------------------------------------------------------
    def draw(self) -> None:
        """One frame: draw N, simulate N+1, present (`Particles.cpp:432-456`)."""
        with trace.span("frame", self.frame_count):
            self._draw()

    def _draw(self) -> None:
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
        if self.fused_engine is not None:
            self._draw_fused(sim_arg, num_draw)
            return

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
            self.compute.simulate(sim_arg, stage_timer=timer)
            self.compute.wait_for_gpu()
            st.end()
        else:
            self.compute.simulate(sim_arg, stage_timer=timer)
        if timer is not None:
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
                if isinstance(src, Sharded):  # the mesh's last launch
                    src = src.shards[-1]
                self.pacing.push(src)

        if self.debug:
            where = f"frame {self.frame_count}"
            dbg.validate_handoff(self.compute, self.render,
                                 self._display_positions, where)
            dbg.validate_state(self.compute.state,
                               self.sim_config.num_particles, where)
        self.frame_count += 1
        self._handle_reconfiguration()

    def _draw_fused(self, sim_arg: Optional[int], num_draw: int) -> None:
        """One fused frame (the JAX orchestrator's fused branch). The SPACE
        toggle draws 0 sprites: the frame keeps its shape, no recapture."""
        eng = self.fused_engine
        timer = self.stage_timer
        eng.frame(self.app, num_sim=sim_arg,
                  num_draw=num_draw if self.draw_enabled else 0,
                  stage_timer=timer)
        if timer is not None:
            timer.mark("simulate")
            timer.end_frame()
        if self.app.vsync and self.draw_enabled:
            eng.present()  # the single host block per frame
        else:
            # launch ahead, bounded in flight; no present, so no growth (the
            # exact binning draws every sprite whole within its capacity)
            self.pacing.push(eng.positions)
        self._display_positions = eng.positions
        if self.debug:
            where = f"frame {self.frame_count} (fused)"
            dbg.validate_fused_handoff(eng, where)
            dbg.validate_state(eng.state, self.sim_config.num_particles,
                               where)
        self.frame_count += 1
        self._handle_reconfiguration()

    # -- live reconfiguration (`Particles.cpp:458-537`) ---------------------------
    def set_compute_adapter(self, index: int) -> None:
        self.compute_adapter = self.adapters[index]

    def set_render_adapter(self, index: int) -> None:
        self.render_adapter = self.adapters[index]

    def _handle_reconfiguration(self) -> None:
        # extension toggle only: the next split step asks for its stream
        # again; fused frames stay on the current stream
        # (`Particles.cpp:533-537`)
        if self.app.use_queue_extension != self._prev_use_extension:
            self._prev_use_extension = self.app.use_queue_extension
            self.extension.set_enabled(self.app.use_queue_extension)

        cchange = self.compute_adapter.index != self._prev_compute_index
        rchange = self.render_adapter.index != self._prev_render_index
        # fullscreen/resolution change: drain + render-engine rebuild at
        # the new resolution (`Particles.cpp:458-463,488-509`)
        fschange = self.app.fullscreen != self._prev_fullscreen
        if not (cchange or rchange or fschange):
            return
        with trace.span("reconfigure"):
            self._reconfigure(cchange, rchange, fschange)

    def _reconfigure(self, cchange: bool, rchange: bool,
                     fschange: bool) -> None:
        """Drain, rebuild the engines a change moved, migrate the state."""
        t0 = time.perf_counter()
        # Drain all in-flight work on both engines (Particles.cpp:467-471).
        self.pacing.drain()
        self.render.wait_for_gpu()
        self.compute.wait_for_gpu()

        if self.fused_engine is not None:
            self._rebuild_fused()
            self._count_reconfiguration(t0)
            return

        if rchange or fschange:
            # Rebuild the render engine on the (possibly new) device at the
            # active resolution; camera and learned dup window survive.
            rcfg = self._active_render_config()
            renderer = self._carry_renderer(rcfg)
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
            # New engine on the new device, migrating state (CopyState). A
            # compute-adapter change while a mesh is active collapses the
            # mesh back to one device: its bookkeeping goes first.
            if self.mesh_devices > 1:
                self.mesh_devices = 0
                self.metrics.gauges.pop("mesh", None)
            self._restart_timer()
            self.extension = self._new_extension()
            self.compute = ComputeEngine(
                self.sim_config,
                self.compute_adapter.device,
                self.metrics,
                prev=self.compute,
                extension=self.extension,
            )
            self._prev_compute_index = self.compute_adapter.index

        self.share_handles()
        self._count_reconfiguration(t0)

    def _new_extension(self) -> ExtensionHelper:
        """The extension helper for the compute role's (new) device."""
        return ExtensionHelper(self.compute_adapter.device,
                               enabled=self.app.use_queue_extension)

    def _count_reconfiguration(self, t0: float) -> None:
        """Wait for the rebuilt engines, then count the reconfiguration and
        keep its host milliseconds since `t0` (before the drain)."""
        self.compute.wait_for_gpu()
        self.render.wait_for_gpu()
        self.metrics.count("reconfigurations")
        ms = self.metrics.gauges.setdefault("reconfig_ms", [])
        ms.append((time.perf_counter() - t0) * 1e3)

    def _carry_renderer(self, rcfg: RenderConfig) -> Renderer:
        """A renderer at `rcfg` that keeps the current one's settings and
        learned capacity or dup window."""
        o = self.render.renderer
        return Renderer(rcfg, seg_q=o.seg_q, dup_y=o.dup_y, dup_x=o.dup_x,
                        blend=o.blend, auto_raise_dup=o.auto_raise_dup,
                        entry_factor=o.entry_factor)

    def _restart_timer(self) -> None:
        """A stage timer follows the compute role to its new device."""
        if self.stage_timer is not None:
            self.stage_timer.close()
            self.stage_timer = (
                trace.EventStageTimer(self.metrics,
                                      self.compute_adapter.device)
                if self.compute_adapter.device.type == "cuda" else None
            )

    def _rebuild_fused(self) -> None:
        """Fused mode binds both roles to ONE device: a change moves both
        together, into a new engine that migrates the state and keeps the
        camera and the learned dup window (the JAX orchestrator's fused
        reconfiguration). A change that moves one role only raises
        `ValueError` and is undone: both adapters go back to the engine's,
        and the next frame runs as before."""
        if self.compute_adapter.device != self.render_adapter.device:
            self.compute_adapter = self.adapters[self._prev_compute_index]
            self.render_adapter = self.adapters[self._prev_render_index]
            raise ValueError(
                "fused mode needs compute and render on the same device; "
                "move both adapters together (or restart split)")
        old = self.fused_engine
        rcfg = self._active_render_config()
        if self.compute_adapter.device != old.device:
            self._restart_timer()
            self.extension = self._new_extension()
        self.fused_engine = FusedEngine(
            self.sim_config, rcfg, self.compute_adapter.device, self.metrics,
            prev=old, camera=old.camera, renderer=self._carry_renderer(rcfg))
        self.compute = self.render = self.fused_engine
        self._prev_compute_index = self.compute_adapter.index
        self._prev_render_index = self.render_adapter.index
        self._prev_fullscreen = self.app.fullscreen
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
        overflow = self.compute.overflow
        if overflow is not None:
            self.metrics.gauge("p3m_overflow", int(overflow))
        outside = self.compute.outside
        if outside is not None:
            self.metrics.gauge("pm_outside", int(outside))
