"""Render engine: owns the render device, camera, splatter, and local buffer.

The reference's `class Render` (`Particles/Render.{h,cpp}`) owns the direct +
copy queues, the swap chain, and local particle buffers that the copy
queue fills from the cross-adapter shared heap each frame
(`Render.cpp:727-759,789-831`). Here:

- the copy queue is a tensor copy of the positions onto the render device;
  on the compute device with the full count it is the zero-copy identity,
  like the reference's same-adapter mode skipping `CopySimulationResults`
  (`Render.cpp:844-852`) — the local buffer is then an ALIAS of the compute
  state, which the compute engine never overwrites in place (it swaps two
  buffers), so the stale-by-one draw stays correct;
- the `num_copy` knob copies only the first ceil(num_copy/128)*128
  columns into an engine-owned buffer and leaves the rest *stale*
  (`Render.cpp:814`; the lane rounding is the JAX package's, `PARITY.md`);
- the swap chain is the host-side frame handle: `draw()` returns the frame
  (async); `present()` blocks on it with ONE host read of a 6-element
  tensor (fence anchor + truncated + span_y + span_x + entries + blends,
  `present_frame`, which the fused engine shares and lengthens by
  pm_grid's `pm_outside` count).

- positions sharded over a mesh (`parallel.mesh.Sharded`, from a
  `MeshComputeEngine`) are gathered onto the render device: the copy
  queue becomes a gather of the shards (never zero-copy);
- with `mesh` set (the orchestrator's `-shardrender`), a frame renders
  sharded over that mesh instead (`Renderer.render_mesh`): no position
  copy, the ranks' (color, transmittance) image pairs are the only
  traffic, counted in `transfer_bytes` as the JAX package counts them.

Spans (`runtime/trace.py`): a frame's `draw` runs inside `render.draw`,
its copy stage inside `render.copy` (the renderer opens the other three
stages), `present` and `wait_for_gpu` inside `wait`.
"""

from __future__ import annotations

from typing import Optional

import torch

from multi_adapter_particles_torch.config import AppConfig, RenderConfig
from multi_adapter_particles_torch.models.state import parked_position
from multi_adapter_particles_torch.render.camera import Camera
from multi_adapter_particles_torch.ops.composite import WARP
from multi_adapter_particles_torch.render.renderer import (
    TILE_H,
    TILE_W,
    FrameOutput,
    Renderer,
)
from multi_adapter_particles_torch.runtime import trace
from multi_adapter_particles_torch.utils.metrics import MetricsRegistry
from multi_adapter_particles_torch.utils.timers import sync


def _present_probe(f: FrameOutput, counters=()) -> torch.Tensor:
    """[6 + len(counters)] f64 carrying (frame anchor, truncated, span_y,
    span_x, entries, blends; -1 where the window path counts no entries,
    or a composite no blends), then the `counters` (0-d device tensors).

    present() needs both a completion fence on the frame and the growth
    scalars; packing them into one small dependent tensor makes it a
    single device -> host read (the JAX package's `_present_probe`, with
    the counts beside)."""
    def count(x):
        return torch.full_like(f.truncated, -1) if x is None else x

    anchor = f.frame.reshape(-1)[:1].to(torch.float64) * 0.0
    counts = torch.stack([f.truncated, f.span_y, f.span_x, count(f.entries)])
    tail = [count(f.blends).reshape(1), *(c.reshape(1) for c in counters)]
    return torch.cat([anchor, counts.to(torch.float64),
                      *(t.to(torch.float64) for t in tail)])


def present_frame(renderer: Renderer, f: FrameOutput,
                  metrics: MetricsRegistry, counters=None) -> None:
    """Block until frame `f` is really finished, both engines' present().
    With auto-raise on, one host read carries the fence and the counts:
    `last_truncated` and the `render_truncated` / `render_entries` gauges
    take them, `render_sort_skipped` (the exact path's sort slots past its
    entries, which its sorts leave where they are: capacity x sorts -
    entries) and `render_blend_share` (the (entry, 32-pixel block) pairs
    the composite blended over entries x the tile's blocks: the share of
    the blends the row kernel would run without `reach_blocks`) are host
    arithmetic on them, and a truncating frame grows the exact binning's
    capacity, or the dup window, for FUTURE frames (it is not
    re-rendered). `counters` ({gauge: 0-d int tensor on the frame's
    device}) ride in the same read, each into its gauge."""
    counters = counters or {}
    with trace.span("wait"):
        if not renderer.auto_raise_dup:
            sync(f.frame)
            return
        # the anchor (first value) is a fence only, and may be NaN
        truncated, span_y, span_x, entries, blends, *extra = (
            int(v) for v in _present_probe(
                f, counters.values()).cpu().tolist()[1:])
        renderer.last_truncated = truncated
        metrics.gauge("render_truncated", truncated)
        if entries >= 0:
            metrics.gauge("render_entries", entries)
            metrics.gauge("render_sort_skipped",
                          renderer.last_sort_slots - entries)
            if entries > 0 and blends >= 0:
                metrics.gauge("render_blend_share", blends / (
                    entries * (TILE_H * TILE_W // WARP)))
        for name, value in zip(counters, extra):
            metrics.gauge(name, value)
        renderer.raise_dup_values(truncated, span_y, span_x)


class RenderEngine:
    def __init__(
        self,
        render_config: RenderConfig,
        device,
        metrics: Optional[MetricsRegistry] = None,
        camera: Optional[Camera] = None,
        renderer: Optional[Renderer] = None,
    ):
        self.config = render_config
        self.device = torch.device(device)
        self.metrics = metrics or MetricsRegistry()
        self.camera = camera or Camera(position=render_config.camera_position)
        self.renderer = renderer or Renderer(render_config)
        # Local particle buffer (the dGPU-resident copy target,
        # Render.cpp:727-759). `_local_owned` tells a buffer this engine
        # allocated (safe to splice into) from a zero-copy alias of the
        # compute state (never written here).
        self._local: Optional[torch.Tensor] = None
        self._local_owned = False
        self._frame: Optional[FrameOutput] = None
        # When set (orchestrator, -shardrender), frames render sharded over
        # this mesh (renderer.render_mesh).
        self.mesh = None

    # -- copy stage (the copy-queue analog) -------------------------------------
    def copy_simulation_results(
        self, shared_positions, num_copy: Optional[int] = None
    ) -> torch.Tensor:
        """Pull sim results into the render device's local buffer.

        Same device, full count: identity (async mode, zero copies).
        Otherwise a copy of exactly the first `num_copy` columns (rounded
        up to the 128 multiple); the tail stays stale. Sharded positions
        are gathered (the same copy, from every shard it spans).
        """
        with trace.span("render.copy"):
            return self._copy(shared_positions, num_copy)

    def _copy(self, shared_positions, num_copy: Optional[int]
              ) -> torch.Tensor:
        n = shared_positions.shape[1]
        nc = n if num_copy is None else min(int(num_copy), n)
        nc = min(-(-nc // 128) * 128, n)  # lane-align the slice boundary
        sharded = not isinstance(shared_positions, torch.Tensor)

        if (not sharded and shared_positions.device == self.device
                and nc >= n):
            self._local = shared_positions  # zero-copy async mode: an ALIAS
            self._local_owned = False
            return self._local

        self.metrics.count("transfer_bytes", float(nc) * 16.0)
        if sharded:
            incoming = shared_positions.gather(self.device, nc)
        else:
            incoming = shared_positions[:, :nc]
        if nc >= n:
            self._local = (incoming if sharded
                           else incoming.to(self.device, copy=True))
            self._local_owned = True
            return self._local
        if (
            not self._local_owned
            or self._local is None
            or self._local.shape != shared_positions.shape
        ):
            # never splice into an alias of the compute state
            self._local = parked_position(n, self.device)
            self._local_owned = True
        self._local[:, :nc].copy_(incoming)
        return self._local

    # -- draw stage ----------------------------------------------------------------
    def draw(
        self,
        shared_positions,
        app: AppConfig,
        num_copy: Optional[int] = None,
        num_draw: Optional[int] = None,
    ) -> FrameOutput:
        """Record + launch one frame (async). The reference's
        `Render::Draw` (`Render.cpp:839-935`) minus the OS present."""
        with trace.span("render.draw"):
            return self._draw(shared_positions, app, num_copy, num_draw)

    def _draw(self, shared_positions, app: AppConfig,
              num_copy: Optional[int], num_draw: Optional[int]
              ) -> FrameOutput:
        n = shared_positions.shape[1]
        if self.mesh is not None and (num_copy is None or num_copy >= n):
            # Sharded render: shards rasterize in place and the image-pair
            # fold replaces the copy stage. A num_copy below N (the
            # stale-tail knob) needs the local buffer: the gather path.
            self._frame = self.renderer.render_mesh(
                shared_positions, self.camera,
                particle_size=app.particle_size,
                particle_intensity=app.particle_intensity,
                mesh=self.mesh, num_draw=num_draw, device=self.device,
            )
            h, w = self.config.height, self.config.width
            self.metrics.count("transfer_bytes",
                               float(self.mesh.size * h * w * 16))
            return self._frame
        local = self.copy_simulation_results(shared_positions, num_copy)
        self._frame = self.renderer.render_arrays(
            local,
            self.camera,
            particle_size=app.particle_size,
            particle_intensity=app.particle_intensity,
            num_draw=num_draw,
        )
        return self._frame

    # -- present ---------------------------------------------------------------------
    def present(self) -> Optional[FrameOutput]:
        """Block until the last frame is really finished — the
        latency-waitable-swapchain host wait (`Particles.cpp:452-456`),
        with its one packed read (`present_frame`)."""
        if self._frame is not None:
            present_frame(self.renderer, self._frame, self.metrics)
        return self._frame

    @property
    def last_output(self) -> Optional[FrameOutput]:
        """The last frame with its truncated / span counts."""
        return self._frame

    @property
    def last_frame(self) -> Optional[torch.Tensor]:
        return None if self._frame is None else self._frame.frame

    def wait_for_gpu(self) -> None:
        with trace.span("wait"):
            if self._frame is not None:
                sync(self._frame.frame)
            if self._local is not None:
                sync(self._local)
