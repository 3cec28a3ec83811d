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
  (async); `present()` blocks on it with ONE host read of a 4-element
  tensor (fence anchor + truncated + span_y + span_x).

The mesh-sharded render of the JAX package is not ported (ROADMAP queue 1
item 14); the orchestrator raises for it.
"""

from __future__ import annotations

from typing import Optional

import torch

from multi_adapter_particles_torch.config import AppConfig, RenderConfig
from multi_adapter_particles_torch.models.state import parked_position
from multi_adapter_particles_torch.render.camera import Camera
from multi_adapter_particles_torch.render.renderer import FrameOutput, Renderer
from multi_adapter_particles_torch.utils.metrics import MetricsRegistry
from multi_adapter_particles_torch.utils.timers import sync


def _present_probe(f: FrameOutput) -> torch.Tensor:
    """[4] f32 carrying (frame anchor, truncated, span_y, span_x).

    present() needs both a completion fence on the frame and the auto-raise
    scalars; packing them into one small dependent tensor makes it a
    single device -> host read (the JAX package's `_present_probe`)."""
    anchor = f.frame.reshape(-1)[0].to(torch.float32) * 0.0
    return torch.stack([
        anchor,
        f.truncated.to(torch.float32),
        f.span_y.to(torch.float32),
        f.span_x.to(torch.float32),
    ])


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

    # -- copy stage (the copy-queue analog) -------------------------------------
    def copy_simulation_results(
        self, shared_positions: torch.Tensor, num_copy: Optional[int] = None
    ) -> torch.Tensor:
        """Pull sim results into the render device's local buffer.

        Same device, full count: identity (async mode, zero copies).
        Otherwise a copy of exactly the first `num_copy` columns (rounded
        up to the 128 multiple); the tail stays stale.
        """
        n = shared_positions.shape[1]
        nc = n if num_copy is None else min(int(num_copy), n)
        nc = min(-(-nc // 128) * 128, n)  # lane-align the slice boundary

        if shared_positions.device == self.device and nc >= n:
            self._local = shared_positions  # zero-copy async mode: an ALIAS
            self._local_owned = False
            return self._local

        self.metrics.count("transfer_bytes", float(nc) * 16.0)
        if nc >= n:
            self._local = shared_positions.to(self.device, copy=True)
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
        self._local[:, :nc].copy_(shared_positions[:, :nc])
        return self._local

    # -- draw stage ----------------------------------------------------------------
    def draw(
        self,
        shared_positions: torch.Tensor,
        app: AppConfig,
        num_copy: Optional[int] = None,
        num_draw: Optional[int] = None,
    ) -> FrameOutput:
        """Record + launch one frame (async). The reference's
        `Render::Draw` (`Render.cpp:839-935`) minus the OS present."""
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
        latency-waitable-swapchain host wait (`Particles.cpp:452-456`).

        With auto-raise on, one host read carries the fence and the
        auto-raise scalars; a truncating frame grows the dup window for
        FUTURE frames (it is not re-rendered)."""
        f = self._frame
        if f is not None:
            if self.renderer.auto_raise_dup:
                vals = _present_probe(f).cpu().tolist()
                self.renderer.raise_dup_values(
                    int(vals[1]), int(vals[2]), int(vals[3])
                )
            else:
                sync(f.frame)
        return self._frame

    @property
    def last_output(self) -> Optional[FrameOutput]:
        """The last frame with its truncated / span counts."""
        return self._frame

    @property
    def last_frame(self) -> Optional[torch.Tensor]:
        return None if self._frame is None else self._frame.frame

    def wait_for_gpu(self) -> None:
        if self._frame is not None:
            sync(self._frame.frame)
        if self._local is not None:
            sync(self._local)
