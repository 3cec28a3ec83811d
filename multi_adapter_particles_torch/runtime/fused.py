"""Fused single-program frame: splat render of state N + step to N+1.

The port of the JAX package's `runtime/fused.py`. The reference's
single-adapter async-compute mode shares one device between its compute and
direct queues, interleaved by fences (`Compute::SetAsync`,
`Compute.cpp:956-987`; `Render.cpp:844-852`). The JAX package compiles the
whole frame — render state N (stale-by-one), then integrate to N+1 — into
one XLA program. The torch analog of one compiled program is a captured
CUDA graph:

- **Two state buffers, explicit ping-pong** (the descriptor-base-sliding
  analog, `Compute.cpp:52-62,1030-1035`): the render reads the current
  state, the step writes the other one, and the two swap every frame.
- **Four graphs on a CUDA device**, captured at the first frame and
  sharing one memory pool: a render graph and a step graph for each
  ping-pong parity. A frame is two replays. The first frame runs eagerly
  (it builds and loads the kernels, cuFFT plans and cached spectra), and
  the graphs are captured right after it.
- **Static arguments**: the per-frame scalars (wvp, p00, p11, radius,
  intensity) and `num_draw` live in device tensors that the graphs read;
  they are copied into only when they change (the `_arg_key` cache), so a
  moving camera or the draw toggle needs no recapture.
- **Recapture** when `present()` grows the dup window (the JAX
  `_rebuild_fused`), or when num_sim's live count changes. A new
  resolution or device is a new engine.
- **Stage marks**: with a stage timer, the "render" mark falls between the
  render and step replays (events at the stage boundary replace the JAX
  package's optimization-barrier marker).
- **Launch counts**: a capture runs nothing, so the kernel wrappers'
  `.launches` counters are put back after it and advanced by the captured
  frame's launches at every replay: the counters count launches on the
  device in both modes. `launches_per_frame` and `replays` report them.

Which force models capture is fixed (`CAPTURED`), decided from the model up
front and never by catching a capture error; the others run the same frame
function uncaptured. The `fused_graph` gauge says which way a frame ran. On
the CPU nothing is captured.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from multi_adapter_particles_torch.config import AppConfig, RenderConfig, SimConfig
from multi_adapter_particles_torch.models import init as pinit
from multi_adapter_particles_torch.models import integrator
from multi_adapter_particles_torch.models.state import ParticleState
from multi_adapter_particles_torch.ops.allpairs import (
    all_pairs_accel,
    all_pairs_accel_halfpair,
)
from multi_adapter_particles_torch.ops.central_well import central_well_step
from multi_adapter_particles_torch.ops.composite import composite_rows
from multi_adapter_particles_torch.ops.rowgather import gather_rows
from multi_adapter_particles_torch.ops.sortkv import sort_kv_stable
from multi_adapter_particles_torch.render.camera import Camera
from multi_adapter_particles_torch.render.renderer import FrameOutput, Renderer
from multi_adapter_particles_torch.runtime.compute_engine import (
    interactions,
    step_into,
)
from multi_adapter_particles_torch.runtime.render_engine import _present_probe
from multi_adapter_particles_torch.utils.metrics import MetricsRegistry
from multi_adapter_particles_torch.utils.timers import sync

# Force models whose step a CUDA graph captures, and why it can: nothing on
# the step's path reads the device from the host or copies to it.
CAPTURED = {
    "central_well": "one kernel launch into the spare state",
    "all_pairs": "the accel kernel, then the Euler tail as torch ops",
    "pm_grid": "torch sort, cumsum and index ops, and cuFFT (its plans and "
               "the cached kernel spectrum made by the eager first frame)",
}
# Not captured: p3m. The tree sweep reads int(counts.max()) on the host
# (ops/treeforce.py) and the list build uses torch.nonzero, which syncs.

# The kernel wrappers a fused frame can launch (their `.launches` counters).
COUNTED = (central_well_step, composite_rows, sort_kv_stable, gather_rows,
           all_pairs_accel, all_pairs_accel_halfpair)


class FusedEngine:
    """Both engine roles on one device: compute (`positions`,
    `get_fence_value`, `wait_for_gpu`, `snapshot`, `restore`, `state`) and
    render (`camera`, `renderer`, `last_frame`, `last_output`,
    `present`)."""

    def __init__(
        self,
        sim_config: SimConfig,
        render_config: RenderConfig,
        device,
        metrics: Optional[MetricsRegistry] = None,
        seed: int = 0,
        prev=None,
        camera: Optional[Camera] = None,
        renderer: Optional[Renderer] = None,
    ):
        """`prev` (an engine with `state`, `step_count`, `wait_for_gpu`)
        migrates its state here; `camera` and `renderer` carry over a
        rebuilt engine's view and learned dup window."""
        self.config = sim_config
        self.render_config = render_config
        self.device = torch.device(device)
        self.metrics = metrics or MetricsRegistry()
        self.camera = camera or Camera(position=render_config.camera_position)
        self.renderer = renderer or Renderer(render_config)
        self.use_graph = (self.device.type == "cuda"
                          and sim_config.force_model in CAPTURED)
        # raises for a part not ported yet (the p3m slot near field)
        self._step = integrator.make_step(sim_config)
        self.step_count = 0
        self.frame_count = 0
        if prev is not None:
            prev.wait_for_gpu()
            state = prev.state.to(self.device)
            self.step_count = prev.step_count
        else:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            state = pinit.initialize_particles_device(
                sim_config.num_particles, generator=gen, device=self.device)
        self._states = [state, state.empty_like()]
        self._cur = 0
        # static frame arguments: wvp (16), p00, p11, size, intensity
        self._args_buf = torch.zeros(20, dtype=torch.float32,
                                     device=self.device)
        b = self._args_buf
        self._args = (b[:16].view(4, 4), b[16], b[17], b[18], b[19])
        self._num_draw = torch.zeros((), dtype=torch.int32,
                                     device=self.device)
        self._arg_key = None
        self._num_draw_host = None
        self._graphs = None       # per parity: (render graph, out, step graph)
        self._graph_key = None
        self._frame: Optional[FrameOutput] = None
        self.replays = 0
        self._per_frame = {}      # counted wrapper -> launches a frame

    # -- the frame -----------------------------------------------------------
    @property
    def state(self) -> ParticleState:
        return self._states[self._cur]

    def _set_args(self, app: AppConfig, num_draw: int) -> None:
        """Copy the frame's scalars into the static tensors when they
        changed (one host -> device copy; the draw count a fill)."""
        host = self.renderer.frame_args(self.camera, app.particle_size,
                                        app.particle_intensity)
        key = (host[0].tobytes(), *host[1:])
        if key != self._arg_key:
            vals = torch.cat([torch.from_numpy(host[0]).reshape(-1),
                              torch.tensor(host[1:], dtype=torch.float32)])
            self._args_buf.copy_(vals)
            self._arg_key = key
        if num_draw != self._num_draw_host:
            self._num_draw.fill_(num_draw)
            self._num_draw_host = num_draw

    def _render(self, parity: int) -> FrameOutput:
        return self.renderer.render_with(self._states[parity].position,
                                         self._args, self._num_draw)

    def _simulate(self, parity: int, num_sim: Optional[int]) -> None:
        step_into(self.config, self._step, self._states[parity],
                  self._states[1 - parity], num_sim)

    def _key(self, num_sim: Optional[int]):
        """What a captured frame bakes in besides the static tensors."""
        r = self.renderer
        return (r.dup_y, r.dup_x, r.seg_q, r.blend, r.chunk_threshold,
                r.chunk_size, r.composite, r.sort, r.gather,
                integrator.live_count(num_sim, self.state.padded_count))

    def _capture(self, num_sim: Optional[int]) -> None:
        """Capture the render and step graphs of both parities into one
        memory pool. A capture launches nothing: the counters are put back
        and the captured frame's launches kept for the replays."""
        self._graphs = None
        before = {f: f.launches for f in COUNTED}
        pool = torch.cuda.graph_pool_handle()
        graphs = []
        for parity in (0, 1):
            g_render, g_step = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
            with torch.cuda.graph(g_render, pool=pool):
                out = self._render(parity)
            with torch.cuda.graph(g_step, pool=pool):
                self._simulate(parity, num_sim)
            graphs.append((g_render, out, g_step))
        self._per_frame = {f: (f.launches - n) // 2 for f, n in before.items()
                           if f.launches != n}
        for f, n in before.items():
            f.launches = n
        self._graphs = graphs

    @property
    def launches_per_frame(self) -> Dict[str, int]:
        """Kernel launches of one captured frame, by wrapper name."""
        return {f.__name__: c for f, c in self._per_frame.items()}

    def frame(self, app: AppConfig, num_sim: Optional[int] = None,
              num_draw: Optional[int] = None, stage_timer=None) -> FrameOutput:
        """Render the current state, step it into the other buffer, swap.
        Async: no host sync (except at a capture). `stage_timer` (an
        `EventStageTimer` whose frame is open) gets the "render" mark
        between the two stages."""
        n = self.state.padded_count
        nd = n if num_draw is None else int(num_draw)
        self._set_args(app, min(nd, 2**31 - 1))
        key = self._key(num_sim)
        replay = self.use_graph and key == self._graph_key
        if replay:
            g_render, out, g_step = self._graphs[self._cur]
            g_render.replay()
        else:
            out = self._render(self._cur)
        if stage_timer is not None:
            stage_timer.mark("render")
        if replay:
            g_step.replay()
            self.replays += 1
            for f, c in self._per_frame.items():
                f.launches += c
        else:
            self._simulate(self._cur, num_sim)
        self._frame = out
        self._cur = 1 - self._cur
        if self.use_graph and key != self._graph_key:
            # this frame ran eagerly: capture for the next ones
            self._capture(num_sim)
            self._graph_key = key
        self.metrics.gauge("fused_graph", replay)
        self.metrics.count("interactions",
                           interactions(self.config, num_sim, n))
        self.step_count += 1
        self.frame_count += 1
        return out

    # -- compute-engine interface ------------------------------------------------
    @property
    def positions(self) -> torch.Tensor:
        return self.state.position

    def get_fence_value(self) -> int:
        return self.step_count

    def wait_for_gpu(self) -> None:
        sync(self.state.position)

    def snapshot(self) -> ParticleState:
        self.wait_for_gpu()
        return self.state.to("cpu")

    def restore(self, host_state: ParticleState) -> None:
        """Copy a state into the current buffers (the graphs stay valid);
        a state of another shape takes new buffers and a recapture."""
        self.wait_for_gpu()
        cur = self.state
        if host_state.position.shape == cur.position.shape:
            cur.position.copy_(host_state.position)
            cur.velocity.copy_(host_state.velocity)
            return
        state = host_state.to(self.device)
        self._states = [state, state.empty_like()]
        self._cur = 0
        self._graphs = self._graph_key = None

    # -- render-engine interface ----------------------------------------------
    @property
    def last_output(self) -> Optional[FrameOutput]:
        return self._frame

    @property
    def last_frame(self) -> Optional[torch.Tensor]:
        return None if self._frame is None else self._frame.frame

    def present(self) -> Optional[FrameOutput]:
        """Fence on the last frame with the split engine's deferred dup
        auto-raise: ONE packed host read carries fence + truncated + spans;
        a truncating frame grows the window for FUTURE frames, which then
        run eagerly once and recapture (the graphs baked the old window
        in)."""
        f = self._frame
        if f is None:
            return None
        rend = self.renderer
        if rend.auto_raise_dup:
            vals = _present_probe(f).cpu().tolist()
            rend.last_truncated = int(vals[1])
            rend.raise_dup_values(int(vals[1]), int(vals[2]), int(vals[3]))
        else:
            sync(f.frame)
        return f
