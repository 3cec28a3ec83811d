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
- **Instantiated for device launch** (`DeviceGraph`,
  `csrc/device_graph.cu`): each captured graph is instantiated with the
  device-launch flag, uploaded once, and replayed from the host with the
  runtime's `cudaGraphLaunch`. Graphs instantiated as `torch.cuda.
  CUDAGraph` does it ran each kernel boundary at one of two latencies on
  an H100 (~0.46 us or ~0.12 us), switching from the slow to the fast one
  at a moment no seed or frame fixes, so a 4M frame of ~280 kernels took
  one of two times 4% apart; graphs instantiated for device launch ran
  every boundary at the fast latency in every process measured
  (`PERF.md` §6).
- **Static arguments**: the per-frame scalars (wvp, p00, p11, radius,
  intensity) and `num_draw` live in device tensors that the graphs read;
  they are copied into only when they change (the `_arg_key` cache), so a
  moving camera or the draw toggle needs no recapture.
- **Recapture** when `present()` grows the exact binning's capacity or
  the dup window (the JAX `_rebuild_fused`), or when num_sim's live count
  changes. A new resolution or device is a new engine.
- **Stage marks**: with a stage timer, the "render" mark falls between the
  render and step replays (events at the stage boundary replace the JAX
  package's optimization-barrier marker).
- **Extension**: fused frames run on the current stream whatever the
  queue-throttle extension says (`utils/extension.py`): one program on one
  device leaves no second stream for a priority to beat.

Which force models capture is fixed (`CAPTURED`, by `capture_key`),
decided from the configuration up front and never by catching a capture
error; the others run the same frame function uncaptured. The
`fused_graph` gauge says which way a frame ran. On the CPU nothing is
captured.

Spans (`runtime/trace.py`): the render, eager or replayed, runs inside
`render.draw` (its arguments inside `render.project`, the hand-off of
the current buffer inside `render.copy`; a replay is one graph launch, so
the renderer's stage spans open only in an eager frame), the step inside
`step`, a capture inside `fused.capture`, `present` and `wait_for_gpu`
inside `wait`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from multi_adapter_particles_torch.config import AppConfig, RenderConfig, SimConfig
from multi_adapter_particles_torch.models import init as pinit
from multi_adapter_particles_torch.models import integrator
from multi_adapter_particles_torch.models.state import ParticleState
from multi_adapter_particles_torch.ops import _build
from multi_adapter_particles_torch.render.camera import Camera
from multi_adapter_particles_torch.render.renderer import FrameOutput, Renderer
from multi_adapter_particles_torch.runtime import trace
from multi_adapter_particles_torch.runtime.compute_engine import step_into
from multi_adapter_particles_torch.runtime.render_engine import present_frame
from multi_adapter_particles_torch.utils.metrics import MetricsRegistry
from multi_adapter_particles_torch.utils.timers import sync

# Steps a CUDA graph captures (by `capture_key`), and why it can: nothing on
# the step's path reads the device from the host or copies to it.
CAPTURED = {
    "central_well": "one kernel launch into the spare state",
    "all_pairs": "the accel kernel, then the Euler tail as torch ops",
    "pm_grid": "torch sort, searchsorted and index ops, the deposit's two "
               "kernels, and cuFFT (its plans and the cached kernel "
               "spectrum made by the eager first frame)",
    "p3m:slots": "pm_grid's mesh path, then the slot binning (a stable "
                 "sort, searchsorted, gathers), the 27 shifted-slice sweeps "
                 "over fixed slabs and a scatter; the overflow count stays "
                 "on the device",
}
# Not captured: p3m with the tree near field. The tree sweep reads
# int(counts.max()) on the host (ops/treeforce.py) and the list build uses
# torch.nonzero, which syncs.


def capture_key(config: SimConfig) -> str:
    """The `CAPTURED` key of a configuration's step: the force model, and
    for p3m its near field ("auto" is slots, as `p3m.make_accel_fn` reads
    it)."""
    if config.force_model != "p3m":
        return config.force_model
    mode = config.p3m_near_mode
    return "p3m:" + ("slots" if mode == "auto" else mode)


@functools.cache
def _graph_library() -> ctypes.CDLL:
    """`csrc/device_graph.cu`'s host calls (built at the first capture)."""
    lib = _build.load("device_graph")
    p = ctypes.c_void_p
    lib.device_graph_instantiate.argtypes = [p, ctypes.POINTER(p), p]
    lib.device_graph_launch.argtypes = [p, p]
    lib.device_graph_destroy.argtypes = [p]
    return lib


class DeviceGraph:
    """A captured CUDA graph (`graph`, a `torch.cuda.CUDAGraph` that keeps
    its captured graph) instantiated for device launch: `instantiate`
    makes and uploads the executable graph, `replay` launches it on the
    current stream (`csrc/device_graph.cu`). The torch graph keeps the
    memory pool the captured kernels address."""

    def __init__(self):
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        self._exec = None

    def instantiate(self, stream) -> None:
        ex = ctypes.c_void_p()
        rc = _graph_library().device_graph_instantiate(
            ctypes.c_void_p(self.graph.raw_cuda_graph()), ctypes.byref(ex),
            ctypes.c_void_p(stream.cuda_stream))
        if ex.value:
            self._exec = ex
        _build.check(rc, "device_graph_instantiate")

    def replay(self) -> None:
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(_graph_library().device_graph_launch(
            self._exec, ctypes.c_void_p(stream)), "device_graph_launch")

    def __del__(self):
        if self._exec is not None:
            _graph_library().device_graph_destroy(self._exec)


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
        rebuilt engine's view and learned capacity or dup window."""
        self.config = sim_config
        self.render_config = render_config
        self.device = torch.device(device)
        self.metrics = metrics or MetricsRegistry()
        self.camera = camera or Camera(position=render_config.camera_position)
        self.renderer = renderer or Renderer(render_config)
        self.use_graph = (self.device.type == "cuda"
                          and capture_key(sim_config) in CAPTURED)
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
        # fused frames stay float whatever `frame_uint8` says, as the JAX
        # package's do (its runtime/fused.py:166)
        with trace.span("render.copy"):   # zero copies: the buffer itself
            position = self._states[parity].position
        return self.renderer.render_with(position, self._args,
                                         self._num_draw, frame_uint8=False)

    def _simulate(self, parity: int, num_sim: Optional[int]) -> None:
        step_into(self.config, self._step, self._states[parity],
                  self._states[1 - parity], num_sim)

    def _key(self, num_sim: Optional[int]):
        """What a captured frame bakes in besides the static tensors."""
        r = self.renderer
        return (r.dup_y, r.dup_x, r.entry_factor, r.seg_q, r.blend,
                r.chunk_threshold, r.chunk_size, r.composite, r.sort, r.bin,
                integrator.live_count(num_sim, self.state.padded_count))

    def _capture(self, num_sim: Optional[int]) -> None:
        """Capture the render and step graphs of both parities into one
        memory pool."""
        with trace.span("fused.capture"):
            self._capture_graphs(num_sim)

    def _capture_graphs(self, num_sim: Optional[int]) -> None:
        self._graphs = None
        pool = torch.cuda.graph_pool_handle()
        graphs = []
        stream = torch.cuda.current_stream(self.device)
        for parity in (0, 1):
            g_render, g_step = DeviceGraph(), DeviceGraph()
            with torch.cuda.graph(g_render.graph, pool=pool):
                out = self._render(parity)
            with torch.cuda.graph(g_step.graph, pool=pool):
                self._simulate(parity, num_sim)
            for g in (g_render, g_step):
                g.instantiate(stream)
            graphs.append((g_render, out, g_step))
        self._graphs = graphs

    def frame(self, app: AppConfig, num_sim: Optional[int] = None,
              num_draw: Optional[int] = None, stage_timer=None) -> FrameOutput:
        """Render the current state, step it into the other buffer, swap.
        Async: no host sync (except at a capture). `stage_timer` (an
        `EventStageTimer` whose frame is open) gets the "render" mark
        between the two stages."""
        n = self.state.padded_count
        nd = n if num_draw is None else int(num_draw)
        key = self._key(num_sim)
        replay = self.use_graph and key == self._graph_key
        with trace.span("render.draw"):
            with trace.span("render.project"):
                self._set_args(app, min(nd, 2**31 - 1))
            if replay:
                g_render, out, g_step = self._graphs[self._cur]
                g_render.replay()
            else:
                out = self._render(self._cur)
        if stage_timer is not None:
            stage_timer.mark("render")
        with trace.span("step"):
            if replay:
                g_step.replay()
                self.replays += 1
            else:
                self._simulate(self._cur, num_sim)
        self._frame = out
        self._cur = 1 - self._cur
        if self.use_graph and key != self._graph_key:
            # this frame ran eagerly: capture for the next ones
            self._capture(num_sim)
            self._graph_key = key
        # no `interactions` count: the JAX fused frame keeps none (only its
        # split compute engine counts)
        self.metrics.gauge("fused_graph", replay)
        self.step_count += 1
        self.frame_count += 1
        return out

    # -- compute-engine interface ------------------------------------------------
    @property
    def positions(self) -> torch.Tensor:
        return self.state.position

    def get_fence_value(self) -> int:
        return self.step_count

    @property
    def overflow(self) -> Optional[torch.Tensor]:
        """The slot near field's overflow count of the last step (a 0-d
        device tensor, refreshed by every replay), None for the other force
        models."""
        return getattr(self._step.accel_fn, "overflow", None)

    @property
    def outside(self) -> Optional[torch.Tensor]:
        """pm_grid's count of particles the last step left outside the
        mesh (a 0-d device tensor, refreshed by every replay), None for the
        other force models."""
        return getattr(self._step.accel_fn, "outside", None)

    def wait_for_gpu(self) -> None:
        with trace.span("wait"):
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
        """Fence on the last frame with the split engine's deferred growth
        (`present_frame`): ONE packed host read carries fence, counts and
        spans; a truncating frame grows the capacity (or the window) for
        FUTURE frames, which then run eagerly once and recapture (the
        graphs baked the old capacity in). pm_grid's `outside` count of the
        step launched with the frame rides in the same read (the
        `pm_outside` gauge)."""
        if self._frame is not None:
            outside = self.outside
            present_frame(self.renderer, self._frame, self.metrics,
                          None if outside is None
                          else {"pm_outside": outside})
        return self._frame
