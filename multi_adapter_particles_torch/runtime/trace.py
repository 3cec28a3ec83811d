"""The port's tracing: device-clock stage timing and host spans.

**Stage timing from CUDA events** (the D3D12GpuTimer analog). The
reference timestamps its compute and render queues every frame and
shows "simulate ms" / "render ms" (`include/D3D12GpuTimer.h:117-160`,
`Particles.cpp:399-409`). The JAX package reads the XLA profiler for that
(`runtime/gputimer.py` there). On CUDA the stream itself keeps time:
`EventStageTimer` records an event at the start of every frame and after
each stage, on the stream the stage ran on (the compute device's current
stream, or the split step's high-priority stream, `utils/extension.py`),
and resolves them only once the device has passed them (`Event.query()`),
so it never stalls the pipeline. Each stage sample is the device time
between the previous mark (or a `begin` on the stage's own stream) and its
own; the frame sample is the device time from one frame's start to the
next frame's start. Stage samples feed the registry's 20-sample EMA
stages ("simulate", "render"); the last WINDOW frame samples are kept for
a median.

Device time between two marks includes any time the device sat idle
waiting for the host to launch the stage, which is what a frame costs.

**Host spans** (`span`). The code that does a frame's work runs inside
named spans: `frame` (`ParticlesApp.draw`, with the frame count), `wait`
(every host block on the device in the frame path), `step`,
`render.draw` and its five stages `render.copy`, `render.project`,
`render.bin` (the exact binning), `render.sort`, `render.composite`
(every operation `render.draw` launches lies in exactly one),
`fused.capture`, `reconfigure` and `diagnostics`. Under a CUDA graph's
replay the stages launch nothing (the replay is one launch inside
`render.draw`). Counters: `present()`'s one packed read fills the gauges
`render_entries` and `render_truncated` (the tile entries the last
presented frame binned and dropped, `runtime/render_engine.py`),
`render_sort_skipped` (the sort slots past those entries, which the
exact path's sorts do not sort) and `render_blend_share` (the (entry,
32-pixel block) pairs the composite's row kernel blended, over entries x
the tile's blocks). While a `torch.profiler` profile runs, a span is a
`record_function` range named `particles.<name>` on the profiler's own
clock, beside the device activity it launched (tied to it by correlation
id), nested on the host thread under the span that opened it. With no
profiler running a span is one shared no-op context: nothing is recorded
and nothing allocated. So the spans show in a `-trace DIR` run's chrome
trace and in the benchmark's traced stretch, and nowhere else. No span
name starts with `cu`, which a trace reader takes for a CUDA API call.
"""

from __future__ import annotations

import contextlib
from collections import deque
from typing import List, Optional, Tuple

import torch

from multi_adapter_particles_torch.utils.metrics import MetricsRegistry

# frame samples kept for the median, and initial frames left out of every
# sample (first-use costs: allocator growth, library loads)
WINDOW = 30
SKIP = 3

# the profiler range of span `name` is PREFIX + name
PREFIX = "particles."
_OFF = contextlib.nullcontext()


def span(name: str, frame: Optional[int] = None):
    """A context manager around one span of the program's work: with a
    profiler running, a `record_function` range `particles.<name>` (the
    frame count, where given, as its argument); otherwise the one shared
    no-op context."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(
        PREFIX + name, None if frame is None else str(frame))


class EventStageTimer:
    """Per-frame CUDA-event stage timing, resolved without host stalls."""

    def __init__(self, metrics: MetricsRegistry, device):
        self.metrics = metrics
        self.device = torch.device(device)
        self.frame_ms: deque = deque(maxlen=WINDOW)
        self._marks: List[Tuple[Optional[str], torch.cuda.Event]] = []
        self._pending: deque = deque()
        self._prev_start: Optional[torch.cuda.Event] = None
        self._frames = 0

    def _event(self) -> torch.cuda.Event:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def begin_frame(self) -> None:
        self._marks = [("start", self._event())]

    def begin(self) -> None:
        """Start of the next stage, on the current stream: a stage on a
        stream of its own starts here, not at the previous mark."""
        self._marks.append((None, self._event()))

    def mark(self, stage: str) -> None:
        """End of `stage` (started at the previous mark or `begin`), on
        the current stream."""
        self._marks.append((stage, self._event()))

    def end_frame(self) -> None:
        self._pending.append(self._marks)
        self._marks = []
        self.poll()

    def poll(self) -> None:
        """Resolve every pending frame the device has finished (all its
        marks: stages on two streams may end in either order)."""
        while self._pending and all(ev.query()
                                    for _, ev in self._pending[0]):
            marks = self._pending.popleft()
            start = marks[0][1]
            self._frames += 1
            counted = self._frames > SKIP
            if self._prev_start is not None and counted:
                self.frame_ms.append(self._prev_start.elapsed_time(start))
            self._prev_start = start
            prev = start
            for stage, ev in marks[1:]:
                if counted and stage is not None:
                    self.metrics.stage(stage).add_sample(
                        prev.elapsed_time(ev) / 1e3
                    )
                prev = ev

    def close(self) -> None:
        """Drain: wait for the device, resolve everything, publish the
        frame samples as the `device_frame_ms` gauge."""
        torch.cuda.synchronize(self.device)
        self.poll()
        self.metrics.gauge("device_frame_ms", list(self.frame_ms))
