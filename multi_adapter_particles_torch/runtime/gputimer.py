"""Device-clock stage timing from CUDA events (the D3D12GpuTimer analog).

The reference timestamps its compute and render queues every frame and
shows "simulate ms" / "render ms" (`include/D3D12GpuTimer.h:117-160`,
`Particles.cpp:399-409`). The JAX package reads the XLA profiler for that
(`runtime/gputimer.py` there). On CUDA the stream itself keeps time:
`EventStageTimer` records an event at the start of every frame and after
each stage, on the compute device's current stream, and resolves them only
once the device has passed them (`Event.query()`), so it never stalls the
pipeline. Each stage sample is the device time between the previous mark
and its own; the frame sample is the device time from one frame's start to
the next frame's start. Stage samples feed the registry's 20-sample EMA
stages ("simulate", "render"); the last WINDOW frame samples are kept for
a median.

Device time between two marks includes any time the device sat idle
waiting for the host to launch the stage, which is what a frame costs.
"""

from __future__ import annotations

from collections import deque
from typing import List, Optional, Tuple

import torch

from multi_adapter_particles_torch.utils.metrics import MetricsRegistry

# frame samples kept for the median, and initial frames left out of every
# sample (first-use costs: allocator growth, library loads)
WINDOW = 30
SKIP = 3


class EventStageTimer:
    """Per-frame CUDA-event stage timing, resolved without host stalls."""

    def __init__(self, metrics: MetricsRegistry, device):
        self.metrics = metrics
        self.device = torch.device(device)
        self.frame_ms: deque = deque(maxlen=WINDOW)
        self._marks: List[Tuple[str, torch.cuda.Event]] = []
        self._pending: deque = deque()
        self._prev_start: Optional[torch.cuda.Event] = None
        self._frames = 0

    def _event(self) -> torch.cuda.Event:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def begin_frame(self) -> None:
        self._marks = [("start", self._event())]

    def mark(self, stage: str) -> None:
        """End of `stage` (started at the previous mark)."""
        self._marks.append((stage, self._event()))

    def end_frame(self) -> None:
        self._pending.append(self._marks)
        self._marks = []
        self.poll()

    def poll(self) -> None:
        """Resolve every pending frame the device has finished."""
        while self._pending and self._pending[0][-1][1].query():
            marks = self._pending.popleft()
            start = marks[0][1]
            self._frames += 1
            counted = self._frames > SKIP
            if self._prev_start is not None and counted:
                self.frame_ms.append(self._prev_start.elapsed_time(start))
            self._prev_start = start
            prev = start
            for stage, ev in marks[1:]:
                if counted:
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
