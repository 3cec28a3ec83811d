"""Structured per-frame metrics registry — the observability surface.

The reference's only dashboard is the imgui overlay: mode banner, adapter
names, "simulate ms" / "render ms" GPU timers and the 20-frame frame-time
average (`Particles.cpp:354-368,399-409`). This module generalizes that to a
structured registry every engine reports into each frame:

- stage durations (EMA-smoothed, the D3D12GpuTimer readout analog),
- counters (frames, transfer bytes, interactions),
- gauges (particle counts, mode, device names),

with text rendering for the terminal dashboard (the imgui stand-in) and
`as_dict()` for machine consumption (bench.py, JSON logs).

The port's own copy of the JAX package's `utils/metrics.py`, with the same
metric names, so `render_text()` and `as_dict()` read the same.
"""

from __future__ import annotations

import time
from typing import Dict

from multi_adapter_particles_torch.utils.timers import StageTimer, TimerAverageOver


class MetricsRegistry:
    """Per-frame metrics: stages (EMA ms), counters, gauges."""

    def __init__(
        self,
        stage_window: int = 20,
        frame_window: int = 20,
        frame_skip: int = 3,
    ):
        """`frame_skip`: number of initial frame laps excluded from the
        rolling frame-time average. The first frames fold compilation
        (30+ s at large N) into the window; the reference's EMA starts
        post-init (`Particles.cpp:432-434` — timing begins once the loop
        runs), so the steady-state analog skips the warm-up laps."""
        self.stages: Dict[str, StageTimer] = {}
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, object] = {}
        self.frame_timer = TimerAverageOver(frame_window)
        self._stage_window = stage_window
        self._frame_skip = max(0, int(frame_skip))
        self._frame_laps = 0
        self._t0 = time.perf_counter()

    # -- stages ---------------------------------------------------------------
    def stage(self, name: str) -> StageTimer:
        if name not in self.stages:
            self.stages[name] = StageTimer(name, window=self._stage_window)
        return self.stages[name]

    # -- counters / gauges ------------------------------------------------------
    def count(self, name: str, delta: float = 1.0):
        self.counters[name] = self.counters.get(name, 0.0) + delta

    def gauge(self, name: str, value):
        self.gauges[name] = value

    def frame_tick(self) -> float:
        """Call once per frame; returns the rolling average frame seconds.
        The first `frame_skip` laps (compile frames) only reset the lap
        clock — they never enter the average."""
        self.count("frames")
        self._frame_laps += 1
        if self._frame_laps <= self._frame_skip:
            self.frame_timer.reset_lap()
            return self.frame_timer.average
        return self.frame_timer.update()

    # -- derived ----------------------------------------------------------------
    @property
    def frame_ms(self) -> float:
        return self.frame_timer.average * 1e3

    @property
    def fps(self) -> float:
        avg = self.frame_timer.average
        return 1.0 / avg if avg > 0 else 0.0

    def rate(self, counter: str) -> float:
        """Counter per wall-second since registry creation."""
        dt = time.perf_counter() - self._t0
        return self.counters.get(counter, 0.0) / dt if dt > 0 else 0.0

    # -- rendering ----------------------------------------------------------------
    def as_dict(self) -> dict:
        return {
            "stages_ms": {k: v.milliseconds for k, v in self.stages.items()},
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "frame_ms": self.frame_ms,
            "fps": self.fps,
        }

    def render_text(self) -> str:
        """The imgui-overlay stand-in (`Particles.cpp:354-409` layout)."""
        lines = []
        banner = self.gauges.get("mode_banner")
        if banner:
            lines.append(str(banner))
        for key in ("compute_device", "render_device", "mesh"):
            if key in self.gauges:
                lines.append(f"{key.replace('_', ' ')}: {self.gauges[key]}")
        for name, st in self.stages.items():
            lines.append(f"{name} ms: {st.milliseconds:8.3f}")
        lines.append(f"frameTime ms: {self.frame_ms:8.3f}  ({self.fps:6.1f} fps)")
        for name in sorted(self.counters):
            lines.append(f"{name}: {self.counters[name]:,.0f}")
        if "interactions" in self.counters:
            lines.append(f"interactions/s: {self.rate('interactions'):,.3e}")
        return "\n".join(lines)
