"""A stage recorder the harness hands to the program in a traced run.

`ParticlesApp.draw`, `FusedEngine.frame` and `ComputeEngine.simulate` call
a stage timer at their own stage boundaries: `begin_frame()` at the start
of a frame, `begin()` where a stage starts on a stream of its own,
`mark(stage)` where a stage ends, `end_frame()`. This recorder takes a
stamp at each call (`stamp`: a CUDA event on the current stream, or the
host clock on the CPU) and keeps every one of every frame: nothing is
skipped, averaged or dropped. After the window (`stage_ms`) a stage's time
in a frame runs from the previous mark, or from a `begin()` just before
it, to its own mark.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch


def stamp(device: torch.device):
    """A point in time on `device`'s clock: a CUDA event recorded on its
    current stream, or on the CPU the host clock."""
    if device.type != "cuda":
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def elapsed_ms(a, b) -> float:
    """Milliseconds from stamp `a` to stamp `b` (after a synchronise)."""
    if isinstance(a, float):
        return (b - a) * 1e3
    return a.elapsed_time(b)


class StageRecorder:
    def __init__(self, device):
        self.device = torch.device(device)
        self.frames: List[List[Tuple[Optional[str], object]]] = []
        self._marks: List[Tuple[Optional[str], object]] = []

    def begin_frame(self) -> None:
        self._marks = [("start", stamp(self.device))]

    def begin(self) -> None:
        self._marks.append((None, stamp(self.device)))

    def mark(self, stage: str) -> None:
        self._marks.append((stage, stamp(self.device)))

    def end_frame(self) -> None:
        self.frames.append(self._marks)
        self._marks = []

    def close(self) -> None:
        """The orchestrator's shutdown hook: nothing to drain here."""

    def stage_ms(self) -> Dict[str, float]:
        """Milliseconds of each stage summed over every recorded frame."""
        total: Dict[str, float] = {}
        for marks in self.frames:
            prev = marks[0][1]
            for stage, at in marks[1:]:
                if stage is not None:
                    total[stage] = total.get(stage, 0.0) + elapsed_ms(prev,
                                                                      at)
                prev = at
        return total
