"""The benchmark's arithmetic: the window's rate and busy time.

Every end-to-end and per-layer number the harness reports is computed
here or in a metric file under `metrics/`, never read ready-made from the
program, so a change to the program cannot change the yardstick.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

Interval = Tuple[float, float]


def window_rate_ms(window_s: float, frames: int) -> float:
    """Milliseconds a frame over the whole window: all the time between the
    synchronise before the first frame and the one after the last, over
    every frame launched in it."""
    if frames <= 0:
        raise ValueError("a window with no frames has no rate")
    return window_s * 1e3 / frames


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """The disjoint, sorted union of [start, end) intervals."""
    out: List[Interval] = []
    for start, end in sorted(intervals):
        if end <= start:
            continue
        if out and start <= out[-1][1]:
            if end > out[-1][1]:
                out[-1] = (out[-1][0], end)
        else:
            out.append((start, end))
    return out


def clip(intervals: Iterable[Interval], lo: float, hi: float
         ) -> List[Interval]:
    """The parts of the intervals inside [lo, hi)."""
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if min(e, hi) > max(s, lo)]


def busy_time(intervals: Iterable[Interval], lo: float, hi: float) -> float:
    """Time inside [lo, hi) in which at least one interval is open: the
    union, so work on two streams at once counts once."""
    return sum(e - s for s, e in union(clip(intervals, lo, hi)))


def gaps(intervals: Iterable[Interval], lo: float, hi: float
         ) -> List[Interval]:
    """The idle stretches of [lo, hi): its complement of the union."""
    out, t = [], lo
    for s, e in union(clip(intervals, lo, hi)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out
