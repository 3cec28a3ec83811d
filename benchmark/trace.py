"""Reading a `torch.profiler` trace of the traced window.

The harness profiles CPU and CUDA activity over a stretch of frames that
starts and ends with `torch.cuda.synchronize()`. From the raw events:

- the window runs from the end of the first `cudaDeviceSynchronize` to the
  end of the last, on the trace's own clock;
- device operations are the CUDA activities (kernels, copies, fills);
  kernels are those that are not copies or fills;
- busy time is the union of the device operations' intervals inside the
  window (`arith.busy_time`): work on two streams at once counts once;
- a span's busy time is the same union over the device operations that a
  call inside the span's profiler range launched: each operation is tied
  to the CUDA runtime or driver call that launched it (`cudaLaunchKernel`,
  `cuLaunchKernel`, `cudaMemcpyAsync`, `cudaGraphLaunch`, ...: a host
  event whose name is `cuda` or `cu` and a capital letter) by the
  profiler's correlation id, and that call lies inside the range. CUPTI
  gives every kernel of a replayed CUDA graph the correlation id of the
  `cudaGraphLaunch` that replayed it, so a replay's kernels tie to the
  range around that launch;
- a span's range is the harness's own, `benchmark.<span>`, around a call
  it wraps, or, where the app has no call to wrap, the program's own,
  `particles.<span>` (the program's `runtime/trace.py` opens it);
- each idle gap of the device is named by the innermost host event that
  spans its middle: what the host was doing while the device waited.
"""

from __future__ import annotations

from bisect import bisect_right
from collections import Counter
from typing import Dict, List, NamedTuple, Optional, Sequence

import re

import torch

from benchmark import arith

SYNC = "cudaDeviceSynchronize"
NOT_KERNELS = ("Memcpy", "Memset")
# a host call of the CUDA runtime or driver API: what launches device work
LAUNCH_CALL = re.compile(r"^cu(da)?[A-Z]")
SPAN_PREFIX = "benchmark."
# the prefix of the ranges the program opens around its own spans
PROGRAM_PREFIX = "particles."


class Event(NamedTuple):
    name: str
    start: float        # microseconds
    end: float
    correlation: int
    kind: str           # "range" (a user annotation), "launch" or "other"


def span_range(name: str) -> str:
    """The profiler range a span's calls run in."""
    return SPAN_PREFIX + name


def program_range(name: str) -> str:
    """The profiler range the program opens around its span `name`."""
    return PROGRAM_PREFIX + name


def events(prof):
    """(device events, host events) of a finished profile."""
    device, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns() / 1e3
        name = ev.name()
        kind = ("range" if ev.is_user_annotation()
                else "launch" if LAUNCH_CALL.match(name) else "other")
        e = Event(name, start, start + ev.duration_ns() / 1e3,
                  int(ev.correlation_id()), kind)
        if ev.device_type() == cuda:
            if kind != "range":
                device.append(e)
        else:
            host.append(e)
    return device, host


def read(prof, frames: int, span_names: Sequence[str] = (),
         ranges: Optional[Dict[str, str]] = None) -> Dict:
    """The traced window's records (`summarize`) from a finished profile."""
    device, host = events(prof)
    return summarize(device, host, frames, span_names, ranges)


def summarize(device: List[Event], host: List[Event], frames: int,
              span_names: Sequence[str] = (),
              ranges: Optional[Dict[str, str]] = None) -> Dict:
    """The traced window's length, the device's busy time, each span's
    busy time and operations, the kernels it ran, the breakdown of device
    time and idle gaps, and the operations tied to no launch (the five
    most frequent names; none where every operation is tied). A span is
    read from the range `ranges` gives it, by default the harness's own
    (`span_range`). Times in seconds."""
    syncs = sorted(e.end for e in host if e.name == SYNC)
    if len(syncs) < 2:
        raise RuntimeError(f"the trace holds {len(syncs)} "
                           f"{SYNC} events; the window needs two")
    lo, hi = syncs[0], syncs[-1]
    inside = [e._replace(start=max(e.start, lo), end=min(e.end, hi))
              for e in device if min(e.end, hi) > max(e.start, lo)]
    busy_us = arith.busy_time([(e.start, e.end) for e in inside], lo, hi)
    kernels = sum(1 for e in inside if not e.name.startswith(NOT_KERNELS))
    by_name: Dict[str, float] = {}
    for e in inside:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.end - e.start) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(arith.gaps([(e.start, e.end) for e in inside], lo, hi),
                  key=lambda g: g[0] - g[1])[:10]
    out = {"frames": frames, "window_s": (hi - lo) / 1e6,
           "busy_s": busy_us / 1e6, "kernels": kernels,
           "device_ops": [[n, t] for n, t in ops],
           "idle_gaps": [[_host_at(host, (s + e) / 2), (e - s) / 1e6]
                         for s, e in idle]}
    out["span_busy_s"], out["span_ops"] = {}, {}
    for name in span_names:
        ops_in = span_ops(inside, host,
                          (ranges or {}).get(name, span_range(name)))
        out["span_ops"][name] = len(ops_in)
        if ops_in:
            out["span_busy_s"][name] = arith.busy_time(
                [(e.start, e.end) for e in ops_in], lo, hi) / 1e6
    launched = {e.correlation for e in host if e.kind == "launch"}
    untied = Counter(e.name for e in inside if e.correlation not in launched)
    out["untied_ops"] = sorted(untied.items(), key=lambda kv: -kv[1])[:5]
    return out


def span_ops(device: List[Event], host: List[Event], range_name: str
             ) -> List[Event]:
    """The device operations launched by a host call inside a range named
    `range_name`."""
    ranges = arith.union((e.start, e.end) for e in host
                         if e.name == range_name)
    if not ranges:
        return []
    starts = [s for s, _ in ranges]
    launched = set()
    for e in host:
        if e.kind == "launch" and e.correlation:
            i = bisect_right(starts, e.start) - 1
            if i >= 0 and e.start <= ranges[i][1]:
                launched.add(e.correlation)
    return [e for e in device if e.correlation in launched]


def _host_at(host: List[Event], t: float) -> str:
    """The innermost host event spanning time t, or "no host event"."""
    best, width = "no host event", float("inf")
    for e in host:
        if e.start <= t <= e.end and e.end - e.start < width:
            best, width = e.name, e.end - e.start
    return best
