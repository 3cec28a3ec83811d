"""Where a frame's device time goes, stage by stage, on one CUDA GPU.

    python3 multi_adapter_particles_torch/tools/render_profile.py ROOT [ROOT ...]

Each ROOT is a checkout of the repository (this one, or an unpacked
`git archive` of another commit), run in a fresh process in the order
given (list two as A B B A to cancel drift). For each scene (4,194,304
particles at 1024x1024, the reference default, and 262,144 at 1280x720;
central well, device init, seed 0) it prints one JSON line with:

- `split`: one steady frame of `ParticlesApp.draw()` (split loop) under
  torch.profiler, its device time grouped by the renderer's stages (below),
  the kernels of each group, the sum, and the CUDA-event time of the frame;
- `fused_eager`: one frame of the fused engine run uncaptured, grouped the
  same way (the kernels a captured frame replays);
- `fused`: the captured frame's CUDA-event time over 10 replayed frames,
  and the device time and kernels torch.profiler sums over 3 of them.

The groups: `projection` (projection, keys, colours and the entry
expansion), `sort`, `map` (the tile starts' searchsorted and the
virtual-row map), `gather` (the packed payload rows and their row gather),
`sp` (the composite's [8, Q, V] parameter planes), `composite`,
`tree` (the eager tree-combine of each tile's rows), `assembly` (the
tile-to-frame assembly and the chunk fold), `step` (the simulation step)
and `other`. A kernel belongs to the group of the source line that
launched it: a line tracer opens a `torch.profiler.record_function` range
per group inside `render/renderer.py::_render`, switching at anchor lines
found in the source (so one tool reads both the old and the new renderer),
and around the functions the renderer calls. Kernels the profiler did not
link to a range are grouped by their names. The tracer slows the host,
not the device.

Read the sums against the CUDA-event times: the profiler can drop events in
long windows, so a group sum is a lower bound.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

SCENES = (("4m_1024", 4_194_304, 1024, 1024), ("262k_720p", 262_144, 1280, 720))
WARM, TIMED, PROFILED = 5, 10, 3

# `_render`'s body: a line containing the anchor starts its group, which
# runs to the next anchor (anchors absent from a version are skipped)
ANCHORS = (
    ("sorted_key, s_cx, s_cy, s_w, s_cgb = sort(", "sort"),
    ("starts = torch.searchsorted(", "map"),
    ("kk = torch.arange(q", "sp"),
    ("payload = torch.stack(", "gather"),
    ("t_cx, t_cy, t_w = ", "sp"),
    ("out4 = composite(", "composite"),
    ("chans = [out4[0].T", "tree"),
    ("rs = row_start.long()", "assembly"),
    ("= composite(", "composite"),
    ("if return_trans:", "assembly"),
)
# functions the renderer calls, by name -> their group
CALLS = {
    "_project": "projection", "_colors": "projection",
    "_pixel_bound": "projection", "expand": "projection",
    "pack_cgb": "projection", "bin_sprites": "projection",
    "_bin_window": "projection", "sort_kv_stable": "sort",
    "virtual_rows": "map", "gather_rows": "gather", "unpack_cgb": "sp",
    "composite_rows": "composite", "composite_tiles": "composite",
    "assemble": "assembly", "_chunked_fold": "assembly",
    "central_well_step": "step", "step_into": "step",
}
# the port's own kernels (anonymous namespace), by name -> group, for
# launches the profiler did not link to a range
KERNELS = (("bin_", "projection"), ("histogram_kernel", "sort"),
           ("digit_pass_kernel", "sort"),
           ("gather_kernel", "gather"), ("composite_kernel", "composite"),
           ("tile_rows_kernel", "composite"),
           ("tile_fold_kernel", "composite"), ("central_well", "step"))
GROUPS = ("projection", "sort", "map", "gather", "sp", "composite", "tree",
          "assembly", "step", "other")


class StageTracer:
    """A `sys.settrace` hook that keeps one `record_function("grp:<g>")`
    range open per stage of `_render` and per renderer call."""

    def __init__(self, renderer_module):
        import inspect

        fn = renderer_module._render
        lines, first = inspect.getsourcelines(fn)
        self.render_code = fn.__code__
        self.line_group = {}
        group = "projection"
        for i, text in enumerate(lines):
            for anchor, g in ANCHORS:
                if anchor in text:
                    group = g
                    break
            self.line_group[first + i] = group
        self.stack = []   # (frame, group, open record_function)

    def _open(self, group):
        from torch.autograd.profiler import record_function

        rf = record_function(f"grp:{group}")
        rf.__enter__()
        return rf

    def _tracer(self, frame, event, arg):
        if event == "call":
            code = frame.f_code
            if code is self.render_code:
                self.stack.append([frame, "projection",
                                   self._open("projection")])
                return self._tracer
            group = CALLS.get(code.co_name)
            if group is not None and code.co_filename.startswith(self.root):
                self.stack.append([frame, group, self._open(group)])
                return self._tracer
            return None
        if not self.stack or self.stack[-1][0] is not frame:
            return self._tracer
        top = self.stack[-1]
        if event == "line" and frame.f_code is self.render_code:
            group = self.line_group.get(frame.f_lineno, top[1])
            if group != top[1]:
                top[2].__exit__(None, None, None)
                top[1], top[2] = group, self._open(group)
        elif event == "return":
            top[2].__exit__(None, None, None)
            self.stack.pop()
        return self._tracer

    def __enter__(self):
        self.root = os.path.dirname(os.path.dirname(
            os.path.abspath(self.render_code.co_filename)))
        sys.settrace(self._tracer)
        return self

    def __exit__(self, *exc):
        sys.settrace(None)
        while self.stack:
            self.stack.pop()[2].__exit__(None, None, None)


def _group_of(ev) -> str:
    while ev is not None:
        if ev.name.startswith("grp:"):
            return ev.name[4:]
        ev = ev.cpu_parent
    return "other"


def attribute(prof) -> dict:
    """Device ms and kernels per group from a finished profile."""
    from collections import Counter, defaultdict

    ms, count = defaultdict(float), Counter()
    linked_ms, linked_n = Counter(), Counter()
    total_ms, total_n = Counter(), Counter()
    for ev in prof.events():
        if ev.device_type.name == "CPU":
            for k in ev.kernels:
                g = _group_of(ev)
                ms[g] += k.duration / 1e3
                count[g] += 1
                linked_ms[k.name] += k.duration / 1e3
                linked_n[k.name] += 1
        elif ev.device_type.name == "CUDA" and not ev.name.startswith("grp:"):
            # (a range's own GPU-side span is not a kernel)
            us = getattr(ev, "device_time", None)
            if us is None:
                us = ev.cuda_time
            total_ms[ev.name] += us / 1e3
            total_n[ev.name] += 1
    for name, n in total_n.items():
        left = n - linked_n[name]
        if left <= 0:
            continue
        g = next((grp for key, grp in KERNELS
                  if "anonymous namespace" in name and key in name), "other")
        ms[g] += max(total_ms[name] - linked_ms[name], 0.0)
        count[g] += left
    return {"groups": {g: {"ms": ms[g], "kernels": count[g]}
                       for g in GROUPS if count[g]},
            "device_ms": sum(ms.values()), "kernels": sum(count.values())}


def _profiled(fn, tracer=None) -> dict:
    """One call of `fn` under torch.profiler (and the stage tracer), its
    grouped device time and its CUDA-event time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        start.record()
        if tracer is None:
            fn()
        else:
            with tracer:
                fn()
        end.record()
        torch.cuda.synchronize()
    return {**attribute(prof), "event_ms": start.elapsed_time(end)}


def _event_ms(fn, reps) -> float:
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def scene(n, width, height) -> dict:
    import torch

    from multi_adapter_particles_torch.config import (
        AppConfig,
        RenderConfig,
        SimConfig,
    )
    from multi_adapter_particles_torch.render import renderer as R
    from multi_adapter_particles_torch.runtime.orchestrator import ParticlesApp

    def app(**kw):
        return ParticlesApp(AppConfig(num_particles=n, vsync=False, gui=False),
                            SimConfig(num_particles=n),
                            RenderConfig(width=width, height=height), **kw)

    out = {}
    p = app()
    for _ in range(WARM):
        p.draw()
    out["split"] = {**_profiled(p.draw, StageTracer(R)),
                    "frame_ms": _event_ms(p.draw, TIMED)}
    p.shutdown()
    del p
    torch.cuda.empty_cache()

    p = app(fused=True)
    for _ in range(WARM):
        p.draw()
    eng = p.fused_engine
    eng.use_graph = False
    out["fused_eager"] = _profiled(p.draw, StageTracer(R))
    eng.use_graph = True
    for _ in range(2):   # recapture if the key moved, then replay
        p.draw()
    replays = eng.replays
    frame_ms = _event_ms(p.draw, TIMED)

    def frames():
        for _ in range(PROFILED):
            p.draw()

    prof = _profiled(frames)
    if eng.replays - replays != TIMED + PROFILED:
        raise SystemExit("the fused frames did not all replay a graph")
    out["fused"] = {"frame_ms": frame_ms,
                    "device_ms": prof["device_ms"] / PROFILED,
                    "kernels": prof["kernels"] / PROFILED,
                    "launches_per_frame": eng.launches_per_frame}
    p.shutdown()
    return out


def measure(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("render_profile.py needs a CUDA GPU")
    out = {"root": root, "device": torch.cuda.get_device_name(0)}
    for label, n, width, height in SCENES:
        out[label] = scene(n, width, height)
        torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print("RP " + json.dumps(measure(os.path.abspath(argv[1]))),
              flush=True)
        return 0
    if not argv:
        raise SystemExit(__doc__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    for root in argv:
        proc = subprocess.run([sys.executable, __file__, "--one", root],
                              capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RP ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-2000:], proc.stderr[-4000:], flush=True)
            return 1
        print(lines[-1][3:], flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
