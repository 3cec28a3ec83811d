"""One run of one cell: set-up, warm-up, the timed window, the check.

Everything a cell is made of is data found by name: `BENCHMARK.json` at
the checkout's root names the cell's configuration, traffic mix and
metrics; `configs/<config>.json` holds the configuration (its force model
picks its reference, `reference/<force_model>.py`), `traffic/<mix>.json`
the mix, `metrics/<metric>.py` the reader of each metric. A new cell,
configuration, mix or metric is a new file.

A run:

1. Set-up. The program's kernels load from `build/torch_kernels/` in the
   checkout (the first run there builds them). The app is built for the
   configuration and mix; it makes its initial state on the device from
   the seed.
2. Warm-up: the mix's `warmup_frames` frames through `ParticlesApp.draw`.
   The first frame's outputs are kept (host memory) for the check.
3. The window: `draw()` again and again for `seconds`, without vsync, the
   program's own dispatch-ahead bounding the frames in flight. With
   `trace` the first `trace_seconds` of it (at least `trace_min_frames`
   frames) run under `torch.profiler` with a `StageRecorder` as the app's
   stage timer, between two synchronises. Each span that a per-layer
   metric of the cell names (its `SPAN`, as "render.draw") is read from a
   profiler range: where the app has that call (`app.render.draw` in split
   frames) the harness runs it inside a range of its own, as before; where
   it has none (the fused engine renders inside `frame`) the harness reads
   the program's own range for it, `particles.<span>` (`trace.py`).
4. The check frame: state N is copied, one more `draw()` turns it into
   state N+1 and an image of state N. The peak device memory is read, the
   app is freed, and `check.compare` holds the check frame, and the first
   frame from the benchmark's own initial state (`reference/init.py`, made
   on the device from the seed), to the float64 reference.

A mix's `frame_mode` picks the program's frame: "split" (the render engine
draws state N while the compute engine steps N+1) or "fused" (one engine in
both roles on the one card: the first frame eager, then a captured CUDA
graph replayed, `runtime/fused.py`). Both keep the same contract (render
the current state, step into the other buffer, swap), so the outputs and
the check are the same for both.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from benchmark import check
from benchmark import trace as trace_reader
from benchmark.recorder import StageRecorder
from benchmark.reference import init as ref_init

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BUILD_DIR = ROOT / "build" / "torch_kernels"
RECORDS_DIR = ROOT / "build" / "benchmark"
SMI_QUERY = "name,clocks.sm,power.draw,power.limit,temperature.gpu"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def metric(name: str):
    """The reader module `metrics/<name>.py`."""
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def cell(bench: dict, workload: str) -> dict:
    """The cell's entry, configuration, mix and the names of the metrics
    it reports: its end-to-end metrics, and the per-layer ones that name
    it (or, naming no cells, move an end-to-end metric it reports)."""
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    e2e = [m["name"] for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    layer = [m["name"] for m in bench["per_layer"]
             if workload in m.get("workloads", [workload])
             and ("workloads" in m or m["moves"] in e2e)]
    return {"entry": entry, "config": config(entry["config"]),
            "traffic": traffic(entry["traffic"]), "end_to_end": e2e,
            "per_layer": layer}


# -- the program ------------------------------------------------------------

FRAME_MODES = ("split", "fused")


def make_app(cfg: dict, mix: dict, seed: int, device: torch.device):
    """The program's app for the configuration and mix (split or fused
    frames, both roles on `device`), its state made from the seed."""
    from multi_adapter_particles_torch.config import (
        AppConfig,
        RenderConfig,
        SimConfig,
    )
    from multi_adapter_particles_torch.runtime import devices
    from multi_adapter_particles_torch.runtime.orchestrator import ParticlesApp

    if mix["frame_mode"] not in FRAME_MODES:
        raise ValueError(f"unknown frame_mode {mix['frame_mode']!r}")
    if mix["camera"] != "static" or mix["draw"] != "all":
        raise ValueError("the mixes draw every particle from the static "
                         "camera")
    n, ph, cam = cfg["num_particles"], cfg["physics"], cfg["camera"]
    sim = SimConfig(num_particles=n, force_model=cfg["force_model"],
                    dt=ph["dt"], damping=ph["damping"], mass=ph["mass"],
                    softening_squared=ph["softening_squared"],
                    **cfg.get("program", {}))
    render = RenderConfig(width=cfg["width"], height=cfg["height"],
                          fov_y=cam["fov_y"], near=cam["near"],
                          far=cam["far"],
                          camera_position=tuple(cam["position"]))
    app_cfg = AppConfig(num_particles=n, vsync=mix["vsync"], gui=False,
                        max_frame_latency=mix["max_frame_latency"],
                        particle_size=mix["particle_size"],
                        particle_intensity=mix["particle_intensity"],
                        use_queue_extension=mix["queue_extension"])
    index = next(a.index for a in devices.enumerate_adapters()
                 if a.device == device)
    return ParticlesApp(app_cfg, sim, render, compute_adapter=index,
                        render_adapter=index, seed=seed,
                        fused=mix["frame_mode"] == "fused")


def initial_state(cfg: dict, seed: int, device):
    init = cfg["init"]
    return ref_init.two_clusters(cfg["num_particles"], seed, device,
                                 spread=init["spread"], speed=init["speed"])


def outputs(app):
    """(position, velocity, image) the app's last frame left: the state it
    stepped into and the image of the state before (in fused frames both
    come from the one engine that holds both roles)."""
    state = app.compute.state
    return state.position, state.velocity, app.render.last_frame


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# -- the card's clocks ------------------------------------------------------

class SmiSampler:
    """`nvidia-smi` polled every 500 ms beside the run (name, SM clock,
    power draw and limit, temperature); nothing where there is none."""

    def __init__(self):
        try:
            self._proc = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={SMI_QUERY}",
                 "--format=csv,noheader,nounits", "-lms", "500"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self._proc = None

    def stop(self) -> List[str]:
        if self._proc is None:
            return []
        self._proc.terminate()
        out, _ = self._proc.communicate(timeout=30)
        return [ln.strip() for ln in out.splitlines() if ln.strip()]


# -- a run ------------------------------------------------------------------

def run(workload: str, seed: int, seconds: float, trace: bool,
        t_process: float, device=None, overrides: Optional[dict] = None
        ) -> Dict:
    """One run of `workload`; returns the result line's object and writes
    the run's records under `build/benchmark/<workload>/`. `device`
    (default cuda:0) and `overrides` (keys of the configuration) are for
    the CPU tests only."""
    bench = spec()
    c = cell(bench, workload)
    cfg, mix = c["config"], c["traffic"]
    cfg.update(overrides or {})
    device = torch.device(device or "cuda:0")
    cuda = device.type == "cuda"
    if cuda:
        from multi_adapter_particles_torch.ops import _build
        _build.set_build_dir(str(BUILD_DIR))
        torch.cuda.set_device(device)
    mods = readers(c, trace)
    smi = SmiSampler() if cuda else None
    try:
        first, before, after, peak, rec = drive(
            cfg, mix, workload, seed, seconds, trace, device, t_process,
            spans(mods))
    finally:
        rec_smi = smi.stop() if smi is not None else []
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rows = check.sample_rows(cfg, seed, device)
    start = initial_state(cfg, seed, device)
    numbers = check.compare(cfg, mix, start,
                            tuple(t.to(device) for t in first), rows)
    last = check.compare(cfg, mix, before, after, rows)
    rec["numbers_first"], rec["numbers_last"] = numbers, last
    numbers = check.worst(numbers, last)
    rec["reference_s"] = time.perf_counter() - t0
    rec["smi"] = rec_smi

    limits = cfg["check"]["limits"]
    failed = check.verdict(numbers, limits)
    metrics = {}
    for name, mod in mods.items():
        value = mod.read(rec)
        if value is not None:
            metrics[name] = {"value": value, "unit": mod.UNIT}
    result = {"correct": not failed, "attempted": rec["window"]["frames"],
              "failed": len(failed), "metrics": metrics,
              "device": device_info(device, peak, rec)}
    if "device_ops" in rec.get("trace", {}):
        result["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                               "idle_gaps": rec["trace"]["idle_gaps"]}
    result["checks"] = {k: {"value": numbers[k], "limit": limits.get(k)}
                        for k in check.NUMBERS}
    rec["result"] = result
    write_records(rec)
    return result


def readers(c: dict, trace: bool) -> dict:
    """The reader module of each metric the run reports, by name."""
    return {name: metric(name)
            for name in (c["per_layer"] if trace else c["end_to_end"])}


def spans(mods: dict) -> List[str]:
    """The program calls the readers time (their `SPAN`s), each once."""
    return sorted({m.SPAN for m in mods.values() if getattr(m, "SPAN", None)})


def drive(cfg: dict, mix: dict, workload: str, seed: int, seconds: float,
          trace: bool, device: torch.device, t_process: float,
          span_names=()):
    """Set-up, warm-up, window and check frame. Returns the first frame's
    outputs (host), state N (device), the check frame's outputs (device),
    the peak device memory and the run's records; the app is gone."""
    phases = {"imports": time.perf_counter() - t_process}
    app = make_app(cfg, mix, seed, device)
    phases["app"] = time.perf_counter() - t_process
    app.draw()
    sync(device)
    phases["first_frame"] = time.perf_counter() - t_process
    first = tuple(t.to("cpu", copy=True) for t in outputs(app))
    for _ in range(mix["warmup_frames"] - 1):
        app.draw()
    sync(device)
    phases["warm_up"] = time.perf_counter() - t_process
    rec = {"workload": workload, "seed": seed, "traced": trace,
           "n": cfg["num_particles"], "force_model": cfg["force_model"],
           "setup_phases_s": phases}
    window(app, mix, seconds, trace, device, t_process, rec, span_names)
    peak = torch.cuda.max_memory_allocated(device) if device.type == (
        "cuda") else 0
    before = tuple(t.clone() for t in outputs(app)[:2])
    app.draw()
    sync(device)
    after = tuple(t.clone() for t in outputs(app))
    rec["truncated"] = int(app.render.last_output.truncated)
    app.shutdown()
    return first, before, after, peak, rec


def window(app, mix: dict, seconds: float, trace: bool, device,
           t_process: float, rec: dict, span_names=()) -> None:
    """The timed window; fills rec["window"], rec["setup_s"] and, traced,
    rec["trace"]."""
    recorder = prof = None
    wrapped, ranges = [], {}
    sync(device)
    if trace:
        recorder = StageRecorder(device)
        if device.type == "cuda":
            ranges, wrapped = span_ranges(app, span_names)
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.start()
            sync(device)
        app.stage_timer = recorder
    t_start = time.perf_counter()
    rec["setup_s"] = t_start - t_process
    frames = traced = 0
    while True:
        app.draw()
        frames += 1
        if recorder is not None:
            traced += 1
            if (traced >= mix["trace_min_frames"] and time.perf_counter()
                    - t_start >= mix["trace_seconds"]):
                app.stage_timer = None
                sync(device)
                stage = recorder.stage_ms()
                rec["trace"] = {"frames": traced, "stage_ms": stage}
                if prof is not None:
                    prof.stop()
                    for owner, attr in wrapped:
                        delattr(owner, attr)
                    rec["trace"].update(trace_reader.read(
                        prof, traced, span_names, ranges))
                    prof = None
                recorder = None
        if recorder is None and time.perf_counter() - t_start >= seconds:
            break
    sync(device)
    t_end = time.perf_counter()
    rec["window"] = {"seconds": t_end - t_start, "frames": frames}


def program_call(app, name: str):
    """The app's call that span `name` names ("render.draw":
    `app.render.draw`), or None where the app has no such call."""
    owner = app
    for part in name.split("."):
        owner = getattr(owner, part, None)
    return owner if callable(owner) else None


def span_ranges(app, span_names):
    """({span: the profiler range it is read from}, the wrapped calls).
    A span whose call the app has runs inside a range of the harness's own
    (`wrap_span`); any other is read from the program's own range for it
    (`trace.program_range`), which the program opens around that work
    whether it runs eagerly or as a CUDA graph's replay."""
    ranges, wrapped = {}, []
    for name in span_names:
        if program_call(app, name) is not None:
            wrapped.append(wrap_span(app, name))
            ranges[name] = trace_reader.span_range(name)
        else:
            ranges[name] = trace_reader.program_range(name)
    return ranges, wrapped


def wrap_span(app, name: str):
    """Runs the program call `name` ("render.draw": `app.render.draw`)
    inside a profiler range named `name`, by an attribute on its object
    that shadows the method; returns (object, attribute) to take it off."""
    *path, attr = name.split(".")
    owner = app
    for part in path:
        owner = getattr(owner, part)
    call = getattr(owner, attr)

    def timed(*args, **kwargs):
        with torch.profiler.record_function(trace_reader.span_range(name)):
            return call(*args, **kwargs)

    setattr(owner, attr, timed)
    return owner, attr


def device_info(device: torch.device, peak: int, rec: dict) -> dict:
    cuda = device.type == "cuda"
    info = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
            "count": 1, "memory_peak_bytes": int(peak)}
    t = rec.get("trace")
    if t and "busy_s" in t:
        info["busy_s"] = t["busy_s"]
        info["window_s"] = t["window_s"]
    return info


def write_records(rec: dict) -> None:
    out = RECORDS_DIR / rec["workload"]
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"seed{rec['seed']}-trace{int(rec['traced'])}.json"
    tmp = path.with_suffix(f".tmp{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump(rec, f)
    os.replace(tmp, path)
