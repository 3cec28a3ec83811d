"""The program's host spans (`runtime/trace.py`), on the CPU.

With no profiler running a span is one shared no-op context and a frame
records nothing. Under `torch.profiler.profile` (CPU activity) a frame of
4,096 bodies at 64x64 opens `particles.*` ranges nested as the program
nests them: `step`, `render.draw` and `wait` inside `frame`, the render's
stages inside `render.draw`, and every operation `render.draw` runs
inside exactly one stage, in the split and the fused frame, the chunked
fold and the mesh render, with the exact binning (`render.bin`) and on the
dup-window path. A live reconfiguration opens `reconfigure` with
`wait` inside, a diagnostics sample `diagnostics`, and `-trace DIR` writes
the spans into its chrome trace.
"""

import json

import pytest
import torch

from multi_adapter_particles_torch import app as cli
from multi_adapter_particles_torch.config import AppConfig, RenderConfig, SimConfig
from multi_adapter_particles_torch.models.diagnostics import DiagnosticsProbe
from multi_adapter_particles_torch.runtime import devices, trace
from multi_adapter_particles_torch.runtime.orchestrator import ParticlesApp

torch.set_num_threads(1)

N = 4096
RENDER = RenderConfig(width=64, height=64)
STAGES = ("render.copy", "render.project", "render.bin", "render.sort",
          "render.composite")
# the spans every frame opens: `render.project` holds the device arguments
# (cached in split frames) and the dup-window path's binning
FRAME_SPANS = {"frame", "wait", "step", "render.draw",
               *STAGES} - {"render.project"}
# every span the program opens (`runtime/trace.py`)
ALL_SPANS = FRAME_SPANS | {"fused.capture", "reconfigure", "diagnostics",
                           "pm.deposit", "pm.solve", "pm.interp"}


def _app(mode="split", n=N, **kw):
    kw.setdefault("compute_adapter", devices.cpu_adapter_index())
    return ParticlesApp(
        AppConfig(num_particles=n, particle_size=10.0, vsync=True,
                  gui=False),
        SimConfig(num_particles=n), RENDER, fused=mode == "fused", **kw)


def _profile(fn):
    """(ranges, aten ops) of a CPU profile of fn(): ranges as (span name,
    start, end) for the `particles.*` ones, ops as (name, start, end)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    ranges, ops = [], []
    for ev in prof.profiler.kineto_results.events():
        t = (ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
        if ev.is_user_annotation() and t[0].startswith(trace.PREFIX):
            ranges.append((t[0][len(trace.PREFIX):], *t[1:]))
        elif t[0].startswith("aten::"):
            ops.append(t)
    return ranges, ops


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _parents(ranges):
    """Span name -> the names of the spans directly around its ranges."""
    out = {}
    for r in ranges:
        around = [o for o in ranges if o is not r and _inside(r, o)]
        if around:
            tight = min(around, key=lambda o: o[2] - o[1])
            out.setdefault(r[0], set()).add(tight[0])
        else:
            out.setdefault(r[0], set()).add(None)
    return out


def _assert_stages_tile(ranges, ops, draw="render.draw"):
    """Every aten op inside a `draw` range lies in exactly one stage."""
    draws = [r for r in ranges if r[0] == draw]
    stages = [r for r in ranges if r[0] in STAGES]
    assert draws
    inside = [op for op in ops if any(_inside(op, d) for d in draws)]
    assert inside
    for op in inside:
        n = sum(_inside(op, s) for s in stages)
        assert n == 1, (op, n)


def test_span_off_is_one_shared_noop():
    assert not torch.autograd._profiler_enabled()
    a, b = trace.span("frame", 3), trace.span("render.sort")
    assert a is b
    with a:
        pass
    with trace.span("step"):
        with trace.span("wait"):
            pass


def test_no_span_names_a_launch_call():
    """A name that starts with `cu` reads as a CUDA API call to the
    benchmark's trace reader."""
    assert not any(name.startswith("cu") for name in ALL_SPANS)


@pytest.mark.parametrize("mode", ["split", "fused"])
def test_frame_opens_no_range_without_a_profiler(mode, monkeypatch):
    app = _app(mode)
    app.draw()

    def refuse(*args, **kwargs):
        raise AssertionError("a range was opened with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    app.draw()
    app.shutdown()


@pytest.mark.parametrize("mode", ["split", "fused"])
def test_frame_spans_nest(mode):
    app = _app(mode)
    app.draw()
    ranges, _ = _profile(app.draw)
    app.shutdown()
    names = {r[0] for r in ranges}
    assert FRAME_SPANS <= names
    parents = _parents(ranges)
    assert parents["frame"] == {None}
    for name in ("step", "render.draw", "wait"):
        assert parents[name] == {"frame"}, name
    for name in names & set(STAGES):
        assert parents[name] == {"render.draw"}, name
    assert sum(r[0] == "frame" for r in ranges) == 1


@pytest.mark.parametrize("mode", ["split", "fused"])
def test_render_stages_tile_render_draw(mode):
    app = _app(mode)
    app.draw()
    _assert_stages_tile(*_profile(app.draw))
    app.shutdown()


def test_chunked_render_stages_tile_render_draw():
    """A state past the chunk threshold: the chunks' slices, their renders
    and the fold, each inside one stage."""
    app = _app(n=3 * 1024)
    app.render.renderer.chunk_threshold = 1024
    app.render.renderer.chunk_size = 1024
    app.draw()
    ranges, ops = _profile(app.draw)
    app.shutdown()
    _assert_stages_tile(ranges, ops)
    assert sum(r[0] == "render.sort" for r in ranges) == 3


def test_window_render_stages_tile_render_draw():
    """A renderer given a dup window: its binning inside `render.project`,
    and no `render.bin`."""
    app = _app()
    renderer = app.render.renderer
    renderer.dup_y = renderer.dup_x = 2
    app.draw()
    ranges, ops = _profile(app.draw)
    app.shutdown()
    _assert_stages_tile(ranges, ops)
    names = {r[0] for r in ranges}
    assert "render.project" in names and "render.bin" not in names


def test_mesh_render_stages_tile_render_draw(monkeypatch):
    """The sharded render over a two-shard mesh: the ranks' renders, the
    gather of their image pairs (`render.copy`) and the pair fold."""
    ads = [devices.AdapterInfo(i, torch.device("cpu"), "cpu", f"cpu {i}")
           for i in range(2)]
    monkeypatch.setattr(devices, "enumerate_adapters", lambda: ads)
    app = _app(compute_adapter=0, render_adapter=0, mesh_devices=2,
               shard_render=True)
    assert app.render.mesh is not None
    app.draw()
    ranges, ops = _profile(app.draw)
    app.shutdown()
    _assert_stages_tile(ranges, ops)
    assert _parents(ranges)["step"] == {"frame"}
    assert sum(r[0] == "render.sort" for r in ranges) == 2


def test_reconfiguration_opens_reconfigure_with_wait_inside(monkeypatch):
    ads = [devices.AdapterInfo(i, torch.device("cpu"), "cpu", f"cpu {i}")
           for i in range(2)]
    monkeypatch.setattr(devices, "enumerate_adapters", lambda: ads)
    app = _app(compute_adapter=0, render_adapter=0)
    app.draw()
    app.set_render_adapter(1)
    ranges, _ = _profile(app.draw)
    app.shutdown()
    assert app.render.device == torch.device("cpu")
    assert app.metrics.counters["reconfigurations"] == 1
    parents = _parents(ranges)
    assert parents["reconfigure"] == {"frame"}
    assert "reconfigure" in parents["wait"]


def test_diagnostics_span_opens_when_it_samples():
    cfg = SimConfig(num_particles=1024, force_model="all_pairs")
    app = ParticlesApp(
        AppConfig(num_particles=1024, vsync=False, gui=False), cfg, RENDER,
        compute_adapter=devices.cpu_adapter_index())
    probe = DiagnosticsProbe(cfg, 2)
    app.draw()
    ranges, _ = _profile(lambda: [probe.maybe_publish(
        k, app.compute.state, app.metrics) for k in (1, 2, 3)])
    app.shutdown()
    assert [r[0] for r in ranges] == ["diagnostics"]


def test_gate_follows_the_profiler():
    off = trace.span("frame")
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        on = trace.span("frame", 7)
        assert on is not off
        assert isinstance(on, torch.profiler.record_function)
        assert on.name == "particles.frame" and on.args == "7"
        with on:
            pass
    finally:
        prof.stop()
    assert trace.span("frame") is off
    names = [e.name for e in prof.events()]
    assert names.count("particles.frame") == 1


def test_trace_flag_writes_the_spans(tmp_path):
    d = tmp_path / "trace"
    rc = cli.main(["-numparticles", "2048", "-steps", "3", "-nogui",
                   "-width", "64", "-height", "64", "-diagnostics", "2",
                   "-trace", str(d), "-computeadapter",
                   str(devices.cpu_adapter_index())])
    assert rc == 0
    events = json.loads((d / "trace.json").read_text())["traceEvents"]
    names = {e["name"][len(trace.PREFIX):] for e in events
             if e.get("cat") == "user_annotation"
             and e["name"].startswith(trace.PREFIX)}
    # the first frame's device arguments open `render.project`
    assert names == FRAME_SPANS | {"diagnostics", "render.project"}
