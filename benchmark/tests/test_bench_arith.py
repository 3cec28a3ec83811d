"""The metric arithmetic on synthetic records."""

import pytest

from benchmark import arith, harness, trace


def test_window_rate_is_all_time_over_all_frames():
    assert arith.window_rate_ms(30.0, 6000) == pytest.approx(5.0)
    # a stall anywhere in the window shows in the rate
    frames = [5.0] * 5999 + [505.0]
    assert arith.window_rate_ms(sum(frames) / 1e3, 6000) == pytest.approx(
        5.0 + 500.0 / 6000)
    with pytest.raises(ValueError):
        arith.window_rate_ms(1.0, 0)


def test_frame_ms_through_the_metric_file():
    rec = {"window": {"seconds": 1.0, "frames": 100}}
    assert harness.metric("frame_ms").read(rec) == pytest.approx(10.0)


def test_union_against_sum_with_overlapping_streams():
    # a long step on one stream, short render kernels on another beside it
    step = [(0.0, 100.0)]
    render = [(10.0 + 5 * k, 12.0 + 5 * k) for k in range(10)]
    total = sum(e - s for s, e in step + render)
    assert total == 120.0                      # the sum passes the window
    assert arith.busy_time(step + render, 0.0, 100.0) == 100.0
    # gaps: two kernels on one stream, idle between and after
    ivs = [(0.0, 1.0), (3.0, 4.0), (3.5, 6.0)]
    assert arith.busy_time(ivs, 0.0, 10.0) == 4.0
    assert arith.gaps(ivs, 0.0, 10.0) == [(1.0, 3.0), (6.0, 10.0)]
    # clipped to the window
    assert arith.busy_time([(-5.0, 2.0), (9.0, 20.0)], 0.0, 10.0) == 3.0


def test_busy_pct_through_the_metric_file():
    rec = {"trace": {"frames": 4, "window_s": 2.0, "busy_s": 1.5,
                     "kernels": 1000, "stage_ms": {}}}
    assert harness.metric("device_busy_pct").read(rec) == 75.0
    assert harness.metric("launches_per_frame").read(rec) == 250.0


def test_allpairs_count_at_one_mebibody():
    m = harness.metric("allpairs_fp32_pct")
    n = 1_048_576
    pairs = n * (n - 1) // 2
    assert pairs == 549_755_289_600
    assert m.operations(n) == 20 * pairs + 23 * n == 10_995_129_909_248
    assert m.least_ms(n) == pytest.approx(164.10641655594029)
    # the float32 bound, not the bytes one, sets the least time
    assert 52 * n / m.PEAK_BYTES * 1e3 < 0.1
    rec = {"n": n, "force_model": "all_pairs",
           "trace": {"frames": 3, "stage_ms": {"simulate": 3 * 328.2}}}
    assert m.read(rec) == pytest.approx(100 * 164.10641655594029 / 328.2)
    assert m.read(dict(rec, force_model="central_well")) is None


def test_stage_metric_divides_by_traced_frames():
    rec = {"trace": {"frames": 4, "stage_ms": {"simulate": 0.4}}}
    assert harness.metric("simulate_ms").read(rec) == pytest.approx(0.1)
    assert harness.metric("render_ms").read(rec) is None


def _ev(name, start, end, corr=0, kind="other"):
    return trace.Event(name, start, end, corr, kind)


def test_launch_calls_are_runtime_and_driver_names():
    for name in ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync",
                 "cuLaunchKernelEx", "cudaGraphLaunch"):
        assert trace.LAUNCH_CALL.match(name)
    for name in ("aten::copy_", "cutlass_op", "custom", "benchmark.x"):
        assert not trace.LAUNCH_CALL.match(name)


def test_span_is_the_union_of_the_work_its_calls_launched():
    """Device operations tie to the host launch by correlation id; a
    span's busy time is the union of those launched inside its range,
    however long they waited, and none of the others."""
    rng = trace.span_range("render.draw")
    host = [_ev(trace.SYNC, 0.0, 10.0, kind="launch"),
            _ev(rng, 20.0, 30.0, kind="range"),
            _ev("cudaLaunchKernel", 21.0, 22.0, 1, "launch"),
            _ev("cuLaunchKernel", 23.0, 24.0, 2, "launch"),
            _ev("cudaLaunchKernel", 31.0, 32.0, 3, "launch"),
            _ev(rng, 40.0, 50.0, kind="range"),
            _ev("cudaMemcpyAsync", 41.0, 42.0, 4, "launch"),
            _ev("aten::add", 41.0, 42.0, 5),
            _ev(trace.SYNC, 990.0, 1010.0, kind="launch")]
    device = [_ev("render_a", 100.0, 200.0, 1),
              _ev("render_b", 150.0, 260.0, 2),        # overlaps render_a
              _ev("step", 30.0, 900.0, 3),              # launched outside
              _ev("Memcpy DtoD", 300.0, 310.0, 4),
              _ev("not_tied", 400.0, 410.0, 5)]         # id of a cpu_op
    t = trace.summarize(device, host, 2, ["render.draw"])
    assert t["span_ops"] == {"render.draw": 3}
    assert t["span_busy_s"]["render.draw"] == pytest.approx(170e-6)
    assert t["window_s"] == pytest.approx(1000e-6)
    assert t["busy_s"] == pytest.approx(870e-6)
    assert t["kernels"] == 4
    m = harness.metric("render_ms")
    assert m.read({"trace": t}) == pytest.approx(1e3 * 170e-6 / 2)
    assert t["untied_ops"] == [("not_tied", 1)]
    # no range in the trace: nothing to read
    t = trace.summarize(device, host[:1] + host[-1:], 2, ["render.draw"])
    assert t["span_ops"] == {"render.draw": 0}
    assert m.read({"trace": t}) is None


def test_graph_launch_ties_a_replay_to_the_programs_range():
    """A replayed CUDA graph is one `cudaGraphLaunch` on the host; its
    kernels carry that launch's correlation id, so they tie to the range
    around it, here the program's own `particles.render.draw`."""
    rng = trace.program_range("render.draw")
    assert rng == "particles.render.draw"
    host = [_ev(trace.SYNC, 0.0, 10.0, kind="launch"),
            _ev("particles.frame", 15.0, 40.0, kind="range"),
            _ev(rng, 20.0, 25.0, kind="range"),
            _ev("cudaGraphLaunch", 21.0, 24.0, 7, "launch"),
            _ev("particles.step", 26.0, 30.0, kind="range"),
            _ev("cudaGraphLaunch", 27.0, 29.0, 8, "launch"),
            _ev(trace.SYNC, 990.0, 1010.0, kind="launch")]
    device = [_ev("project", 100.0, 300.0, 7), _ev("sort", 300.0, 400.0, 7),
              _ev("composite", 400.0, 450.0, 7), _ev("well", 450.0, 500.0, 8)]
    t = trace.summarize(device, host, 1, ["render.draw"],
                        {"render.draw": rng})
    assert t["span_ops"] == {"render.draw": 3}
    assert t["span_busy_s"]["render.draw"] == pytest.approx(350e-6)
    assert t["untied_ops"] == [] and t["kernels"] == 4
    # the harness's own range is absent here: read by default, nothing
    assert trace.summarize(device, host, 1, ["render.draw"])["span_ops"] == {
        "render.draw": 0}


class _RenderEngine:
    def draw(self):
        return "drawn"


class _App:
    def __init__(self, split):
        self.render = _RenderEngine() if split else object()


@pytest.mark.parametrize("has_call", [True, False], ids=["split", "fused"])
def test_span_is_wrapped_where_the_app_has_the_call(has_call):
    """Split: `app.render.draw` runs inside the harness's range, as before.
    Fused (no `draw`): nothing is wrapped and the program's range is read.
    A span naming a path the app lacks is read the program's way too."""
    app = _App(has_call)
    ranges, wrapped = harness.span_ranges(app, ["render.draw", "no.such"])
    assert ranges["no.such"] == "particles.no.such"
    if has_call:
        assert ranges["render.draw"] == "benchmark.render.draw"
        assert wrapped == [(app.render, "draw")]
        assert "draw" in vars(app.render) and app.render.draw() == "drawn"
        delattr(*wrapped[0])
        assert "draw" not in vars(app.render)
    else:
        assert ranges["render.draw"] == "particles.render.draw"
        assert wrapped == [] and not hasattr(app.render, "draw")
