"""render_ms: device milliseconds a frame in which the render's work ran:
the union of the intervals of the device operations that the render
launched in the traced frames (tied to it by the profiler's correlation
ids, `trace.span_ops`), over those frames. In split frames that is the
render engine's `draw` call, which the harness wraps; the fused engine has
no such call, and its render, eager or a CUDA graph's replay, is read from
the program's own `render.draw` range. In the split pipeline the render's
kernels share the card with the step on its priority stream, so this is
the device time the render's work held there, not its time alone, and not
the time it waited; in fused frames the render runs alone before the
step."""

LAYER = "render engine and renderer"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "frame_ms"
SPAN = "render.draw"


def read(rec):
    t = rec.get("trace")
    if not t or SPAN not in t.get("span_busy_s", {}):
        return None
    return 1e3 * t["span_busy_s"][SPAN] / t["frames"]
