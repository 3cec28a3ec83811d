"""device_busy_pct: the share of the traced window in which some
operation ran on the device: the union of the intervals of the profiler's
device operations over the window's length (`trace.read`), so a step and a
render on two streams at once count once."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "frame_ms"


def read(rec):
    t = rec.get("trace")
    if not t or not t.get("window_s") or not t.get("busy_s"):
        return None
    return 100.0 * t["busy_s"] / t["window_s"]
