"""launches_per_frame: CUDA kernels the device ran in the traced window,
from the profiler's trace (copies and fills left out), over the traced
frames."""

LAYER = "orchestrator and engines"
UNIT = "launches"
SOURCE = "device_trace"
MOVES = "frame_ms"


def read(rec):
    t = rec.get("trace")
    if not t or "kernels" not in t:
        return None
    return t["kernels"] / t["frames"]
