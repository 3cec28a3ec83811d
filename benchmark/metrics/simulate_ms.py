"""simulate_ms: device milliseconds a frame of the step, between the
program's own "simulate" stage marks (the split step on its stream, from
its start; in fused frames from the engine's "render" mark, after the
render, to the end of the step), summed over the traced frames and
divided by them (`recorder.StageRecorder`)."""

LAYER = "compute engine and force kernels"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frame_ms"


def read(rec):
    t = rec.get("trace")
    if not t or "simulate" not in t["stage_ms"]:
        return None
    return t["stage_ms"]["simulate"] / t["frames"]
