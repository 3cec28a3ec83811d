"""frame_ms: milliseconds a frame over the timed window, all the work
over all the time: the host clock from a synchronise before the first
frame to a synchronise after the last, divided by the frames launched in
between (`arith.window_rate_ms`)."""

from benchmark import arith

LAYER = None
UNIT = "ms"
SOURCE = "host_clock"
MOVES = None


def read(rec):
    w = rec.get("window")
    if not w or not w["frames"]:
        return None
    return arith.window_rate_ms(w["seconds"], w["frames"])
