"""setup_s: host seconds from the start of the process to the first timed
frame: imports, CUDA start, loading (and in a checkout's first run,
building) the kernels, the app and its initial state, and the warm-up
frames."""

LAYER = None
UNIT = "s"
SOURCE = "host_clock"
MOVES = None


def read(rec):
    return rec.get("setup_s")
