"""render_bin_ms: device milliseconds a frame of the exact binning's
kernels (`bin_count_kernel` and `bin_emit_kernel`, the program's
`csrc/binning.cu`): their device time in the traced window, from the
trace's breakdown by name (`device_ops`, the ten operations that took most
device time), over the traced frames. Read by name, because under a CUDA
graph's replay the render's inner spans launch nothing. Nothing to read
unless both kernels are in the breakdown: a program without the exact
binning has neither."""

LAYER = "render engine and renderer"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "frame_ms"
KERNELS = ("bin_count_kernel", "bin_emit_kernel")


def read(rec):
    t = rec.get("trace")
    if not t or not t.get("frames") or not t.get("device_ops"):
        return None
    seconds = {k: 0.0 for k in KERNELS}
    found = set()
    for name, s in t["device_ops"]:
        for k in KERNELS:
            if k in name:
                seconds[k] += s
                found.add(k)
    if found != set(KERNELS):
        return None
    return 1e3 * sum(seconds.values()) / t["frames"]
