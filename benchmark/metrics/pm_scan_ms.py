"""pm_scan_ms: device milliseconds a frame of the particle-mesh deposit's
scan: the cumsum over the [8, N] corner weights (`ops/pm.py`,
`_deposit_sorted`), which torch runs as one `tensor_kernel_scan_innermost_
dim<float, ...>` launch a step. Its device time in the traced window, from
the trace's breakdown by name (`device_ops`, the ten operations that took
most device time), over the traced frames. Read by name, because under a
CUDA graph's replay the step's `pm.deposit` span launches nothing. No
other operation of a frame scans float32 (the render's scans count
integers), so nothing else matches; nothing to read where no such scan is
in the breakdown."""

LAYER = "compute engine and force kernels"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "frame_ms"
MATCH = "scan_innermost_dim<float"


def read(rec):
    t = rec.get("trace")
    if not t or not t.get("frames") or not t.get("device_ops"):
        return None
    seconds = [s for name, s in t["device_ops"] if MATCH in name]
    if not seconds:
        return None
    return 1e3 * sum(seconds) / t["frames"]
