"""bin_bytes_pct: the exact binning's share of the H100's HBM roofline: the
least time its work needs over the device time of its kernels a frame
(`render_bin_ms`), in percent.

The work is the least the binning itself must move, whatever implements
it: each particle's position read once (x, y, z, |a|: 16 B) and one entry
written a particle (the int32 tile key and four 32-bit payloads, cx, cy,
w_clip and the packed colour pair: 20 B). Not counted: a sprite's further
tiles, the capacity's sentinel tail, the sort that follows, so a change of
the capacity cannot make the count stale. Least time = bytes / 3.35 TB/s,
the H100 SXM data sheet's HBM3 peak at its 700 W limit. At n = 4,194,304:
150,994,944 B, 0.045073 ms a frame.
"""

from benchmark import harness

PEAK_BYTES = 3.35e12
BYTES_PARTICLE = 16 + 20

LAYER = "render engine and renderer"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "frame_ms"


def least_bytes(n: int) -> int:
    return BYTES_PARTICLE * n


def least_ms(n: int) -> float:
    return 1e3 * least_bytes(n) / PEAK_BYTES


def read(rec):
    ms = harness.metric("render_bin_ms").read(rec)
    if not ms or "n" not in rec:
        return None
    return 100.0 * least_ms(rec["n"]) / ms
