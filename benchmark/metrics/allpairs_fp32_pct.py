"""allpairs_fp32_pct: the whole step's share of the H100's float32 peak
in the all-pairs configuration: the least time the step's work needs on
the card over the step's device time a frame (`simulate_ms`), in percent.

The work is counted from the algorithm, whatever implements it:

- a pair of bodies, both sides accumulated (Newton's third law), each
  operation counted once and an FMA as two: d = p_j - p_i (3), d.d (5),
  + eps^2 (1), inv^3 from inv = rsqrt(d^2 + eps^2) (2; the rsqrt is a
  special-function op, not an FP32 one), s * d (3), a_i += (3), a_j -= (3):
  20 operations for each of the n (n - 1) / 2 unordered pairs (the self
  pair needs none);
- a body: the mass scale once after the sum (3), |a| (5; the sqrt is not
  counted), the Euler tail v' = (v + a dt) damping, p' = p + v' dt (15):
  23;
- bytes: the state read once (position xyz and velocity, 24 B) and
  written once (position xyzw and velocity, 28 B): 52 B a body.

Least time = max(operations / 67 TFLOP/s, bytes / 3.35 TB/s), the H100
SXM data sheet's float32 (non-tensor) and HBM3 peaks at its 700 W limit.
At n = 1,048,576 that is 10,995,129,909,248 operations, 164.106 ms.
"""

PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
OPS_PAIR = 20
OPS_BODY = 23
BYTES_BODY = 52

LAYER = "compute engine and force kernels"
UNIT = "%"
SOURCE = "program_span"
MOVES = "frame_ms"


def operations(n: int) -> int:
    return OPS_PAIR * (n * (n - 1) // 2) + OPS_BODY * n


def least_ms(n: int) -> float:
    return 1e3 * max(operations(n) / PEAK_FP32, BYTES_BODY * n / PEAK_BYTES)


def read(rec):
    t = rec.get("trace")
    if not t or rec.get("force_model") != "all_pairs":
        return None
    step_ms = t["stage_ms"].get("simulate", 0.0) / t["frames"]
    if step_ms <= 0:
        return None
    return 100.0 * least_ms(rec["n"]) / step_ms
