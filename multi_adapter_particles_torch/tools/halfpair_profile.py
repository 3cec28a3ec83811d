"""Where the time of the half-pair all-pairs kernel
(`all_pairs_accel_halfpair`, `csrc/allpairs.cu`) goes, for one or more
checkouts, on one CUDA GPU.

    python3 multi_adapter_particles_torch/tools/halfpair_profile.py ROOT [ROOT ...]

Each ROOT is a checkout of the repository (this one, or an unpacked
`git archive` of another commit). For each it prints one JSON line:

- `ptxas`, `loops`: ROOT's `csrc/allpairs.cu` compiled for sm_90a, the
  registers and spills of each kernel, and each kernel's hot-loop
  instruction mix per pair (`tools/sass.py`);
- `call_ms`: one 1,048,576-particle call (device init, seed 0) by CUDA
  events, mean of 2 after one warm-up, with the SM clock read under load;
- `kernels`: the device kernels of one profiled call (torch.profiler):
  per name, launches, summed, mean, min and max device ms;
  `profiled_launches`, all device launches of the call; `gap_ms`,
  `call_ms` less the summed kernel time (the launch gaps: the profiled
  call's own wall time, `profiled_call_ms`, carries the profiler's cost
  of every launch);
- where ROOT still has the round schedule (`half_round_kernel`), `round`:
  one round launch alone, by CUDA events (mean of 16 rounds), against the
  FP32 work of its 1,024 tile pairs at the sampled clock;
- `bound_ms`: the call's FP32 issue bound (15 instructions a pair that
  takes both sides, 12 on the diagonal tiles; 132 SMs x 128 lanes at the
  sampled clock), and `issue_ms`, the same pairs at each loop's SASS issue
  slots a pair;
- `attribution` (round schedule only): the gap between `call_ms` and
  `bound_ms` split into the issue mix (SASS slots over 15), round tails
  (the partial wave of each round: 1,024 CTAs on 132 SMs x 8, modelled),
  launch gaps (measured), the end-of-CTA read-modify-write of the
  accumulators (its bytes over HBM's 3.35 TB/s, modelled) and the rest,
  per-SM latency and occupancy.

Kernels build into each checkout's own `build/torch_kernels/`; the round
harness into a temporary directory. Run ROOTs in the order A B B A to
cancel drift.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

N = 1_048_576
T = 512
SMS, LANES = 132, 128
HBM_BYTES_PER_S = 3.35e12
FP32_BOTH, FP32_ISIDE = 15, 12

# One round of the circle method on its own: ROOT's source is included
# whole, so the launch is its own kernel.
_ROUND_HARNESS = r"""
#include "{src}"
extern "C" int one_round(const void* pos, long long n, int round, void* acc,
                         void* comp, float eps2, void* stream) {{
  const int nt = (int)(n / HALF_T), nt_even = nt + (nt & 1);
  half_round_kernel<<<nt_even / 2, HALF_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), n, nt, nt_even, round,
      static_cast<float*>(acc), static_cast<float*>(comp), eps2);
  return static_cast<int>(cudaGetLastError());
}}
"""


def _clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return float(out.stdout.split()[0])


def _issue_ms(lane_slots: float, mhz: float) -> float:
    return lane_slots / (SMS * LANES * mhz * 1e6) * 1e3


def _round_lib(root: str, tmp: str):
    from multi_adapter_particles_torch.ops import _build

    src = Path(root) / "multi_adapter_particles_torch/csrc/allpairs.cu"
    cu = Path(tmp) / "round_harness.cu"
    cu.write_text(_ROUND_HARNESS.format(src=src))
    so = Path(tmp) / "round_harness.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                           str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"round harness: {proc.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.one_round.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                              ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_float, ctypes.c_void_p]
    lib.one_round.restype = ctypes.c_int
    return lib


def measure(root: str) -> dict:
    """The device numbers of one checkout (run in its own process)."""
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from multi_adapter_particles_torch import constants as C
    from multi_adapter_particles_torch.models import init as pinit
    from multi_adapter_particles_torch.ops import allpairs

    if not torch.cuda.is_available():
        raise SystemExit("halfpair_profile.py needs a CUDA GPU")
    dev = torch.device("cuda", 0)
    pos = pinit.initialize_particles_device(
        N, torch.Generator(device=dev).manual_seed(0), device=dev).position
    kw = dict(mass=C.PARTICLE_MASS, softening_squared=C.SOFTENING_SQUARED,
              interaction_scale=1.0 / N)

    def call():
        return allpairs.all_pairs_accel_halfpair(pos, **kw)

    call()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(2):
        call()
    end.record()
    mhz = _clock_mhz()
    torch.cuda.synchronize()
    call_ms = start.elapsed_time(end) / 2

    torch.cuda.synchronize()
    start.record()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        end.record()
        torch.cuda.synchronize()
    profiled_ms = start.elapsed_time(end)
    per = {}
    for ev in prof.events():
        if ev.device_type.name != "CUDA":
            continue
        us = getattr(ev, "device_time", None)
        if us is None:
            us = ev.cuda_time
        name = ev.name.replace("(anonymous namespace)::", "").split("(")[0]
        per.setdefault(name.removeprefix("void ").strip(), []).append(us / 1e3)
    kernels = {name: {"launches": len(v), "sum_ms": sum(v),
                      "mean_ms": statistics.mean(v), "min_ms": min(v),
                      "max_ms": max(v)} for name, v in per.items()}
    busy = sum(k["sum_ms"] for k in kernels.values())
    out = {"root": root, "device": torch.cuda.get_device_name(0),
           "n": N, "mhz": mhz, "call_ms": call_ms,
           "profiled_call_ms": profiled_ms, "kernels": kernels,
           "profiled_launches": sum(k["launches"] for k in kernels.values()),
           "kernel_sum_ms": busy, "gap_ms": call_ms - busy}

    src = Path(root) / "multi_adapter_particles_torch/csrc/allpairs.cu"
    if "half_round_kernel" in src.read_text():
        with tempfile.TemporaryDirectory() as tmp:
            lib = _round_lib(root, tmp)
            acc = torch.zeros((3, N), dtype=torch.float32, device=dev)
            comp = torch.zeros_like(acc)
            stream = torch.cuda.current_stream(dev).cuda_stream

            def one(r):
                rc = lib.one_round(pos.data_ptr(), N, r, acc.data_ptr(),
                                   comp.data_ptr(), C.SOFTENING_SQUARED,
                                   stream)
                if rc:
                    raise SystemExit(f"one_round: CUDA error {rc}")

            one(0)
            times = []
            for r in range(1, 17):
                torch.cuda.synchronize()
                start.record()
                one(r)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            nt = N // T
            pairs = nt // 2 * T * T
            out["round"] = {
                "ms": statistics.mean(times), "min_ms": min(times),
                "max_ms": max(times), "ctas": nt // 2, "pairs": pairs,
                "fp32_bound_ms": _issue_ms(pairs * FP32_BOTH, mhz)}
    return out


def _loop_slots(loops: dict) -> tuple[float, float]:
    """SASS issue slots a pair of the half-pair kernels' rsqrt loops: the
    loop that moves j-side sums (SHFL) and the i-side-only one."""
    both, iside = [], []
    for kernel, mixes in loops.items():
        if kernel.startswith("half_"):
            for mix in mixes:
                if not mix.get("collective"):
                    (both if mix["SHFL"] > 0 else iside).append(mix["slots"])
    return max(both), max(iside)


def _bounds(rec: dict, loops: dict) -> dict:
    """FP32 bound and SASS issue time of the call at the sampled clock;
    for the round schedule, the attribution of the rest."""
    nt = N // T
    diag, off = nt * T * T, nt * (nt - 1) // 2 * T * T
    mhz = rec["mhz"]
    bound = _issue_ms(diag * FP32_ISIDE + off * FP32_BOTH, mhz)
    both, iside = _loop_slots(loops)
    issue = _issue_ms(diag * iside + off * both, mhz)
    out = {"bound_ms": bound, "share": bound / rec["call_ms"],
           "issue_ms": issue, "slots_both": both, "slots_iside": iside}
    if "round" in rec:
        rounds = rec["kernels"]["half_round_kernel"]
        # each round: 1,024 CTAs on 132 SMs x 8, the busiest SMs set it
        tail = rounds["sum_ms"] * (1 - (nt // 2) / (SMS * 8.0))
        # acc and comp (3 floats each) read and written by each CTA for its
        # i-side and its j-side tile, at HBM's rate: an upper estimate, the
        # two 12 MB planes fit in L2
        rmw_bytes = (nt - 1) * (nt // 2) * 2 * T * 3 * 2 * 2 * 4
        rmw = rmw_bytes / HBM_BYTES_PER_S * 1e3
        gaps = rec["gap_ms"]
        out["attribution"] = {
            "issue_mix_ms": issue - bound, "round_tails_ms": tail,
            "launch_gaps_ms": gaps, "epilogue_rmw_ms": rmw,
            "latency_occupancy_ms": rec["call_ms"] - issue - tail - gaps
            - rmw}
    return out


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print("HP " + json.dumps(measure(os.path.abspath(argv[1]))),
              flush=True)
        return 0
    if not argv:
        raise SystemExit(__doc__)
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from multi_adapter_particles_torch.tools import sass

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    for root in argv:
        src = (Path(root) / "multi_adapter_particles_torch/csrc/allpairs.cu")
        ptxas, loops = sass.report(src)
        proc = subprocess.run([sys.executable, __file__, "--one", root],
                              capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("HP ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-2000:], proc.stderr[-4000:], flush=True)
            return 1
        rec = json.loads(lines[-1][3:])
        rec.update(ptxas=ptxas, loops=loops, **_bounds(rec, loops))
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
