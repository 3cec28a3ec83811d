"""Where the time of the half-pair all-pairs kernel
(`all_pairs_accel_halfpair`, `csrc/allpairs.cu`) goes, for one or more
checkouts, on one CUDA GPU.

    python3 multi_adapter_particles_torch/tools/halfpair_profile.py ROOT [ROOT ...]

Each ROOT is a checkout of the repository (this one, or an unpacked
`git archive` of another commit; the package directory is enough). For
each it prints one JSON line:

- `ptxas`, `loops`: ROOT's `csrc/allpairs.cu` compiled for sm_90a, the
  registers and spills of each kernel, and each kernel's hot-loop
  instruction mix per pair (`tools/sass.py`);
- `wave`: the item kernel's CTAs the card runs at once (SMs x CTAs an SM);
- `call_ms`: one 1,048,576-particle call (device init, seed 0) by CUDA
  events, mean of 2 after one warm-up, with the SM clock read under load;
  `small_ms`: the same at 65,536 and 131,072 (mean of 20);
- `kernels`: the device kernels of one profiled call (torch.profiler):
  per name, launches, summed, mean, min and max device ms;
  `profiled_launches`, all device launches of the call; `gap_ms`,
  `call_ms` less the summed kernel time (the launch gaps: the profiled
  call's own wall time, `profiled_call_ms`, carries the profiler's cost
  of every launch);
- `bound_ms`: the call's FP32 issue bound (14 instructions a pair that
  takes both sides, 11 on the diagonal tiles; 132 SMs x 128 lanes at the
  sampled clock), `share` = bound over call, and `issue_ms`, the same
  pairs at each loop's SASS issue slots a pair.

Kernels build into each checkout's own `build/torch_kernels/`. Run ROOTs
in the order A B B A to cancel drift.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

N = 1_048_576
T = 512
SMS, LANES = 132, 128
FP32_BOTH, FP32_ISIDE = 14, 11
SMALL = (65_536, 131_072)


def _clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return float(out.stdout.split()[0])


def _issue_ms(lane_slots: float, mhz: float) -> float:
    return lane_slots / (SMS * LANES * mhz * 1e6) * 1e3


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
           "kernel_sum_ms": busy, "gap_ms": call_ms - busy,
           "wave": allpairs._half_wave(dev.index), "small_ms": {}}
    del pos
    for n in SMALL:
        pos = pinit.initialize_particles_device(
            n, torch.Generator(device=dev).manual_seed(0),
            device=dev).position
        kw["interaction_scale"] = 1.0 / n
        call()
        torch.cuda.synchronize()
        start.record()
        for _ in range(20):
            call()
        end.record()
        torch.cuda.synchronize()
        out["small_ms"][n] = start.elapsed_time(end) / 20
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
    """FP32 bound and SASS issue time of the call at the sampled clock."""
    nt = N // T
    diag, off = nt * T * T, nt * (nt - 1) // 2 * T * T
    mhz = rec["mhz"]
    bound = _issue_ms(diag * FP32_ISIDE + off * FP32_BOTH, mhz)
    both, iside = _loop_slots(loops)
    issue = _issue_ms(diag * iside + off * both, mhz)
    out = {"bound_ms": bound, "share": bound / rec["call_ms"],
           "issue_ms": issue, "slots_both": both, "slots_iside": iside}
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
