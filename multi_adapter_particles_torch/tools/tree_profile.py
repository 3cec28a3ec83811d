"""Where the time of the tree-P3M near-field sweeps (`near_sweep`,
`near_sweep_n3`; `csrc/treeforce.cu`) goes, for one or more checkouts, on
one CUDA GPU.

    python3 multi_adapter_particles_torch/tools/tree_profile.py ROOT [ROOT ...]

Each ROOT is a checkout of the repository (this one, or an unpacked
`git archive` of another commit), run in its own process in the order
given (list two as A B B A to cancel drift). Scenes: the port's device
init (seed 0) at 262,144 (G=128, B=256), 1,048,576 (G=192, B=512) and
the 4M pm_grid diagnostics gauge (4,194,304, G=256, tree blocks of 2,048
swept at 512), each at the probed pair budget. Sweeps: `force` (directed)
and `n3` (halved) at 262,144 and 1M; `with_potential` and
`potential_only` at 1M; `half_pairs` (halved potential only) at 4M. For
each sweep and ROOT it prints one JSON line:

- `call_ms`: one call of the kernels on lists built once (the wrapper's
  bare launch: `_launch_sweep`, `_launch_sweep_n3`), CUDA events, mean of
  4 after one warm-up; `mhz`, the SM clock read under load;
- `kernels`: the device kernels of one call under torch.profiler (per
  name: launches and summed ms), and `gap_ms`, `call_ms` less their sum;
- `ctas`: the CTAs of the sweep kernel (one a target block, or one a work
  item where ROOT has an item table, `sweep_items`), `per_sm` the CTAs an
  SM holds at once (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`),
  `waves` their ratio over 132 SMs, the longest and mean CTA's work in
  listed block pairs, and the longest segment;
- `longest_ms`: the longest segment's target block alone (a list holding
  only that block's segment), CUDA events; `lone_cta_work`, the largest
  CTA of that list (the segment, or one item of it);
- `loops` (one line a ROOT, first): ptxas's registers and the SASS mix a
  pair of every rsqrt loop (`tools/sass.py`); per sweep, `bound_ms`, the
  FP32 work at the sweep kernel's FP32 instructions a pair less the rsqrtf
  guard's predicated ones (halved: the loop with shuffles for j > i, the
  other for the diagonal pairs) over 132 SMs x 128 lanes at `mhz`, and
  `issue_ms`, the same pairs at the loops' issue slots a pair;
- `attribution` of `call_ms - bound_ms`, from a model of the SMs: each SM
  shares a rate (`sm_rate`, block pairs a ms) among its resident CTAs,
  each CTA at most at the lone CTA's rate (`lone_cta_work / longest_ms`);
  CTAs are launched in order to the SM that frees a slot first; `sm_rate`
  is the one at which that schedule takes the sweep kernel's measured
  time. `issue_mix_ms` is issue_ms less bound_ms; `imbalance_ms` the
  sweep kernel's time less `balanced_ms`, all its work at sm_rate on
  every SM (the longest CTA, the tail and partial waves); `other_ms` the
  other kernels and launch gaps; `sync_reduce_ms` every warp issuing the
  kernel's code outside its rsqrt loops once a listed block pair (the
  barriers, the warps' reductions, the staging; an upper estimate);
  `latency_ms` the rest of balanced_ms over issue_ms.

Kernels build into each checkout's own `build/torch_kernels/`; the
occupancy query of a checkout that does not export one is a small
harness built in a temporary directory.
"""

from __future__ import annotations

import ctypes
import heapq
import json
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

BOX, CUTOFF, SMS, LANES = 2048.0, 6.75, 132, 128
# (label, particles, mesh, sweeps); the 4M scene is the pm_grid gauge's
SCENES = (("262k", 262_144, 128, ("force", "n3")),
          ("1m", 1_048_576, 192, ("force", "n3", "with_potential",
                                  "potential_only")),
          ("4m_gauge", 4_194_304, 256, ("half_pairs",)))
# sweep -> the directed kernel's variant index (n3: the halved sweep)
VARIANT = {"force": 0, "with_potential": 1, "potential_only": 2,
           "half_pairs": 3}
# The occupancy of the one-CTA-a-target-block kernels of a checkout that
# exports no `tree_sweep_occupancy`: ROOT's source included whole, so the
# kernels are in reach.
_OCC_HARNESS = r"""
#include "{src}"
extern "C" int occ(int variant, int B, int* per_sm, int* threads) {{
  cudaError_t err;
  const size_t tiles = 2 * B * sizeof(float4);
  if (variant == 4) {{
    const int T = B < kN3Threads ? B : kN3Threads;
    const size_t shm = tiles + (size_t)(T / 32) * 3 * B * 4;
    *threads = T;
    switch (B / T) {{
      case 1: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          per_sm, sweep_n3_pair_kernel<1>, T, shm); break;
      case 2: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          per_sm, sweep_n3_pair_kernel<2>, T, shm); break;
      default: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          per_sm, sweep_n3_pair_kernel<4>, T, shm); break;
    }}
    return (int)err;
  }}
  *threads = B;
  switch (variant) {{
    case 0: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, sweep_kernel<true, false, false>, B, tiles); break;
    case 1: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, sweep_kernel<true, true, false>, B, tiles); break;
    case 2: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, sweep_kernel<false, true, false>, B, tiles); break;
    default: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, sweep_kernel<false, true, true>, B, tiles); break;
  }}
  return (int)err;
}}
"""


def _clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return float(out.stdout.split()[0])


def _issue_ms(lane_slots: float, mhz: float) -> float:
    return lane_slots / (SMS * LANES * mhz * 1e6) * 1e3


def _occupancy_fn(root: str, tmp: str):
    """occupancy(variant, B) -> (CTAs an SM, threads a CTA) of ROOT's sweep
    kernel (variant 4: the halved sweep)."""
    from multi_adapter_particles_torch.ops import _build, treeforce

    lib = treeforce._library()
    if hasattr(lib, "tree_sweep_occupancy"):
        fn = lib.tree_sweep_occupancy
    else:
        src = Path(root) / "multi_adapter_particles_torch/csrc/treeforce.cu"
        cu = Path(tmp) / "occ_harness.cu"
        cu.write_text(_OCC_HARNESS.format(src=src))
        so = Path(tmp) / "occ_harness.so"
        proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                               str(so), str(cu)], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise SystemExit(f"occupancy harness: {proc.stderr}")
        fn = ctypes.CDLL(str(so)).occ
    fn.argtypes = [ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int

    def occupancy(variant: int, block: int):
        per_sm, threads = ctypes.c_int(0), ctypes.c_int(0)
        rc = fn(variant, block, ctypes.byref(per_sm), ctypes.byref(threads))
        if rc:
            raise SystemExit(f"occupancy query: CUDA error {rc}")
        return per_sm.value, threads.value

    return occupancy


def _makespan(work: list, per_sm: int, full_rate: float,
              lone_rate: float) -> float:
    """The time CTAs of `work` units (launched in order, each to the SM
    that frees a slot first, `per_sm` slots an SM) take on 132 SMs, where
    the CTAs resident on an SM share its `full_rate` units a ms equally,
    each at most at `lone_rate`: processor sharing, event by event."""
    level = [0.0] * SMS      # service each resident CTA of an SM has had
    since = [0.0] * SMS      # when `level` was last brought up to date
    res = [[] for _ in range(SMS)]   # finish levels of resident CTAs
    version = [0] * SMS
    events, nxt, end = [], 0, 0.0

    def rate(s):
        return min(full_rate / len(res[s]), lone_rate) if res[s] else 0.0

    def fill(s):
        nonlocal nxt
        while len(res[s]) < per_sm and nxt < len(work):
            heapq.heappush(res[s], level[s] + work[nxt])
            nxt += 1

    def schedule(s):
        version[s] += 1
        if res[s]:
            heapq.heappush(events, (since[s] + (res[s][0] - level[s])
                                    / rate(s), s, version[s]))

    for _ in range(per_sm):          # the first wave, round robin
        for s in range(SMS):
            if nxt < len(work):
                heapq.heappush(res[s], work[nxt])
                nxt += 1
    for s in range(SMS):
        schedule(s)
    while events:
        t, s, v = heapq.heappop(events)
        if v != version[s]:
            continue
        level[s] += (t - since[s]) * rate(s)
        since[s], end = t, t
        while res[s] and res[s][0] <= level[s] * (1 + 1e-12):
            heapq.heappop(res[s])
        fill(s)
        schedule(s)
    return end


def _calibrate(work: list, per_sm: int, lone_rate: float,
               kernel_ms: float) -> float:
    """The SM rate at which `_makespan` of `work` is `kernel_ms` (between
    one lone CTA's rate and per_sm of them), by bisection."""
    lo, hi = lone_rate, per_sm * lone_rate
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        if _makespan(work, per_sm, mid, lone_rate) > kernel_ms:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def _profile(fn) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per = {}
    for ev in prof.events():
        if ev.device_type.name != "CUDA":
            continue
        us = getattr(ev, "device_time", None)
        if us is None:
            us = ev.cuda_time
        name = ev.name.replace("(anonymous namespace)::", "").split("(")[0]
        name = name.removeprefix("void ").strip()
        k = per.setdefault(name, {"launches": 0, "sum_ms": 0.0})
        k["launches"] += 1
        k["sum_ms"] += us / 1e3
    return per


def _time_ms(fn, reps: int = 4) -> tuple:
    """(mean ms of `reps` calls by CUDA events after one warm-up, the SM
    clock read while they run)."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    mhz = _clock_mhz()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, mhz


def _scene(dev, n: int, grid: int):
    from multi_adapter_particles_torch.models import init as pinit
    from multi_adapter_particles_torch.ops import p3m, treeforce

    import torch

    pos = pinit.initialize_particles_device(
        n, torch.Generator(device=dev).manual_seed(0), device=dev).position
    r_c, gn = p3m.near_grid_for(grid, BOX, CUTOFF)
    coarse, sub, _ = treeforce.host_tree_counts(pos.cpu().numpy(), BOX, r_c,
                                                gn)
    budgets = dict(pair_budget=int(coarse * treeforce.PAIR_HEADROOM) + 1)
    if sub is not None:
        budgets["sub_pair_budget"] = int(sub * treeforce.PAIR_HEADROOM) + 2
    return pos, r_c, gn, budgets


def _one_block(L, i: int):
    """The list holding only target block i's segment, in the form the
    sweep takes: (bounds, j_idx) directed, (sweep_i, sweep_j) halved."""
    import torch

    i_idx = L.sweep_i.long()
    keep = i_idx == i
    if L.n3:
        return L.sweep_i[keep], L.sweep_j[keep]
    b = torch.zeros(L.sweep_nb + 1, dtype=torch.int32, device=i_idx.device)
    b[i + 1:] = int(keep.sum())
    return b, L.sweep_j[keep].to(torch.int32)


def _cta_work(treeforce, bounds, list_len: int) -> list:
    """The listed block pairs of each CTA of the sweep kernel, in launch
    order: one CTA a target block's segment, or one a work item where the
    checkout has an item table (`sweep_items`)."""
    import torch

    bounds = bounds.to(torch.int32)
    table = getattr(treeforce, "sweep_items", None)
    if table is None:
        return (bounds[1:] - bounds[:-1]).tolist()
    items = table(bounds, int(list_len))
    return [w for w in (items.q1 - items.q0)[items.order].tolist() if w > 0]


def measure(root: str) -> list:
    """The device numbers of one checkout (run in its own process)."""
    sys.path.insert(0, root)
    import torch

    from multi_adapter_particles_torch import constants as C
    from multi_adapter_particles_torch.ops import p3m, treeforce

    if not torch.cuda.is_available():
        raise SystemExit("tree_profile.py needs a CUDA GPU")
    dev = torch.device("cuda", 0)
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        occupancy = _occupancy_fn(root, tmp)
        for label, n, grid, sweeps in SCENES:
            pos, r_c, gn, budgets = _scene(dev, n, grid)
            eps2, sigma = C.SOFTENING_SQUARED, r_c * p3m._SIGMA_PER_CUTOFF
            for sweep in sweeps:
                n3 = sweep == "n3"
                L = treeforce.tree_lists(pos, BOX, r_c, gn, half_force=n3,
                                         half_pairs=sweep == "half_pairs",
                                         **budgets)
                if L.dropped:
                    raise SystemExit(f"{label} {sweep}: {L.dropped} dropped")
                B, nb = L.sweep_block, L.sweep_nb
                if n3:
                    def launch(si, sj):
                        prep = treeforce._n3_prepare(L.spos, si, sj, nb, B)
                        return lambda: treeforce._launch_sweep_n3(
                            L.spos, *prep, eps2, sigma)
                    call = launch(L.sweep_i, L.sweep_j)
                else:
                    def launch(bounds, j_idx):
                        b32, j32 = bounds.to(torch.int32), j_idx.to(
                            torch.int32)
                        return lambda: treeforce._launch_sweep(
                            L.spos, nb, B, b32, j32, eps2, sigma,
                            VARIANT[sweep])
                    call = launch(L.bounds, L.sweep_j)
                call_ms, mhz = _time_ms(call)
                kernels = _profile(call)
                seg = torch.bincount(L.sweep_i.long(),
                                     minlength=nb)[:nb].cpu()
                longest = int(seg.argmax())
                one = _one_block(L, longest)
                longest_ms, _ = _time_ms(launch(*one))
                diag = int((L.sweep_i == L.sweep_j).sum())
                if n3:
                    bounds = treeforce._n3_lists(L.sweep_i, L.sweep_j, nb)[0]
                    one_bounds = treeforce._n3_lists(*one, nb)[0]
                else:
                    bounds, one_bounds = L.bounds, one[0]
                work = _cta_work(treeforce, bounds, L.sweep_j.numel())
                lone = max(_cta_work(treeforce, one_bounds, one[1].numel()))
                per_sm, threads = occupancy(4 if n3 else VARIANT[sweep], B)
                out.append({
                    "root": root, "device": torch.cuda.get_device_name(0),
                    "scene": label, "n": n, "grid": grid, "sweep": sweep,
                    "block": B, "target_blocks": nb, "pairs": L.pairs,
                    "diag_pairs": diag, "call_ms": call_ms, "mhz": mhz,
                    "kernels": kernels, "gap_ms": call_ms - sum(
                        k["sum_ms"] for k in kernels.values()),
                    "ctas": len(work), "threads": threads, "per_sm": per_sm,
                    "waves": len(work) / (SMS * per_sm),
                    "longest_cta_work": max(work), "mean_cta_work":
                        statistics.mean(work), "longest_segment":
                        int(seg.max()), "longest_ms": longest_ms,
                    "lone_cta_work": lone, "work": work})
            del pos
            torch.cuda.empty_cache()
    return out


# the sweep kernel of each sweep at B = 512 (B = 256 at 262,144): its name
# in a checkout with one CTA a target block, and in the item schedule
KERNELS = {
    "force": ("sweep_kernel<1,0,0>", "sweep_item_kernel<1,0,0,2>"),
    "with_potential": ("sweep_kernel<1,1,0>", "sweep_item_kernel<1,1,0,2>"),
    "potential_only": ("sweep_kernel<0,1,0>", "sweep_item_kernel<0,1,0,2>"),
    "half_pairs": ("sweep_kernel<0,1,1>", "sweep_item_kernel<0,1,1,2>"),
    "n3": ("sweep_n3_pair_kernel<4>", "sweep_n3_item_kernel<8,4>"),
}


def _loops(all_loops: dict, sweep: str, block: int):
    """(kernel name, j-side loop, diagonal loop) of a sweep: the halved
    item kernel's loop with shuffles and the one without; one loop for
    both elsewhere."""
    names = KERNELS[sweep]
    if sweep == "n3" and block == 256:
        names = ("sweep_n3_pair_kernel<2>", "sweep_n3_item_kernel<8,1>")
    for name in names:
        mixes = [m for m in all_loops.get(name, []) if not m["collective"]]
        if not mixes:
            continue
        # the main loop of each kind: the most pairs a body (the compiler
        # adds a remainder loop after an unrolled one)
        with_shfl = [m for m in mixes if m["SHFL"] > 0]
        plain = [m for m in mixes if m["SHFL"] == 0]
        if with_shfl and plain:
            return name, max(with_shfl, key=lambda m: m["pairs"]), max(
                plain, key=lambda m: m["pairs"])
        loop = max(mixes, key=lambda m: m["pairs"])
        return name, loop, loop
    raise SystemExit(f"no rsqrt loop of {names} in the SASS")


def _attribute(rec: dict, all_loops: dict) -> dict:
    name, jloop, dloop = _loops(all_loops, rec["sweep"], rec["block"])
    b2 = rec["block"] ** 2
    off, diag = (rec["pairs"] - rec["diag_pairs"]) * b2, rec["diag_pairs"] * b2
    if rec["sweep"] != "n3":
        off, diag = off + diag, 0
    mhz = rec["mhz"]

    def fp32(m):
        return m["fp32"] - m["predicated_fp32"]

    bound = _issue_ms(off * fp32(jloop) + diag * fp32(dloop), mhz)
    issue = _issue_ms(off * jloop["slots"] + diag * dloop["slots"], mhz)
    # the sweep kernel's share of the profiled kernels, of the call
    ksum = sum(k["sum_ms"] for k in rec["kernels"].values())
    sweep_ms = rec["call_ms"] * sum(
        k["sum_ms"] for kname, k in rec["kernels"].items()
        if kname.startswith(name.split("<")[0])) / ksum
    other = rec["call_ms"] - sweep_ms
    work = rec.pop("work")
    lone_rate = rec["lone_cta_work"] / rec["longest_ms"]
    sm_rate = _calibrate(work, rec["per_sm"], lone_rate, sweep_ms)
    balanced = sum(work) / (SMS * sm_rate)
    # every warp of every CTA issues the code outside the rsqrt loops once
    # a listed block pair (an upper estimate)
    outside = rec["static_instrs"][name] - sum(
        len(b) for b in rec["loop_bodies"].get(name, []))
    warps = rec["threads"] // 32
    sync_reduce = _issue_ms(rec["pairs"] * warps * 32 * outside, mhz)
    return {"kernel": name, "fp32_pair": fp32(jloop),
            "fp32_pair_diag": fp32(dloop) if diag else None,
            "slots_pair": jloop["slots"],
            "slots_pair_diag": dloop["slots"] if diag else None,
            "bound_ms": bound, "share": bound / rec["call_ms"],
            "issue_ms": issue, "sweep_kernel_ms": sweep_ms,
            "lone_rate": lone_rate, "sm_rate": sm_rate,
            "balanced_ms": balanced,
            "attribution": {
                "issue_mix_ms": issue - bound,
                "imbalance_ms": sweep_ms - balanced, "other_ms": other,
                "sync_reduce_ms": sync_reduce,
                "latency_ms": balanced - issue - sync_reduce}}


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        for rec in measure(os.path.abspath(argv[1])):
            print("TP " + json.dumps(rec), flush=True)
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
        src = Path(root) / "multi_adapter_particles_torch/csrc/treeforce.cu"
        with tempfile.TemporaryDirectory() as d:
            cubin = Path(d) / "treeforce.cubin"
            ptxas = sass.compile_cubin(src, cubin)
            instrs = sass.disassemble(cubin)
        bodies = {k: sass.rsqrt_loops(v) for k, v in instrs.items()}
        loops = {k: [sass.loop_mix(b) for b in v] for k, v in bodies.items()
                 if v}
        print(json.dumps({"root": root, "ptxas": ptxas, "loops": {
            k: [sass.format_mix(m) for m in v] for k, v in loops.items()}}),
            flush=True)
        proc = subprocess.run([sys.executable, __file__, "--one", root],
                              capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("TP ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-2000:], proc.stderr[-4000:], flush=True)
            return 1
        for line in lines:
            rec = json.loads(line[3:])
            rec["static_instrs"] = {k: len(v) for k, v in instrs.items()}
            rec["loop_bodies"] = bodies
            rec.update(_attribute(rec, loops))
            del rec["static_instrs"], rec["loop_bodies"]
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
