"""Smoke test of the torch port on one CUDA GPU: builds the hand-written
kernels from `multi_adapter_particles_torch/csrc`, holds each against its
plain torch twin at the main paths' shapes, then runs the port's CLI main
paths (4,194,304 particles, central well; 1,048,576 particles, all-pairs
self-gravity; 4,194,304 particles, pm_grid; 1,048,576 particles, tree-P3M
self-gravity; 1024x1024 split frame loops) and checks that each went
through its kernels and produced a sane frame; then the conservation
diagnostics (`-diagnostics K`) on those scenes, whose P3M gauge runs the
tree sweep's three potential variants, with finite gauges and no dropped
pairs; then the fused single-program frame (`-fused`, captured CUDA
graphs) against the split loop from the same seed.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU):
1. device check + the card's name and power limit (nvidia-smi)
2. kernel build (nvcc, seconds printed; ptxas register and spill report,
   one line per kernel)
3. central-well kernel vs plain at 4,194,304 particles (+ num_sim freeze)
4. composite kernel vs plain on the rows the renderer builds for one 1M
   chunk of the 4M state (Q=256) and for 262,144 particles (Q=64)
4a. sort kernel vs plain, bitwise on every output: the render keys and
   payloads of the 4M state's first chunk after one step (E = 2^22), its
   dup 2x3 window (E = 6 x 2^20, padded), keys in [0, 37) and all-equal
   keys at 2^20 (the identity), negative keys at 2^20 + 3; times beside
   torch.sort + 4 gathers and the bytes bound
4b. row gather kernel vs plain, bitwise: the render's packed payload rows
   of that chunk, the TPU prototype's shape ([2,097,152, 32] x 4,194,304),
   clamped out-of-range indices (16-byte and scalar paths); times beside
   index_select (on indices clamped beforehand) and the bytes bound
5. main path: `multi_adapter_particles_torch.app.main`, launch counters
   (composite, sort and gather at least 4 a frame)
6. the final state's frame through the kernels vs through the plain twins
   of all three render kernels
7. all-pairs rectangle kernel vs plain: 4,096 targets spread over the
   1,048,576-particle state against all its sources (float32 twin and a
   float64 evaluation); kernel time at the full 1M
8. all-pairs half-pair kernel vs plain at 131,072 and vs the rectangle
   kernel at 1,048,576; kernel times at 1M
9. half-pair fallback at an untileable N (100,096) is bitwise the rectangle
   kernel; both kernels run twice at 1M give equal results
10. all-pairs main path: `app.main -force all_pairs` at 1,048,576, 8 frames
    of the half-pair schedule, then 6 with -rectpair; launch counters
11. tree sweeps vs their twins at 262,144 (device init, auto grid G=128,
    B=256, probed budget, dropped == 0): directed and Newton-3rd kernels
    on the same lists, <= 1e-5 of max|a_near|; kernel (on lists prepared
    once), wrapper and twin times, each kernel's issue bound at the sampled
    SM clock
12. sub-block expansion at 262,144: blocks of 1024 swept at 512 against
    blocks of 256, <= 1e-5 of max|a_near|
13. tree sweeps at 1,048,576 (G=192, B=512): each kernel vs its twin, the
    Newton-3rd vs the directed kernel, each run twice bitwise; kernel,
    wrapper, list-build and far-field (deposit, FFT solve, interpolation) times;
    each kernel's issue bound at the sampled SM clock
14. physics at 1,048,576: the full tree-P3M accel on 4,096 targets against
    the exact all-pairs sum (rectangle kernel), RMS < 1% of max|a|
15. long-range solve memory at G=192 and G=256 (max_memory_allocated per
    grid cell, cold and warm) against the count `feasible_grid` uses
16. pm_grid main path: `app.main -force pm_grid` at 4,194,304, G=128, 5
    steps, no draw: finite state, ms/step
17. tree-P3M main path: `app.main -force p3m -p3mnear tree` at 1,048,576
    and 1024x1024, 8 frames of the Newton-3rd sweep then 6 with
    -treedirected; launch counters, the run's config, the probe seconds
18. the sweep's potential variants vs their twins at 262,144 (G=128,
    B=256, probed budget): u within 1e-5 of max|u_near| over the live
    lanes, the fused force rows bitwise the force-only kernel's,
    potential-only bitwise the fused potential row, the halved total
    within rel 1e-5 of the directed one; times and bounds
19. the gauge sweeps at their paths' shapes: the 4M pm_grid gauge (G=256,
    blocks of 2048 expanded to 512, halved potential-only) and the 1M
    tree-P3M gauge (G=192, B=512: fused, and potential-only), each kernel
    vs its twin and run twice bitwise; the host budget probe, list build,
    kernel and twin times and bounds; the 4M halved total vs the directed
    one; `DiagnosticsProbe.maybe_publish` at 4M, first and warm, gauges
    bitwise equal on the second call
20. mesh vs exact potential gauge at 262,144 (device init, G=64): rel
    1e-3, the JAX package's pin; both gauges' times
21. diagnostics main paths: `app.main -diagnostics` on the 4M pm_grid
    scene (G=128, no draw, 5 steps, every 2), the 1M tree-P3M scene
    (1024x1024, 8 steps, every 4), the 4M central well (20 frames, every
    10) and the 262,144 all-pairs scene (exact gauge, no draw, 2 steps,
    every 2); finite gauges, `diag_dropped_pairs == 0`, the variants'
    launch counters; and the potential-only directed sweep's path, the
    library call `mesh_potential_only(half_pairs=False)` on the 1M scene
22. fused main path: `app.main -fused` at 4,194,304 and 1024x1024, 40
    frames through captured CUDA graphs: positions bitwise the split run of
    phase 5, the last frame within 1e-5 of it, `fused_graph` true; frame,
    render and simulate ms, replays, launches a frame, peak memory
23. the same at 262,144 and 1280x720 against a split run of that shape
24. `-fused -force p3m -p3mnear tree` at 262,144 runs uncaptured
    (`fused_graph` false) and agrees with split the same way; all_pairs
    (65,536) and pm_grid (262,144, G=64) capture and agree likewise

The kernels line (before the last) has one entry per kernel with its
launches on its main path, the error against its twin, kernel / twin times
and the least time the card could take (`bound_ms`: bytes over 3.35 TB/s,
or FP32-pipe instructions counted from the source over 132 SMs x 128 lanes
at the SM clock sampled while the kernel ran), and for the sort and the row
gather the time of the one PyTorch call that computes the same function
(`library_ms`); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import tempfile
import time

N_MAIN = 4_194_304
STEPS = 40
# phase 5's frame on an H100 at 700 W before the sort and row-gather
# kernels, logged beside the new one (no gate)
MAIN_FRAME_MS_BEFORE = 39.92
WIDTH = HEIGHT = 1024
N_AP = 1_048_576          # the all-pairs path (BASELINE.json's 1M)
AP_SAMPLE = 4_096         # rectangle targets held against the plain twin
N_HALF_CHECK = 131_072    # 256 tiles of 512: half-pair kernel vs plain
N_UNTILEABLE = 100_096    # padded 100,000: not a multiple of 512
AP_STEPS_HALF = 8
AP_STEPS_RECT = 6
N_TREE_CHECK = 262_144    # tree kernels vs twins (G=128, B=256); exact gauge
N_TREE = 1_048_576        # the tree-P3M path (G=192, B=512)
TREE_SAMPLE = 4_096       # targets held against the exact sum
TREE_STEPS_N3 = 8
TREE_STEPS_DIRECTED = 6
PM_STEPS = 5
PM_GRID = 128
DIAG_RUNS = (   # (label, argv, steps, every) of phase 21
    ("pm_grid", ["-force", "pm_grid", "-pmgrid", str(PM_GRID),
                 "-numparticles", str(N_MAIN), "-nodraw"], 5, 2),
    ("p3m", ["-force", "p3m", "-p3mnear", "tree", "-numparticles",
             str(N_TREE), "-width", str(WIDTH), "-height", str(HEIGHT)],
     8, 4),
    ("central_well", ["-numparticles", str(N_MAIN), "-width", str(WIDTH),
                      "-height", str(HEIGHT)], 20, 10),
    ("all_pairs", ["-force", "all_pairs", "-numparticles",
                   str(N_TREE_CHECK), "-nodraw"], 2, 2),
)
BOX, CUTOFF = 2048.0, 6.75   # SimConfig's pm_box and p3m_cutoff_cells

# The card's limits for `bound_ms` (NVIDIA's H100 SXM data sheet):
# HBM bytes/s; FP32 lanes.
HBM_BYTES_PER_S = 3.35e12
SMS, FP32_LANES = 132, 128
# FP32-pipe instructions per pair or pixel-slot, counted from the sources
# (each source's header comment gives the tally)
INSTR = {"all_pairs_rect": 11, "all_pairs_half_round": 14,
         "all_pairs_half_diag": 11, "tree_sweep": 27, "tree_sweep_n3": 33,
         "tree_sweep_with_potential": 41, "tree_sweep_potential_only": 23,
         "tree_sweep_half_pairs": 23, "composite": 28}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    raise SystemExit(1)


def timed(fn):
    """(fn(), its device milliseconds): one call between CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device milliseconds per call, by CUDA events around `reps`
    back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_close(name: str, got, want, rtol: float, atol: float) -> float:
    """Fail unless |got - want| <= atol + rtol*|want| everywhere; returns
    the max abs error."""
    import torch

    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite kernel output")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    max_err = float(err.max())
    if bool(bad.any()):
        fail(f"{name}: {int(bad.sum())} elements out of rtol {rtol} / atol "
             f"{atol} (max abs err {max_err:.3e})")
    log(f"  {name}: max abs err {max_err:.3e} (rtol {rtol}, atol {atol})")
    return max_err


def phase_device():
    import torch

    log("phase 1: device")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False — this smoke test needs a "
             "CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(smi.stdout.strip().splitlines()[0])
    log(f"  torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _kernel_name(mangled: str) -> str:
    """A kernel's name and its template arguments (ints or bools) from its
    Itanium-mangled symbol: `_ZN12_GLOBAL__N_120sweep_n3_pair_kernelILi4E
    ...` -> `sweep_n3_pair_kernel<4>`, `..._kernelILb1ELb0ELb0EE...` ->
    `..._kernel<1,0,0>`."""
    s = mangled[2:].lstrip("N") if mangled.startswith("_Z") else mangled
    name = s
    while (m := re.match(r"\d+", s)):
        n, start = int(m.group()), m.end()
        name, s = s[start:start + n], s[start + n:]
    t = re.match(r"I((?:L[a-z]+-?\d+E)+)", s)
    if not t:
        return name
    return name + "<" + ",".join(re.findall(r"L[a-z]+(-?\d+)E",
                                           t.group(1))) + ">"


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from multi_adapter_particles_torch.ops import _build
    from multi_adapter_particles_torch.ops import (
        allpairs,
        central_well,
        composite,
        rowgather,
        sortkv,
        treeforce,
    )

    log("phase 2: build")
    sources = (("central_well", central_well, ()),
               ("composite", composite, composite._NVCC_FLAGS),
               ("allpairs", allpairs, ()),
               ("treeforce", treeforce, ()),
               ("sortkv", sortkv, ()),
               ("rowgather", rowgather, ()))

    def ptxas_report(name, extra, tmp):
        """register / spill lines of one source (compile only, no library)"""
        cmd = [_build.nvcc_path(), "-gencode",
               "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               *extra, "-Xptxas", "-v", "-cubin",
               "-o", os.path.join(tmp, f"{name}.cubin"),
               str(_build.CSRC_DIR / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            fail(f"ptxas report for {name}: {proc.stderr}")
        # one line per kernel: its name, then its spill and register lines
        out, kernel, parts = [], "?", []
        for line in (proc.stdout + proc.stderr).splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:
                kernel = _kernel_name(entry.group(1))
            elif "spill" in line:
                parts = [line.strip()]
            elif "registers" in line:
                out.append(f"{kernel}: {line.split(':', 1)[-1].strip()}; "
                           + "; ".join(parts))
                parts = []
        return out

    t0 = time.perf_counter()
    # one nvcc per source and per report, all started together
    with tempfile.TemporaryDirectory() as tmp, \
            ThreadPoolExecutor(2 * len(sources)) as pool:
        libs = [pool.submit(mod._library) for _, mod, _ in sources]
        reports = [(name, pool.submit(ptxas_report, name, extra, tmp))
                   for name, _, extra in sources]
        for fut in libs:
            fut.result()
        log(f"  built/loaded the {len(sources)} kernel sources in "
            f"{time.perf_counter() - t0:.2f} s ({_build.BUILD_DIR})")
        for name, fut in reports:
            for line in fut.result():
                log(f"  ptxas {name}: {line}")


def phase_central_well(dev):
    import torch

    from multi_adapter_particles_torch import constants as C
    from multi_adapter_particles_torch.models import init as pinit
    from multi_adapter_particles_torch.models import integrator
    from multi_adapter_particles_torch.ops.central_well import (
        central_well_step,
        central_well_step_plain,
    )

    log(f"phase 3: central-well kernel vs plain @ {N_MAIN:,}")
    st = pinit.initialize_particles_device(
        N_MAIN, torch.Generator(device=dev).manual_seed(0), device=dev)
    phys = dict(dt=C.TIMESTEP, damping=C.DAMPING, mass=C.PARTICLE_MASS,
                softening_squared=C.SOFTENING_SQUARED)
    p, v = st.position, st.velocity
    kp, kv = central_well_step(p, v, **phys)
    pp, pv = central_well_step_plain(p, v, **phys)
    torch.cuda.synchronize()
    err = max(check_close("position", kp, pp, 2e-5, 2e-5),
              check_close("velocity", kv, pv, 2e-5, 2e-5))
    live = integrator.live_count(3_000_001, p.shape[1])
    kp, kv = central_well_step(p, v, num_live=live, **phys)
    pp, pv = central_well_step_plain(p, v, num_live=live, **phys)
    torch.cuda.synchronize()
    if not (torch.equal(kp[:, live:], p[:, live:])
            and torch.equal(kv[:, live:], v[:, live:])):
        fail("num_sim freeze: the frozen tail is not bitwise the input")
    err = max(err, check_close("position (num_sim)", kp, pp, 2e-5, 2e-5))
    log(f"  num_sim freeze bitwise past column {live:,}")
    out = (torch.empty_like(p), torch.empty_like(v))
    ms = time_ms(lambda: central_well_step(p, v, out=out, **phys), reps=100)
    plain_ms = time_ms(lambda: central_well_step_plain(p, v, **phys), reps=20)
    gbs = N_MAIN * 56 / (ms * 1e-3) / 1e9
    bound = bytes_bound_ms(p.shape[1] * 56)   # 7 floats read, 7 written
    log(f"  kernel {ms:.4f} ms ({gbs:.0f} GB/s of 56 B/particle), plain "
        f"{plain_ms:.4f} ms; bound {bound:.4f} ms (bytes)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "bytes"}


def _composite_inputs(dev, n, chunk):
    """The (sp, bases, row_hi) the renderer builds for the first `chunk`
    particles of an n-particle device-init state at 1024x1024."""
    import torch

    from multi_adapter_particles_torch.config import RenderConfig
    from multi_adapter_particles_torch.models import init as pinit
    from multi_adapter_particles_torch.ops.composite import composite_rows
    from multi_adapter_particles_torch.render import renderer as R
    from multi_adapter_particles_torch.render.camera import Camera

    st = pinit.initialize_particles_device(
        n, torch.Generator(device=dev).manual_seed(0), device=dev)
    rend = R.Renderer(RenderConfig(width=WIDTH, height=HEIGHT))
    q = rend.resolve_seg_q(chunk)
    captured = []

    def capture(sp, bases, tile_h, tile_w, blend="over", row_hi=None):
        captured.append((sp, bases, row_hi))
        return composite_rows(sp, bases, tile_h, tile_w, blend, row_hi)

    args = rend._device_args(Camera(), 2.5, 0.15, dev)
    R._render(st.position[:, :chunk], *args, chunk, width=WIDTH,
              height=HEIGHT, seg_q=q, dup_y=2, dup_x=2, near=1.0,
              blend="over", return_trans=True, composite=capture)
    return q, captured[0]


def phase_composite(dev):
    import torch

    from multi_adapter_particles_torch.ops.composite import (
        composite_rows,
        composite_rows_plain,
    )
    from multi_adapter_particles_torch.render.renderer import TILE_H, TILE_W

    log("phase 4: composite kernel vs plain")
    err = 0.0
    times = {}
    for label, n, chunk in (("1M chunk of 4M", N_MAIN, 1_048_576),
                            ("262K", 262_144, 262_144)):
        q, (sp, bases, hi) = _composite_inputs(dev, n, chunk)
        live = int((hi > 0).sum())
        log(f"  {label}: sp {list(sp.shape)} (Q={q}), {live:,} live rows")
        for blend in ("over", "additive"):
            k = composite_rows(sp, bases, TILE_H, TILE_W, blend, hi)
            p = composite_rows_plain(sp, bases, TILE_H, TILE_W, blend, hi)
            torch.cuda.synchronize()
            err = max(err, check_close(f"{label} {blend}", k, p, 1e-5, 1e-6))
        def kernel():
            return composite_rows(sp, bases, TILE_H, TILE_W, "over", hi)

        ms = time_ms(kernel, reps=20)
        plain_ms = time_ms(lambda: composite_rows_plain(
            sp, bases, TILE_H, TILE_W, "over", hi), reps=3, warmup=1)
        # the work these rows need: each live slot (q < row_hi) of each
        # row blends into TILE_H * TILE_W pixels; every byte once
        slots = float(hi.clamp(0, q).sum())
        px = TILE_H * TILE_W
        mhz = busy_clock_mhz(kernel, reps=max(20, int(300 / ms)))
        ops = issue_bound_ms(slots * px * INSTR["composite"], mhz)
        nbytes = (sp.numel() + bases.numel() + hi.numel()
                  + 4 * px * sp.shape[2]) * 4
        bound = max(ops, bytes_bound_ms(nbytes))
        by = "operations" if ops >= bytes_bound_ms(nbytes) else "bytes"
        log(f"  {label} over: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; "
            f"{slots:.4e} live slots x {px} px; bound {bound:.4f} ms "
            f"({by}, {mhz:.0f} MHz) -> {bound / ms:.1%} of it")
        times[label] = (ms, plain_ms, bound, by)
        del sp, bases, hi
    ms, plain_ms, bound, by = times["1M chunk of 4M"]
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by,
            "ms_262k": times["262K"][0], "plain_ms_262k": times["262K"][1]}


def _render_io(dev, dup_y=2, dup_x=2):
    """The sort's (key, *payloads) and the row gather's (packed, idx)
    arguments as the renderer makes them for the first 1M chunk of the 4M
    device-init state (seed 0) after one central-well step, at
    1024x1024 and the given dup window."""
    import torch

    from multi_adapter_particles_torch import constants as C
    from multi_adapter_particles_torch.config import RenderConfig
    from multi_adapter_particles_torch.models import init as pinit
    from multi_adapter_particles_torch.ops.central_well import central_well_step
    from multi_adapter_particles_torch.ops.rowgather import gather_rows_plain
    from multi_adapter_particles_torch.ops.sortkv import sort_kv_stable_plain
    from multi_adapter_particles_torch.render import renderer as R
    from multi_adapter_particles_torch.render.camera import Camera

    st = pinit.initialize_particles_device(
        N_MAIN, torch.Generator(device=dev).manual_seed(0), device=dev)
    pos, _ = central_well_step(st.position, st.velocity, dt=C.TIMESTEP,
                               damping=C.DAMPING, mass=C.PARTICLE_MASS,
                               softening_squared=C.SOFTENING_SQUARED)
    del st
    chunk = 1_048_576
    rend = R.Renderer(RenderConfig(width=WIDTH, height=HEIGHT))
    rend.dup_y, rend.dup_x = dup_y, dup_x
    seen = {}

    def sort(*args):
        seen["sort"] = args
        return sort_kv_stable_plain(*args)

    def gather(*args):
        seen["gather"] = args
        return gather_rows_plain(*args)

    args = rend._device_args(Camera(), 2.5, 0.15, dev)
    R._render(pos[:, :chunk], *args, chunk, width=WIDTH, height=HEIGHT,
              seg_q=rend.resolve_seg_q(chunk), dup_y=dup_y, dup_x=dup_x,
              near=1.0, blend="over", return_trans=True, sort=sort,
              gather=gather)
    return seen["sort"], seen["gather"]


def phase_sort(dev):
    import torch

    from multi_adapter_particles_torch.ops.sortkv import (
        sort_kv_stable,
        sort_kv_stable_plain,
    )

    log("phase 4a: sort kernel vs plain (bitwise on every output)")
    (key, *pay), gather_args = _render_io(dev)
    e = key.shape[0]
    wide = _render_io(dev, 2, 3)[0]
    gen = torch.Generator(device=dev).manual_seed(1)
    m = 1 << 20

    def rand_pay(n):
        return [torch.rand(n, device=dev, generator=gen),
                torch.randint(-2**31, 2**31 - 1, (n,), device=dev,
                              dtype=torch.int32, generator=gen)]

    neg = torch.randint(-2**31, 2**31 - 1, (m + 3,), device=dev,
                        dtype=torch.int32, generator=gen)
    neg[:4] = torch.tensor([-2**31, 2**31 - 1, -1, 0], dtype=torch.int32)
    ident = torch.arange(m, device=dev, dtype=torch.int32)
    cases = (
        ("render chunk, dup 2x2", (key, *pay)),
        ("render chunk, dup 2x3 (padded)", wide),
        ("keys in [0, 37)", (torch.randint(0, 37, (m,), device=dev,
                                           dtype=torch.int32, generator=gen),
                             *rand_pay(m))),
        ("all-equal keys", (torch.zeros(m, device=dev, dtype=torch.int32),
                            ident, *rand_pay(m))),
        ("negative keys, E = 2^20 + 3", (neg, *rand_pay(m + 3))),
    )
    for label, args in cases:
        k = sort_kv_stable(*args)
        p = sort_kv_stable_plain(*args)
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(k, p)):
            if a.dtype != b.dtype or not torch.equal(a, b):
                fail(f"sort {label}: output {i} differs from the twin "
                     f"({int((a != b).sum())} entries)")
        if label == "all-equal keys" and not torch.equal(k[1], ident):
            fail("sort of all-equal keys is not the identity")
        log(f"  {label}: E = {args[0].shape[0]:,}, {len(args) - 1} payloads:"
            " bitwise the twin")
    del wide, cases

    def library():
        sk, perm = torch.sort(key, stable=True)
        return sk, *(q[perm] for q in pay)

    ms = time_ms(lambda: sort_kv_stable(key, *pay), reps=20)
    plain_ms = time_ms(lambda: sort_kv_stable_plain(key, *pay), reps=20)
    lib_ms = time_ms(library, reps=20)
    bound = bytes_bound_ms(e * (4 + 4 * len(pay)) * 2)
    log(f"  E = {e:,}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch.sort + {len(pay)} gathers {lib_ms:.4f} ms; bound "
        f"{bound:.4f} ms (bytes) -> {bound / ms:.1%} of it")
    # every output bitwise the twin's (checked above)
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "bytes",
            "library_ms": lib_ms}, gather_args


def phase_gather(dev, render_args):
    import torch

    from multi_adapter_particles_torch.ops.rowgather import (
        gather_rows,
        gather_rows_plain,
    )

    log("phase 4b: row gather kernel vs plain (bitwise)")
    gen = torch.Generator(device=dev).manual_seed(2)
    table, idx = render_args
    rows_p, w_p, n_p = 2_097_152, 32, 4_194_304
    proto = (torch.randn((rows_p, w_p), device=dev, generator=gen),
             torch.randint(0, rows_p, (n_p,), device=dev, dtype=torch.int32,
                           generator=gen))
    flat = torch.randn(4096 * 36 + 1, device=dev, generator=gen)
    wild = torch.randint(-5000, 9000, (50_000,), device=dev,
                         dtype=torch.int32, generator=gen)
    cases = (
        (f"render rows {list(table.shape)} x {idx.shape[0]:,}", table, idx),
        (f"prototype [{rows_p:,}, {w_p}] x {n_p:,}", *proto),
        ("clamped, 16-byte path", flat[:4096 * 36].view(4096, 36), wild),
        ("clamped, unaligned rows", flat[1:].view(4096, 36), wild),
        ("clamped, W = 7", flat[:4096 * 7].view(4096, 7), wild),
    )
    timings = {}
    for label, tab, ix in cases:
        k = gather_rows(tab, ix)
        p = gather_rows_plain(tab, ix)
        torch.cuda.synchronize()
        if not torch.equal(k, p):
            fail(f"gather {label}: {int((k != p).sum())} words differ")
        log(f"  {label}: bitwise the twin")
        if label.startswith(("render", "prototype")):
            ms = time_ms(lambda: gather_rows(tab, ix), reps=20)
            plain_ms = time_ms(lambda: gather_rows_plain(tab, ix), reps=20)
            # the library call on indices clamped once beforehand (the
            # render's dead rows point past the table)
            ixc = ix.clamp(0, tab.shape[0] - 1)
            lib_ms = time_ms(lambda: torch.index_select(tab, 0, ixc), reps=20)
            bound = bytes_bound_ms(2 * ix.shape[0] * tab.shape[1] * 4)
            log(f"    kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"index_select {lib_ms:.4f} ms; bound {bound:.4f} ms "
                f"(bytes) -> {bound / ms:.1%} of it")
            timings[label.split()[0]] = (ms, plain_ms, lib_ms, bound)
    ms, plain_ms, lib_ms, bound = timings["render"]
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": lib_ms,
            "prototype_ms": timings["prototype"]}


def _run_app(argv, steps, draw=True):
    """app.main with -metrics; returns (metrics dict, what on_exit saw).
    With `draw` the last frame must be finite, nonzero and untruncated."""
    import torch

    from multi_adapter_particles_torch import app

    seen = {}

    def on_exit(particles):
        seen["position"] = particles.compute.state.position.clone()
        if draw:
            out = particles.render.last_output
            seen["frame"] = out.frame.clone()
            seen["truncated"] = int(out.truncated)
        seen["frames"] = particles.frame_count
        seen["device"] = particles.compute.device
        seen["config"] = particles.compute.config
        seen["rate"] = particles.metrics.rate("interactions")
        seen["renderer"] = particles.render.renderer
        seen["camera"] = particles.render.camera
        seen["fused"] = particles.fused_engine

    with tempfile.TemporaryDirectory() as tmp:
        metrics_path = os.path.join(tmp, "metrics.json")
        rc = app.main(argv + ["-metrics", metrics_path], on_exit=on_exit)
        if rc != 0:
            fail(f"app.main {argv} returned {rc}")
        with open(metrics_path) as f:
            metrics = json.load(f)
    if seen["frames"] != steps:
        fail(f"{seen['frames']} frames, expected {steps}")
    if seen["device"].type != "cuda":
        fail(f"compute ran on {seen['device']}, not the GPU")
    if not torch.isfinite(seen["position"]).all():
        fail("non-finite positions after the main path")
    if not draw:
        return metrics, seen
    frame = seen["frame"]
    if not torch.isfinite(frame).all():
        fail("non-finite values in the last frame")
    if float(frame.max()) <= 0.0:
        fail("the last frame is all zero")
    if seen["truncated"] != 0:
        fail(f"the last frame truncated {seen['truncated']} tile entries")
    return metrics, seen


def _counted():
    """name -> the kernel wrapper whose `.launches` counts it."""
    from multi_adapter_particles_torch.ops.allpairs import (
        all_pairs_accel,
        all_pairs_accel_halfpair,
    )
    from multi_adapter_particles_torch.ops.central_well import central_well_step
    from multi_adapter_particles_torch.ops.composite import composite_rows
    from multi_adapter_particles_torch.ops.rowgather import gather_rows
    from multi_adapter_particles_torch.ops.sortkv import sort_kv_stable

    return {"central_well": central_well_step, "composite": composite_rows,
            "sort_kv_stable": sort_kv_stable, "gather_rows": gather_rows,
            "all_pairs_rect": all_pairs_accel,
            "all_pairs_half": all_pairs_accel_halfpair}


def _zero_counters() -> None:
    for fn in _counted().values():
        fn.launches = 0


def _read_counters() -> dict:
    return {name: fn.launches for name, fn in _counted().items()}


def phase_main_path(dev):
    import statistics

    log(f"phase 5: main path — app.main -numparticles {N_MAIN} -steps {STEPS}"
        f" at {WIDTH}x{HEIGHT}")
    _zero_counters()
    t0 = time.perf_counter()
    metrics, seen = _run_app(
        ["-numparticles", str(N_MAIN), "-steps", str(STEPS), "-novsync",
         "-nogui", "-width", str(WIDTH), "-height", str(HEIGHT)], STEPS)
    wall = time.perf_counter() - t0
    launches = _read_counters()
    log(f"  app.main: rc 0, {seen['frames']} frames in {wall:.2f} s wall "
        f"(first-frame costs included), launches {launches}")
    if launches["central_well"] < STEPS:
        fail(f"central-well kernel launched {launches['central_well']} times"
             f" in {STEPS} frames")
    for name in ("composite", "sort_kv_stable", "gather_rows"):
        if launches[name] < 4 * STEPS:
            fail(f"{name} launched {launches[name]} times in {STEPS} frames "
                 "of 4 chunks")
    dev_frames = metrics["gauges"].get("device_frame_ms", [])[-30:]
    if len(dev_frames) < 10:
        fail(f"only {len(dev_frames)} CUDA-event frame samples")
    frame_ms = statistics.median(dev_frames)
    stages = metrics["stages_ms"]
    log(f"  ms/frame (CUDA events, median of last {len(dev_frames)}): "
        f"{frame_ms:.3f} (before the sort and gather kernels: "
        f"{MAIN_FRAME_MS_BEFORE}); simulate ms {stages['simulate']:.3f}, "
        f"render ms {stages['render']:.3f} (20-sample EMA); host frameTime ms "
        f"{metrics['frame_ms']:.3f}")
    frame = seen["frame"]
    log(f"  last frame: max {float(frame.max()):.4f}, mean "
        f"{float(frame.mean()):.5f}, truncated 0")
    return launches, seen, {"frame_ms": frame_ms,
                            "simulate_ms": stages["simulate"],
                            "render_ms": stages["render"]}


def phase_full_frame(seen):
    import torch

    from multi_adapter_particles_torch.ops.composite import composite_rows_plain
    from multi_adapter_particles_torch.ops.rowgather import gather_rows_plain
    from multi_adapter_particles_torch.ops.sortkv import sort_kv_stable_plain

    log("phase 6: final state's frame, the composite, sort and row-gather "
        "kernels vs their plain twins")
    rend = seen["renderer"]
    pos = seen["position"]
    with_kernel = rend.render_arrays(pos, seen["camera"], 2.5, 0.15).frame
    rend.composite = composite_rows_plain
    rend.sort = sort_kv_stable_plain
    rend.gather = gather_rows_plain
    with_plain = rend.render_arrays(pos, seen["camera"], 2.5, 0.15).frame
    torch.cuda.synchronize()
    log(f"  bitwise equal: {torch.equal(with_kernel, with_plain)}")
    return check_close("frame", with_kernel, with_plain, 0.0, 1e-5)


def _fused_vs_split(label, argv, steps, graph, split=None):
    """`app.main` with `-fused` against the split loop from the same seed
    (`split`: that run's `seen`, else run here): positions bitwise, the last
    frame within 1e-5, `fused_graph` == `graph`; with graphs, every counted
    kernel launched its captured frame's count once a frame. Returns the
    fused run's numbers."""
    import statistics

    import torch

    split_ms = None
    if split is None:
        split_metrics, split = _run_app(argv + ["-steps", str(steps)], steps)
        frames = split_metrics["gauges"].get("device_frame_ms", [])
        split_ms = statistics.median(frames) if frames else None
    _zero_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    metrics, seen = _run_app(argv + ["-fused", "-steps", str(steps)], steps)
    wall = time.perf_counter() - t0
    # the run's own peak, above what the process held before it
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    launches = {k: v for k, v in _read_counters().items() if v}
    eng = seen["fused"]
    ran_graph = metrics["gauges"].get("fused_graph")
    log(f"  {label}: rc 0, {steps} frames in {wall:.2f} s wall; fused_graph "
        f"{ran_graph}, {eng.replays} replays, launches a frame "
        f"{eng.launches_per_frame}, launches {launches}; peak memory "
        f"{peak:.2f} GiB")
    if ran_graph is not graph:
        fail(f"{label}: fused_graph {ran_graph}, expected {graph}")
    if graph:
        if eng.replays != steps - 1:
            fail(f"{label}: {eng.replays} replays in {steps} frames")
        for name, fn in _counted().items():
            want = eng.launches_per_frame.get(fn.__name__, 0) * steps
            if launches.get(name, 0) != want:
                fail(f"{label}: {name} launched {launches.get(name, 0)} "
                     f"times, the captured frame's count x {steps} is {want}")
    if not torch.equal(seen["position"], split["position"]):
        err = float((seen["position"] - split["position"]).abs().max())
        fail(f"{label}: positions after {steps} frames differ from the "
             f"split run's (max abs err {err:.3e})")
    frame_err = check_close(f"{label} last frame vs split", seen["frame"],
                            split["frame"], 0.0, 1e-5)
    bitwise = torch.equal(seen["frame"], split["frame"])
    frames = metrics["gauges"].get("device_frame_ms", [])
    stages = metrics["stages_ms"]
    out = {"frame_ms": statistics.median(frames) if frames else None,
           "split_frame_ms": split_ms, "render_ms": stages.get("render"),
           "simulate_ms": stages.get("simulate"), "replays": eng.replays,
           "launches_per_frame": eng.launches_per_frame,
           "peak_gib": peak, "frame_bitwise": bitwise,
           "frame_err": frame_err}
    log(f"  positions bitwise the split run's; last frame bitwise {bitwise};"
        f" ms/frame (CUDA events, median of {len(frames)}) "
        f"{out['frame_ms']} (the split run here: {split_ms}); render ms "
        f"{out['render_ms']}, simulate ms {out['simulate_ms']} (EMA)")
    return out


def phase_fused(split_4m):
    base = ["-novsync", "-nogui"]
    log(f"phase 22: fused main path — app.main -fused -numparticles {N_MAIN} "
        f"-steps {STEPS} at {WIDTH}x{HEIGHT} (vs phase 5)")
    out = {"4m": _fused_vs_split(
        "fused 4M", base + ["-numparticles", str(N_MAIN), "-width", str(WIDTH),
                            "-height", str(HEIGHT)], STEPS, True, split_4m)}
    log("phase 23: fused @262,144, 1280x720, vs split")
    out["262k_720p"] = _fused_vs_split(
        "fused 262K 720p", base + ["-numparticles", "262144", "-width", "1280",
                                   "-height", "720"], 30, True)
    log("phase 24: fused p3m (uncaptured), all_pairs and pm_grid, vs split")
    out["p3m"] = _fused_vs_split(
        "fused p3m 262K", base + ["-force", "p3m", "-p3mnear", "tree",
                                  "-numparticles", "262144"], 4, False)
    out["all_pairs"] = _fused_vs_split(
        "fused all_pairs 64K", base + ["-force", "all_pairs", "-numparticles",
                                       "65536", "-width", "512", "-height",
                                       "512"], 6, True)
    out["pm_grid"] = _fused_vs_split(
        "fused pm_grid 262K", base + ["-force", "pm_grid", "-pmgrid", "64",
                                      "-numparticles", "262144", "-width",
                                      "512", "-height", "512"], 6, True)
    return out


def check_rel(name: str, got, want, rel: float) -> float:
    """Fail unless max |got - want| <= rel * max |want[:3]| over all four
    channels (ax, ay, az, |a|); returns the max abs error."""
    import torch

    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite kernel output")
    scale = float(want[:3].abs().max())
    err = float((got.to(want.dtype) - want).abs().max())
    if not err <= rel * scale:
        fail(f"{name}: max abs err {err:.3e} > {rel} x max|a| {scale:.3e}")
    log(f"  {name}: max abs err {err:.3e} = {err / scale:.2e} of max|a| "
        f"{scale:.3e} (limit {rel})")
    return err


def _ap_state(dev, n):
    import torch

    from multi_adapter_particles_torch.models import init as pinit

    return pinit.initialize_particles_device(
        n, torch.Generator(device=dev).manual_seed(0), device=dev).position


def _ap_phys(n):
    from multi_adapter_particles_torch import constants as C

    # the engine's auto interaction scale, 1/N
    return dict(mass=C.PARTICLE_MASS, softening_squared=C.SOFTENING_SQUARED,
                interaction_scale=1.0 / n)


def phase_allpairs_rect(dev):
    import torch

    from multi_adapter_particles_torch.ops.allpairs import (
        all_pairs_accel,
        all_pairs_accel_plain,
    )

    log(f"phase 7: all-pairs rectangle kernel vs plain, {AP_SAMPLE:,} "
        f"targets x {N_AP:,} sources")
    pos = _ap_state(dev, N_AP)
    phys = _ap_phys(N_AP)
    idx = torch.linspace(0, N_AP - 1, AP_SAMPLE, device=dev).long()
    tgt = pos[:, idx].contiguous()
    k = all_pairs_accel(tgt, sources=pos, **phys)
    p32 = all_pairs_accel_plain(tgt, sources=pos, **phys)
    p64 = all_pairs_accel_plain(tgt.double(), sources=pos.double(), **phys)
    torch.cuda.synchronize()
    # Both are float32 sums of 1M terms in different orders (the twin:
    # torch's tree sums over 16k-source blocks; the kernel: 4 chains a
    # 256-source tile, Kahan over tiles), each ~1e-6 of max|a| from the
    # float64 sum: 1e-5 leaves 10x room. The kernel's RMS error against
    # float64 must be no worse than 2x the float32 twin's.
    err = check_rel("rect vs plain f32", k, p32, 1e-5)
    check_rel("rect vs plain f64", k, p64, 1e-5)
    rms_k = float(((k[:3].double() - p64[:3]) ** 2).mean().sqrt())
    rms_p = float(((p32[:3].double() - p64[:3]) ** 2).mean().sqrt())
    log(f"  RMS error vs float64: kernel {rms_k:.3e}, f32 twin {rms_p:.3e}")
    if not rms_k <= 2.0 * rms_p:
        fail(f"rect kernel RMS error {rms_k:.3e} > 2x the twin's {rms_p:.3e}")
    ms = time_ms(lambda: all_pairs_accel(tgt, sources=pos, **phys), reps=5)
    plain_ms = time_ms(lambda: all_pairs_accel_plain(tgt, sources=pos,
                                                     **phys), reps=2,
                       warmup=1)
    mhz = busy_clock_mhz(lambda: all_pairs_accel(tgt, sources=pos, **phys),
                         reps=10)
    bound = issue_bound_ms(AP_SAMPLE * N_AP * INSTR["all_pairs_rect"], mhz)
    full = all_pairs_accel(pos, **phys)  # the 1M result, kept for phase 8
    ms_1m = time_ms(lambda: all_pairs_accel(pos, **phys), reps=2, warmup=0)
    bound_1m = issue_bound_ms(N_AP * N_AP * INSTR["all_pairs_rect"], mhz)
    log(f"  sampled: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
        f"{bound:.3f} ms ({mhz:.0f} MHz); full {N_AP:,}: kernel "
        f"{ms_1m:.3f} ms = {N_AP * N_AP / (ms_1m * 1e-3):.4e} pairs/s, "
        f"bound {bound_1m:.3f} ms -> {bound_1m / ms_1m:.1%} of it")
    if not torch.equal(full[:, idx], k):
        fail("the sampled targets' rows differ from the full 1M result")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "operations",
            "ms_1m": ms_1m}, full


def phase_allpairs_half(dev, rect_1m):
    import torch

    from multi_adapter_particles_torch.ops.allpairs import (
        all_pairs_accel_halfpair,
        all_pairs_accel_halfpair_plain,
    )

    log(f"phase 8: all-pairs half-pair kernel vs plain @ {N_HALF_CHECK:,}, "
        f"vs the rectangle kernel @ {N_AP:,}")
    pos = _ap_state(dev, N_HALF_CHECK)
    phys = _ap_phys(N_HALF_CHECK)
    k = all_pairs_accel_halfpair(pos, **phys)
    p = all_pairs_accel_halfpair_plain(pos, **phys)
    torch.cuda.synchronize()
    # the same tile pairs summed in another order, as in phase 7
    err = check_rel("half vs plain", k, p, 1e-5)
    ms = time_ms(lambda: all_pairs_accel_halfpair(pos, **phys), reps=5)
    plain_ms = time_ms(lambda: all_pairs_accel_halfpair_plain(pos, **phys),
                       reps=2, warmup=1)
    mhz = busy_clock_mhz(lambda: all_pairs_accel_halfpair(pos, **phys),
                         reps=20)

    def half_bound_ms(n):
        nt, t2 = n // 512, 512 * 512
        return issue_bound_ms(
            nt * t2 * INSTR["all_pairs_half_diag"]
            + nt * (nt - 1) // 2 * t2 * INSTR["all_pairs_half_round"], mhz)

    bound = half_bound_ms(N_HALF_CHECK)
    del pos, k, p
    pos = _ap_state(dev, N_AP)
    phys = _ap_phys(N_AP)
    half = all_pairs_accel_halfpair(pos, **phys)
    torch.cuda.synchronize()
    # two schedules of the same sum (the JAX test: 5e-6 at 2048)
    check_rel("half vs rect @1M", half, rect_1m, 2e-5)
    ms_1m = time_ms(lambda: all_pairs_accel_halfpair(pos, **phys), reps=2,
                    warmup=0)
    log(f"  {N_HALF_CHECK:,}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; "
        f"{N_AP:,}: kernel {ms_1m:.3f} ms = "
        f"{N_AP * N_AP / (ms_1m * 1e-3):.4e} effective pairs/s")
    log(f"  {N_HALF_CHECK:,} bound {bound:.3f} ms, {N_AP:,} bound "
        f"{half_bound_ms(N_AP):.3f} ms ({mhz:.0f} MHz)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "operations",
            "ms_1m": ms_1m}, half


def phase_allpairs_exact(dev, rect_1m, half_1m):
    import torch

    from multi_adapter_particles_torch.ops.allpairs import (
        all_pairs_accel,
        all_pairs_accel_halfpair,
    )

    log(f"phase 9: half-pair fallback @ {N_UNTILEABLE:,}, run-to-run "
        f"determinism @ {N_AP:,}")
    pos = _ap_state(dev, 100_000)
    if pos.shape[1] != N_UNTILEABLE:
        fail(f"padded count {pos.shape[1]} != {N_UNTILEABLE}")
    phys = _ap_phys(100_000)
    if not torch.equal(all_pairs_accel_halfpair(pos, **phys),
                       all_pairs_accel(pos, **phys)):
        fail("the half-pair wrapper at an untileable N is not the "
             "rectangle kernel bit for bit")
    log("  fallback: bitwise the rectangle kernel")
    del pos
    pos = _ap_state(dev, N_AP)
    phys = _ap_phys(N_AP)
    for name, fn, first in (("rect", all_pairs_accel, rect_1m),
                            ("half", all_pairs_accel_halfpair, half_1m)):
        again = fn(pos, **phys)
        torch.cuda.synchronize()
        if not torch.equal(again, first):
            fail(f"{name} kernel: two runs at 1M differ")
        log(f"  {name}: two runs at {N_AP:,} bitwise equal")


def phase_allpairs_main_path():
    import statistics

    from multi_adapter_particles_torch.ops.allpairs import (
        all_pairs_accel,
        all_pairs_accel_halfpair,
    )
    from multi_adapter_particles_torch.ops.composite import composite_rows

    base = ["-force", "all_pairs", "-numparticles", str(N_AP), "-novsync",
            "-nogui", "-width", str(WIDTH), "-height", str(HEIGHT)]
    results = {}
    launches = {}
    for label, extra, steps, counter in (
            ("half", [], AP_STEPS_HALF, all_pairs_accel_halfpair),
            ("rect", ["-rectpair"], AP_STEPS_RECT, all_pairs_accel)):
        log(f"phase 10: all-pairs main path ({label}) — app.main "
            f"{' '.join(base + extra)} -steps {steps}")
        all_pairs_accel.launches = 0
        all_pairs_accel_halfpair.launches = 0
        composite_rows.launches = 0
        t0 = time.perf_counter()
        metrics, seen = _run_app(base + extra + ["-steps", str(steps)], steps)
        wall = time.perf_counter() - t0
        got = {"all_pairs_rect": all_pairs_accel.launches,
               "all_pairs_half": all_pairs_accel_halfpair.launches,
               "composite": composite_rows.launches}
        log(f"  rc 0, {steps} frames in {wall:.2f} s wall, launches {got}")
        if seen["config"].all_pairs_half != (label == "half"):
            fail(f"{label}: the run's config has all_pairs_half="
                 f"{seen['config'].all_pairs_half}")
        if counter.launches < steps:
            fail(f"{label}: the all-pairs kernel launched "
                 f"{counter.launches} times in {steps} frames")
        if got["composite"] < steps:
            fail(f"{label}: the composite kernel launched "
                 f"{got['composite']} times in {steps} frames")
        launches[label] = got
        # frame intervals past the timer's warm-up frames
        dev_frames = metrics["gauges"].get("device_frame_ms", [])
        if len(dev_frames) < steps - 3:
            fail(f"only {len(dev_frames)} CUDA-event frame samples")
        frame_ms = statistics.median(dev_frames)
        stages = metrics["stages_ms"]
        pairs = metrics["counters"]["interactions"] / steps
        results[label] = {
            "frame_ms": frame_ms, "simulate_ms": stages["simulate"],
            "render_ms": stages["render"],
            "pairs_per_s": pairs / (frame_ms * 1e-3),
            "interactions_per_s_wall": seen["rate"],
        }
        log(f"  ms/step (CUDA events, median of {len(dev_frames)} frames): "
            f"{frame_ms:.2f}; simulate ms {stages['simulate']:.2f}, render "
            f"ms {stages['render']:.3f} (EMA); {pairs:.6e} pairs/step -> "
            f"{results[label]['pairs_per_s']:.4e} pairs/s of device frame "
            f"time; interactions/s (wall, setup included) "
            f"{seen['rate']:.4e}")
        log(f"  last frame: max {float(seen['frame'].max()):.4f}, mean "
            f"{float(seen['frame'].mean()):.5f}, truncated 0")
        del seen
    return launches, results


def sm_clock_mhz() -> float:
    """The SM clock now (nvidia-smi)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    try:
        return float(out.stdout.split()[0])
    except (IndexError, ValueError):
        fail(f"nvidia-smi clocks.sm: {out.stdout!r} {out.stderr!r}")


def busy_clock_mhz(fn, reps: int) -> float:
    """The SM clock read while `reps` queued calls of `fn` run."""
    import torch

    torch.cuda.synchronize()
    for _ in range(reps):
        fn()
    mhz = sm_clock_mhz()
    torch.cuda.synchronize()
    return mhz


def issue_bound_ms(instructions: float, mhz: float) -> float:
    """Least time for `instructions` FP32-pipe lane-instructions: 132 SMs x
    128 lanes, one a clock (at 1,980 MHz that is the 67 TFLOP/s FP32 peak
    with each instruction an FMA's two flops)."""
    return instructions / (SMS * FP32_LANES * mhz * 1e6) * 1e3


def bytes_bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def _tree_scene(dev, n):
    """The port's device init (seed 0) at n, the grid `auto_grid` picks
    for it on this card, and the probed pair budget, as the CLI's startup
    probe sizes them."""
    from multi_adapter_particles_torch.ops import p3m, treeforce

    pos = _ap_state(dev, n)
    host = pos.cpu().numpy()
    grid = treeforce.auto_grid(host, BOX, CUTOFF,
                               treeforce.solve_budget(dev))
    r_c, gn = p3m.near_grid_for(grid, BOX, CUTOFF)
    coarse, _, block = treeforce.host_tree_counts(host, BOX, r_c, gn)
    budget = int(coarse * treeforce.PAIR_HEADROOM) + 1
    log(f"  {n:,}: auto grid G={grid}, near grid {gn}, block {block}, "
        f"{coarse:,} directed block pairs (host probe), budget {budget:,}")
    return pos, host, grid, r_c, gn, budget


def _sweeps(lists, r_c, **flags):
    """(wrapper, bare kernel, twin) calls of the sweep `lists` asks for;
    `flags` pick a potential variant of the directed sweep. The wrapper
    checks the list (one host sync) and, halved, builds the fold index
    each call; the bare call launches the kernels on int32 lists built
    here once, so its time is the kernels' alone."""
    import torch

    from multi_adapter_particles_torch import constants as C
    from multi_adapter_particles_torch.ops import p3m, treeforce

    eps2, sigma = C.SOFTENING_SQUARED, r_c * p3m._SIGMA_PER_CUTOFF
    L = lists
    if L.n3:
        args = (L.spos, L.sweep_i, L.sweep_j)
        kw = dict(nb=L.nb, block=L.block, eps2=eps2, sigma=sigma)
        prep = treeforce._n3_prepare(*args, L.nb, L.block)
        return (lambda: treeforce.near_sweep_n3(*args, **kw),
                lambda: treeforce._launch_sweep_n3(L.spos, *prep, eps2,
                                                   sigma),
                lambda: treeforce.near_sweep_n3_plain(*args, **kw))
    variant = treeforce._variant(flags.get("with_potential", False),
                                 flags.get("potential_only", False),
                                 flags.get("half_pairs", False))
    args = (L.spos, L.bounds, L.sweep_j)
    kw = dict(block=L.sweep_block, eps2=eps2, sigma=sigma, **flags)
    b32, j32 = L.bounds.to(torch.int32), L.sweep_j.to(torch.int32)
    return (lambda: treeforce.near_sweep(*args, **kw),
            lambda: treeforce._launch_sweep(L.spos, L.sweep_nb,
                                            L.sweep_block, b32, j32, eps2,
                                            sigma, variant),
            lambda: treeforce.near_sweep_plain(*args, **kw))


TREE_KERNELS = (("tree_sweep", False), ("tree_sweep_n3", True))


def phase_tree_check(dev):
    import torch

    from multi_adapter_particles_torch.ops import treeforce

    log(f"phase 11: tree sweeps vs twins @ {N_TREE_CHECK:,}")
    pos, host, grid, r_c, gn, budget = _tree_scene(dev, N_TREE_CHECK)
    for name, half in TREE_KERNELS:
        L = treeforce.tree_lists(pos, BOX, r_c, gn, pair_budget=budget,
                                 half_force=half)
        if L.dropped:
            fail(f"{name}: {L.dropped} block pairs dropped at the probed "
                 "budget")
        wrapper, kernel, twin = _sweeps(L, r_c)
        k, p = wrapper(), twin()
        torch.cuda.synchronize()
        # the same pair terms summed in another order (the kernel: list,
        # then lane order in float32 chains; the twin: torch's sums)
        check_rel(f"{name} vs plain", k, p, 1e-5)
        ms = time_ms(kernel, reps=10)
        wrapper_ms = time_ms(wrapper, reps=10)
        plain_ms = time_ms(twin, reps=1, warmup=0)
        mhz = busy_clock_mhz(kernel, reps=20)
        pairs = L.pairs * L.sweep_block ** 2
        bound = issue_bound_ms(pairs * INSTR[name], mhz)
        log(f"  {name}: {L.pairs:,} listed block pairs of {L.sweep_block} "
            f"= {pairs:.4e} pair interactions, dropped 0; kernel {ms:.3f} "
            f"ms (wrapper {wrapper_ms:.3f} ms), plain {plain_ms:.1f} ms; "
            f"bound {bound:.3f} ms at {mhz:.0f} MHz -> {bound / ms:.1%} of "
            "it")
    return pos, host, r_c, gn, budget


def phase_tree_expansion(pos, host, r_c, gn, budget):
    import torch

    from multi_adapter_particles_torch import constants as C
    from multi_adapter_particles_torch.ops import treeforce

    log(f"phase 12: sub-block expansion @ {N_TREE_CHECK:,}: blocks of 1024 "
        "swept at 512 vs blocks of 256")
    coarse, sub, _ = treeforce.host_tree_counts(host, BOX, r_c, gn,
                                                block=1024)
    wide = treeforce.tree_lists(pos, BOX, r_c, gn, block=1024,
                                pair_budget=int(coarse * 1.25) + 1,
                                sub_pair_budget=int(sub * 1.25) + 2)
    if (wide.sweep_block, wide.n3) != (512, False):
        fail(f"block 1024 swept at {wide.sweep_block}, n3 {wide.n3}")
    if wide.pairs != sub or wide.dropped:
        fail(f"expansion kept {wide.pairs} sub-pairs (host probe {sub}), "
             f"dropped {wide.dropped}")
    kw = dict(g_const=1.0, eps2=C.SOFTENING_SQUARED, r_c=r_c, near_grid=gn)
    a_wide, d_wide = treeforce.near_field_tree(
        pos, BOX, block=1024, pair_budget=int(coarse * 1.25) + 1,
        sub_pair_budget=int(sub * 1.25) + 2, **kw)
    a_ref, d_ref = treeforce.near_field_tree(pos, BOX, block=256,
                                             pair_budget=budget, **kw)
    torch.cuda.synchronize()
    if d_wide or d_ref:
        fail(f"dropped pairs: {d_wide} (1024), {d_ref} (256)")
    log(f"  block 1024: {coarse:,} block pairs -> {sub:,} sub-pairs of 512")
    return check_rel("expanded (1024 -> 512) vs blocks of 256", a_wide,
                     a_ref, 1e-5)


def phase_tree_1m(dev):
    import torch

    from multi_adapter_particles_torch.ops import p3m, pm, treeforce

    log(f"phase 13: tree sweeps @ {N_TREE:,}")
    pos, host, grid, r_c, gn, budget = _tree_scene(dev, N_TREE)
    out, accel = {}, {}
    for name, half in TREE_KERNELS:
        build_ms = time_ms(lambda: treeforce.tree_lists(
            pos, BOX, r_c, gn, pair_budget=budget, half_force=half), reps=3)
        L = treeforce.tree_lists(pos, BOX, r_c, gn, pair_budget=budget,
                                 half_force=half)
        if L.dropped:
            fail(f"{name}: {L.dropped} block pairs dropped")
        wrapper, kernel, twin = _sweeps(L, r_c)
        k, again = wrapper(), kernel()
        p, plain_ms = timed(twin)
        if not torch.equal(k, again):
            fail(f"{name}: two runs at {N_TREE:,} differ")
        err = check_rel(f"{name} vs plain", k, p, 1e-5)
        del again, p
        ms = time_ms(kernel, reps=5)
        wrapper_ms = time_ms(wrapper, reps=5)
        plain_ms = time_ms(twin, reps=1, warmup=0)
        mhz = busy_clock_mhz(kernel, reps=8)
        pairs = L.pairs * L.sweep_block ** 2
        bound = issue_bound_ms(pairs * INSTR[name], mhz)
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": "operations",
                     "wrapper_ms": wrapper_ms, "list_ms": build_ms,
                     "pairs": pairs, "mhz": mhz}
        log(f"  {name}: {L.pairs:,} listed block pairs of {L.sweep_block}"
            f" = {pairs:.4e} pair interactions; runs bitwise equal; kernel "
            f"{ms:.3f} ms (wrapper, list checks and fold index included: "
            f"{wrapper_ms:.3f} ms), plain {plain_ms:.1f} ms; list build "
            f"{build_ms:.3f} ms; bound {bound:.3f} ms ({INSTR[name]} FP32 "
            f"instructions a pair at {mhz:.0f} MHz) -> {bound / ms:.1%} of "
            "it")
        accel[name] = treeforce.unsort(L, k, 1.0)
        del L, k
    check_rel("tree_sweep_n3 vs tree_sweep @1M", accel["tree_sweep_n3"],
              accel["tree_sweep"], 1e-5)
    del accel
    rho = pm.deposit_cic(pos, grid, BOX)
    grids = p3m._accel_long(rho, grid, BOX, 1.0, r_c)
    far = {"deposit": time_ms(lambda: pm.deposit_cic(pos, grid, BOX), 5),
           "solve": time_ms(lambda: p3m._accel_long(rho, grid, BOX, 1.0,
                                                    r_c), 5),
           "interp": time_ms(lambda: pm._interp(grids, pos, grid, BOX), 5)}
    log(f"  far field G={grid}: deposit {far['deposit']:.3f} ms, FFT solve "
        f"{far['solve']:.3f} ms, interpolation {far['interp']:.3f} ms")
    out["far_ms"] = far
    out["scene"] = (pos, grid, budget)
    return out


def phase_tree_physics(scene):
    import torch

    from multi_adapter_particles_torch import constants as C
    from multi_adapter_particles_torch.ops import p3m
    from multi_adapter_particles_torch.ops.allpairs import all_pairs_accel

    pos, grid, budget = scene
    log(f"phase 14: tree-P3M vs the exact sum, {TREE_SAMPLE:,} targets of "
        f"{N_TREE:,}")
    a = p3m.p3m_accel(pos, grid=grid, box=BOX,
                      g_const=C.PARTICLE_MASS / N_TREE,
                      softening_squared=C.SOFTENING_SQUARED,
                      cutoff_cells=CUTOFF, near_mode="tree",
                      pair_budget=budget, half_force=True)
    idx = torch.linspace(0, N_TREE - 1, TREE_SAMPLE,
                         device=pos.device).long()
    exact = all_pairs_accel(pos[:, idx].contiguous(), sources=pos,
                            **_ap_phys(N_TREE))[:3]
    torch.cuda.synchronize()
    rms = float(((a[:, idx] - exact) ** 2).mean().sqrt())
    scale = float(exact.abs().max())
    log(f"  RMS error {rms:.4e} = {rms / scale:.4%} of max|a| {scale:.4e} "
        "(limit 1%)")
    if not rms < 0.01 * scale:
        fail(f"tree-P3M RMS error {rms / scale:.4%} of max|a|")
    return rms / scale


def phase_solve_memory(dev):
    import torch

    from multi_adapter_particles_torch.ops import p3m, treeforce

    log("phase 15: long-range solve memory")
    per_cell = {}
    for g in (192, 256):
        rho = torch.rand((g, g, g), device=dev)
        p3m._long_grad_kernels_rfft.cache_clear()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        got = []
        for _ in ("cold", "warm"):   # cold tabulates the kernels
            torch.cuda.reset_peak_memory_stats(dev)
            grids = p3m._accel_long(rho, g, BOX, 1.0, CUTOFF * BOX / g)
            torch.cuda.synchronize()
            got.append((torch.cuda.max_memory_allocated(dev) - base
                        + rho.numel() * 4) / g ** 3)
            del grids
        per_cell[g] = got
        log(f"  G={g}: peak {got[0]:.2f} B/cell cold, {got[1]:.2f} warm "
            f"(rho included); count {treeforce.SOLVE_BYTES_PER_CELL}")
        if max(got) > treeforce.SOLVE_BYTES_PER_CELL:
            fail(f"G={g}: the solve held {max(got):.2f} B/cell, over the "
                 f"{treeforce.SOLVE_BYTES_PER_CELL} feasible_grid counts")
        del rho
        p3m._long_grad_kernels_rfft.cache_clear()
        torch.cuda.empty_cache()
    return per_cell


def phase_pm_main_path():
    import statistics

    n = N_MAIN
    log(f"phase 16: pm_grid main path — app.main -force pm_grid "
        f"-numparticles {n} -pmgrid {PM_GRID} -nodraw -steps {PM_STEPS}")
    t0 = time.perf_counter()
    metrics, seen = _run_app(
        ["-force", "pm_grid", "-numparticles", str(n), "-pmgrid",
         str(PM_GRID), "-nodraw", "-novsync", "-nogui",
         "-steps", str(PM_STEPS)], PM_STEPS, draw=False)
    wall = time.perf_counter() - t0
    if seen["config"].force_model != "pm_grid":
        fail(f"ran {seen['config'].force_model}")
    frames = metrics["gauges"].get("device_frame_ms", [])
    step_ms = (statistics.median(frames) if frames
               else metrics["stages_ms"]["simulate"])
    log(f"  rc 0, {PM_STEPS} steps in {wall:.2f} s wall; ms/step {step_ms:.3f}"
        f" (CUDA events, median of {len(frames)}); simulate ms "
        f"{metrics['stages_ms']['simulate']:.3f} (EMA)")
    return {"step_ms": step_ms, "simulate_ms":
            metrics["stages_ms"]["simulate"]}


def phase_tree_main_path():
    import statistics

    from multi_adapter_particles_torch.ops.composite import composite_rows
    from multi_adapter_particles_torch.ops.treeforce import (
        near_sweep,
        near_sweep_n3,
    )

    base = ["-force", "p3m", "-p3mnear", "tree", "-numparticles",
            str(N_TREE), "-novsync", "-nogui", "-width", str(WIDTH),
            "-height", str(HEIGHT)]
    results, launches = {}, {}
    for label, extra, steps, counter in (
            ("n3", [], TREE_STEPS_N3, near_sweep_n3),
            ("directed", ["-treedirected"], TREE_STEPS_DIRECTED,
             near_sweep)):
        log(f"phase 17: tree-P3M main path ({label}) — app.main "
            f"{' '.join(base + extra)} -steps {steps}")
        near_sweep.launches = 0
        near_sweep_n3.launches = 0
        composite_rows.launches = 0
        t0 = time.perf_counter()
        metrics, seen = _run_app(base + extra + ["-steps", str(steps)],
                                 steps)
        wall = time.perf_counter() - t0
        got = {"tree_sweep": near_sweep.launches,
               "tree_sweep_n3": near_sweep_n3.launches,
               "composite": composite_rows.launches}
        cfg = seen["config"]
        log(f"  rc 0, {steps} frames in {wall:.2f} s wall, launches {got}; "
            f"G={cfg.pm_grid_size}, pair budget {cfg.p3m_pair_budget}, "
            f"tree_half_force {cfg.tree_half_force}")
        if cfg.tree_half_force != (label == "n3"):
            fail(f"{label}: the run's config has tree_half_force="
                 f"{cfg.tree_half_force}")
        if counter.launches < steps:
            fail(f"{label}: the sweep kernel launched {counter.launches} "
                 f"times in {steps} frames")
        if got["composite"] < steps:
            fail(f"{label}: the composite kernel launched "
                 f"{got['composite']} times in {steps} frames")
        dev_frames = metrics["gauges"].get("device_frame_ms", [])
        if len(dev_frames) < steps - 3:
            fail(f"only {len(dev_frames)} CUDA-event frame samples")
        stages = metrics["stages_ms"]
        results[label] = {
            "frame_ms": statistics.median(dev_frames),
            "simulate_ms": stages["simulate"],
            "render_ms": stages["render"],
            "probe_s": metrics["gauges"]["probe_s"],
            "grid": cfg.pm_grid_size,
        }
        launches[label] = got
        log(f"  ms/frame (CUDA events, median of {len(dev_frames)}): "
            f"{results[label]['frame_ms']:.2f}; simulate ms "
            f"{stages['simulate']:.2f}, render ms {stages['render']:.3f} "
            f"(EMA); startup probe {results[label]['probe_s']:.2f} s")
        log(f"  last frame: max {float(seen['frame'].max()):.4f}, mean "
            f"{float(seen['frame'].mean()):.5f}, truncated 0")
        del seen
    return launches, results


# the potential variants of the directed sweep: (name, wrapper flags)
POT_VARIANTS = (
    ("tree_sweep_with_potential", dict(with_potential=True)),
    ("tree_sweep_potential_only", dict(with_potential=True,
                                       potential_only=True)),
    ("tree_sweep_half_pairs", dict(with_potential=True, potential_only=True,
                                   half_pairs=True)),
)
POT = dict(POT_VARIANTS)


def check_u(name: str, got, want, live, rel: float) -> float:
    """Fail unless the potential rows agree within rel x max|want| over the
    live lanes (dead lanes are zeroed by the caller); returns the max abs
    error there."""
    import torch

    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite kernel output")
    scale = float(want[live].abs().max())
    err = float((got[live] - want[live]).abs().max())
    if not err <= rel * scale:
        fail(f"{name}: max abs err {err:.3e} > {rel} x max|u| {scale:.3e}")
    log(f"  {name}: max abs err {err:.3e} = {err / scale:.2e} of max|u| "
        f"{scale:.3e} (limit {rel}, live lanes)")
    return err


def _time_variant(name, lists, kernel, plain_ms, reps):
    """Kernel ms, the SM clock under load, and the issue bound of `name`
    over the listed pairs, beside the twin's ms (one timed call)."""
    ms = time_ms(kernel, reps=reps)
    mhz = busy_clock_mhz(kernel, reps=max(8, reps))
    pairs = lists.pairs * lists.sweep_block ** 2
    bound = issue_bound_ms(pairs * INSTR[name], mhz)
    log(f"  {name}: {lists.pairs:,} listed block pairs of "
        f"{lists.sweep_block} = {pairs:.4e} pair interactions; kernel "
        f"{ms:.3f} ms, plain {plain_ms:.1f} ms; bound {bound:.3f} ms "
        f"({INSTR[name]} FP32 instructions a pair at {mhz:.0f} MHz) -> "
        f"{bound / ms:.1%} of it")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations", "pairs": pairs, "mhz": mhz}


def _potential_totals(pos, r_c, gn, **budgets):
    """Σu of the potential-only sweep, directed and halved (dropped must be
    0), through `near_field_tree(total_only=True)`."""
    from multi_adapter_particles_torch import constants as C
    from multi_adapter_particles_torch.ops import treeforce

    totals = []
    for half in (False, True):
        tot, dropped = treeforce.near_field_tree(
            pos, BOX, 1.0, C.SOFTENING_SQUARED, r_c, gn, with_potential=True,
            potential_only=True, half_pairs=half, total_only=True, **budgets)
        if dropped:
            fail(f"potential total (half_pairs={half}): {dropped} pairs "
                 "dropped")
        totals.append(float(tot))
    rel = abs(totals[1] - totals[0]) / abs(totals[0])
    log(f"  Σu directed {totals[0]:.9e}, halved {totals[1]:.9e}: rel "
        f"{rel:.2e} (limit 1e-5)")
    if not rel <= 1e-5:
        fail(f"halved potential total off the directed one by {rel:.2e}")
    return rel


def phase_potential_check(dev):
    import torch

    from multi_adapter_particles_torch import constants as C
    from multi_adapter_particles_torch.ops import p3m, treeforce

    log(f"phase 18: potential sweep variants vs twins @ {N_TREE_CHECK:,}")
    pos, _, _, r_c, gn, budget = _tree_scene(dev, N_TREE_CHECK)
    L = treeforce.tree_lists(pos, BOX, r_c, gn, pair_budget=budget)
    Lh = treeforce.tree_lists(pos, BOX, r_c, gn, pair_budget=budget,
                              half_pairs=True)
    if L.dropped or Lh.dropped:
        fail(f"dropped pairs: {L.dropped} directed, {Lh.dropped} halved")
    log(f"  {L.pairs:,} directed block pairs, {Lh.pairs:,} halved")
    force = _sweeps(L, r_c)[1]()
    out = {}
    for name, flags in POT_VARIANTS:
        lists = Lh if flags.get("half_pairs") else L
        wrapper, kernel, twin = _sweeps(lists, r_c, **flags)
        k = wrapper()
        p, plain_ms = timed(twin)
        check_u(f"{name} vs plain", k[3], p[3], lists.live, 1e-5)
        if flags.get("potential_only"):
            if not bool((k[:3] == 0).all()):
                fail(f"{name}: nonzero force rows")
        else:
            check_rel(f"{name} force rows vs plain", k[:3], p[:3], 1e-5)
            if not torch.equal(k[:3], force[:3]):
                fail(f"{name}: the force rows are not bitwise the "
                     "force-only kernel's")
            log(f"  {name}: force rows bitwise the force-only kernel's")
        out[name] = k
        _time_variant(name, lists, kernel, plain_ms, reps=10)
    if not torch.equal(out["tree_sweep_potential_only"][3],
                       out["tree_sweep_with_potential"][3]):
        fail("potential-only row 3 is not bitwise the fused variant's")
    log("  potential-only row 3 bitwise the fused variant's")
    # the self-pair constant the wrappers subtract is what a sweep adds:
    # 32 particles 4 r_c apart in one block, each alone with itself
    eps2, sigma = C.SOFTENING_SQUARED, r_c * p3m._SIGMA_PER_CUTOFF
    u_self = treeforce.potential_self(eps2, sigma, dev)
    lone = torch.zeros((4, 32), device=dev)
    lone[0] = torch.arange(32, device=dev) * (4.0 * r_c) - 60.0 * r_c
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    bounds = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    for name, flags in POT_VARIANTS:
        row = treeforce.near_sweep(lone, bounds, one, block=32, eps2=eps2,
                                   sigma=sigma, **flags)[3]
        want = u_self * (0.5 if flags.get("half_pairs") else 1.0)
        if not bool((row == want).all()):
            fail(f"{name}: a lone particle's sum {row[:2].tolist()} is not "
                 f"the self constant {want!r}")
    log(f"  self-pair constant on the card {u_self!r} (host evaluation "
        f"{treeforce.short_potential_self(eps2, sigma)!r}): every variant's "
        "lone-particle sum is it, bitwise")
    _potential_totals(pos, r_c, gn, pair_budget=budget)


def phase_gauge_sweeps(dev):
    import torch

    from multi_adapter_particles_torch.config import SimConfig
    from multi_adapter_particles_torch.models import diagnostics as D
    from multi_adapter_particles_torch.models import init as pinit
    from multi_adapter_particles_torch.ops import p3m, treeforce
    from multi_adapter_particles_torch.utils.metrics import MetricsRegistry

    log(f"phase 19: gauge sweeps @ {N_MAIN:,} (pm_grid gauge) and "
        f"{N_TREE:,} (tree-P3M gauge)")
    out = {}
    state = pinit.initialize_particles_device(
        N_MAIN, torch.Generator(device=dev).manual_seed(0), device=dev)
    pos = state.position
    grid = D._gauge_grid(N_MAIN, PM_GRID)
    r_c, gn = p3m.near_grid_for(grid, BOX, CUTOFF)
    t0 = time.perf_counter()
    coarse, sub, block = treeforce.host_tree_counts(pos.cpu().numpy(), BOX,
                                                    r_c, gn)
    probe_s = time.perf_counter() - t0
    budgets = dict(pair_budget=int(coarse * treeforce.PAIR_HEADROOM) + 1,
                   sub_pair_budget=int(sub * treeforce.PAIR_HEADROOM) + 2)
    log(f"  {N_MAIN:,}: gauge grid G={grid}, near grid {gn}, block {block}; "
        f"host probe {probe_s:.2f} s: {coarse:,} block pairs, {sub:,} "
        f"sub-pairs of 512; budgets {budgets}")
    Lh = treeforce.tree_lists(pos, BOX, r_c, gn, half_pairs=True, **budgets)
    if (block, Lh.sweep_block, Lh.dropped) != (2048, 512, 0):
        fail(f"4M gauge list: block {block} swept at {Lh.sweep_block}, "
             f"dropped {Lh.dropped}")
    build_ms = time_ms(lambda: treeforce.tree_lists(
        pos, BOX, r_c, gn, half_pairs=True, **budgets), reps=3)
    name = "tree_sweep_half_pairs"
    wrapper, kernel, twin = _sweeps(Lh, r_c, **POT[name])
    k, again = wrapper(), kernel()
    p, plain_ms = timed(twin)
    if not torch.equal(k, again):
        fail(f"{name}: two runs at {N_MAIN:,} differ")
    err = check_u(f"{name} vs plain @4M", k[3], p[3], Lh.live, 1e-5)
    del again, p
    out[name] = {"max_abs_err": err, "list_ms": build_ms,
                 "probe_s": probe_s,
                 **_time_variant(name, Lh, kernel, plain_ms, reps=5)}
    log(f"  halved list build {build_ms:.3f} ms")
    del k, Lh
    out["total_rel_4m"] = _potential_totals(pos, r_c, gn, **budgets)

    cfg = SimConfig(num_particles=N_MAIN, force_model="pm_grid",
                    pm_grid_size=PM_GRID)
    probe = D.DiagnosticsProbe(cfg, 1)
    if not probe.use_run_accel:
        fail("the 4M pm_grid probe does not take the run's accel")
    seen = []
    for _ in range(2):
        m = MetricsRegistry()
        probe.maybe_publish(0, state, m)
        seen.append(m.gauges)
    first, warm = seen[1]["diag_sample_ms"]
    for key, v in seen[0].items():
        if key != "diag_sample_ms" and v != seen[1][key]:
            fail(f"gauge {key}: {v!r} then {seen[1][key]!r} on the same "
                 "state")
    if seen[0]["diag_dropped_pairs"] != 0:
        fail(f"4M gauge dropped {seen[0]['diag_dropped_pairs']} pairs")
    out["publish_ms"] = {"first": first, "warm": warm}
    log(f"  DiagnosticsProbe.maybe_publish @4M: first {first:.1f} ms (budget "
        f"probe included), warm {warm:.1f} ms; gauges bitwise equal on the "
        f"second call: potential {seen[0]['potential']:.9e}, energy "
        f"{seen[0]['energy']:.9e}")
    del state, pos, seen
    torch.cuda.empty_cache()

    pos, _, grid, r_c, gn, budget = _tree_scene(dev, N_TREE)
    if D._gauge_grid(N_TREE, grid) != grid:
        fail(f"the 1M gauge grid is not the run's G={grid}")
    L = treeforce.tree_lists(pos, BOX, r_c, gn, pair_budget=budget)
    if L.dropped:
        fail(f"1M gauge list dropped {L.dropped} pairs")
    force = _sweeps(L, r_c)[1]()
    rows = {}
    for name in ("tree_sweep_with_potential", "tree_sweep_potential_only"):
        wrapper, kernel, twin = _sweeps(L, r_c, **POT[name])
        k, again = wrapper(), kernel()
        p, plain_ms = timed(twin)
        if not torch.equal(k, again):
            fail(f"{name}: two runs at {N_TREE:,} differ")
        err = check_u(f"{name} vs plain @1M", k[3], p[3], L.live, 1e-5)
        if name == "tree_sweep_with_potential":
            err = max(err, check_rel(f"{name} force rows vs plain @1M",
                                     k[:3], p[:3], 1e-5))
            if not torch.equal(k[:3], force[:3]):
                fail(f"{name}: force rows differ from the force-only "
                     "kernel's @1M")
        rows[name] = k[3]
        del again, p
        out[name] = {"max_abs_err": err,
                     **_time_variant(name, L, kernel, plain_ms, reps=5)}
    if not torch.equal(rows["tree_sweep_potential_only"],
                       rows["tree_sweep_with_potential"]):
        fail("potential-only row 3 differs from the fused one @1M")
    log("  @1M: fused force rows bitwise the force-only kernel's, "
        "potential-only row 3 bitwise the fused one")
    out["scene_1m"] = (pos, grid, budget)
    return out


def phase_exact_gauge(dev):
    import torch

    from multi_adapter_particles_torch.config import SimConfig
    from multi_adapter_particles_torch.models import diagnostics as D
    from multi_adapter_particles_torch.models import init as pinit

    n = N_TREE_CHECK
    log(f"phase 20: mesh vs exact potential gauge @ {n:,}")
    state = pinit.initialize_particles_device(
        n, torch.Generator(device=dev).manual_seed(0), device=dev)
    cfg = SimConfig(num_particles=n, force_model="pm_grid")
    exact_fn = D.make_diagnostics(cfg, potential_mode="exact")
    mesh_fn = D.DiagnosticsProbe(cfg, 1, potential_mode="mesh")._build(
        state, external_accel=False)
    got, ms = {}, {}
    for label, fn in (("exact", exact_fn), ("mesh", mesh_fn), ("exact", exact_fn),
                      ("mesh", mesh_fn)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got[label] = {k: float(v) for k, v in fn(state).items()}
        ms[label] = (time.perf_counter() - t0) * 1e3   # the second: warm
    if got["mesh"]["diag_dropped_pairs"] != 0:
        fail(f"mesh gauge dropped {got['mesh']['diag_dropped_pairs']} pairs")
    pe, pm_ = got["exact"]["potential"], got["mesh"]["potential"]
    rel = abs(pm_ - pe) / abs(pe)
    log(f"  G={cfg.pm_grid_size}: potential exact {pe:.9e}, mesh {pm_:.9e}: "
        f"rel {rel:.2e} (limit 1e-3); a sample: exact {ms['exact']:.1f} ms, "
        f"mesh {ms['mesh']:.1f} ms (warm, host wall)")
    if not rel <= 1e-3:
        fail(f"mesh potential off the exact sum by {rel:.2e}")
    return {"rel": rel, "exact_ms": ms["exact"], "mesh_ms": ms["mesh"]}


def phase_diag_main_paths(scene_1m):
    import math

    from multi_adapter_particles_torch import constants as C
    from multi_adapter_particles_torch.models import diagnostics as D
    from multi_adapter_particles_torch.ops.central_well import central_well_step
    from multi_adapter_particles_torch.ops.treeforce import (
        LAUNCH_COUNTERS,
        near_sweep,
    )

    names = dict(zip(LAUNCH_COUNTERS, ("tree_sweep", *POT)))
    results, launches = {}, {}
    for label, argv, steps, every in DIAG_RUNS:
        full = argv + ["-novsync", "-nogui", "-steps", str(steps),
                       "-diagnostics", str(every)]
        log(f"phase 21: diagnostics main path ({label}) — app.main "
            f"{' '.join(full)}")
        for c in LAUNCH_COUNTERS:
            setattr(near_sweep, c, 0)
        central_well_step.launches = 0
        t0 = time.perf_counter()
        metrics, seen = _run_app(full, steps, draw="-nodraw" not in argv)
        wall = time.perf_counter() - t0
        got = {names[c]: getattr(near_sweep, c) for c in LAUNCH_COUNTERS}
        got["central_well"] = central_well_step.launches
        g = metrics["gauges"]
        samples = steps // every
        log(f"  rc 0, {steps} frames in {wall:.2f} s wall; launches {got}; "
            f"sample ms {g.get('diag_sample_ms')}")
        for key in ("kinetic", "potential", "energy", "energy_drift",
                    "momentum_mag", "angular_momentum_mag"):
            if not math.isfinite(g.get(key, math.nan)):
                fail(f"{label}: gauge {key} = {g.get(key)!r}")
        if len(g["diag_sample_ms"]) != samples:
            fail(f"{label}: {len(g['diag_sample_ms'])} samples, expected "
                 f"{samples}")
        mesh = label in ("pm_grid", "p3m")
        if mesh != ("diag_dropped_pairs" in g):
            fail(f"{label}: expected the {'mesh' if mesh else 'exact'} "
                 "gauge")
        if mesh and g["diag_dropped_pairs"] != 0:
            fail(f"{label}: diag_dropped_pairs {g['diag_dropped_pairs']}")
        want = {"pm_grid": "tree_sweep_half_pairs",
                "p3m": "tree_sweep_with_potential",
                "central_well": "central_well"}.get(label)
        if want and got[want] < (samples if mesh else steps):
            fail(f"{label}: {want} launched {got[want]} times")
        if label == "p3m" and seen["config"].pm_grid_size != scene_1m[1]:
            fail(f"p3m run picked G={seen['config'].pm_grid_size}")
        launches[label] = got
        results[label] = {"sample_ms": g["diag_sample_ms"],
                          "energy_drift": g["energy_drift"],
                          "frame_ms": metrics["gauges"].get(
                              "device_frame_ms", [])}
        del seen

    pos, grid, budget = scene_1m
    label = "mesh_potential_only(half_pairs=False)"
    log(f"phase 21: potential-only directed path — {label} @ {N_TREE:,}, "
        f"G={grid}")
    for c in LAUNCH_COUNTERS:
        setattr(near_sweep, c, 0)
    pot, dropped = D.mesh_potential_only(
        pos, C.PARTICLE_MASS / N_TREE, C.SOFTENING_SQUARED, grid=grid,
        box=BOX, cutoff_cells=CUTOFF, pair_budget=budget, half_pairs=False,
        total_only=False)
    got = {names[c]: getattr(near_sweep, c) for c in LAUNCH_COUNTERS}
    log(f"  potential {float(pot):.9e}, dropped {dropped}, launches {got}")
    if dropped or got["tree_sweep_potential_only"] < 1:
        fail(f"{label}: dropped {dropped}, launches {got}")
    if not math.isfinite(float(pot)):
        fail(f"{label}: potential {float(pot)!r}")
    launches["potential_only"] = got
    return launches, results


def main() -> int:
    phase_device()
    import torch

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    cw = phase_central_well(dev)
    comp = phase_composite(dev)
    torch.cuda.empty_cache()
    sort, gather_args = phase_sort(dev)
    gather = phase_gather(dev, gather_args)
    del gather_args
    torch.cuda.empty_cache()
    launches, seen, frame = phase_main_path(dev)
    split_4m = {"position": seen["position"], "frame": seen["frame"]}
    frame_err = phase_full_frame(seen)
    del seen
    torch.cuda.empty_cache()
    rect, rect_1m = phase_allpairs_rect(dev)
    half, half_1m = phase_allpairs_half(dev, rect_1m)
    phase_allpairs_exact(dev, rect_1m, half_1m)
    del rect_1m, half_1m
    torch.cuda.empty_cache()
    ap_launches, ap_path = phase_allpairs_main_path()
    torch.cuda.empty_cache()
    scene = phase_tree_check(dev)
    phase_tree_expansion(*scene)
    del scene
    torch.cuda.empty_cache()
    tree = phase_tree_1m(dev)
    rms = phase_tree_physics(tree.pop("scene"))
    torch.cuda.empty_cache()
    solve = phase_solve_memory(dev)
    pm_path = phase_pm_main_path()
    torch.cuda.empty_cache()
    tree_launches, tree_path = phase_tree_main_path()
    torch.cuda.empty_cache()
    phase_potential_check(dev)
    torch.cuda.empty_cache()
    gauge = phase_gauge_sweeps(dev)
    torch.cuda.empty_cache()
    exact = phase_exact_gauge(dev)
    torch.cuda.empty_cache()
    diag_launches, diag_path = phase_diag_main_paths(gauge.pop("scene_1m"))
    torch.cuda.empty_cache()
    fused = phase_fused(split_4m)
    del split_4m

    def entry(name, source, replaces, launches, stats):
        """`replaces`: the TPU kernel's file:line from the repository root
        (a bare name is under multi_adapter_particles_tpu/ops/)."""
        if "/" not in replaces:
            replaces = f"multi_adapter_particles_tpu/ops/{replaces}"
        return {"name": name, "route": "cuda",
                "source": f"multi_adapter_particles_torch/csrc/{source}",
                "replaces": replaces,
                "launches": launches, "max_abs_err": stats["max_abs_err"],
                "ms": stats["ms"], "plain_ms": stats["plain_ms"],
                "bound_ms": stats["bound_ms"], "bound_by": stats["bound_by"],
                "library_ms": stats.get("library_ms")}

    kernels = [
        entry("central_well", "central_well.cu", "central_well.py:32",
              launches["central_well"], cw),
        entry("composite", "composite.cu", "composite.py:34",
              launches["composite"],
              {**comp, "max_abs_err": max(comp["max_abs_err"], frame_err)}),
        entry("all_pairs_rect", "allpairs.cu", "allpairs.py:47",
              ap_launches["rect"]["all_pairs_rect"], rect),
        entry("all_pairs_half", "allpairs.cu", "allpairs.py:269",
              ap_launches["half"]["all_pairs_half"], half),
        entry("tree_sweep", "treeforce.cu", "treeforce.py:210",
              tree_launches["directed"]["tree_sweep"], tree["tree_sweep"]),
        entry("tree_sweep_n3", "treeforce.cu", "treeforce.py:422",
              tree_launches["n3"]["tree_sweep_n3"], tree["tree_sweep_n3"]),
        entry("tree_sweep_with_potential", "treeforce.cu", "treeforce.py:288",
              diag_launches["p3m"]["tree_sweep_with_potential"],
              gauge["tree_sweep_with_potential"]),
        entry("tree_sweep_potential_only", "treeforce.cu", "treeforce.py:305",
              diag_launches["potential_only"]["tree_sweep_potential_only"],
              gauge["tree_sweep_potential_only"]),
        entry("tree_sweep_half_pairs", "treeforce.cu", "treeforce.py:293",
              diag_launches["pm_grid"]["tree_sweep_half_pairs"],
              gauge["tree_sweep_half_pairs"]),
        entry("sort_kv_stable", "sortkv.cu", "sortkv.py:113",
              launches["sort_kv_stable"], sort),
        entry("gather_rows", "rowgather.cu",
              "experiments/rowgather_pallas.py:27",
              launches["gather_rows"], gather),
    ]
    log(f"main path: {json.dumps(frame)}; composite @262K Q=64: kernel "
        f"{comp['ms_262k']:.4f} ms, plain {comp['plain_ms_262k']:.4f} ms")
    log(f"all-pairs @{N_AP:,}: rect kernel {rect['ms_1m']:.3f} ms, half "
        f"kernel {half['ms_1m']:.3f} ms; main path {json.dumps(ap_path)}; "
        f"composite launches on it {ap_launches['half']['composite']} + "
        f"{ap_launches['rect']['composite']}")
    log(f"tree-P3M @{N_TREE:,}: far field {json.dumps(tree['far_ms'])}; "
        f"RMS vs exact {rms:.4e} of max|a|; solve B/cell {json.dumps(solve)};"
        f" pm_grid @{N_MAIN:,} G={PM_GRID} {json.dumps(pm_path)}; main path "
        f"{json.dumps(tree_path)}; launches {json.dumps(tree_launches)}")
    log(f"diagnostics: 4M gauge sweep {json.dumps(gauge)}; exact vs mesh "
        f"@{N_TREE_CHECK:,} {json.dumps(exact)}; main paths "
        f"{json.dumps(diag_path)}; launches {json.dumps(diag_launches)}")
    log(f"sort @E={N_MAIN:,}: {json.dumps(sort)}; row gather "
        f"{json.dumps(gather)}")
    log(f"fused: {json.dumps(fused)}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
