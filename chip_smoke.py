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
graphs) against the split loop from the same seed; then the one-process
mesh (`-meshdevices`, `-shardrender`, `-preset 1m-mesh8`, the
`meshdevices` control) on D logical shards of the card; then a process
group on the card (`parallel/bootstrap.py`, `tools/pod_worker.py`); last
the native host init (`models/init.initialize_particles_host`).

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU):
1. device check + the card's name and power limit (nvidia-smi)
2. kernel build (nvcc, seconds printed; ptxas register and spill report,
   one line per kernel; the all-pairs variants' SASS opcode tally, and
   attr's modes checked to have dropped their rsqrt or multiplies; the
   instruction mix a pair of every rsqrt loop of the three all-pairs
   sources and of csrc/treeforce.cu (`tools/sass.py`), the half-pair item
   kernel's held to 14 FP32 and 1 MUFU a pair with the j-side (11
   without), no rsqrt guard, and at most 16 issue slots a pair, its CTAs
   an SM logged; every tree sweep item kernel's to its FP32 count a pair
   (INSTR: 27, 41, 23, 23; the halved one 30 with the j-side, 27
   without), 1 MUFU, no rsqrt guard and no divergent-shuffle fallback;
   the half-pair generations' ring loops (csrc/allpairs_halfpair.cu:
   every tri_kernel mode and pair_kernel) to 15 FP32 with the j-side and
   12 without, 1 MUFU, no rsqrt guard, no divergent-shuffle fallback, at
   most the 3 j-side sums' SHFL a ring step of 4 pairs (no source
   shuffle) and no spills; every
   v3 kernel's (`v3_kernel<path>`) one rsqrt loop to its path's
   FP32 count a pair (PIPES: vpu 8, mm_split 5, mm_bf16 4), 1 MUFU, no
   rsqrt guard, no divergent-shuffle copy and no spills; the same for the
   v1 / v1b expansion's four kernels (`expand_kernel<v1b,highest>`, FP32 4,
   3, 5, 4 a pair, "highest" plus its fold's 10 FP32 per 64 pairs) and for
   hybrid's one loop (`hybrid_kernel`, FP32 28/3 a pair), each logged
   with its issue slots a pair and registers)
3. central-well kernel vs plain at 4,194,304 particles (+ num_sim freeze)
4. composite_rows kernel (the depth-Q pass alone, off the render path) vs
   plain, bitwise in both blends, on the rows the eager composite builds
   for one 1M chunk of the 4M state (Q=256) and for 262,144 particles
   (Q=64), and on synthetic rows of awkward shapes (COMPOSITE_SHAPES: Q
   and V not multiples of the kernel's blocks, Q = 1, V = 1, every row_hi
   0, row_hi None, a tile of two CTA passes); its device launches counted
   in one profiled call of each timed shape
4a. sort kernel vs plain, bitwise on every output: the render keys and
   payloads of the 4M state's first chunk after one step (E = 2^22), its
   dup 2x3 window (E = 6 x 2^20), the 262,144-particle 1280x720 chunk (E =
   2^20), keys in [0, 37) and all-equal keys at 2^20 (the identity),
   negative keys at 2^20 + 3, full-range keys at 2^22 (all four digit
   passes), k << 24 keys (the top digit only) and full-range keys at E = 1,
   2, tile - 1 and tile + 1, each with its live digits checked; the render
   chunk twice, bitwise; the sort captured in a CUDA graph and replayed on
   new keys, bitwise the eager call; times on render and full-range keys
   beside torch.sort + 4 gathers and the bytes bound; torch.profiler's
   device time of each launch of one call; the live length (`live=`, the
   exact path's form) on the exact bins of the 4M default scene's first two
   1M chunks (`bin_sprites`): in place, bitwise the full-length sort of the
   twin and of the kernel, twice, and from a CUDA graph replayed on the
   other chunk's bins twice; its device time beside the full-length call's,
   the bytes bound at the live length (40 B a live entry) and at E
4b. row gather kernel (off the render path) vs plain, bitwise: the eager
   composite's packed payload rows of that chunk, the TPU prototype's
   shape ([2,097,152, 32] x 4,194,304), clamped out-of-range indices
   (16-byte and scalar paths); times beside index_select (on indices
   clamped beforehand) in 5 rounds in turns (median and spread of each;
   the kernel's device launches counted in one profiled call) and the
   bytes bound
4c. composite_tiles (the render's composite: row and fold kernels) vs
   composite_tiles_plain, bitwise on C and T in both blends: the 1M chunk
   of phase 4 (Q=256), 262,144 at 1280x720 (Q=64), 262,144 at Q=8 (hot
   tiles of 9 or more rows), 16,384 at 1024x1024 (empty tiles); the 1M
   chunk twice, bitwise; a render chunk captured in a CUDA graph with the
   sort and replayed on new positions, bitwise the eager call; times of
   the call (CUDA events) and of each launch (torch.profiler) beside the
   plain version and the composite_rows kernel, the bound; then the golden
   corpus' adversarial scenes (coincident stacks, one depth plane, culled
   and giant sprites) through `Renderer.render_mesh` at 2 and 4 shards of
   the card, placed across a shard boundary: the sort and composite_tiles
   kernels bitwise the plain path (frame, truncated, spans)
4d. the exact binning's kernels (ops/binning.py) vs bin_sprites_plain,
   bitwise on the stats, every key and the live payloads: the 4M state's
   first and second 1M chunks (a strided view, an id offset, a device
   num_draw), a close-up from z = 700, that close-up at a capacity of
   1 x n (truncated > 0); run to run; captured in a CUDA graph and
   replayed on new positions and a new num_draw; the kernels' time beside
   the plain version's, each launch's (torch.profiler) and the byte bound
5. main path: `multi_adapter_particles_torch.app.main` under
   torch.profiler, each wrapper's device launches (`KERNELS`: the binning,
   composite_tiles and the sort at least 4 a frame, once a render chunk
   each; gather_rows and composite_rows none)
6. the final state's frame through the kernels vs through the plain twins
   of the binning, the sort and composite_tiles, bitwise; the device
   launches of that render (torch.profiler)
7. all-pairs rectangle kernel vs plain: 4,096 targets spread over the
   1,048,576-particle state against all its sources (float32 twin and a
   float64 evaluation); kernel time at the full 1M
8. all-pairs half-pair kernel vs plain at 131,072 and vs the rectangle
   kernel at 1,048,576; its RMS error against phase 7's float64 sum on
   the 4,096 sampled targets at most 2x the float32 twin's; kernel times
   at 1M; the device launches of one call at 1M and at 65,536
   (torch.profiler, at most 32), the folds' share of the call and the
   peak scratch at 1M
9. half-pair fallback at an untileable N (100,096) is bitwise the rectangle
   kernel; both kernels run twice at 1M give equal results
10. all-pairs main path: `app.main -force all_pairs` at 1,048,576, 8 frames
    of the half-pair schedule, then 6 with -rectpair; the kernels' device
    launches on a profiled run of 2 frames of each, apart from the timed
    one (the half-pair call's launches as its `half_items` schedule gives)
10b. all-pairs variants (`experiments/allpairs_*.py`'s rectangle forms):
    their path, the harness `tools/allpairs_variants.py` at its defaults
    (131,072; hybrid 98,304), with its kernels' device launches; each
    kernel vs its twin at 131,072 (hybrid 98,304), two runs bitwise (FP32
    forms on the device init scene, the HIGHEST expansion also by RMS
    against the float64 sum, the bf16 forms on a compact copy; v3 at tj =
    512 and 1024, and at 98,304 at five more (ti, tj) that reach its other
    stage sizes, untimed); each timed at 1,048,576 (hybrid 1,047,552) with
    pairs/s, its per-pipe bound and its error against v0, v3's held to no
    NaN and 1.5x the error against v0 before; v1 and v1b's four cases also
    at 98,432 (769 x 128: stages of 128, a half-filled last CTA) against
    their twins, twice bitwise, and at 1M held to 1.5x their error against
    v0 before and a NaN share no higher than before; hybrid also at tj =
    128 (98,304) and 384 (97,920, stages of 128, a half-filled last CTA)
    against its twin, twice bitwise, and at 1M held to 1.5x its error
    against v0 before and a NaN share no higher
10c. half-pair generations (`experiments/allpairs_halfpair.py`: v5 and its
    modes, v5s, v6, v7): their path, the harness
    `tools/allpairs_halfpair.py` at its default (131,072) and in its v7
    mode at 131,072, with their kernels' device launches (the two modes
    profiled apart: v5s and v7 launch the same kernel) and each full form
    vs v0; every case of the harness (v5, v5s and v6 at each of their t,
    v5's modes, v7 at the JAX harness's four (t, kb)) kernel vs its twin at
    131,072 on the device init scene, two runs bitwise; the full forms vs
    phase 8's half-pair kernel at 131,072 and at 1,048,576; the t = 512
    cases and the v7 cases timed at 1,048,576 with pairs/s, their FP32 and
    MUFU bounds, phase 8's time, the peak scratch and the fold kernels'
    device time (torch.profiler), for v7 beside the fold's byte bound and
    its share of it; v6 beside phase 8's kernel
11. tree sweeps vs their twins at 262,144 (device init, auto grid G=128,
    B=256, probed budget, dropped == 0): directed and Newton-3rd kernels
    on the same lists, <= 1e-5 of max|a_near|; kernel (on lists prepared
    once), wrapper and twin times, each kernel's issue bound at the sampled
    SM clock; the work items (count, longest) and the SASS issue slots a
    pair. Then adversarial lists at B = 32, 128 and 512: a clustered scene
    whose dense blocks list 128 or more source blocks (segments split into
    8 or more items) and the same list with every third target block's
    segment removed; every directed variant and the Newton-3rd sweep vs
    their twins (1e-5 of max|a| or max|u|), and run in chunks of 3 table
    entries bitwise the same as in one
12. sub-block expansion at 262,144: blocks of 1024 swept at 512 against
    blocks of 256, <= 1e-5 of max|a_near|
13. tree sweeps at 1,048,576 (G=192, B=512): each kernel vs its twin, the
    Newton-3rd vs the directed kernel, each run twice bitwise and in three
    chunks bitwise; kernel, wrapper, list-build and far-field (deposit, FFT
    solve, interpolation) times; each kernel's issue bound at the sampled
    SM clock, its work items and SASS issue slots a pair
14. physics at 1,048,576: the full tree-P3M accel on 4,096 targets against
    the exact all-pairs sum (rectangle kernel), RMS < 1% of max|a|
15. long-range solve memory at G=192 and G=256 (max_memory_allocated per
    grid cell, cold and warm) against the count `feasible_grid` uses
16. pm_grid main path: `app.main -force pm_grid` at 4,194,304, G=128, 5
    steps, no draw: finite state, ms/step
17. tree-P3M main path: `app.main -force p3m -p3mnear tree` at 1,048,576
    and 1024x1024, 8 frames of the Newton-3rd sweep then 6 with
    -treedirected under torch.profiler; the sweep's and composite_tiles'
    device launches, the run's config, the probe seconds
18. the sweep's potential variants vs their twins at 262,144 (G=128,
    B=256, probed budget): u within 1e-5 of max|u_near| over the live
    lanes, the fused force rows bitwise the force-only kernel's,
    potential-only bitwise the fused potential row, the halved total
    within rel 1e-5 of the directed one; times and bounds, work items and
    SASS issue slots a pair
19. the gauge sweeps at their paths' shapes: the 4M pm_grid gauge (G=256,
    blocks of 2048 expanded to 512, halved potential-only) and the 1M
    tree-P3M gauge (G=192, B=512: fused, and potential-only), each kernel
    vs its twin and run twice bitwise; the host budget probe, list build,
    kernel and twin times and bounds; the 4M halved total vs the directed
    one; `DiagnosticsProbe.maybe_publish` at 4M, first and warm, gauges
    bitwise equal on the second call
20. mesh vs exact potential gauge at 262,144 (device init, G=64): rel
    1e-3, the JAX package's pin; both gauges' times
21. diagnostics main paths: `app.main -diagnostics` on the 4M pm_grid scene
    (G=128, no draw, 5 steps, every 2), the 1M tree-P3M scene (1024x1024, 8
    steps, every 4), the 4M central well (20 frames, every 10) and the
    262,144 all-pairs scene (exact gauge, no draw, 2 steps, every 2), under
    torch.profiler; finite gauges, `diag_dropped_pairs == 0`, the variants'
    device launches; and the potential-only directed sweep's path, the
    library call `mesh_potential_only(half_pairs=False)` on the 1M scene
22. fused main path: `app.main -fused` at 4,194,304 and 1024x1024, 40
    frames through captured CUDA graphs: positions bitwise the split run of
    phase 5, the last frame within 1e-5 of it, `fused_graph` true; frame,
    render and simulate ms, replays, one replayed frame's device launches
    kernel by kernel the same as an eager frame of the engine's
    (torch.profiler), peak memory
23. the same at 262,144 and 1280x720 against a split run of that shape
24. `-fused -force p3m -p3mnear tree` at 262,144 runs uncaptured
    (`fused_graph` false) and agrees with split the same way; all_pairs
    (65,536) and pm_grid (262,144, G=64) capture and agree likewise
25. live reassignment through the control surface (`apply_key`,
    `apply_control`): at 4,194,304 / 1024², split, `c` moves compute to
    the CPU for 3 frames (CPU steps, a cross-adapter copy of the
    positions each frame, the H100 renders) and back, then the draw
    toggle, the extension (the compute stream's priority) and size and
    intensity keys; positions within rtol 1e-5 / atol 1e-3 of a bare run
    of the same steps; drain + migrate ms of each move, the CPU-compute
    frame and the copy's ms. The render role H100 -> CPU -> H100 at
    65,536 / 512² (the CPU's frame within 2e-5 of the H100's render of
    the same positions); fused at 262,144 / 1280x720 with both roles to
    the CPU and back (each move rebuilds the fused engine), held the same
    way
26. `-interactive` through the CLI at 262,144 on a scripted key stream (c,
    c, SPACE, [, ], w, q): rc 0, 6 frames, 2 reassignments
27. `-fused` at 4M: `-checkpointevery 10` over 20 frames, `-resume` for 10,
    bitwise an uninterrupted 30-frame run (write and read ms); `-preset
    4m-fused` 20 frames with and without `-debug`; `-trace` for 8 frames
    names the central-well and composite_tiles kernels; the 1M tree-P3M
    CLI twice with `-probecache` (warm probe under 10% of cold); `-serve 0
    -dashboard` in its own process answers GET /state and POST /set (the
    size changes), stops on SIGINT with rc 0 and leaves the page
28. the p3m slot near field: on a uniform 262,144 scene (G=128, the least
    capacity with no overflow) the accel vs the exact sum on 4,096 targets
    (RMS < 1% of max|a|) and vs the tree near field, the sweep's ms and
    peak memory; then `-force p3m -p3mnear slots` at 262,144 on the demo
    init: the overflow warning, `p3m_overflow` equal to the host count, and
    split vs fused (captured) bitwise
29. the one-process mesh, D logical shards of cuda:0 (an adapter list of D
    `cuda:0` entries and the CPU swapped in for `enumerate_adapters` here
    only; no mesh over distinct GPUs is measured): `-preset 1m-mesh8` cut
    to 3 steps from 20, bitwise the one-device `-rectpair` run, 8
    rectangle launches a step; the mesh and one-device step ms, the
    all-gather, the rectangle kernel at the shard shapes (131,072 x 1M,
    131,072 x 131,072) beside its bound; the ring one step within rtol
    1e-4 / atol 1e-3; the 4M central well at 1024^2 on 4 shards with
    `-shardrender` and with the gather, each frame and state bitwise the
    one-device split run, frame ms of the three; pm_grid 4M (G=128,
    dist_fft) and the p3m tree 1M (G=192) on 4 shards against one device
    (rtol 1e-5 / atol 1e-3, dropped equal, RMS under 1%); the
    `meshdevices` control 4 -> 2 -> 1 -> 4 at 262,144 all-pairs, bitwise a
    bare run, its drain + reshard ms; the whole phase within 60 s
30. a process group on the one card (`tools/pod_worker.py` spawned, gloo:
    the processes share the card, so CUDA tensors are staged through host
    memory; the backend and its reason printed): 2 processes x 4 shards run
    `-preset 1m-mesh8`'s bit-stable step for 3 steps, bitwise phase 29's
    one-process positions (and, in the worker, the one-device `-rectpair`
    run), the rectangle kernel 4 launches a step on each process's shards
    (torch.profiler in the primary); the 4M central well stepped and
    rendered at 1024^2 across the 2 processes, bitwise the one-process
    `render_mesh` (8 shards) and within 2e-3 of one device, the
    central-well, sort and composite_tiles kernels launched on each shard;
    4 processes x 1 shard run pm_grid 4M (G = 128, dist_fft) within rtol
    1e-5 / atol 1e-3 of one device; host-clock times logged (time-sliced,
    no gate); any worker failing fails the run; the whole phase within 60 s
    (no NCCL over distinct cards is measured)
31. host init at the default scene: the native tiers (g++ at first use)
    scalar and simd at 4,194,304, host ms on one thread and on every
    core; bitwise the port's oracle at 512; `initialize_particles_host`
    uploaded to cuda:0, 40 central-well kernel steps each within phase
    3's 2e-5 of the plain twin, one 1024^2 frame finite and non-empty;
    within 30 s

The kernels line (before the last) has one entry per kernel with its
device launches on its main path (torch.profiler; the all-pairs kernels
in phase 10's profiled frames; composite_rows and the row gather, off the
render path, in a profiled call of each timed shape), the error against
its twin,
kernel / twin times and the least time the card could take (`bound_ms`:
bytes over 3.35 TB/s, or FP32-pipe instructions counted from the source
over 132 SMs x 128 lanes at the SM clock sampled while the kernel ran; for
the all-pairs variants the slowest of their FP32, MUFU and tensor-core
work), and for the sort and the row gather the time of the one PyTorch call
that computes the same function (`library_ms`); the last line is {"ok":
true, "device": {...}}.
"""

from __future__ import annotations

import collections
import json
import os
import re
import subprocess
import tempfile
import time

N_MAIN = 4_194_304
STEPS = 40
GATHER_ROUNDS = 5   # phase 4b: kernel and index_select timed in turns
WIDTH = HEIGHT = 1024
N_AP = 1_048_576          # the all-pairs path (BASELINE.json's 1M)
AP_SAMPLE = 4_096         # rectangle targets held against the plain twin
N_HALF_CHECK = 131_072    # 256 tiles of 512: half-pair kernel vs plain
N_UNTILEABLE = 100_096    # padded 100,000: not a multiple of 512
N_HALF_CAPTURE = 65_536   # the fused all-pairs scene (phase 24)
HALF_LAUNCH_LIMIT = 32    # device launches a half-pair call may take
AP_STEPS_HALF = 8
AP_STEPS_RECT = 6
AP_STEPS_COUNTED = 2      # frames of phase 10's profiled runs (not timed)
# phase 10's "simulate" stage (EMA) against its kernel's time alone: the
# step adds only the Euler tail, ~0.1% at 1M
STAGE_TOL = 0.05
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
# (each source's header comment gives the tally; the all-pairs and tree
# sweep ones agree with phase 2's SASS of their loops, which holds the
# tree sweeps' to them)
INSTR = {"all_pairs_rect": 12, "all_pairs_half": 14,
         "all_pairs_half_diag": 11, "tree_sweep": 27, "tree_sweep_n3": 30,
         "tree_sweep_n3_diag": 27, "tree_sweep_with_potential": 41,
         "tree_sweep_potential_only": 23, "tree_sweep_half_pairs": 23,
         "composite": 28, "tile_combine": 7}
# the tree sweep item kernels' template flags -> INSTR name; their SASS
# issue slots a pair at B = 512, filled by phase 2
TREE_FLAGS = {"1,0,0": "tree_sweep", "1,1,0": "tree_sweep_with_potential",
              "0,1,0": "tree_sweep_potential_only",
              "0,1,1": "tree_sweep_half_pairs"}
TREE_SLOTS = {}
# Per pair and pipe, for the all-pairs variants (the tally in
# csrc/allpairs_variants.cu's header, which phase 2's SASS of their loops
# bears out): FP32 instructions, MUFU (rsqrt) instructions and padded
# tensor-core flops (BF16 mma, dense)
PIPES = {
    "attr full": (12, 1, 0), "attr norsqrt": (11, 0, 0),
    "attr noaccum": (9, 1, 0), "unroll": (12, 1, 0), "v4": (12, 1, 0),
    "v1b highest": (4, 1, 112), "v1b default": (3, 1, 32),
    "v1 highest": (5, 1, 112), "v1 default": (4, 1, 32),
    "v3 vpu": (8, 1, 32), "v3 mm_split": (5, 1, 64), "v3 mm_bf16": (4, 1, 48),
    "hybrid": (28 / 3, 1, 112 / 3),
}
# issue rates a clock per SM: FP32 lanes, MUFU lanes, BF16 dense tensor
# flops (989 TFLOP/s = 132 x 4,096 x 1,830 MHz, the data sheet's clock)
PIPE_RATE = {"fp32": FP32_LANES, "mufu": 16, "tensor": 4096}


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


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from multi_adapter_particles_torch.ops import _build
    from multi_adapter_particles_torch.ops import (
        allpairs,
        allpairs_halfpair,
        allpairs_variants,
        binning,
        central_well,
        composite,
        rowgather,
        sortkv,
        treeforce,
    )
    from multi_adapter_particles_torch.runtime import fused
    from multi_adapter_particles_torch.tools import sass

    log("phase 2: build")
    # (source, the loader that builds it, its extra nvcc flags)
    sources = (("central_well", central_well._library, ()),
               ("composite", composite._library, composite._NVCC_FLAGS),
               ("composite_tiles", composite._tiles_library,
                composite._NVCC_FLAGS),
               ("allpairs", allpairs._library, ()),
               ("treeforce", treeforce._library, ()),
               ("sortkv", sortkv._library, ()),
               ("rowgather", rowgather._library, ()),
               ("allpairs_variants", allpairs_variants._library, ()),
               ("allpairs_halfpair", allpairs_halfpair._library, ()),
               ("binning", binning._library, binning._NVCC_FLAGS),
               ("device_graph", fused._graph_library, ()))

    def ptxas_report(name, extra, tmp):
        """register / spill lines of one source (compile only, no
        library), its cubin kept in `tmp` for the SASS tallies"""
        try:
            return sass.compile_cubin(_build.CSRC_DIR / f"{name}.cu",
                                      os.path.join(tmp, f"{name}.cubin"),
                                      extra)
        except RuntimeError as e:
            fail(f"ptxas report for {name}: {e}")

    t0 = time.perf_counter()
    # one nvcc per source and per report, all started together
    with tempfile.TemporaryDirectory() as tmp, \
            ThreadPoolExecutor(2 * len(sources)) as pool:
        libs = [pool.submit(load) for _, load, _ in sources]
        reports = [(name, pool.submit(ptxas_report, name, extra, tmp))
                   for name, _, extra in sources]
        for fut in libs:
            fut.result()
        log(f"  built/loaded the {len(sources)} kernel sources in "
            f"{time.perf_counter() - t0:.2f} s ({_build.build_dir()})")
        for name, fut in reports:
            for line in fut.result():
                log(f"  ptxas {name}: {line}")
                spills = ("spill" in line and "0 bytes spill stores, 0 bytes "
                          "spill loads" not in line)
                if spills and (name == "allpairs_halfpair" or (
                        name == "allpairs_variants" and line.startswith(
                            ("v3_kernel", "expand_kernel", "hybrid_kernel")))):
                    fail(f"{name} spills: {line}")
        sass_tally(os.path.join(tmp, "allpairs_variants.cubin"))
        for name in ("allpairs", "allpairs_variants", "allpairs_halfpair",
                     "treeforce"):
            loop_tally(name, os.path.join(tmp, f"{name}.cubin"))


# SASS opcodes tallied per kernel of csrc/allpairs_variants.cu
SASS_OPS = ("FFMA", "FADD", "FMUL", "MUFU", "HMMA", "F2FP", "SHFL", "LDS")


def sass_tally(cubin):
    """Count the SASS opcodes of each kernel in `cubin` (cuobjdump), and
    fail unless attr's modes removed what they remove: no rsqrt in the
    source loop of "norsqrt" (only |a|'s sqrt is left), fewer multiplies
    in "noaccum" than in "full"."""
    from multi_adapter_particles_torch.tools import sass

    counts = {}
    for kernel, instrs in sass.disassemble(cubin).items():
        ops = collections.Counter(op.split(".")[0] for _, _, op, _ in instrs)
        counts[kernel] = {k: ops[k] for k in SASS_OPS}
    for kernel, c in counts.items():
        log(f"  SASS {kernel}: " + ", ".join(f"{k} {v}" for k, v in
                                              c.items()))
    full, norsqrt, noaccum = (counts.get(f"elem_kernel<{m}>")
                              for m in range(3))
    if None in (full, norsqrt, noaccum):
        fail(f"attr kernels missing from the SASS: {sorted(counts)}")
    if not norsqrt["MUFU"] < full["MUFU"] / 4:
        fail(f"attr norsqrt keeps {norsqrt['MUFU']} MUFU (full "
             f"{full['MUFU']})")
    if not noaccum["FMUL"] + noaccum["FFMA"] < full["FMUL"] + full["FFMA"]:
        fail("attr noaccum keeps full's multiplies")


def loop_tally(name, cubin):
    """Log the instruction mix a pair of every rsqrt loop in `cubin`
    (`tools/sass.py`); for csrc/allpairs.cu, fail unless the half-pair
    item kernel's j-side loop takes 14 FP32 and 1 MUFU a pair in at most
    16 issue slots, its i-side loop 11 FP32, neither with the rsqrt
    guard, and log its CTAs an SM."""
    import torch

    from multi_adapter_particles_torch.ops.allpairs import _half_wave
    from multi_adapter_particles_torch.tools import sass

    loops = {k: [sass.loop_mix(b) for b in sass.rsqrt_loops(v)]
             for k, v in sass.disassemble(cubin).items()}
    for kernel, mixes in loops.items():
        for mix in mixes:
            log(f"  SASS loop {name} {kernel}: {sass.format_mix(mix)}")
    if name == "treeforce":
        tree_loop_check(loops)
    if name == "allpairs_halfpair":
        gen_loop_check(loops)
    if name == "allpairs_variants":
        v3_loop_check(loops)
        expand_loop_check(loops)
        hybrid_loop_check(loops)
    if name != "allpairs":
        return
    mixes = [m for m in loops.get("half_item_kernel", [])
             if not m["collective"]]
    both = [m for m in mixes if m["SHFL"] > 0]
    iside = [m for m in mixes if m["SHFL"] == 0]
    if len(both) != 1 or len(iside) != 1:
        fail(f"half_item_kernel: {len(both)} j-side and {len(iside)} i-side "
             "rsqrt loops, expected one each")
    for label, mix, fp32 in (("j-side", both[0], INSTR["all_pairs_half"]),
                             ("i-side", iside[0],
                              INSTR["all_pairs_half_diag"])):
        if mix["fp32"] != fp32 or mix["MUFU"] != 1 or mix["FSETP"]:
            fail(f"half_item_kernel {label} loop: FP32 {mix['fp32']}, MUFU "
                 f"{mix['MUFU']}, FSETP {mix['FSETP']} a pair (want {fp32}, "
                 "1, 0)")
    if both[0]["slots"] > 16:
        fail(f"half_item_kernel j-side loop: {both[0]['slots']:.3f} issue "
             "slots a pair > 16")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    wave = _half_wave(0)
    log(f"  half_item_kernel: {wave // sms} CTAs an SM ({wave} a wave on "
        f"{sms} SMs)")


# the generations' ring loops expected in each kernel of
# csrc/allpairs_halfpair.cu: "both" sides (the j-side sums shuffle) and the
# i-side alone
GEN_LOOPS = {"tri_kernel<0,0>": ["both", "iside"],
             "tri_kernel<0,1>": ["both", "iside"],
             "tri_kernel<1,0>": ["both"], "tri_kernel<2,0>": ["iside"],
             "pair_kernel": ["both", "iside"]}


def gen_loop_check(loops):
    """Fail unless each generation kernel's ring loops (GEN_LOOPS) take
    their FP32 count a pair (GEN_INSTR), 1 MUFU, no rsqrt guard (no FSETP,
    no predicated FP32), no source shuffle (at most the 3 j-side sums a
    ring step of R pairs; none on the i-side alone) and no
    divergent-shuffle copy; logs their issue slots a pair."""
    from multi_adapter_particles_torch.ops import allpairs_halfpair

    shfl = 3 / (allpairs_halfpair.TILE // 32)   # a ring step: R pairs
    slots = {}
    for kernel, want in GEN_LOOPS.items():
        mixes = loops.get(kernel, [])
        sides = sorted("both" if m["SHFL"] else "iside" for m in mixes)
        if sides != sorted(want):
            fail(f"{kernel}: rsqrt loops {sides}, want {want}")
        for mix in mixes:
            side = "both" if mix["SHFL"] else "iside"
            if (mix["fp32"] != GEN_INSTR[side] or mix["MUFU"] != 1
                    or mix["FSETP"] or mix["guarded"] or mix["collective"]
                    or mix["SHFL"] > (shfl if side == "both" else 0)):
                fail(f"{kernel} {side} loop: FP32 {mix['fp32']}, MUFU "
                     f"{mix['MUFU']}, FSETP {mix['FSETP']}, SHFL "
                     f"{mix['SHFL']:.3f}, fallback {mix['collective']} a "
                     f"pair (want {GEN_INSTR[side]}, 1, 0, <= "
                     f"{shfl if side == 'both' else 0}, no)")
            slots[f"{kernel} {side}"] = mix["slots"]
    log("  generation ring loops at their FP32 counts, no guard, no source "
        f"shuffle, no fallback; issue slots a pair {json.dumps(slots)}")


# v3's kernels: v3_kernel<force path>; each has one rsqrt loop (four
# pipelined chunks a body) at its path's FP32 count a pair (PIPES)
V3_KERNELS = {f"v3_kernel<{p}>": f"v3 {fp}"
              for p, fp in enumerate(("vpu", "mm_split", "mm_bf16"))}
V3_SLOTS = {}   # SASS issue slots a pair, filled by phase 2


def v3_loop_check(loops):
    """Fail unless each v3 kernel (V3_KERNELS) has one rsqrt loop at its
    FP32 count a pair (PIPES: 8, 5, 4), 1 MUFU, no rsqrt guard (no FSETP,
    no predicated FP32) and no divergent-shuffle copy; logs and keeps
    (V3_SLOTS) its issue slots a pair. Its spills are phase 2's ptxas
    check."""
    for kernel, label in V3_KERNELS.items():
        mixes = loops.get(kernel, [])
        if len(mixes) != 1:
            fail(f"{kernel}: {len(mixes)} rsqrt loops, want 1")
        mix = mixes[0]
        fp32 = PIPES[label][0]
        if (mix["fp32"] != fp32 or mix["MUFU"] != 1 or mix["FSETP"]
                or mix["guarded"] or mix["collective"]):
            fail(f"{kernel} loop: FP32 {mix['fp32']}, MUFU {mix['MUFU']}, "
                 f"FSETP {mix['FSETP']}, guarded {mix['guarded']}, fallback "
                 f"{mix['collective']} a pair (want {fp32}, 1, 0, no, no)")
        V3_SLOTS[kernel] = mix["slots"]
    log("  v3 loops at their FP32 counts, 1 MUFU, no guard, no fallback; "
        f"issue slots a pair {json.dumps(V3_SLOTS)}")


# v1 / v1b's kernels: expand_kernel<v1b, highest>; each has one rsqrt loop
# (eight chunks a body) at its case's FP32 count a pair (PIPES); "highest"
# folds its sums into the Kahan totals inside that loop, every 8 chunks: a
# row tile's 10 FP32 (for each of a lane's two columns the pair's add and a
# Kahan add of 4) per 64 of its pairs a lane
EXPAND_FOLD_FP32 = 10 / 64
EXPAND_KERNELS = {"expand_kernel<1,1>": "v1b highest",
                  "expand_kernel<1,0>": "v1b default",
                  "expand_kernel<0,1>": "v1 highest",
                  "expand_kernel<0,0>": "v1 default"}
EXPAND_SLOTS = {}   # SASS issue slots a pair, filled by phase 2


def expand_loop_check(loops):
    """Fail unless each expansion kernel (EXPAND_KERNELS) has one rsqrt
    loop at its FP32 count a pair (PIPES: 4, 3, 5, 4; "highest" plus
    EXPAND_FOLD_FP32), 1 MUFU, no rsqrt guard (no FSETP, no predicated
    FP32) and no divergent-shuffle copy; logs and keeps (EXPAND_SLOTS) its
    issue slots a pair. Its spills are phase 2's ptxas check."""
    for kernel, label in EXPAND_KERNELS.items():
        mixes = loops.get(kernel, [])
        if len(mixes) != 1:
            fail(f"{kernel}: {len(mixes)} rsqrt loops, want 1")
        mix = mixes[0]
        fp32 = PIPES[label][0] + (EXPAND_FOLD_FP32 if "highest" in label
                                  else 0)
        if (mix["fp32"] != fp32 or mix["MUFU"] != 1 or mix["FSETP"]
                or mix["guarded"] or mix["collective"]):
            fail(f"{kernel} loop: FP32 {mix['fp32']}, MUFU {mix['MUFU']}, "
                 f"FSETP {mix['FSETP']}, guarded {mix['guarded']}, fallback "
                 f"{mix['collective']} a pair (want {fp32}, 1, 0, no, no)")
        EXPAND_SLOTS[kernel] = mix["slots"]
    log("  expansion loops at their FP32 counts, 1 MUFU, no guard, no "
        f"fallback; issue slots a pair {json.dumps(EXPAND_SLOTS)}")


# hybrid's kernel: one rsqrt loop, each body a v1b "highest" chunk (16
# pairs a lane) and 32 elementwise pairs, at PIPES' FP32 count a pair (its
# folds lie outside the loop, every eight bodies)
HYBRID_SLOTS = {}   # SASS issue slots a pair, filled by phase 2


def hybrid_loop_check(loops):
    """Fail unless hybrid_kernel has one rsqrt loop at PIPES["hybrid"]'s
    FP32 count a pair (28/3: 12 elementwise, 4 expansion), 1 MUFU, no
    rsqrt guard (no FSETP, no predicated FP32) and no divergent-shuffle
    copy; logs and keeps (HYBRID_SLOTS) its issue slots a pair. Its spills
    are phase 2's ptxas check."""
    mixes = loops.get("hybrid_kernel", [])
    if len(mixes) != 1:
        fail(f"hybrid_kernel: {len(mixes)} rsqrt loops, want 1")
    mix = mixes[0]
    fp32 = PIPES["hybrid"][0]
    if (abs(mix["fp32"] - fp32) > 1e-9 or mix["MUFU"] != 1 or mix["FSETP"]
            or mix["guarded"] or mix["collective"]):
        fail(f"hybrid_kernel loop: FP32 {mix['fp32']:.4f}, MUFU "
             f"{mix['MUFU']}, FSETP {mix['FSETP']}, guarded "
             f"{mix['guarded']}, fallback {mix['collective']} a pair (want "
             f"{fp32:.4f}, 1, 0, no, no)")
    HYBRID_SLOTS["hybrid_kernel"] = mix["slots"]
    log("  hybrid loop at its FP32 count, 1 MUFU, no guard, no fallback; "
        f"issue slots a pair {mix['slots']:.3f} ({mix['pairs']} pairs a "
        "body)")


def tree_loop_check(loops):
    """Fail unless every tree sweep item kernel's rsqrt loops take their
    FP32 count a pair (INSTR), 1 MUFU, no rsqrt guard and no
    divergent-shuffle fallback; the halved kernel one loop with the j-side
    (SHFL) and one without. Keeps the issue slots a pair of the instances
    B = 512 runs (the loop of most pairs a body) in TREE_SLOTS."""
    for kernel, mixes in loops.items():
        if kernel.startswith("sweep_item_kernel<"):
            flags, r = kernel[len("sweep_item_kernel<"):-1].rsplit(",", 1)
            names = [TREE_FLAGS[flags]] * len(mixes)
            main = r == "2"
        elif kernel.startswith("sweep_n3_item_kernel<"):
            names = ["tree_sweep_n3" if m["SHFL"] else "tree_sweep_n3_diag"
                     for m in mixes]
            if sorted(names) != ["tree_sweep_n3", "tree_sweep_n3_diag"]:
                fail(f"{kernel}: rsqrt loops {names}, want one with the "
                     "j-side and one without")
            main = kernel == "sweep_n3_item_kernel<8,4>"
        else:
            continue
        for name, mix in zip(names, mixes):
            if (mix["fp32"] != INSTR[name] or mix["MUFU"] != 1
                    or mix["guarded"] or mix["collective"]):
                fail(f"{kernel} loop: FP32 {mix['fp32']}, MUFU "
                     f"{mix['MUFU']}, guarded {mix['guarded']}, fallback "
                     f"{mix['collective']} (want {INSTR[name]}, 1, no, no)")
            if main and mix["pairs"] >= TREE_SLOTS.get(name, (0, 0))[0]:
                TREE_SLOTS[name] = (mix["pairs"], mix["slots"])
    if len(TREE_SLOTS) != 6:
        fail(f"tree sweep item kernels in the SASS: {sorted(TREE_SLOTS)}")
    for name, (_, slots) in TREE_SLOTS.items():
        TREE_SLOTS[name] = slots
    log(f"  tree sweep loops at their FP32 counts (INSTR), no guard, no "
        f"fallback; issue slots a pair {json.dumps(TREE_SLOTS)}")


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


def _tiles_inputs(pos, width, height, seg_q=None, blend="over"):
    """(args, kw) of the `composite_tiles` call the renderer makes for the
    particles `pos` [4, n] at width x height (seg_q None: the renderer's
    adaptive Q), recorded from `_render` with the plain composite."""
    from multi_adapter_particles_torch.config import RenderConfig
    from multi_adapter_particles_torch.ops.composite import (
        composite_tiles_plain,
    )
    from multi_adapter_particles_torch.render import renderer as R
    from multi_adapter_particles_torch.render.camera import Camera

    n = pos.shape[1]
    rend = R.Renderer(RenderConfig(width=width, height=height))
    seen = {}

    def record(*args, **kw):
        seen["call"] = (args, kw)
        return composite_tiles_plain(*args, **kw)

    args = rend._device_args(Camera(), 2.5, 0.15, pos.device)
    R._render(pos, *args, n, width=width, height=height,
              seg_q=seg_q or rend.resolve_seg_q(n), dup_y=2, dup_x=2,
              near=1.0, blend=blend, return_trans=True, composite=record)
    return seen["call"]


def _rows_inputs(args, kw):
    """`composite_rows`' (sp, bases, row_hi) for a `composite_tiles` call:
    the [8, Q, V] planes the eager path builds."""
    from multi_adapter_particles_torch.ops.composite import (
        composite_rows_inputs,
    )

    (s_cx, s_cy, s_w, s_cgb, _, tile_v, j_v, lo_k, hi_k, _, _, inv_sx,
     inv_sy, intensity) = args
    sp, bases = composite_rows_inputs(
        s_cx, s_cy, s_w, s_cgb, tile_v, j_v, lo_k, hi_k, inv_sx, inv_sy,
        intensity, q=kw["q"], grid=kw["grid"], tile=kw["tile"])
    return sp, bases, hi_k


# composite_rows' awkward shapes (Q, V, tile_h, tile_w, row_hi), each
# bitwise against the twin in both blends: Q not a multiple of the kernel's
# q-block (32) and V not a multiple of its row block (8), Q = 1, V = 1,
# every row_hi 0, row_hi None, and a 150-pixel tile (two CTA passes)
COMPOSITE_SHAPES = ((40, 1_001, 8, 16, "random"), (1, 37, 8, 16, "random"),
                    (33, 16, 8, 16, "zero"), (70, 9, 8, 16, "none"),
                    (5, 1, 8, 16, "random"), (33, 11, 3, 50, "random"))


def _composite_case(dev, q, v, tile_h, tile_w, hi_mode, seed):
    """(sp, bases, row_hi) of a synthetic composite_rows input: sprites
    over the tile, random row_hi in [-2, Q + 2] (or all 0, or None), dead
    slots with alpha scale 0 (the layout's rule): those at or past row_hi
    and, as the renderer's rows have them, a random prefix of each row."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    sp = np.empty((8, q, v), np.float32)
    sp[0] = rng.uniform(-2.0, tile_w + 2.0, (q, v))
    sp[1] = rng.uniform(-2.0, tile_h + 2.0, (q, v))
    sp[2:4] = rng.uniform(0.05, 0.6, (2, q, v))
    sp[4:7] = rng.uniform(0.0, 1.5, (3, q, v))
    sp[7] = rng.uniform(0.1, 1.0, (q, v))
    bases = rng.integers(0, 64, (2, v)).astype(np.float32)
    hi = {"random": rng.integers(-2, q + 3, v), "zero": np.zeros(v),
          "none": None}[hi_mode]
    if hi is not None:
        hi = hi.astype(np.int32)
        slot = np.arange(q)[:, None]
        live = ((slot < np.clip(hi, 0, q)[None, :])
                & (slot >= rng.integers(0, q + 1, v)[None, :]))
        sp[7] = np.where(live, sp[7], 0.0)
        hi = torch.from_numpy(hi).to(dev)
    return torch.from_numpy(sp).to(dev), torch.from_numpy(bases).to(dev), hi


def _composite_bitwise(label, got, want):
    import torch

    if got.shape != want.shape or not torch.equal(got, want):
        bad = int((got != want).sum()) if got.shape == want.shape else "shape"
        fail(f"composite_rows {label}: differs from the plain version ({bad} "
             "elements)")
    log(f"  {label}: bitwise the plain version")


def phase_composite(dev):
    import torch

    from multi_adapter_particles_torch.ops.composite import (
        composite_rows,
        composite_rows_plain,
    )
    from multi_adapter_particles_torch.render.renderer import TILE_H, TILE_W

    log("phase 4: composite_rows kernel (off the render path) vs plain")
    err = 0.0
    times = {}
    calls = {}
    launches = 0
    for label, n, chunk in (("1M chunk of 4M", N_MAIN, 1_048_576),
                            ("262K", 262_144, 262_144)):
        pos = _ap_state(dev, n)[:, :chunk].contiguous()
        calls[label] = _tiles_inputs(pos, WIDTH, HEIGHT)
        del pos
        q = calls[label][1]["q"]
        sp, bases, hi = _rows_inputs(*calls[label])
        live = int((hi > 0).sum())
        log(f"  {label}: sp {list(sp.shape)} (Q={q}), {live:,} live rows")
        for blend in ("over", "additive"):
            k = composite_rows(sp, bases, TILE_H, TILE_W, blend, hi)
            p = composite_rows_plain(sp, bases, TILE_H, TILE_W, blend, hi)
            torch.cuda.synchronize()
            _composite_bitwise(f"{label} {blend}", k, p)
        def kernel():
            return composite_rows(sp, bases, TILE_H, TILE_W, "over", hi)

        ms = time_ms(kernel, reps=20)
        # off the render path, its path is these calls: one profiled
        launches += counted(kernel, ["composite_rows"])[1]["composite_rows"]
        plain_ms = time_ms(lambda: composite_rows_plain(
            sp, bases, TILE_H, TILE_W, "over", hi), reps=3, warmup=1)
        # the work these rows need: each live slot of each row blends into
        # TILE_H * TILE_W pixels; every byte once. A row's live slots run
        # from its first slot of nonzero alpha scale to row_hi (the dead
        # slots before it blend as the identity; the kernel skips them);
        # row_hi's own count, every slot below it, is logged beside
        top = hi.clamp(0, q)
        live = ((sp[7] != 0) & (torch.arange(q, device=dev)[:, None]
                                < top[None, :]))
        first = torch.where(live.any(0), live.int().argmax(0), top)
        slots = float((top - first).sum())
        px = TILE_H * TILE_W
        mhz = busy_clock_mhz(kernel, reps=max(20, int(300 / ms)))
        ops = issue_bound_ms(slots * px * INSTR["composite"], mhz)
        ops_hi = issue_bound_ms(float(top.sum()) * px * INSTR["composite"],
                                mhz)
        nbytes = (sp.numel() + bases.numel() + hi.numel()
                  + 4 * px * sp.shape[2]) * 4
        bound = max(ops, bytes_bound_ms(nbytes))
        by = "operations" if ops >= bytes_bound_ms(nbytes) else "bytes"
        log(f"  {label} over: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; "
            f"{slots:.4e} live slots x {px} px; bound {bound:.4f} ms "
            f"({by}, {mhz:.0f} MHz) -> {bound / ms:.1%} of it; row_hi's "
            f"count {float(top.sum()):.4e} slots, {ops_hi:.4f} ms -> "
            f"{ops_hi / ms:.1%}")
        times[label] = (ms, plain_ms, bound, by)
        del sp, bases, hi
    for seed, (q, v, th, tw, hi_mode) in enumerate(COMPOSITE_SHAPES):
        sp, bases, hi = _composite_case(dev, q, v, th, tw, hi_mode, seed)
        for blend in ("over", "additive"):
            _composite_bitwise(
                f"Q={q}, V={v:,}, tile {th}x{tw}, row_hi {hi_mode}, {blend}",
                composite_rows(sp, bases, th, tw, blend, hi),
                composite_rows_plain(sp, bases, th, tw, blend, hi))
    ms, plain_ms, bound, by = times["1M chunk of 4M"]
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "launches": launches,
            "ms_262k": times["262K"][0],
            "plain_ms_262k": times["262K"][1]}, calls["1M chunk of 4M"]


def _equal_outputs(label, got, want):
    """Fail unless the (C, T) pairs are bitwise equal."""
    import torch

    for name, a, b in zip(("C", "T"), got, want):
        if a.shape != b.shape or not torch.equal(a, b):
            bad = int((a != b).sum()) if a.shape == b.shape else "shape"
            fail(f"composite_tiles {label}: {name} differs from the plain "
                 f"version ({bad} elements)")


def _tiles_work(args, kw):
    """(live slot-pixels, combine-pixels, bytes) one call needs: each live
    slot blends into every pixel of its row's tile, a tile of s rows
    combines s - 1 times; 16 B a sorted entry, the map, the live rows'
    results written and read, the frame planes."""
    (s_cx, _, _, _, starts, tile_v, _, lo_k, hi_k, row_start, row_end,
     *_) = args
    px = kw["tile"][0] * kw["tile"][1]
    live = int(row_end[-1])
    slots = float((hi_k[:live] - lo_k[:live]).clamp(min=0).sum())
    combines = float((row_end - row_start - 1).sum())
    nbytes = (16 * s_cx.shape[0] + 4 * starts.numel() + 16 * tile_v.numel()
              + 8 * row_start.numel() + 2 * 16 * live * px
              + 16 * row_start.numel() * px)
    return slots * px, combines * px, nbytes


def _time_tiles(label, args, kw):
    """CUDA-event times of the call, its plain version and the old
    composite_rows kernel on the same rows; torch.profiler's time of each
    launch; the bound and its share."""
    from multi_adapter_particles_torch.ops.composite import (
        composite_rows,
        composite_tiles,
        composite_tiles_plain,
    )

    def kernel():
        return composite_tiles(*args, **kw)

    ms = time_ms(kernel, reps=20)
    plain_ms = time_ms(lambda: composite_tiles_plain(*args, **kw), reps=3,
                       warmup=1)
    sp, bases, hi = _rows_inputs(args, kw)
    th, tw = kw["tile"]
    rows_ms = time_ms(lambda: composite_rows(sp, bases, th, tw, "over", hi),
                      reps=20)
    del sp, bases, hi
    _, launches = launch_profile(kernel)
    slot_px, comb_px, nbytes = _tiles_work(args, kw)
    mhz = busy_clock_mhz(kernel, reps=max(20, int(300 / ms)))
    ops = issue_bound_ms(slot_px * INSTR["composite"]
                         + comb_px * INSTR["tile_combine"], mhz)
    byt = bytes_bound_ms(nbytes)
    bound, by = (ops, "operations") if ops >= byt else (byt, "bytes")
    log(f"  {label}: composite_tiles {ms:.4f} ms (device ms a launch: "
        + ", ".join(f"{n} {t:.4f}" for n, t in launches)
        + f"), plain version {plain_ms:.4f} ms, composite_rows kernel on its "
        f"rows {rows_ms:.4f} ms; {slot_px:.4e} slot-pixels, {comb_px:.4e} "
        f"combine-pixels, {nbytes / 1e6:.1f} MB; bound {bound:.4f} ms ({by}, "
        f"{mhz:.0f} MHz; bytes {byt:.4f}) -> {bound / ms:.1%} of it")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "composite_rows_ms": rows_ms,
            "profile": launches}


def phase_tiles(dev, main_call):
    """composite_tiles' kernels vs composite_tiles_plain, bitwise, on the
    1M render chunk of phase 4 and three more scenes; run to run; from a
    CUDA graph; timed."""
    import torch

    from multi_adapter_particles_torch.config import RenderConfig
    from multi_adapter_particles_torch.ops.composite import (
        composite_tiles,
        composite_tiles_plain,
    )
    from multi_adapter_particles_torch.render import renderer as R
    from multi_adapter_particles_torch.render.camera import Camera

    log("phase 4c: composite_tiles kernels vs composite_tiles_plain "
        "(bitwise on C and T)")
    small = _ap_state(dev, 262_144)
    cases = (
        ("1M chunk of 4M", main_call, None),
        ("262,144 at 1280x720", None, (small, 1280, 720)),
        ("clustered: 262,144 at 1024x1024, Q=8", None,
         (small, WIDTH, HEIGHT, 8)),
        ("empty tiles: 16,384 at 1024x1024", None,
         (small[:, :16_384].contiguous(), WIDTH, HEIGHT)),
    )
    stats = {}
    for label, call, make in cases:
        args, kw = call if call is not None else _tiles_inputs(*make)
        starts, row_start, row_end = args[4], args[9], args[10]
        counts = starts[1:] - starts[:-1]
        segs = int((row_end - row_start).max())
        empty = int((counts == 0).sum())
        if label.startswith("clustered") and segs < 9:
            fail(f"composite_tiles {label}: hot tiles span {segs} rows (< 9)")
        if label.startswith("empty") and empty == 0:
            fail(f"composite_tiles {label}: no empty tile")
        for blend in ("over", "additive"):
            kb = {**kw, "blend": blend}
            got = composite_tiles(*args, **kb)
            want = composite_tiles_plain(*args, **kb)
            torch.cuda.synchronize()
            _equal_outputs(f"{label} {blend}", got, want)
        log(f"  {label}: E = {args[0].shape[0]:,}, Q = {kw['q']}, "
            f"{int(row_end[-1]):,} live rows of {args[5].shape[0]:,}, up to "
            f"{segs} rows a tile, {empty:,} empty tiles of "
            f"{counts.shape[0]:,}: over and additive bitwise the plain "
            "version")
        if label.startswith("1M"):
            first = composite_tiles(*args, **kw)
            again = composite_tiles(*args, **kw)
            torch.cuda.synchronize()
            _equal_outputs("run to run", first, again)
            log("  1M chunk composited twice: bitwise run to run")
            del first, again
        if label.startswith(("1M", "262,144 at")):
            stats[label] = _time_tiles(label, args, kw)
        del args, kw
    del small

    # the render chunk (sort + composite_tiles) captured in a CUDA graph,
    # replayed on the next chunk's positions
    chunk = 1_048_576
    state = _ap_state(dev, 2 * chunk)
    rend = R.Renderer(RenderConfig(width=WIDTH, height=HEIGHT))
    dargs = rend._device_args(Camera(), 2.5, 0.15, dev)
    kw = dict(width=WIDTH, height=HEIGHT, seg_q=rend.resolve_seg_q(chunk),
              dup_y=2, dup_x=2, near=1.0, blend="over", return_trans=True)
    static = state[:, :chunk].clone()
    R._render(static, *dargs, chunk, **kw)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = R._render(static, *dargs, chunk, **kw)
    static.copy_(state[:, chunk:])
    graph.replay()
    eager = R._render(static, *dargs, chunk, **kw)
    torch.cuda.synchronize()
    _equal_outputs("graph replay", (captured.frame, captured.trans),
                   (eager.frame, eager.trans))
    log("  a render chunk (sort + composite_tiles) captured in a CUDA graph "
        "and replayed on the next chunk's positions: bitwise the eager call")
    out = stats["1M chunk of 4M"]
    out["720p"] = stats["262,144 at 1280x720"]
    return out


def _same_bins(label, got, want, row):
    """Fail unless two `bin_sprites` results are bitwise equal: the stats,
    every key, and the payloads of the live entries and of the tail slots
    up to the next multiple of `row` (the kernels leave later ones
    unwritten). Returns the stats as ints."""
    import torch

    if not torch.equal(got[-1], want[-1]):
        fail(f"bin_sprites {label}: stats {got[-1].tolist()}, the plain "
             f"version's {want[-1].tolist()}")
    entries, truncated, span_y, span_x = (int(v) for v in want[-1])
    cap = got[0].shape[0]
    upto = min(cap, -(-entries // row) * row)
    if not torch.equal(got[0], want[0]):
        fail(f"bin_sprites {label}: {int((got[0] != want[0]).sum())} keys "
             "differ from the plain version")
    for name, a, b in zip(("cx", "cy", "w", "cgb"), got[1:5], want[1:5]):
        a, b = a[:upto].view(torch.int32), b[:upto].view(torch.int32)
        if not torch.equal(a, b):
            fail(f"bin_sprites {label}: {int((a != b).sum())} {name} "
                 "payloads differ from the plain version")
    log(f"  {label}: {entries:,} entries of {cap:,}, truncated "
        f"{truncated:,}, spans {span_y} x {span_x}: bitwise the plain "
        "version")
    return entries, truncated


def phase_binning(dev):
    """The exact binning's kernels vs bin_sprites_plain, bitwise: the 4M
    central-well state's first and second 1M render chunks (a strided
    view, an id offset, a device num_draw), a close-up of large sprites,
    an overflow past the capacity; run to run; captured in a CUDA graph
    and replayed on new positions; timed against the byte bound."""
    import torch

    from multi_adapter_particles_torch import constants as C
    from multi_adapter_particles_torch.config import RenderConfig
    from multi_adapter_particles_torch.models import init as pinit
    from multi_adapter_particles_torch.ops.binning import (
        bin_sprites,
        bin_sprites_plain,
    )
    from multi_adapter_particles_torch.ops.central_well import central_well_step
    from multi_adapter_particles_torch.render import renderer as R
    from multi_adapter_particles_torch.render.camera import Camera

    log("phase 4d: exact binning kernels vs bin_sprites_plain (bitwise)")
    st = pinit.initialize_particles_device(
        N_MAIN, torch.Generator(device=dev).manual_seed(0), device=dev)
    pos, _ = central_well_step(st.position, st.velocity, dt=C.TIMESTEP,
                               damping=C.DAMPING, mass=C.PARTICLE_MASS,
                               softening_squared=C.SOFTENING_SQUARED)
    del st
    chunk = 1_048_576
    rend = R.Renderer(RenderConfig(width=WIDTH, height=HEIGHT))
    q = rend.resolve_seg_q(chunk)
    near = rend._device_args(Camera(position=(0.0, 0.0, 700.0)), 2.5, 0.15,
                             dev)

    def run(fn, p, nd, off, cap, args=None):
        args = args or rend._device_args(Camera(), 2.5, 0.15, dev)
        return fn(p, *args[:4], nd, off, width=WIDTH, height=HEIGHT,
                  near=1.0, capacity=cap, row=q)

    draw = torch.tensor(700_000, dtype=torch.int32, device=dev)
    cases = (("1M chunk 0 of 4M", pos[:, :chunk], chunk, 0, 4 * chunk, None),
             ("1M chunk 1 of 4M, device num_draw 700,000",
              pos[:, chunk:2 * chunk], draw, chunk, 4 * chunk, None),
             ("close-up from z = 700", pos[:, :chunk], chunk, 0, 4 * chunk,
              near),
             ("close-up, capacity 1 x n", pos[:, :chunk], chunk, 0, chunk,
              near))
    stats = {}
    for label, p, nd, off, cap, args in cases:
        got = run(bin_sprites, p, nd, off, cap, args)
        want = run(bin_sprites_plain, p, nd, off, cap, args)
        torch.cuda.synchronize()
        stats[label] = _same_bins(label, got, want, q)
        del got, want
    if stats["close-up, capacity 1 x n"][1] == 0:
        fail("bin_sprites: the 1 x n capacity case truncated nothing")
    first = run(bin_sprites, pos[:, :chunk], chunk, 0, 4 * chunk)
    again = run(bin_sprites, pos[:, :chunk], chunk, 0, 4 * chunk)
    torch.cuda.synchronize()
    _same_bins("run to run", first, again, q)
    del first, again

    static = pos[:, :chunk].clone()
    run(bin_sprites, static, draw, 0, 4 * chunk)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run(bin_sprites, static, draw, 0, 4 * chunk)
    static.copy_(pos[:, 2 * chunk:3 * chunk])
    draw.fill_(1_000_000)
    graph.replay()
    eager = run(bin_sprites_plain, static, draw, 0, 4 * chunk)
    torch.cuda.synchronize()
    _same_bins("captured, replayed on chunk 2 with num_draw 1,000,000",
               captured, eager, q)

    p = pos[:, :chunk]
    # back to back the calls are bound by the wrapper's host work (five
    # 4M-slot outputs and a ctypes call), so the kernels' time is the
    # profiler's device time of one call's launches
    call_ms = time_ms(lambda: run(bin_sprites, p, chunk, 0, 4 * chunk),
                      reps=50)
    plain_ms = time_ms(lambda: run(bin_sprites_plain, p, chunk, 0,
                                   4 * chunk), reps=3, warmup=1)
    bound = bytes_bound_ms(36 * chunk)
    _, launches = launch_profile(lambda: run(bin_sprites, p, chunk, 0,
                                             4 * chunk))
    ms = sum(t for _, t in launches)
    log(f"  1M chunk: kernels {ms:.4f} ms device ("
        + ", ".join(f"{k} {t:.4f}" for k, t in launches)
        + f"), {call_ms:.4f} ms a call back to back; plain {plain_ms:.4f} "
        f"ms; bound {bound:.4f} ms (bytes, 36 B a particle) — "
        f"{100 * bound / ms:.1f}%")
    return {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "bytes",
            "launches": [k for k, _ in launches]}


def _render_io(dev, dup_y=2, dup_x=2, n=N_MAIN, width=WIDTH, height=HEIGHT):
    """The sort's (key, *payloads) as the renderer makes them for the
    first 1M chunk (or all) of the n-particle device-init state (seed 0)
    after one central-well step, at width x height and the given dup
    window, and the row gather's (packed, idx) the eager composite builds
    from the sorted streams (`packed_rows`, gathered at each virtual row's
    data row)."""
    import torch

    from multi_adapter_particles_torch import constants as C
    from multi_adapter_particles_torch.config import RenderConfig
    from multi_adapter_particles_torch.models import init as pinit
    from multi_adapter_particles_torch.ops.central_well import central_well_step
    from multi_adapter_particles_torch.ops.composite import (
        composite_tiles_plain,
        packed_rows,
    )
    from multi_adapter_particles_torch.ops.sortkv import sort_kv_stable_plain
    from multi_adapter_particles_torch.render import renderer as R
    from multi_adapter_particles_torch.render.camera import Camera

    st = pinit.initialize_particles_device(
        n, torch.Generator(device=dev).manual_seed(0), device=dev)
    pos, _ = central_well_step(st.position, st.velocity, dt=C.TIMESTEP,
                               damping=C.DAMPING, mass=C.PARTICLE_MASS,
                               softening_squared=C.SOFTENING_SQUARED)
    del st
    chunk = min(n, 1_048_576)
    rend = R.Renderer(RenderConfig(width=width, height=height))
    rend.dup_y, rend.dup_x = dup_y, dup_x
    seen = {}

    def sort(*args):
        seen["sort"] = args
        return sort_kv_stable_plain(*args)

    def composite(*args, **kw):
        seen["gather"] = (packed_rows(*args[:4], kw["q"]), args[6])
        return composite_tiles_plain(*args, **kw)

    args = rend._device_args(Camera(), 2.5, 0.15, dev)
    R._render(pos[:, :chunk], *args, chunk, width=width, height=height,
              seg_q=rend.resolve_seg_q(chunk), dup_y=dup_y, dup_x=dup_x,
              near=1.0, blend="over", return_trans=True, sort=sort,
              composite=composite)
    return seen["sort"], seen["gather"]


def launch_profile(fn):
    """(fn(), [(kernel or memset, device ms)] in launch order) of one call
    under torch.profiler."""
    from multi_adapter_particles_torch.tools.allpairs_halfpair import (
        profile_call,
    )

    return profile_call(fn)


# Each kernel wrapper's launches in the device trace: the CUDA kernel its
# call launches (a pattern on `launch_profile`'s names). A call launches it
# once, but the half-pair call launches both its kernels once a chunk of
# its `half_items` schedule (`half_launches`), and the directed tree sweep
# its item kernel once a chunk of its item table (one chunk at the shapes
# phases 17, 21 and 29 run). v5s and v7 launch the same kernel: phase 10c
# profiles the harness's two modes apart.
KERNELS = {
    "central_well": r"central_well_kernel",
    "bin_sprites": r"bin_count_kernel",
    "sort_kv_stable": r"histogram_kernel",
    "composite_tiles": r"tile_rows_kernel<(true|false)>",
    "composite_rows": r"composite_kernel<(true|false)>",
    "gather_rows": r"gather_(wide|narrow)_kernel<.+>",
    "all_pairs_rect": r"rect_kernel",
    "all_pairs_half": r"half_(item|fold)_kernel",
    "tree_sweep": r"sweep_item_kernel<true, false, false, \d+>",
    "tree_sweep_with_potential": r"sweep_item_kernel<true, true, false, \d+>",
    "tree_sweep_potential_only": r"sweep_item_kernel<false, true, false, \d+>",
    "tree_sweep_half_pairs": r"sweep_item_kernel<false, true, true, \d+>",
    "tree_sweep_n3": r"sweep_n3_fold_kernel",
    "attr_accel": r"elem_kernel<[012]>",
    "unroll_accel": r"elem_kernel<3>",
    "v4_accel": r"plane_kernel",
    "v1b_accel": r"expand_kernel<true, (true|false)>",
    "v1_accel": r"expand_kernel<false, (true|false)>",
    "v3_accel": r"v3_kernel<[012]>",
    "hybrid_accel": r"hybrid_kernel",
    "v5_accel": r"tri_kernel<[012], false>",
    "v5s_accel": r"tri_kernel<0, true>",
    "v6_accel": r"pair_kernel",
    "v7_accel": r"tri_kernel<0, true>",
}
# the wrappers of the render and the steps of the main paths
MAIN_WRAPPERS = ("central_well", "bin_sprites", "composite_tiles",
                 "sort_kv_stable", "gather_rows", "composite_rows",
                 "all_pairs_rect", "all_pairs_half")


def kernel_counts(kernels, wrappers) -> dict:
    """{wrapper: launches of its KERNELS pattern} in `kernels`, a
    `launch_profile` list or a {kernel name: launches}."""
    if not isinstance(kernels, dict):
        kernels = collections.Counter(name for name, _ in kernels)
    return {w: sum(c for name, c in kernels.items()
                   if re.fullmatch(KERNELS[w], name)) for w in wrappers}


def counted(fn, wrappers=MAIN_WRAPPERS):
    """(fn(), `kernel_counts` of its launches): one call of `fn` under
    torch.profiler."""
    out, kernels = launch_profile(fn)
    return out, kernel_counts(kernels, wrappers)


def half_launches(n, dev) -> int:
    """Device launches of one half-pair call at `n` on `dev`: an item
    kernel and its fold a chunk of the `half_items` schedule."""
    from multi_adapter_particles_torch.ops.allpairs import (
        _half_wave,
        half_chunk,
        half_items,
    )

    items = half_items(n, dev).shape[1]
    return 2 * -(-items // half_chunk(items, _half_wave(dev.index)))


def _exact_bins(dev):
    """`bin_sprites` (key, cx, cy, w, cgb, stats) of the first two 1M
    chunks of the 4M default scene (the device init, seed 0, after one
    central-well step) at 1024x1024, capacity 4 x 1M: the exact path's
    sort inputs."""
    import torch

    from multi_adapter_particles_torch import constants as C
    from multi_adapter_particles_torch.config import RenderConfig
    from multi_adapter_particles_torch.models import init as pinit
    from multi_adapter_particles_torch.ops.binning import bin_sprites
    from multi_adapter_particles_torch.ops.central_well import central_well_step
    from multi_adapter_particles_torch.render import renderer as R
    from multi_adapter_particles_torch.render.camera import Camera

    st = pinit.initialize_particles_device(
        N_MAIN, torch.Generator(device=dev).manual_seed(0), device=dev)
    pos, _ = central_well_step(st.position, st.velocity, dt=C.TIMESTEP,
                               damping=C.DAMPING, mass=C.PARTICLE_MASS,
                               softening_squared=C.SOFTENING_SQUARED)
    del st
    n = 1_048_576
    rend = R.Renderer(RenderConfig(width=WIDTH, height=HEIGHT))
    args = rend._device_args(Camera(), 2.5, 0.15, dev)
    return [bin_sprites(pos[:, c * n:(c + 1) * n], *args[:4], n, c * n,
                        width=WIDTH, height=HEIGHT, near=1.0, capacity=4 * n,
                        row=rend.resolve_seg_q(n)) for c in (0, 1)]


def _sort_device_ms(fn, inputs, reps=10):
    """Device ms a call of `fn(*args)` by torch.profiler (the sort's
    memset and kernels), each call on a fresh copy of `inputs` (an in-place
    sort changes its input; the copies are not counted): the median."""
    import statistics

    import torch

    args = [x.clone() for x in inputs]

    def calls():
        for _ in range(reps):
            for a, x in zip(args, inputs):
                a.copy_(x)
            fn(*args)

    _, launches = launch_profile(calls)
    ours = [(n, t) for n, t in launches
            if "histogram_kernel" in n or "digit_pass_kernel" in n
            or "Memset" in n]
    per_call = len(ours) // reps
    return statistics.median(
        sum(t for _, t in ours[i * per_call:(i + 1) * per_call])
        for i in range(reps)), ours[:per_call]


def phase_sort_live(dev):
    """The live-length sort on the exact path's real bins: in place,
    bitwise the full-length stable sort, run to run and under a graph
    replay; its device time against the full-length call and the bound."""
    import torch

    from multi_adapter_particles_torch.ops.sortkv import (
        live_digits,
        sort_kv_stable,
        sort_kv_stable_plain,
    )

    bins = _exact_bins(dev)
    wants = []
    for c, (key, *pay, stats) in enumerate(bins):
        live = stats[0]
        want = sort_kv_stable_plain(key, *pay)
        full = sort_kv_stable(key, *pay)
        got = sort_kv_stable(*(x.clone() for x in (key, *pay)), live=live)
        again = sort_kv_stable(*(x.clone() for x in (key, *pay)), live=live)
        torch.cuda.synchronize()
        for label, out in (("full length", full), ("live", got),
                           ("live, again", again)):
            for i, (a, b) in enumerate(zip(out, want)):
                if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                    fail(f"sort, exact chunk {c}, {label}: output {i} "
                         f"differs from the full-length twin "
                         f"({int((a != b).sum())} entries)")
        n, e = int(live), key.shape[0]
        log(f"  exact chunk {c}: {n:,} live of {e:,} ({n / e:.1%}), digit "
            f"passes {live_digits(key[:n])}: live length in place bitwise "
            "the full-length twin and kernel, twice")
        wants.append(want)
        del full, got, again

    # captured once on chunk 0's bins, replayed twice on chunk 1's
    static = [x.clone() for x in bins[0][:-1]]
    live = bins[0][-1][0].clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        sort_kv_stable(*static, live=live)
    for _ in range(2):
        for dst, src in zip(static, bins[1][:-1]):
            dst.copy_(src)
        live.copy_(bins[1][-1][0])
        graph.replay()
        torch.cuda.synchronize()
        if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(static, wants[1])):
            fail("sort: the live-length graph replayed on chunk 1's bins "
                 "differs from the full-length twin")
    log("  live length captured in a CUDA graph on chunk 0, replayed twice "
        "on chunk 1's bins: bitwise the full-length twin both times")
    del static, graph, wants

    key, *pay, stats = bins[0]
    n, e = int(stats[0]), key.shape[0]
    live = stats[0]
    ms_live, live_launches = _sort_device_ms(
        lambda *a: sort_kv_stable(*a, live=live), (key, *pay))
    ms_full, full_launches = _sort_device_ms(sort_kv_stable, (key, *pay))
    words = 1 + len(pay)
    passes = len(live_digits(key[:n]))
    bound_live = bytes_bound_ms(8 * words * n)
    bound_passes = bytes_bound_ms((4 + 8 * words * passes) * n)
    bound_full = bytes_bound_ms(8 * words * e)
    log(f"  exact chunk 0 ({n:,} live of {e:,}), device ms a call "
        f"(torch.profiler, median of 10): live {ms_live:.4f}, full length "
        f"{ms_full:.4f} ({ms_full / ms_live:.2f}x); bound {bound_live:.4f} "
        f"ms at the live length (40 B a live entry) -> "
        f"{bound_live / ms_live:.1%}; the passes' traffic (4 B a live key "
        f"read by the histogram, 40 B a live entry a pass, {passes} "
        f"passes) {bound_passes:.4f} -> {bound_passes / ms_live:.1%}; "
        f"{bound_full:.4f} at E -> {bound_full / ms_full:.1%}")
    for label, launches in (("live", live_launches),
                            ("full length", full_launches)):
        log(f"  one {label} call, device ms a launch: " + ", ".join(
            f"{k} {t:.4f}" for k, t in launches))
    return {"ms_live": ms_live, "ms_full_length": ms_full,
            "bound_live_ms": bound_live, "bound_passes_ms": bound_passes,
            "bound_ms_e": bound_full, "live": n, "capacity": e}


def phase_sort(dev):
    import torch

    from multi_adapter_particles_torch.ops.sortkv import (
        TILE,
        live_digits,
        sort_kv_stable,
        sort_kv_stable_plain,
    )

    log("phase 4a: sort kernel vs plain (bitwise on every output)")
    (key, *pay), gather_args = _render_io(dev)
    e = key.shape[0]
    wide = _render_io(dev, 2, 3)[0]
    small = _render_io(dev, n=262_144, width=1280, height=720)[0]
    gen = torch.Generator(device=dev).manual_seed(1)
    m = 1 << 20

    def rand_pay(n):
        return [torch.rand(n, device=dev, generator=gen),
                torch.randint(-2**31, 2**31 - 1, (n,), device=dev,
                              dtype=torch.int32, generator=gen)]

    def full_range(n):
        return torch.randint(-2**31, 2**31 - 1, (n,), device=dev,
                             dtype=torch.int32, generator=gen)

    neg = full_range(m + 3)
    neg[:4] = torch.tensor([-2**31, 2**31 - 1, -1, 0], dtype=torch.int32)
    ident = torch.arange(m, device=dev, dtype=torch.int32)
    full = (full_range(e), *pay)
    top = torch.randint(-128, 128, (m,), device=dev, dtype=torch.int32,
                        generator=gen) << 24
    cases = [
        ("render chunk, dup 2x2", (key, *pay), [0, 1]),
        ("render chunk, dup 2x3", wide, [0, 1]),
        ("keys in [0, 37)", (torch.randint(0, 37, (m,), device=dev,
                                           dtype=torch.int32, generator=gen),
                             *rand_pay(m)), [0]),
        ("all-equal keys", (torch.zeros(m, device=dev, dtype=torch.int32),
                            ident, *rand_pay(m)), []),
        ("negative keys, E = 2^20 + 3", (neg, *rand_pay(m + 3)),
         [0, 1, 2, 3]),
        ("full-range keys, E = 2^22", full, [0, 1, 2, 3]),
        ("k << 24 keys", (top, *rand_pay(m)), [3]),
        ("262,144 render chunk, 1280x720", small, [0, 1]),
    ] + [(f"full-range keys, E = {n:,}", (full_range(n), *rand_pay(n)),
          None) for n in (1, 2, TILE - 1, TILE + 1)]
    for label, args, digits in cases:
        k = sort_kv_stable(*args)
        p = sort_kv_stable_plain(*args)
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(k, p)):
            if a.dtype != b.dtype or not torch.equal(a, b):
                fail(f"sort {label}: output {i} differs from the twin "
                     f"({int((a != b).sum())} entries)")
        if label == "all-equal keys" and not torch.equal(k[1], ident):
            fail("sort of all-equal keys is not the identity")
        run = live_digits(args[0])
        if digits is not None and run != digits:
            fail(f"sort {label}: live digits {run}, expected {digits}")
        log(f"  {label}: E = {args[0].shape[0]:,}, {len(args) - 1} payloads,"
            f" digit passes {run}: bitwise the twin")
    del wide, small, cases

    first = sort_kv_stable(key, *pay)
    again = sort_kv_stable(key, *pay)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        fail("sort: two runs on the 4M render chunk differ")
    log("  render chunk sorted twice: bitwise run to run")
    del first, again

    # captured once on static inputs, replayed on full-range keys
    static = [key.clone(), *(q.clone() for q in pay)]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = sort_kv_stable(*static)
    for dst, src in zip(static, full):
        dst.copy_(src)
    graph.replay()
    eager = sort_kv_stable(*static)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(captured, eager)):
        fail("sort: the CUDA-graph replay on new keys differs from the "
             "eager call")
    log("  captured in a CUDA graph, replayed on full-range keys: bitwise "
        "the eager call")
    del static, graph, captured, eager

    def library(k, q):
        sk, perm = torch.sort(k, stable=True)
        return sk, *(x[perm] for x in q)

    ms = time_ms(lambda: sort_kv_stable(key, *pay), reps=20)
    plain_ms = time_ms(lambda: sort_kv_stable_plain(key, *pay), reps=20)
    lib_ms = time_ms(lambda: library(key, pay), reps=20)
    ms_full = time_ms(lambda: sort_kv_stable(*full), reps=20)
    lib_full = time_ms(lambda: library(full[0], pay), reps=20)
    bound = bytes_bound_ms(e * (4 + 4 * len(pay)) * 2)
    log(f"  E = {e:,}, {len(pay)} payloads: render keys kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, torch.sort + {len(pay)} gathers "
        f"{lib_ms:.4f} ms; full-range "
        f"keys kernel {ms_full:.4f} ms, torch.sort + gathers {lib_full:.4f} "
        f"ms; bound {bound:.4f} ms (bytes) -> {bound / ms:.1%} of it")
    log(f"  kernel faster than torch.sort + gathers on the render chunk: "
        f"{ms < lib_ms} ({lib_ms / ms:.2f}x)")
    profile = {}
    for label, args in (("render", (key, *pay)), ("full_range", full)):
        sort_kv_stable(*args)
        _, launches = launch_profile(lambda: sort_kv_stable(*args))
        profile[label] = launches
        kernels = sum(1 for name, _ in launches if "Memset" not in name)
        log(f"  one call on {label} keys, device ms a launch ({kernels} "
            "kernels): " + ", ".join(f"{n} {t:.4f}" for n, t in launches))
    del full
    exact = phase_sort_live(dev)
    # every output bitwise the twin's (checked above)
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": lib_ms,
            "ms_full_range": ms_full, "library_ms_full_range": lib_full,
            "profile": profile, "exact": exact}, gather_args


def phase_gather(dev, render_args):
    import statistics

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
    timings, rounds_by = {}, {}
    launches = 0
    for label, tab, ix in cases:
        k = gather_rows(tab, ix)
        p = gather_rows_plain(tab, ix)
        torch.cuda.synchronize()
        if not torch.equal(k, p):
            fail(f"gather {label}: {int((k != p).sum())} words differ")
        log(f"  {label}: bitwise the twin")
        if label.startswith(("render", "prototype")):
            plain_ms = time_ms(lambda: gather_rows_plain(tab, ix), reps=20)
            # the library call on indices clamped once beforehand (the
            # render's dead rows point past the table)
            ixc = ix.clamp(0, tab.shape[0] - 1)
            # kernel and index_select in turns, GATHER_ROUNDS rounds of 20
            # calls each: the median and the spread of each
            rounds = {"kernel": [], "index_select": []}
            for _ in range(GATHER_ROUNDS):
                rounds["kernel"].append(
                    time_ms(lambda: gather_rows(tab, ix), reps=20))
                rounds["index_select"].append(
                    time_ms(lambda: torch.index_select(tab, 0, ixc), reps=20))
            # off the render path, its path is these calls: one profiled
            launches += counted(lambda: gather_rows(tab, ix),
                                ["gather_rows"])[1]["gather_rows"]
            ms, lib_ms = (statistics.median(rounds[k]) for k in rounds)
            bound = bytes_bound_ms(2 * ix.shape[0] * tab.shape[1] * 4)
            slower = min(rounds["kernel"]) > max(rounds["index_select"])
            log(f"    kernel {ms:.4f} ms [{min(rounds['kernel']):.4f}, "
                f"{max(rounds['kernel']):.4f}], index_select {lib_ms:.4f} ms "
                f"[{min(rounds['index_select']):.4f}, "
                f"{max(rounds['index_select']):.4f}] (median [min, max] of "
                f"{GATHER_ROUNDS} rounds in turns), plain {plain_ms:.4f} ms; "
                f"kernel slower beyond the spread: {slower}; bound "
                f"{bound:.4f} ms (bytes) -> {bound / ms:.1%} of it")
            timings[label.split()[0]] = (ms, plain_ms, lib_ms, bound)
            rounds_by[label.split()[0]] = rounds
    ms, plain_ms, lib_ms, bound = timings["render"]
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": lib_ms,
            "rounds": rounds_by["render"], "launches": launches,
            "rounds_prototype": rounds_by["prototype"],
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


def phase_main_path(dev):
    import statistics

    log(f"phase 5: main path — app.main -numparticles {N_MAIN} -steps {STEPS}"
        f" at {WIDTH}x{HEIGHT}")
    t0 = time.perf_counter()
    (metrics, seen), launches = counted(lambda: _run_app(
        ["-numparticles", str(N_MAIN), "-steps", str(STEPS), "-novsync",
         "-nogui", "-width", str(WIDTH), "-height", str(HEIGHT)], STEPS))
    wall = time.perf_counter() - t0
    log(f"  app.main: rc 0, {seen['frames']} frames in {wall:.2f} s wall "
        f"(first-frame costs included, under torch.profiler), device "
        f"launches {launches}")
    if launches["central_well"] < STEPS:
        fail(f"central-well kernel launched {launches['central_well']} times"
             f" in {STEPS} frames")
    for name in ("bin_sprites", "composite_tiles", "sort_kv_stable"):
        if launches[name] < 4 * STEPS:
            fail(f"{name} launched {launches[name]} times in {STEPS} frames "
                 "of 4 chunks")
    if launches["composite_tiles"] != launches["sort_kv_stable"]:
        fail(f"composite_tiles launched {launches['composite_tiles']} times "
             f"for {launches['sort_kv_stable']} render chunks")
    for name in ("gather_rows", "composite_rows"):
        if launches[name]:
            fail(f"{name} launched {launches[name]} times on the main path")
    dev_frames = metrics["gauges"].get("device_frame_ms", [])[-30:]
    if len(dev_frames) < 10:
        fail(f"only {len(dev_frames)} CUDA-event frame samples")
    frame_ms = statistics.median(dev_frames)
    stages = metrics["stages_ms"]
    log(f"  ms/frame (CUDA events, median of last {len(dev_frames)}, "
        f"profiled): {frame_ms:.3f}; simulate ms {stages['simulate']:.3f}, "
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

    from multi_adapter_particles_torch.ops.composite import (
        composite_tiles_plain,
    )
    from multi_adapter_particles_torch.ops.binning import bin_sprites_plain
    from multi_adapter_particles_torch.ops.sortkv import sort_kv_stable_plain

    log("phase 6: final state's frame, the binning, sort and composite_tiles "
        "kernels vs their plain twins")
    rend = seen["renderer"]
    pos = seen["position"]
    out, launches = launch_profile(
        lambda: rend.render_arrays(pos, seen["camera"], 2.5, 0.15))
    with_kernel = out.frame

    def full_length(*args, live=None):   # every entry, as before `live`
        return sort_kv_stable_plain(*args)

    rend.composite = composite_tiles_plain
    rend.sort = full_length
    rend.bin = bin_sprites_plain
    with_plain = rend.render_arrays(pos, seen["camera"], 2.5, 0.15).frame
    torch.cuda.synchronize()
    log(f"  one split-frame render through the kernels: {len(launches)} "
        "device launches (torch.profiler; the step adds 1)")
    err = check_close("frame", with_kernel, with_plain, 0.0, 1e-5)
    if not torch.equal(with_kernel, with_plain):
        fail("the frame through the kernels is not bitwise the twins'")
    log("  bitwise equal: True")
    return err, len(launches)


def _fused_vs_split(label, argv, steps, graph, split=None):
    """`app.main` with `-fused` against the split loop from the same seed
    (`split`: that run's `seen`, else run here): positions bitwise, the last
    frame within 1e-5, `fused_graph` == `graph`; with graphs, a replayed
    frame launches the kernels an eager frame of the engine launches, name
    by name and count by count (torch.profiler). Returns the fused run's
    numbers."""
    import statistics

    import torch

    split_ms = None
    if split is None:
        split_metrics, split = _run_app(argv + ["-steps", str(steps)], steps)
        frames = split_metrics["gauges"].get("device_frame_ms", [])
        split_ms = statistics.median(frames) if frames else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    metrics, seen = _run_app(argv + ["-fused", "-steps", str(steps)], steps)
    wall = time.perf_counter() - t0
    # the run's own peak, above what the process held before it
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    eng = seen["fused"]
    ran_graph = metrics["gauges"].get("fused_graph")
    log(f"  {label}: rc 0, {steps} frames in {wall:.2f} s wall; fused_graph "
        f"{ran_graph}, {eng.replays} replays; peak memory {peak:.2f} GiB")
    if ran_graph is not graph:
        fail(f"{label}: fused_graph {ran_graph}, expected {graph}")
    replayed = per_frame = None
    if graph:
        if eng.replays != steps - 1:
            fail(f"{label}: {eng.replays} replays in {steps} frames")
        # the run is over: one frame of the engine's parity eagerly (every
        # particle stepped: no run here sets -numsim), then the same frame
        # replayed from its graphs
        parity = eng._cur
        eager = collections.Counter(n for n, _ in launch_profile(
            lambda: (eng._render(parity), eng._simulate(parity, None)))[1])
        g_render, _, g_step = eng._graphs[parity]
        replay = collections.Counter(n for n, _ in launch_profile(
            lambda: (g_render.replay(), g_step.replay()))[1])
        replayed = sum(replay.values())
        per_frame = {k: v for k, v in kernel_counts(
            replay, MAIN_WRAPPERS).items() if v}
        log(f"  one replayed frame: {replayed} device launches "
            f"(torch.profiler), {per_frame}; an eager frame "
            f"{sum(eager.values())}")
        if replay != eager:
            fail(f"{label}: a replayed frame's launches differ from an eager"
                 f" frame's: replayed {dict(replay - eager)} more, eager "
                 f"{dict(eager - replay)} more")
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
           "wrapper_launches_a_frame": per_frame,
           "device_launches_a_frame": replayed,
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
            "ms_1m": ms_1m}, full, (idx, rms_p, p64)


def phase_allpairs_half(dev, rect_1m, sample):
    """Phase 8. `sample`: phase 7's sampled target indices, its float32
    twin's RMS error against the float64 sum, and that sum."""
    import torch

    from multi_adapter_particles_torch.ops.allpairs import (
        all_pairs_accel_halfpair,
        all_pairs_accel_halfpair_plain,
        half_items,
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
            + nt * (nt - 1) // 2 * t2 * INSTR["all_pairs_half"], mhz)

    bound = half_bound_ms(N_HALF_CHECK)
    del pos, k, p
    # the device launches of a call, its item table built beforehand (by
    # the first call of a run)
    launches = {}
    pos = _ap_state(dev, N_HALF_CAPTURE)
    half_items(N_HALF_CAPTURE, pos.device)
    _, kernels = launch_profile(
        lambda: all_pairs_accel_halfpair(pos, **_ap_phys(N_HALF_CAPTURE)))
    launches[N_HALF_CAPTURE] = len(kernels)
    del pos
    pos = _ap_state(dev, N_AP)
    phys = _ap_phys(N_AP)
    half_items(N_AP, pos.device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    half, kernels = launch_profile(
        lambda: all_pairs_accel_halfpair(pos, **phys))
    # above what the process held before, less the [4, N] result
    scratch = torch.cuda.max_memory_allocated() - base - half.numel() * 4
    launches[N_AP] = len(kernels)
    fold = sum(t for name, t in kernels if "fold" in name)
    busy = sum(t for _, t in kernels)
    log(f"  device launches a call (torch.profiler): {launches}; at "
        f"{N_AP:,}: {dict(collections.Counter(n for n, _ in kernels))}, "
        f"folds {fold:.3f} of {busy:.3f} profiled kernel ms "
        f"({fold / busy:.2%}); peak scratch {scratch / 1e9:.3f} GB")
    for n, count in launches.items():
        if count > HALF_LAUNCH_LIMIT:
            fail(f"half-pair kernel at {n:,}: {count} device launches > "
                 f"{HALF_LAUNCH_LIMIT}")
    # two schedules of the same sum (the JAX test: 5e-6 at 2048)
    check_rel("half vs rect @1M", half, rect_1m, 2e-5)
    idx, rms_twin, p64 = sample
    rms = float(((half[:3, idx].double() - p64[:3]) ** 2).mean().sqrt())
    log(f"  RMS error vs float64 on phase 7's {idx.numel():,} targets: "
        f"kernel {rms:.3e}, phase 7's float32 twin {rms_twin:.3e}")
    if not rms <= 2.0 * rms_twin:
        fail(f"half kernel RMS error {rms:.3e} > 2x the twin's "
             f"{rms_twin:.3e}")
    ms_1m, mhz_1m = _time_and_clock(
        lambda: all_pairs_accel_halfpair(pos, **phys), reps=2, warmup=0)
    bound_1m = half_bound_ms(N_AP) * mhz / mhz_1m
    log(f"  {N_HALF_CHECK:,}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; "
        f"{N_AP:,}: kernel {ms_1m:.3f} ms = "
        f"{N_AP * N_AP / (ms_1m * 1e-3):.4e} effective pairs/s")
    log(f"  {N_HALF_CHECK:,} bound {bound:.3f} ms ({mhz:.0f} MHz) -> "
        f"{bound / ms:.1%}; {N_AP:,} bound {bound_1m:.3f} ms ({mhz_1m:.0f} "
        f"MHz) -> {bound_1m / ms_1m:.1%}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "operations",
            "ms_1m": ms_1m, "bound_ms_1m": bound_1m, "rms_1m": rms,
            "rms_twin": rms_twin, "launches_a_call": launches,
            "fold_ms": fold, "profiled_kernel_ms": busy,
            "scratch_bytes_1m": scratch}, half


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


def phase_allpairs_main_path(kernel_ms):
    """Phase 10. `kernel_ms`: the half and rect kernels' 1M times (phases
    7 and 8), which the path's "simulate" stage must match within
    STAGE_TOL: the stage times the step where it runs (its own stream
    when the extension is on), not what overlaps it. The device launches
    are counted on a profiled run of AP_STEPS_COUNTED frames of its own,
    so the timed run is not profiled."""
    import statistics

    import torch

    base = ["-force", "all_pairs", "-numparticles", str(N_AP), "-novsync",
            "-nogui", "-width", str(WIDTH), "-height", str(HEIGHT)]
    results = {}
    launches = {}
    for label, extra, steps, wrapper, a_call in (
            ("half", [], AP_STEPS_HALF, "all_pairs_half",
             half_launches(N_AP, torch.device("cuda:0"))),
            ("rect", ["-rectpair"], AP_STEPS_RECT, "all_pairs_rect", 1)):
        log(f"phase 10: all-pairs main path ({label}) — app.main "
            f"{' '.join(base + extra)} -steps {steps}")
        n = AP_STEPS_COUNTED
        _, got = counted(lambda: _run_app(base + extra + ["-steps", str(n)],
                                          n),
                         ("all_pairs_rect", "all_pairs_half",
                          "composite_tiles"))
        log(f"  {n} frames under torch.profiler: device launches {got} "
            f"({a_call} a {label} call)")
        if got[wrapper] < n * a_call:
            fail(f"{label}: the all-pairs kernels launched {got[wrapper]} "
                 f"times in {n} frames of {a_call} launches a call")
        if got["composite_tiles"] < n:
            fail(f"{label}: composite_tiles launched "
                 f"{got['composite_tiles']} times in {n} frames")
        launches[label] = got
        t0 = time.perf_counter()
        metrics, seen = _run_app(base + extra + ["-steps", str(steps)], steps)
        wall = time.perf_counter() - t0
        log(f"  rc 0, {steps} frames in {wall:.2f} s wall")
        if seen["config"].all_pairs_half != (label == "half"):
            fail(f"{label}: the run's config has all_pairs_half="
                 f"{seen['config'].all_pairs_half}")
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
        gap = abs(stages["simulate"] / kernel_ms[label] - 1)
        log(f"  simulate ms vs the {label} kernel's {kernel_ms[label]:.2f} ms"
            f" alone: {gap:.2%} apart (at most {STAGE_TOL:.0%})")
        if gap > STAGE_TOL:
            fail(f"{label}: the simulate stage reads {stages['simulate']:.2f}"
                 f" ms for a step whose kernel takes {kernel_ms[label]:.2f}")
        log(f"  last frame: max {float(seen['frame'].max()):.4f}, mean "
            f"{float(seen['frame'].mean()):.5f}, truncated 0")
        del seen
    return launches, results


# The variants' sizes (phase 10b): kernel vs twin at 131,072 (hybrid at
# 98,304, its JAX harness's 192 tiles of 512); timed at 1M (hybrid at
# 1,047,552 = 2,046 tiles of 512). All multiples of 128: no padding.
N_VAR_CHECK = 131_072
N_HYBRID_CHECK = 98_304
N_HYBRID_1M = 1_047_552
VAR_SAMPLE = 4_096   # targets held against the float64 sum
# Kernel vs twin, in units of max|a|. "fp32": elementwise, the same terms
# in another order (phase 7's 1e-5). "highest": the expansion's d²
# cancels ~|p|² down to ~eps2, which multiplies the difference between the
# kernel's six bf16-piece products (summed in the tensor cores) and the
# twin's float32 ops; held also by RMS against the float64 sum (at most 2x
# the twin's). "bf16": one bf16 pass, on a compact copy of the scene
# (|p| <= 4, eps2 = 25: no cancellation), where an s a rounding apart can
# land in another bf16 step.
VAR_LIMIT = {"fp32": 1e-5, "highest": 5e-3, "bf16": 1e-4}
# v3 before its redesign, on an H100 at 700 W: its error against v0 on
# this phase's 1M scene (this phase run on that kernel's tree; it had only
# tj = 512), which both tj are held to within V3_ERR_FACTOR, with no NaN
V3_ERR_BEFORE = {"vpu": 3.199e-3, "mm_split": 3.198e-3, "mm_bf16": 3.123e-3}
V3_ERR_FACTOR = 1.5
# v3's other stage sizes and ti, held against the twin (untimed) at
# 98,304, which every ti, tj here divides (131,072 is not a multiple of
# 384): (ti, tj) = (384, 384) and (256, 128) stages of 128 sources,
# (512, 256) and (128, 256) stages of 256, (128, 512) 512 with a CTA a
# ti-block; VAR_CASES gives stages of 512 at ti = 512
N_V3_SHAPES = 98_304
V3_SHAPES = ((384, 384), (256, 128), (512, 256), (128, 256), (128, 512))
# v1 / v1b's expansion before its redesign, on an H100 at 700 W (this phase
# on that kernel's tree): each case's error against v0 on this phase's 1M
# scene, which the new kernel is held to within EXPAND_ERR_FACTOR, and its
# NaN share there (NaN components of 3 x 2^20), which it may not exceed
# (the "default" forms are NaN on this scene by design)
EXPAND_ERR_BEFORE = {"v1b highest": 2.110e-4, "v1 highest": 3.198e-4,
                     "v1b default": 2.759e4, "v1 default": 2.757e3}
EXPAND_NAN_BEFORE = {"v1b highest": 0.0, "v1 highest": 0.0,
                     "v1b default": 3_123_915 / 3_145_728,
                     "v1 default": 3_034_443 / 3_145_728}
EXPAND_ERR_FACTOR = 1.5
# hybrid before its redesign, on an H100 at 700 W (this phase on that
# kernel's tree): its error against v0 at 1,047,552, which the new kernel
# is held to within EXPAND_ERR_FACTOR, and its NaN share, which it may not
# exceed
HYBRID_ERR_BEFORE = 1.148e-4
HYBRID_NAN_BEFORE = 0.0
# hybrid at other tiles (untimed), against its twin: tj = 128 (stages of
# 128, one a group) at 98,304, and tj = 384 (stages of 128, three a group)
# at 97,920 = 255 x 384, whose last CTA of 256 targets half-fills
HYBRID_SHAPES = ((98_304, 128), (97_920, 384))
# an odd multiple of 128 (769 x 128): the expansion's stages fall to 128
# sources and its last CTA of 256 targets half-fills
N_EXPAND_ODD = 98_432
# (PIPES key, JAX launcher it belongs to, keywords, form)
VAR_CASES = (
    ("attr full", "attr_accel", dict(mode="full"), "fp32"),
    ("attr norsqrt", "attr_accel", dict(mode="norsqrt"), "fp32"),
    ("attr noaccum", "attr_accel", dict(mode="noaccum"), "fp32"),
    ("unroll", "unroll_accel", {}, "fp32"),
    ("v4", "v4_accel", {}, "fp32"),
    ("v1b highest", "v1b_accel", dict(precision="highest"), "highest"),
    ("v1 highest", "v1_accel", dict(precision="highest"), "highest"),
    ("hybrid", "hybrid_accel", {}, "highest"),
    ("v1b default", "v1b_accel", dict(precision="default"), "bf16"),
    ("v1 default", "v1_accel", dict(precision="default"), "bf16"),
    ("v3 vpu", "v3_accel", dict(force_path="vpu"), "bf16"),
    ("v3 mm_split", "v3_accel", dict(force_path="mm_split"), "bf16"),
    ("v3 mm_bf16", "v3_accel", dict(force_path="mm_bf16"), "bf16"),
    ("v3 vpu tj=1024", "v3_accel", dict(force_path="vpu", tj=1024), "bf16"),
    ("v3 mm_split tj=1024", "v3_accel", dict(force_path="mm_split", tj=1024),
     "bf16"),
    ("v3 mm_bf16 tj=1024", "v3_accel", dict(force_path="mm_bf16", tj=1024),
     "bf16"),
)
# the JSON entry of each launcher: its JAX defaults' case, and the TPU
# kernel body it replaces
VAR_ENTRIES = (
    ("attr_accel", "attr full", "experiments/allpairs_v2.py:37"),
    ("v1b_accel", "v1b highest", "experiments/allpairs_v2.py:112"),
    ("unroll_accel", "unroll", "experiments/allpairs_unroll.py:29"),
    ("v1_accel", "v1 default", "experiments/allpairs_variants.py:35"),
    ("v3_accel", "v3 vpu", "experiments/allpairs_v3.py:53"),
    ("hybrid_accel", "hybrid", "experiments/allpairs_hybrid.py:42"),
    ("v4_accel", "v4", "experiments/allpairs_planeacc.py:35"),
)


def _rows4(out):
    """[4, N] of a result in either layout ([N, 4] for attr and v4)."""
    return out if out.shape[0] == 4 else out.T


def _time_and_clock(fn, reps: int, warmup: int):
    """(mean device ms of `reps` calls after `warmup`, the SM clock read
    while they run)."""
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
    mhz = sm_clock_mhz()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, mhz


def v3_shape_checks(pos):
    """v3 at V3_SHAPES on every force path, twice bitwise and against its
    twin within VAR_LIMIT["bf16"] of max|a| (`pos`: the compact scene)."""
    import torch

    from multi_adapter_particles_torch.ops import allpairs_variants as V

    for ti, tj in V3_SHAPES:
        for fp in V.FORCE_PATHS:
            kw = dict(ti=ti, tj=tj, force_path=fp)
            k = V.v3_accel(pos, **kw)
            again = V.v3_accel(pos, **kw)
            plain = V.v3_accel_plain(pos, **kw)
            torch.cuda.synchronize()
            label = f"v3 {fp} ti={ti} tj={tj} (stage {V.v3_stage(tj)})"
            if not torch.equal(k, again):
                fail(f"{label}: two runs differ")
            check_rel(f"{label} vs plain @{pos.shape[1]:,} (bf16, two runs "
                      "bitwise)", k, plain, VAR_LIMIT["bf16"])


def expand_odd_checks(scene):
    """v1 and v1b's four cases at N_EXPAND_ODD, twice bitwise and against
    their twins within VAR_LIMIT (`scene(n, form)`: the phase's scenes)."""
    import torch

    from multi_adapter_particles_torch.ops import allpairs_variants as V

    for label, name, kw, form in VAR_CASES:
        if label not in EXPAND_ERR_BEFORE:
            continue
        pos = scene(N_EXPAND_ODD, form)
        fn, plain = getattr(V, name), getattr(V, f"{name}_plain")
        k = fn(pos, **kw)
        again = fn(pos, **kw)
        want = plain(pos, **kw)
        torch.cuda.synchronize()
        if not torch.equal(k, again):
            fail(f"{label} @{N_EXPAND_ODD:,}: two runs differ")
        check_rel(f"{label} vs plain @{N_EXPAND_ODD:,} (stage "
                  f"{V.expand_stage(N_EXPAND_ODD)}, {form}, two runs "
                  "bitwise)", k, want, VAR_LIMIT[form])


def hybrid_shape_checks(scene):
    """hybrid at HYBRID_SHAPES, twice bitwise, no NaN, and against its twin
    within VAR_LIMIT["highest"] (`scene(n, form)`: the phase's scenes)."""
    import torch

    from multi_adapter_particles_torch.ops import allpairs_variants as V

    for n, tj in HYBRID_SHAPES:
        pos = scene(n, "highest")
        k = V.hybrid_accel(pos, tj=tj)
        again = V.hybrid_accel(pos, tj=tj)
        want = V.hybrid_accel_plain(pos, tj=tj)
        torch.cuda.synchronize()
        if not torch.equal(k, again):
            fail(f"hybrid tj={tj} @{n:,}: two runs differ")
        check_rel(f"hybrid tj={tj} vs plain @{n:,} (stage "
                  f"{V.hybrid_stage(tj)}, highest, two runs bitwise, no NaN)",
                  k, want, VAR_LIMIT["highest"])


def phase_allpairs_variants(dev):
    """Phase 10b: the rectangle-schedule variants. Their path is the
    harness (`tools/allpairs_variants.py`) at its defaults; then each
    kernel against its twin, twice bitwise; then each timed at 1M against
    its per-pipe bound, with its error against v0."""
    import torch

    from multi_adapter_particles_torch import constants as C
    from multi_adapter_particles_torch.ops import allpairs_variants as V
    from multi_adapter_particles_torch.ops.allpairs import (
        all_pairs_accel,
        all_pairs_accel_plain,
    )
    from multi_adapter_particles_torch.tools import allpairs_variants as H

    log("phase 10b: all-pairs variants — the harness "
        "`python -m multi_adapter_particles_torch.tools.allpairs_variants` "
        "at its defaults (131,072; hybrid 98,304)")
    _, launches = counted(
        lambda: H.run(None, "cuda", reps=1, log=lambda s: log("  " + s)),
        [fn.__name__ for fn in V.VARIANTS])
    log(f"  harness device launches {launches}")
    for name, count in launches.items():
        if count == 0:
            fail(f"{name} launched no kernel in the harness run")

    fns = {fn.__name__: fn for fn in V.VARIANTS}
    plains = {name: getattr(V, f"{name}_plain") for name in fns}
    phys = dict(mass=C.PARTICLE_MASS, softening_squared=C.SOFTENING_SQUARED)
    scenes = {}

    def scene(n, form):
        if n not in scenes:
            main = _ap_state(dev, n)
            scale = 4.0 / float(main[:3].abs().max())
            scenes[n] = {"main": main, "compact": main * scale}
        return scenes[n]["compact" if form == "bf16" else "main"]

    log(f"  kernel vs twin @ {N_VAR_CHECK:,} (hybrid {N_HYBRID_CHECK:,}); "
        f"limits {VAR_LIMIT} of max|a|")
    stats = {}
    for label, name, kw, form in VAR_CASES:
        n = N_HYBRID_CHECK if name == "hybrid_accel" else N_VAR_CHECK
        pos = scene(n, form)
        fn = fns[name]
        k = _rows4(fn(pos, **kw))
        again = _rows4(fn(pos, **kw))
        plain, plain_ms = timed(lambda: _rows4(plains[name](pos, **kw)))
        torch.cuda.synchronize()
        if not torch.equal(k, again):
            fail(f"{label}: two runs differ")
        err = check_rel(f"{label} vs plain ({form}, two runs bitwise)", k,
                        plain, VAR_LIMIT[form])
        if form == "highest":
            idx = torch.linspace(0, n - 1, VAR_SAMPLE, device=dev).long()
            p64 = all_pairs_accel_plain(pos[:, idx].double(),
                                        sources=pos.double(), **phys)
            rms_k = float(((k[:3, idx].double() - p64[:3]) ** 2).mean()
                          .sqrt())
            rms_p = float(((plain[:3, idx].double() - p64[:3]) ** 2).mean()
                          .sqrt())
            log(f"    RMS vs float64 ({VAR_SAMPLE:,} targets): kernel "
                f"{rms_k:.3e}, f32 twin {rms_p:.3e} ({rms_k / rms_p:.2f}x)")
            if not rms_k <= 2.0 * rms_p:
                fail(f"{label}: kernel RMS error {rms_k:.3e} > 2x the "
                     f"twin's {rms_p:.3e}")
        ms, mhz = _time_and_clock(lambda: fn(pos, **kw), reps=3, warmup=1)
        bound, pipe = pipe_bound_ms(label, float(n) * n, mhz)
        log(f"    {n:,}: kernel {ms:.3f} ms, twin {plain_ms:.1f} ms, bound "
            f"{bound:.3f} ms ({pipe}, {mhz:.0f} MHz) -> {bound / ms:.1%}")
        stats[label] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound, "bound_by": "operations",
                        "pipe": pipe}
    v3_shape_checks(scene(N_V3_SHAPES, "bf16"))
    expand_odd_checks(scene)
    hybrid_shape_checks(scene)
    del scenes
    torch.cuda.empty_cache()

    log(f"  each variant @ {N_AP:,} (hybrid {N_HYBRID_1M:,}): ms, pairs/s, "
        "per-pipe bound, error vs v0 (printed: the bf16 forms are wrong "
        "by design on this scene)")
    at_1m = {}
    for n in (N_AP, N_HYBRID_1M):
        pos = _ap_state(dev, n)
        ref = all_pairs_accel(pos, **phys)
        for label, name, kw, form in VAR_CASES:
            if (name == "hybrid_accel") != (n == N_HYBRID_1M):
                continue
            fn = fns[name]
            rel, nan = H.error_vs(fn(pos, **kw), ref)
            ms, mhz = _time_and_clock(lambda: fn(pos, **kw), reps=2,
                                      warmup=1)
            bound, pipe = pipe_bound_ms(label, float(n) * n, mhz)
            at_1m[label] = {"n": n, "ms": ms, "pairs_per_s": n * n / ms * 1e3,
                            "bound_ms": bound, "pipe": pipe,
                            "share": bound / ms, "mhz": mhz,
                            "rel_err_vs_v0": rel, "nan_share": nan}
            vs = ("(attr: held only against its twin)" if name == "attr_accel"
                  else f"vs v0 rel {rel:.3e}, NaN share {nan:.6e}")
            if label in EXPAND_ERR_BEFORE or label == "hybrid":
                before, nan_before = (
                    (HYBRID_ERR_BEFORE, HYBRID_NAN_BEFORE)
                    if label == "hybrid" else (EXPAND_ERR_BEFORE[label],
                                               EXPAND_NAN_BEFORE[label]))
                vs += (f"; before rel {before:.3e}, NaN share "
                       f"{nan_before:.4e}")
                if nan > nan_before or not rel <= EXPAND_ERR_FACTOR * before:
                    fail(f"{label} @1M: rel {rel:.3e} (before {before:.3e}), "
                         f"NaN share {nan:.6e} (before {nan_before:.6e})")
            if name == "v3_accel":
                before = V3_ERR_BEFORE[kw["force_path"]]
                vs += f"; before rel {before:.3e}"
                if nan or not rel <= V3_ERR_FACTOR * before:
                    fail(f"{label} @1M: rel {rel:.3e} (before {before:.3e}), "
                         f"NaN share {nan:.3e}")
            log(f"    {label:13s} @{n:,}: {ms:9.3f} ms = "
                f"{n * n / ms * 1e3:.4e} pairs/s; bound {bound:.3f} ms "
                f"({pipe}, {mhz:.0f} MHz) -> {bound / ms:.1%}; {vs}")
        del pos, ref
        torch.cuda.empty_cache()
    for label in ("unroll", "v4"):   # v0's terms in another order
        if not at_1m[label]["rel_err_vs_v0"] <= 1e-5:
            fail(f"{label} @1M: {at_1m[label]['rel_err_vs_v0']:.3e} of "
                 "max|a| from v0")
    entries = {name: {**stats[label], "launches": launches[name]}
               for name, label, _ in VAR_ENTRIES}
    return entries, stats, at_1m


# Phase 10c, the half-pair generations: kernel vs twin at N_HALF_CHECK,
# timed at N_AP. FP32 instructions a pair that takes both sides and a pair
# that takes the i-side only (the tally in csrc/allpairs_halfpair.cu's
# header); every computed pair takes one MUFU rsqrt.
GEN_INSTR = {"both": 15, "iside": 12}
# the JSON entry of each launcher: its harness case, and the TPU body it
# replaces
GEN_ENTRIES = (
    ("v5_accel", "v5 halfpair t=512", "experiments/allpairs_halfpair.py:45"),
    ("v5s_accel", "v5s static t=512", "experiments/allpairs_halfpair.py:120"),
    ("v6_accel", "v6 prefetch t=512", "experiments/allpairs_halfpair.py:268"),
    ("v7_accel", "v7 banded t=512 kb=128",
     "experiments/allpairs_halfpair.py:459"),
)
GEN_SCRATCH_LIMIT = 3.3e9   # bytes a call may allocate at 1M


def halfgen_pipe_ms(mode: str, n: int, t: int, mhz: float) -> dict:
    """Least ms on the FP32 and the MUFU pipe of a half-pair generation at
    n, at their issue rates on 132 SMs at `mhz`: diagonal tile pairs take
    the i-side only in "full", every pair does in "tri_only", and every
    pair takes both sides in "reduce_only"."""
    nt = n // t
    diag, off = nt * t * t, nt * (nt - 1) // 2 * t * t
    both, iside = GEN_INSTR["both"], GEN_INSTR["iside"]
    fp32 = {"full": diag * iside + off * both,
            "reduce_only": (diag + off) * both,
            "tri_only": (diag + off) * iside}[mode]
    return {"fp32": issue_bound_ms(fp32, mhz, "fp32"),
            "mufu": issue_bound_ms(diag + off, mhz, "mufu")}


def phase_halfpair_generations(dev, half, half_1m):
    """Phase 10c: the Newton-3rd half-pair generations. Their path is the
    harness (`tools/allpairs_halfpair.py`), each full form held against v0
    there; then every case of the harness, both modes, kernel against its
    twin, twice bitwise, and the full forms against phase 8's half-pair
    kernel (#4); then the t = 512 cases and the v7 cases timed at 1M with
    their bounds, scratch and fold time."""
    import torch

    from multi_adapter_particles_torch import constants as C
    from multi_adapter_particles_torch.ops import allpairs_halfpair as G
    from multi_adapter_particles_torch.ops.allpairs import (
        all_pairs_accel_halfpair,
    )
    from multi_adapter_particles_torch.tools import allpairs_halfpair as HH

    log("phase 10c: half-pair generations — the harness `python -m "
        "multi_adapter_particles_torch.tools.allpairs_halfpair` at its "
        f"default ({HH.N_DEFAULT:,}) and `... v7 {N_HALF_CHECK}`; each "
        "full form vs v0 <= 1e-5, no NaN")
    # v5s and v7 launch the same kernel: the two modes profiled apart
    rows, launches = counted(
        lambda: HH.run(None, "cuda", reps=1, log=lambda s: log("  " + s)),
        ("v5_accel", "v5s_accel", "v6_accel"))
    v7_rows, v7 = counted(
        lambda: HH.run(N_HALF_CHECK, "cuda", reps=1, v7=True,
                       log=lambda s: log("  " + s)), ["v7_accel"])
    rows += v7_rows
    launches.update(v7)
    log(f"  harness device launches {launches}")
    for name, count in launches.items():
        if count == 0:
            fail(f"{name} launched no kernel in the harness run")
    for row in rows:
        if row.get("skipped"):
            fail(f"harness: {row['label']} skipped at {row['n']:,}")
        if "rel_err" in row and not (row["rel_err"] <= 1e-5
                                     and row["nan_share"] == 0):
            fail(f"harness: {row['label']} vs v0 rel {row['rel_err']:.3e}, "
                 f"NaN share {row['nan_share']:.3e}")

    checks = HH.cases() + HH.cases(v7=True)
    pos = _ap_state(dev, N_HALF_CHECK)
    ref4 = all_pairs_accel_halfpair(pos, mass=C.PARTICLE_MASS,
                                    softening_squared=C.SOFTENING_SQUARED)
    # The same tile pairs summed in another order (phase 8's 1e-5); the
    # attribution modes in units of their twin's own max.
    log(f"  kernel vs twin @ {N_HALF_CHECK:,}, every harness case; limit "
        "1e-5 of max|a|")
    stats = {}
    for label, fn, kw, _ in checks:
        mode = kw.get("mode", "full")
        k = fn(pos, **kw)
        again = fn(pos, **kw)
        plain, plain_ms = timed(
            lambda: getattr(G, f"{fn.__name__}_plain")(pos, **kw))
        torch.cuda.synchronize()
        if not torch.equal(k, again):
            fail(f"{label}: two runs differ")
        err = check_rel(f"{label} vs plain (two runs bitwise)", k, plain,
                        1e-5)
        if mode == "full":
            check_rel(f"{label} vs #4's kernel", k, ref4, 1e-5)
        ms, mhz = _time_and_clock(lambda: fn(pos, **kw), reps=3, warmup=1)
        pipes = halfgen_pipe_ms(mode, N_HALF_CHECK, kw["t"], mhz)
        pipe = max(pipes, key=pipes.get)
        bound = pipes[pipe]
        log(f"    kernel {ms:.3f} ms, twin {plain_ms:.1f} ms, bound "
            f"{bound:.3f} ms ({pipe}, {mhz:.0f} MHz) -> {bound / ms:.1%}")
        stats[label] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound, "bound_by": "operations",
                        "pipe": pipe}
    del pos, ref4, k, again, plain
    torch.cuda.empty_cache()

    log(f"  each @ {N_AP:,}: ms, effective pairs/s, FP32 and MUFU bounds, "
        f"#4's {half['ms_1m']:.3f} ms (phase 8), peak scratch, the fold "
        "kernels' device ms in one profiled call; full forms vs #4 <= 2e-5")
    pos = _ap_state(dev, N_AP)
    ref = half_1m * N_AP   # without phase 8's 1/N scale (a power of 2)
    at_1m = {}
    for label, fn, kw, _ in checks:
        if kw["t"] != 512 and fn is not G.v7_accel:
            continue
        mode = kw.get("mode", "full")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out, kernels = launch_profile(lambda: fn(pos, **kw))
        scratch = torch.cuda.max_memory_allocated() - base
        fold = HH.split_kernels(kernels)["folds"][0]
        busy = sum(ms for _, ms in kernels)
        rel = None
        if mode == "full":
            rel = check_rel(f"{label} vs #4 @1M", out, ref, 2e-5) / float(
                ref[:3].abs().max())
        del out
        ms, mhz = _time_and_clock(lambda: fn(pos, **kw), reps=1, warmup=0)
        pipes = halfgen_pipe_ms(mode, N_AP, kw["t"], mhz)
        fp32, mufu = pipes["fp32"], pipes["mufu"]
        bound = max(fp32, mufu)
        at_1m[label] = {"ms": ms, "pairs_per_s": N_AP * N_AP / ms * 1e3,
                        "fp32_bound_ms": fp32, "mufu_bound_ms": mufu,
                        "share": bound / ms, "mhz": mhz,
                        "half_ms": half["ms_1m"], "scratch_bytes": scratch,
                        "fold_ms": fold, "profiled_kernel_ms": busy,
                        "rel_err_vs_half": rel}
        fold_line = ""
        if fn is G.v7_accel:
            fold_bytes = G.v7_fold_bytes(N_AP, kw["t"], kw["kb"])
            fold_bound = bytes_bound_ms(fold_bytes)
            at_1m[label]["fold_bound_ms"] = fold_bound
            fold_line = (f" (byte bound {fold_bound:.3f} ms, "
                         f"{fold_bytes / 1e9:.3f} GB -> "
                         f"{fold_bound / fold:.1%})")
        log(f"    {label:28s}: {ms:9.3f} ms = "
            f"{N_AP * N_AP / ms * 1e3:.4e} pairs/s ({ms / half['ms_1m']:.3f}x "
            f"#4's {half['ms_1m']:.1f}); bound FP32 {fp32:.1f} / MUFU "
            f"{mufu:.1f} ms ({mhz:.0f} MHz) -> {bound / ms:.1%}; scratch "
            f"{scratch / 1e9:.3f} GB; folds {fold:.3f}{fold_line} of "
            f"{busy:.3f} profiled kernel ms")
        if scratch > GEN_SCRATCH_LIMIT:
            fail(f"{label}: {scratch / 1e9:.3f} GB of scratch at 1M > "
                 f"{GEN_SCRATCH_LIMIT / 1e9} GB")
    v6 = at_1m["v6 prefetch t=512"]
    log(f"  v6 {v6['ms']:.3f} ms against #4's {half['ms_1m']:.3f} ms "
        f"(phase 8): #4 takes {half['ms_1m'] / v6['ms']:.3f}x v6's time")
    del pos, ref
    torch.cuda.empty_cache()
    entries = {name: {**stats[label], "launches": launches[name]}
               for name, label, _ in GEN_ENTRIES}
    return entries, stats, at_1m


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


def issue_bound_ms(instructions: float, mhz: float, pipe="fp32") -> float:
    """Least time for `instructions` lane-instructions (tensor: flops) on
    `pipe`: 132 SMs at PIPE_RATE a clock each (FP32: 128 lanes, at 1,980
    MHz the 67 TFLOP/s FP32 peak with each instruction an FMA's two
    flops)."""
    return instructions / (SMS * PIPE_RATE[pipe] * mhz * 1e6) * 1e3


def pipe_bound_ms(name: str, pairs: float, mhz: float):
    """(least ms, bounding pipe) for `pairs` pairs of variant `name`: the
    slowest of its FP32, MUFU and tensor-core work (PIPES) at its pipe's
    issue rate on 132 SMs at `mhz`."""
    times = {pipe: issue_bound_ms(count * pairs, mhz, pipe)
             for pipe, count in zip(PIPE_RATE, PIPES[name.split(" tj=")[0]])}
    pipe = max(times, key=times.get)
    return times[pipe], pipe


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
    here once (its time is the item table's device build and the kernels'
    alone), in chunks of `chunk` table entries if given."""
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
                lambda chunk=None: treeforce._launch_sweep_n3(
                    L.spos, *prep, eps2, sigma, chunk=chunk),
                lambda: treeforce.near_sweep_n3_plain(*args, **kw))
    variant = treeforce._variant(flags.get("with_potential", False),
                                 flags.get("potential_only", False),
                                 flags.get("half_pairs", False))
    args = (L.spos, L.bounds, L.sweep_j)
    kw = dict(block=L.sweep_block, eps2=eps2, sigma=sigma, **flags)
    b32, j32 = L.bounds.to(torch.int32), L.sweep_j.to(torch.int32)
    return (lambda: treeforce.near_sweep(*args, **kw),
            lambda chunk=None: treeforce._launch_sweep(
                L.spos, L.sweep_nb, L.sweep_block, b32, j32, eps2, sigma,
                variant, chunk=chunk),
            lambda: treeforce.near_sweep_plain(*args, **kw))


TREE_KERNELS = (("tree_sweep", False), ("tree_sweep_n3", True))


def tree_bound_ms(name, lists, mhz):
    """Least time of sweep `name` over `lists` at `mhz`: its FP32
    instructions a pair (INSTR; the halved sweep's diagonal pairs at
    tree_sweep_n3_diag) over 132 SMs x 128 lanes."""
    if name == "tree_sweep_n3":
        diag = int((lists.sweep_i == lists.sweep_j).sum())
        fp32 = ((lists.pairs - diag) * INSTR[name]
                + diag * INSTR["tree_sweep_n3_diag"])
    else:
        fp32 = lists.pairs * INSTR[name]
    return issue_bound_ms(fp32 * lists.sweep_block ** 2, mhz)


def item_log(name, lists):
    """Log the work items of sweep `name` over `lists`: their count, the
    longest, the longest segment, and the SASS issue slots a pair."""
    from multi_adapter_particles_torch.ops import treeforce

    bounds = (treeforce._n3_lists(lists.sweep_i, lists.sweep_j, lists.nb)[0]
              if lists.n3 else lists.bounds)
    items = treeforce.sweep_items(bounds, lists.sweep_j.numel())
    slots = f"{TREE_SLOTS[name]:.3f}"
    if lists.n3:
        slots += f" (diagonal {TREE_SLOTS['tree_sweep_n3_diag']:.3f})"
    log(f"  {name}: {int(items.istart[-1]):,} work items (table "
        f"{items.table.shape[1]:,}), the longest "
        f"{int((items.q1 - items.q0).max())} listed source blocks, the "
        f"longest segment {int((bounds[1:] - bounds[:-1]).max())}; SASS "
        f"issue slots a pair at B = 512: {slots}")


def _without_segments(i_idx, j_idx, nb, halved):
    """The list without the segments of target blocks i % 3 == 1:
    (bounds, j_idx) directed, (sweep_i, sweep_j) halved."""
    from multi_adapter_particles_torch.ops import pm

    keep = i_idx % 3 != 1
    if halved:
        return i_idx[keep], j_idx[keep]
    return pm._segment_bounds(i_idx[keep], nb), j_idx[keep]


def phase_tree_adversarial(dev, block):
    """Phase 11's adversarial lists at `block`: 256 blocks, half of them a
    dense blob (each lists every blob block: segments of 128+ source
    blocks, 8+ items), half spread over the box; and the same lists with
    every third target block's segment removed. Every directed variant and
    the halved sweep vs their twins, and in chunks of 3 table entries
    bitwise the same as in one."""
    import torch

    from multi_adapter_particles_torch import constants as C
    from multi_adapter_particles_torch.ops import p3m, treeforce

    n = 256 * block
    g = torch.Generator(device=dev).manual_seed(11)
    pos = torch.zeros((4, n), device=dev)
    pos[:3, :n // 2] = torch.randn((3, n // 2), generator=g,
                                   device=dev) * 12.0
    pos[:3, n // 2:] = (torch.rand((3, n - n // 2), generator=g,
                                   device=dev) - 0.5) * 1600.0
    r_c, gn = p3m.near_grid_for(128, BOX, CUTOFF)
    eps2, sigma = C.SOFTENING_SQUARED, r_c * p3m._SIGMA_PER_CUTOFF
    lists = {
        half: treeforce.tree_lists(pos, BOX, r_c, gn, block=block,
                                   pair_budget=256 * 256,
                                   half_force=half == "n3",
                                   half_pairs=half == "gauge")
        for half in ("directed", "gauge", "n3")}
    seg = [int((L.bounds if L.bounds is not None else
                treeforce._n3_lists(L.sweep_i, L.sweep_j, L.nb)[0])
               .diff().max()) for L in lists.values()]
    if any(L.dropped for L in lists.values()) or min(seg) < 8 * \
            treeforce.ITEM_LEN:
        fail(f"adversarial lists at B={block}: dropped "
             f"{[L.dropped for L in lists.values()]}, longest segments {seg}")
    log(f"  adversarial lists, B={block}: {n:,} particles, directed / "
        f"halved gauge / halved force {[L.pairs for L in lists.values()]} "
        f"block pairs, longest segments {seg}")
    for empty in (False, True):
        for variant, flags in enumerate(({},) + tuple(
                f for _, f in POT_VARIANTS)):
            L = lists["gauge" if flags.get("half_pairs") else "directed"]
            if empty:
                bounds, j_idx = _without_segments(L.sweep_i, L.sweep_j,
                                                  L.nb, False)
            else:
                bounds, j_idx = L.bounds, L.sweep_j
            kw = dict(block=block, eps2=eps2, sigma=sigma, **flags)
            k = treeforce.near_sweep(L.spos, bounds, j_idx, **kw)
            p = treeforce.near_sweep_plain(L.spos, bounds, j_idx, **kw)
            parts = treeforce._launch_sweep(
                L.spos, L.nb, block, bounds.to(torch.int32),
                j_idx.to(torch.int32), eps2, sigma, variant, chunk=3)
            name = f"B={block} variant {variant}" + (
                ", empty segments" if empty else "")
            if not torch.equal(k, parts):
                fail(f"{name}: 3-entry chunks differ from one chunk")
            if not flags.get("potential_only"):
                check_rel(f"{name} force vs plain", k[:3], p[:3], 1e-5)
            if flags:
                check_u(f"{name} u vs plain", k[3], p[3], L.live, 1e-5)
        L = lists["n3"]
        si, sj = L.sweep_i, L.sweep_j
        if empty:
            si, sj = _without_segments(si, sj, L.nb, True)
        kw = dict(nb=L.nb, block=block, eps2=eps2, sigma=sigma)
        k = treeforce.near_sweep_n3(L.spos, si, sj, **kw)
        p = treeforce.near_sweep_n3_plain(L.spos, si, sj, **kw)
        parts = treeforce._launch_sweep_n3(
            L.spos, *treeforce._n3_prepare(L.spos, si, sj, L.nb, block),
            eps2, sigma, chunk=3)
        name = f"B={block} n3" + (", empty segments" if empty else "")
        if not torch.equal(k, parts):
            fail(f"{name}: 3-entry chunks differ from one chunk")
        check_rel(f"{name} vs plain", k, p, 1e-5)


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
        bound = tree_bound_ms(name, L, mhz)
        log(f"  {name}: {L.pairs:,} listed block pairs of {L.sweep_block} "
            f"= {pairs:.4e} pair interactions, dropped 0; kernel {ms:.3f} "
            f"ms (wrapper {wrapper_ms:.3f} ms), plain {plain_ms:.1f} ms; "
            f"bound {bound:.3f} ms at {mhz:.0f} MHz -> {bound / ms:.1%} of "
            "it")
        item_log(name, L)
    for block in (32, 128, 512):
        phase_tree_adversarial(dev, block)
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
        chunk = treeforce.items_len(L.sweep_nb, L.sweep_j.numel()) // 3 + 1
        if not (torch.equal(k, again) and torch.equal(k, kernel(chunk))):
            fail(f"{name}: two runs at {N_TREE:,}, or three chunks of "
                 f"{chunk} items, differ")
        p, plain_ms = timed(twin)
        err = check_rel(f"{name} vs plain", k, p, 1e-5)
        del again, p
        ms = time_ms(kernel, reps=5)
        wrapper_ms = time_ms(wrapper, reps=5)
        plain_ms = time_ms(twin, reps=1, warmup=0)
        mhz = busy_clock_mhz(kernel, reps=8)
        pairs = L.pairs * L.sweep_block ** 2
        bound = tree_bound_ms(name, L, mhz)
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
            "it; runs and chunkings bitwise equal")
        item_log(name, L)
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

    base = ["-force", "p3m", "-p3mnear", "tree", "-numparticles",
            str(N_TREE), "-novsync", "-nogui", "-width", str(WIDTH),
            "-height", str(HEIGHT)]
    results, launches = {}, {}
    for label, extra, steps, wrapper in (
            ("n3", [], TREE_STEPS_N3, "tree_sweep_n3"),
            ("directed", ["-treedirected"], TREE_STEPS_DIRECTED,
             "tree_sweep")):
        log(f"phase 17: tree-P3M main path ({label}) — app.main "
            f"{' '.join(base + extra)} -steps {steps}")
        t0 = time.perf_counter()
        (metrics, seen), got = counted(
            lambda: _run_app(base + extra + ["-steps", str(steps)], steps),
            ("tree_sweep", "tree_sweep_n3", "composite_tiles"))
        wall = time.perf_counter() - t0
        cfg = seen["config"]
        log(f"  rc 0, {steps} frames in {wall:.2f} s wall (under "
            f"torch.profiler), device launches {got}; "
            f"G={cfg.pm_grid_size}, pair budget {cfg.p3m_pair_budget}, "
            f"tree_half_force {cfg.tree_half_force}")
        if cfg.tree_half_force != (label == "n3"):
            fail(f"{label}: the run's config has tree_half_force="
                 f"{cfg.tree_half_force}")
        if got[wrapper] < steps:
            fail(f"{label}: the sweep kernel launched {got[wrapper]} "
                 f"times in {steps} frames")
        if got["composite_tiles"] < steps:
            fail(f"{label}: composite_tiles launched "
                 f"{got['composite_tiles']} times in {steps} frames")
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
        log(f"  ms/frame (CUDA events, median of {len(dev_frames)}, "
            f"profiled): {results[label]['frame_ms']:.2f}; simulate ms "
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
    bound = tree_bound_ms(name, lists, mhz)
    log(f"  {name}: {lists.pairs:,} listed block pairs of "
        f"{lists.sweep_block} = {pairs:.4e} pair interactions; kernel "
        f"{ms:.3f} ms, plain {plain_ms:.1f} ms; bound {bound:.3f} ms "
        f"({INSTR[name]} FP32 instructions a pair at {mhz:.0f} MHz) -> "
        f"{bound / ms:.1%} of it")
    item_log(name, lists)
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

    directed = ("tree_sweep", *POT)
    results, launches = {}, {}
    for label, argv, steps, every in DIAG_RUNS:
        full = argv + ["-novsync", "-nogui", "-steps", str(steps),
                       "-diagnostics", str(every)]
        log(f"phase 21: diagnostics main path ({label}) — app.main "
            f"{' '.join(full)}")
        t0 = time.perf_counter()
        (metrics, seen), got = counted(
            lambda: _run_app(full, steps, draw="-nodraw" not in argv),
            (*directed, "central_well"))
        wall = time.perf_counter() - t0
        g = metrics["gauges"]
        samples = steps // every
        log(f"  rc 0, {steps} frames in {wall:.2f} s wall (under "
            f"torch.profiler); device launches {got}; "
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
    (pot, dropped), got = counted(lambda: D.mesh_potential_only(
        pos, C.PARTICLE_MASS / N_TREE, C.SOFTENING_SQUARED, grid=grid,
        box=BOX, cutoff_cells=CUTOFF, pair_budget=budget, half_pairs=False,
        total_only=False), directed)
    log(f"  potential {float(pot):.9e}, dropped {dropped}, device launches "
        f"{got}")
    if dropped or got["tree_sweep_potential_only"] < 1:
        fail(f"{label}: dropped {dropped}, launches {got}")
    if not math.isfinite(float(pot)):
        fail(f"{label}: potential {float(pot)!r}")
    launches["potential_only"] = got
    return launches, results


# Phases 25-28: the live control surface, the single-device utilities and
# the p3m slot near field. Positions after a reassignment are held against
# a bare run of the same steps at the JAX property test's tolerance; the
# frame rendered on the CPU against the card's at the render tolerance.
MOVE_RTOL, MOVE_ATOL = 1e-5, 1e-3
RENDER_ATOL = 2e-5
N_RENDER_MOVE = 65_536
N_FUSED_MOVE = 262_144
N_SLOTS = 262_144
SLOT_GRID = 128          # r_c = 108, a near grid of 18 cells an axis
# phase 28's uniform cube: its side, inside the mesh's interior (G=128 on
# the 2048 box keeps particles within [-1000, 1000) on the mesh; P3M gives
# a particle outside it no far-field force, as the JAX package does)
SLOT_SPAN = 1800.0
SLOT_STEPS = 8           # phase 28's CLI frames (the timer skips 3)


def _move_app(n, width, height, fused=False):
    """A ParticlesApp on the card (adapter 0) for the moves of phase 25."""
    from multi_adapter_particles_torch.config import (
        AppConfig,
        RenderConfig,
        SimConfig,
    )
    from multi_adapter_particles_torch.runtime.orchestrator import (
        ParticlesApp,
    )

    return ParticlesApp(
        AppConfig(num_particles=n, vsync=False, gui=False),
        SimConfig(num_particles=n), RenderConfig(width=width, height=height),
        compute_adapter=0, render_adapter=0, fused=fused)


def _bare_positions(dev, n, steps):
    """The state after `steps` steps of a compute engine alone on the card,
    from the apps' seed."""
    from multi_adapter_particles_torch.config import SimConfig
    from multi_adapter_particles_torch.runtime.compute_engine import (
        ComputeEngine,
    )

    eng = ComputeEngine(SimConfig(num_particles=n), dev, seed=0)
    for _ in range(steps):
        eng.simulate()
    eng.wait_for_gpu()
    return eng.state.position


def _draw_ms(p) -> float:
    """One frame of `p` with the card drained after it (host ms)."""
    import torch

    t0 = time.perf_counter()
    p.draw()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _expect_device(label, adapter, kind):
    if adapter.device.type != kind:
        fail(f"{label}: role on {adapter.device}, expected {kind}")


def phase_reassign(dev):
    import statistics

    import torch

    from multi_adapter_particles_torch.runtime.controls import (
        apply_control,
        apply_key,
    )
    from multi_adapter_particles_torch.runtime.devices import (
        cpu_adapter_index,
    )

    cpu = cpu_adapter_index()
    out = {}
    log(f"phase 25: live reassignment and controls, split @{N_MAIN:,} "
        f"{WIDTH}x{HEIGHT}: compute H100 -> CPU (3 frames) -> H100, draw, "
        "extension, size and intensity")
    p = _move_app(N_MAIN, WIDTH, HEIGHT)
    steps = 0
    p.draw()
    apply_key(p, "c")
    p.draw()
    steps += 2
    _expect_device("after c", p.compute_adapter, "cpu")
    _expect_device("render after c", p.render_adapter, "cuda")
    cpu_frames = [_draw_ms(p) for _ in range(3)]
    steps += 3
    copy = [timed(lambda: p.render.copy_simulation_results(
        p.compute.positions))[1] for _ in range(3)]
    if p.render._local.device.type != "cuda":
        fail("the cross-adapter copy did not land on the card")
    apply_key(p, "c")
    p.draw()
    steps += 1
    _expect_device("after c c", p.compute_adapter, "cuda")
    apply_control(p, "draw", 0)
    p.draw()
    apply_control(p, "draw", 1)
    apply_key(p, "e")
    p.draw()
    if p.extension.enabled or p.compute.extension.stream() is not None:
        fail("the extension toggle did not reach the compute engine")
    apply_key(p, "e")
    p.draw()
    apply_key(p, "]")
    apply_key(p, "=")
    p.draw()
    steps += 4
    prio = p.extension.priority
    p.shutdown()
    n_moves = int(p.metrics.counters.get("reconfigurations", 0))
    if n_moves != 2:
        fail(f"{n_moves} reconfigurations, expected 2")
    if p.compute.get_fence_value() != steps:
        fail(f"fence {p.compute.get_fence_value()} after {steps} steps")
    got = p.compute.state.position
    err = check_close(f"positions after {steps} frames vs a bare run",
                      got, _bare_positions(dev, N_MAIN, steps), MOVE_RTOL,
                      MOVE_ATOL)
    out["split_4m"] = {
        "reconfig_ms": p.metrics.gauges["reconfig_ms"],
        "cpu_frame_ms": cpu_frames, "copy_ms": statistics.median(copy),
        "copy_bytes": N_MAIN * 16, "max_abs_err": err, "steps": steps,
        "size": p.app.particle_size, "intensity": p.app.particle_intensity,
        "stream_priority": prio}
    log(f"  drain + migrate ms (to the CPU, back): "
        f"{p.metrics.gauges['reconfig_ms']}; CPU-compute frame ms "
        f"{cpu_frames}; cross-adapter copy of {N_MAIN * 16 / 2**20:.0f} MiB "
        f"CPU -> H100 {statistics.median(copy):.3f} ms (median of 3); "
        f"compute stream priority {prio}")
    del p, got
    torch.cuda.empty_cache()

    log(f"  render role H100 -> CPU -> H100 @{N_RENDER_MOVE:,} 512x512")
    p = _move_app(N_RENDER_MOVE, 512, 512)
    p.draw()
    apply_key(p, "r")
    p.draw()
    _expect_device("render after r", p.render_adapter, "cpu")
    drawn = p._display_positions.clone()
    p.draw()
    cpu_frame = p.render.last_frame
    if cpu_frame.device.type != "cpu":
        fail("the moved render did not run on the CPU")
    rend = p._carry_renderer(p.render.config)
    want = rend.render_arrays(drawn, p.render.camera, p.app.particle_size,
                              p.app.particle_intensity,
                              num_draw=p.app.resolved_counts()[2]).frame
    frame_err = check_close("frame rendered on the CPU vs the H100's",
                            cpu_frame.to(dev), want, 0.0, RENDER_ATOL)
    apply_key(p, "r")
    p.draw()
    p.draw()
    _expect_device("render after r r", p.render_adapter, "cuda")
    p.shutdown()
    err = check_close("positions after 5 frames vs a bare run",
                      p.compute.state.position,
                      _bare_positions(dev, N_RENDER_MOVE, 5), MOVE_RTOL,
                      MOVE_ATOL)
    out["render_64k"] = {"reconfig_ms": p.metrics.gauges["reconfig_ms"],
                         "frame_err": frame_err, "max_abs_err": err}
    del p

    log(f"  fused @{N_FUSED_MOVE:,} 1280x720: both roles H100 -> CPU -> "
        "H100")
    p = _move_app(N_FUSED_MOVE, 1280, 720, fused=True)
    for _ in range(3):
        p.draw()
    if p.fused_engine.replays != 2:
        fail(f"fused: {p.fused_engine.replays} replays in 3 frames")
    apply_control(p, "computeadapter", cpu)
    apply_control(p, "renderadapter", cpu)
    p.draw()
    if p.fused_engine.device.type != "cpu":
        fail("the fused engine was not rebuilt on the CPU")
    cpu_fused = [_draw_ms(p) for _ in range(2)]
    apply_control(p, "computeadapter", 0)
    apply_control(p, "renderadapter", 0)
    p.draw()
    for _ in range(3):
        p.draw()
    graph = p.metrics.gauges.get("fused_graph")
    p.shutdown()
    if p.fused_engine.device.type != "cuda" or graph is not True:
        fail(f"fused back on the card: {p.fused_engine.device}, "
             f"fused_graph {graph}")
    err = check_close("fused positions after 10 frames vs a bare run",
                      p.compute.state.position,
                      _bare_positions(dev, N_FUSED_MOVE, 10), MOVE_RTOL,
                      MOVE_ATOL)
    out["fused_262k"] = {"reconfig_ms": p.metrics.gauges["reconfig_ms"],
                         "cpu_frame_ms": cpu_fused, "max_abs_err": err,
                         "fused_graph": graph}
    log(f"  fused moves: drain + rebuild + migrate ms "
        f"{p.metrics.gauges['reconfig_ms']}; CPU fused frame ms {cpu_fused};"
        f" fused_graph {graph} after the move back")
    del p
    torch.cuda.empty_cache()
    return out


def phase_interactive():
    import io

    from multi_adapter_particles_torch import app

    log("phase 26: -interactive through the CLI, a scripted key stream "
        "(c, c, SPACE, [, ], w, q) @262,144")
    seen = {}

    def on_exit(p):
        seen.update(frames=p.frame_count, compute=p.compute.device,
                    draw=p.draw_enabled, size=p.app.particle_size,
                    moves=p.metrics.counters.get("reconfigurations", 0),
                    ms=list(p.metrics.gauges.get("reconfig_ms", [])))

    t0 = time.perf_counter()
    rc = app.main(["-numparticles", "262144", "-steps", "100", "-novsync",
                   "-nogui", "-interactive"], on_exit=on_exit,
                  input_stream=io.StringIO("c\nc\n \n[\n]\nw\nq\n"))
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"-interactive returned {rc}")
    if seen["frames"] != 6 or seen["moves"] != 2:
        fail(f"-interactive: {seen['frames']} frames, {seen['moves']} "
             "reassignments (expected 6 and 2)")
    if seen["compute"].type != "cuda" or seen["draw"] or seen["size"] != 2.5:
        fail(f"-interactive ended with {seen}")
    log(f"  rc 0, 6 frames in {wall:.2f} s wall, 2 reassignments (drain + "
        f"migrate ms {seen['ms']}), draw off, size 2.5, compute on the card")
    return {"frames": 6, "reconfig_ms": seen["ms"], "wall_s": wall}


def _serve_check(root):
    """`-serve 0 -dashboard` as its own process: GET /state, POST a size,
    see it applied, stop it with SIGINT (rc 0) and find the page."""
    import signal
    import sys
    import urllib.request

    tmp = tempfile.mkdtemp()
    html = os.path.join(tmp, "dash.html")
    cmd = [sys.executable, "-m", "multi_adapter_particles_torch",
           "-numparticles", "262144", "-width", "512", "-height", "512",
           "-steps", "0", "-novsync", "-nogui", "-serve", "0",
           "-dashboard", html]
    proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        base = None
        t0 = time.perf_counter()
        while base is None and time.perf_counter() - t0 < 180:
            line = proc.stdout.readline()
            if not line:
                break
            if line.startswith("dashboard: http://"):
                base = line.split()[1].rstrip("/")
        if base is None:
            fail("-serve 0 printed no address")
        state = json.loads(urllib.request.urlopen(f"{base}/state",
                                                  timeout=30).read())
        size0 = next(c["value"] for c in state["controls"]
                     if c["name"] == "size")
        urllib.request.urlopen(urllib.request.Request(
            f"{base}/set", data=b"name=size&value=6.5", method="POST"),
            timeout=30).read()
        size = size0
        t1 = time.perf_counter()
        while size != 6.5 and time.perf_counter() - t1 < 60:
            time.sleep(0.2)
            state = json.loads(urllib.request.urlopen(f"{base}/state",
                                                      timeout=30).read())
            size = next(c["value"] for c in state["controls"]
                        if c["name"] == "size")
        if size != 6.5:
            fail(f"POST /set size=6.5 left particle_size at {size}")
        frames = state["metrics"]["counters"].get("frames", 0)
        proc.send_signal(signal.SIGINT)
        rest, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        fail(f"-serve run exited {proc.returncode}: {rest[-2000:]}")
    with open(html) as f:
        page = f.read()
    if "data:image/png;base64," not in page:
        fail("-dashboard wrote no frame")
    return {"size_before": size0, "size_after": size, "frames_seen": frames,
            "html_bytes": len(page)}


def phase_utilities(dev):
    import statistics

    import torch

    root = os.path.dirname(os.path.abspath(__file__))
    out = {}
    base = ["-novsync", "-nogui", "-numparticles", str(N_MAIN), "-width",
            str(WIDTH), "-height", str(HEIGHT)]
    log(f"phase 27: checkpoint, debug, trace, probe cache, dashboard @"
        f"{N_MAIN:,}")
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "state.npz")
        m1, _ = _run_app(base + ["-fused", "-steps", "20", "-checkpointevery",
                                 "10", "-checkpoint", ck], 20)
        m2, resumed = _run_app(base + ["-fused", "-steps", "10", "-resume",
                                       ck], 10)
        m3, whole = _run_app(base + ["-fused", "-steps", "30"], 30)
        if not torch.equal(resumed["position"], whole["position"]):
            fail("checkpoint at 20 + resume for 10 is not bitwise the "
                 "uninterrupted 30-frame fused run")
        writes = m1["counters"].get("checkpoint_writes")
        if writes != 3:
            fail(f"{writes} checkpoint writes, expected 3 (frames 10, 20, "
                 "exit)")
        out["checkpoint"] = {"write_ms": m1["gauges"]["checkpoint_write_ms"],
                             "read_ms": m2["gauges"]["checkpoint_read_ms"],
                             "bytes": os.path.getsize(ck)}
        log(f"  fused checkpoint every 10 over 20 frames + resume for 10: "
            f"bitwise the 30-frame run; write ms "
            f"{out['checkpoint']['write_ms']}, read ms "
            f"{out['checkpoint']['read_ms']:.1f} "
            f"({os.path.getsize(ck) / 2**20:.1f} MiB)")
        del resumed, whole
        torch.cuda.empty_cache()

        dbg = {}
        for label, extra in (("plain", []), ("debug", ["-debug"])):
            t0 = time.perf_counter()
            m, _ = _run_app(["-preset", "4m-fused", "-steps", "20",
                             "-nogui"] + extra, 20)
            dbg[label] = {"wall_s": time.perf_counter() - t0,
                          "device_frame_ms": statistics.median(
                              m["gauges"]["device_frame_ms"]),
                          "host_frame_ms": m["frame_ms"]}
        out["debug"] = dbg
        log(f"  -preset 4m-fused, 20 frames: {json.dumps(dbg)}")

        trace_dir = os.path.join(tmp, "trace")
        _run_app(base + ["-steps", "8", "-trace", trace_dir], 8)
        with open(os.path.join(trace_dir, "trace.json")) as f:
            trace = f.read()
        for name in ("central_well_kernel", "tile_rows_kernel",
                     "tile_fold_kernel"):
            if name not in trace:
                fail(f"-trace: {name} not in the trace")
        out["trace_mb"] = len(trace) / 2**20
        log(f"  -trace, 8 frames: {out['trace_mb']:.1f} MiB, names "
            "central_well_kernel, tile_rows_kernel and tile_fold_kernel")
        del trace

        cache = os.path.join(tmp, "probes.json")
        probe = []
        for _ in range(2):
            m, _ = _run_app(["-force", "p3m", "-p3mnear", "tree",
                             "-numparticles", str(N_TREE), "-width", "1024",
                             "-height", "1024", "-steps", "2", "-novsync",
                             "-nogui", "-probecache", cache], 2)
            probe.append(m["gauges"]["probe_s"])
        if not probe[1] < 0.1 * probe[0]:
            fail(f"warm probe {probe[1]:.3f} s is not under 10% of the "
                 f"cold {probe[0]:.3f} s")
        out["probe_s"] = {"cold": probe[0], "warm": probe[1]}
        log(f"  1M tree-P3M -probecache: probe_s cold {probe[0]:.3f}, warm "
            f"{probe[1]:.4f}")
    torch.cuda.empty_cache()
    out["serve"] = _serve_check(root)
    log(f"  -serve 0 -dashboard (own process): {json.dumps(out['serve'])}")
    return out


def phase_slots(dev):
    import contextlib
    import io

    import torch

    from multi_adapter_particles_torch import constants as C
    from multi_adapter_particles_torch.config import SimConfig
    from multi_adapter_particles_torch.ops import p3m, treeforce
    from multi_adapter_particles_torch.ops.allpairs import all_pairs_accel

    log(f"phase 28: the p3m slot near field, a uniform cube of side "
        f"{SLOT_SPAN:g} with {N_SLOTS:,} particles (G={SLOT_GRID}, box "
        f"{BOX:g})")
    gen = torch.Generator(device=dev).manual_seed(28)
    pos = torch.zeros((4, N_SLOTS), device=dev)
    pos[:3] = (torch.rand((3, N_SLOTS), generator=gen, device=dev) - 0.5) \
        * SLOT_SPAN
    host = pos.cpu().numpy()
    r_c, gn = p3m.near_grid_for(SLOT_GRID, BOX, CUTOFF)
    cap = 1
    while p3m.host_overflow_count(host, SLOT_GRID, BOX, CUTOFF, cap):
        cap *= 2
    lo = cap // 2
    while lo + 1 < cap:   # the least capacity with no overflow
        mid = (lo + cap) // 2
        if p3m.host_overflow_count(host, SLOT_GRID, BOX, CUTOFF, mid):
            lo = mid
        else:
            cap = mid
    g = C.PARTICLE_MASS / N_SLOTS
    kw = dict(grid=SLOT_GRID, box=BOX, g_const=g,
              softening_squared=C.SOFTENING_SQUARED, cutoff_cells=CUTOFF)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    (a, overflow), total_ms = timed(lambda: p3m.p3m_accel_with_overflow(
        pos, capacity=cap, near_mode="slots", **kw))
    peak = (torch.cuda.max_memory_allocated() - base_mem) / 2**30
    if int(overflow) != 0:
        fail(f"slots at capacity {cap}: overflow {int(overflow)}")
    sweep_ms = time_ms(lambda: p3m.near_field_correction(
        pos, BOX, g, C.SOFTENING_SQUARED, r_c, gn, cap), reps=3, warmup=1)
    accel_ms = time_ms(lambda: p3m.p3m_accel_with_overflow(
        pos, capacity=cap, near_mode="slots", **kw), reps=3, warmup=1)
    idx = torch.linspace(0, N_SLOTS - 1, TREE_SAMPLE, device=dev).long()
    exact = all_pairs_accel(pos[:, idx].contiguous(), sources=pos,
                            **_ap_phys(N_SLOTS))[:3]
    torch.cuda.synchronize()
    scale = float(exact.abs().max())
    rms = float(((a[:, idx] - exact) ** 2).mean().sqrt()) / scale
    log(f"  capacity {cap} (the least with no overflow), near grid {gn}: "
        f"RMS vs the exact sum on {TREE_SAMPLE:,} targets {rms:.4%} of "
        f"max|a| (limit 1%); sweep {sweep_ms:.3f} ms, whole accel "
        f"{accel_ms:.3f} ms (first call {total_ms:.1f} ms); peak memory "
        f"{peak:.3f} GiB above the scene")
    if not rms < 0.01:
        fail(f"slots RMS error {rms:.4%} of max|a|")
    coarse, sub, _ = treeforce.host_tree_counts(host, BOX, r_c, gn)
    budget = int(coarse * treeforce.PAIR_HEADROOM) + 1
    sub_budget = None if sub is None else int(
        sub * treeforce.PAIR_HEADROOM) + 2
    t, dropped = p3m.p3m_accel_with_overflow(
        pos, near_mode="tree", pair_budget=budget,
        sub_pair_budget=sub_budget, half_force=True, **kw)
    if dropped:
        fail(f"tree: {dropped} block pairs dropped")
    vs_tree = float((a - t).abs().max()) / float(t.abs().max())
    rms_tree = float(((a - t) ** 2).mean().sqrt()) / float(t.abs().max())
    log(f"  slots vs tree on the whole scene: max {vs_tree:.3e}, RMS "
        f"{rms_tree:.3e} of max|a| (pairs past r_c inside the 27 cells)")
    if not rms_tree < 0.01:
        fail(f"slots vs tree RMS {rms_tree:.3e} of max|a|")
    out = {"capacity": cap, "near_grid": gn, "rms_vs_exact": rms,
           "sweep_ms": sweep_ms, "accel_ms": accel_ms, "peak_gib": peak,
           "vs_tree_max": vs_tree, "vs_tree_rms": rms_tree}
    del a, t, exact
    torch.cuda.empty_cache()

    argv = ["-force", "p3m", "-p3mnear", "slots", "-numparticles",
            str(N_SLOTS), "-novsync", "-nogui", "-width", "512", "-height",
            "512"]
    log(f"  CLI -force p3m -p3mnear slots @{N_SLOTS:,}, the demo init, "
        "capacity 64")
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            m, _ = _run_app(argv + ["-steps", "1"], 1)
    finally:
        print(printed.getvalue(), end="", flush=True)
    text = printed.getvalue()
    pos0 = _ap_state(dev, N_SLOTS).cpu().numpy()
    ov = p3m.host_overflow_count(pos0, SimConfig.pm_grid_size, BOX, CUTOFF,
                                 SimConfig.p3m_capacity)
    if f"p3m: {ov} of {N_SLOTS} particles exceed" not in text:
        fail("the slot overflow warning was not printed")
    if m["gauges"].get("p3m_overflow") != ov:
        fail(f"p3m_overflow {m['gauges'].get('p3m_overflow')} != the host "
             f"count {ov}")
    fused = _fused_vs_split("slots 262K", argv, SLOT_STEPS, True)
    out["cli"] = {"overflow": ov, "fused_graph": True,
                  "fused_frame_ms": fused["frame_ms"],
                  "split_frame_ms": fused["split_frame_ms"]}
    log(f"  p3m_overflow {ov} = host_overflow_count; split and fused "
        f"bitwise, fused_graph True; frame ms fused {fused['frame_ms']}, "
        f"split {fused['split_frame_ms']}")
    torch.cuda.empty_cache()
    return out


# -- phase 4c (mesh): the golden corpus' adversarial scenes ------------------
# (scene, size, intensity, columns it starts before the first shard
# boundary at column 128), as tests/test_torch_render_corpus.py builds them
def _corpus_scenes():
    import numpy as np

    rng = np.random.default_rng(7)
    stacks = rng.uniform(-200, 200, size=(6, 3)).astype(np.float32)
    coincident = np.zeros((48, 4), np.float32)
    coincident[:, :3] = np.repeat(stacks, 8, axis=0)
    coincident[:, 3] = rng.uniform(0, 12, size=48).astype(np.float32)
    gx, gy = np.meshgrid(np.linspace(-240, 240, 9, dtype=np.float32),
                         np.linspace(-120, 120, 5, dtype=np.float32))
    plane = np.zeros((gx.size, 4), np.float32)
    plane[:, 0], plane[:, 1] = gx.ravel(), gy.ravel()
    plane[:, 3] = np.arange(gx.size, dtype=np.float32) % 13
    giant = np.zeros((12, 4), np.float32)
    giant[:, 3] = np.arange(12, dtype=np.float32)
    giant[:4, :3] = [(0.0, 0.0, 2000.0), (300.0, 100.0, 1700.0),
                     (0.0, 0.0, 1400.0), (-350.0, -160.0, 1350.0)]
    giant[4:, :3] = np.random.default_rng(21).uniform(
        -300, 300, size=(8, 3)).astype(np.float32)
    return {"coincident": (coincident, 6.0, 0.5, 28),
            "equal_depth": (plane, 9.0, 0.8, 20),
            "behind_and_giant": (giant, 8.0, 0.4, 6)}


def phase_tiles_mesh(dev):
    """The corpus' adversarial scenes (coincident stacks, one depth plane,
    culled and giant sprites) through `Renderer.render_mesh` at D = 2 and
    4 shards of the card, straddling a shard boundary: the sort and
    composite_tiles kernels bitwise the plain path."""
    import numpy as np
    import torch

    from multi_adapter_particles_torch.config import RenderConfig
    from multi_adapter_particles_torch.models.state import (
        PAD_POSITION,
        ParticleState,
    )
    from multi_adapter_particles_torch.ops.composite import (
        composite_tiles_plain,
    )
    from multi_adapter_particles_torch.ops.sortkv import sort_kv_stable_plain
    from multi_adapter_particles_torch.parallel import make_mesh
    from multi_adapter_particles_torch.parallel.mesh import shard
    from multi_adapter_particles_torch.render.camera import Camera
    from multi_adapter_particles_torch.render.renderer import Renderer

    log("phase 4c (mesh): the corpus' adversarial scenes through "
        "render_mesh at D = 2 and 4 shards of the card, kernels vs plain")
    for name, (scene, size, intensity, before) in _corpus_scenes().items():
        for d in (2, 4):
            full = np.full((128 * d, 4), PAD_POSITION, np.float32)
            full[:, 3] = 0.0
            full[128 - before:128 - before + scene.shape[0]] = scene
            st = ParticleState.from_aos(full, np.zeros((128 * d, 3),
                                                       np.float32),
                                        device=dev)
            mesh = make_mesh([dev] * d)
            sh = shard(st.position, mesh)
            outs = []
            for plain in (False, True):
                r = Renderer(RenderConfig(width=256, height=128))
                if plain:
                    r.composite, r.sort = (composite_tiles_plain,
                                           sort_kv_stable_plain)
                out = r.render_mesh(sh, Camera(), size, intensity, mesh)
                if r.raise_dup_for(out):
                    out = r.render_mesh(sh, Camera(), size, intensity, mesh)
                outs.append(out)
            torch.cuda.synchronize()
            k, p = outs
            if not torch.equal(k.frame, p.frame):
                fail(f"render_mesh {name} D={d}: the kernels' frame differs "
                     f"from the plain path's ({int((k.frame != p.frame).sum())}"
                     " values)")
            ki, pi = [tuple(int(getattr(o, f)) for f in (
                "truncated", "span_y", "span_x")) for o in outs]
            if ki != pi or ki[0] != 0:
                fail(f"render_mesh {name} D={d}: (truncated, span_y, span_x)"
                     f" {ki} vs plain {pi}")
            if float(k.frame.max()) <= 0.0:
                fail(f"render_mesh {name} D={d}: black frame")
            log(f"  {name}, D={d}: bitwise the plain path, spans "
                f"({ki[1]}, {ki[2]}), max {float(k.frame.max()):.4f}")


# -- phase 29: the one-process mesh -------------------------------------------
N_MESH = 1_048_576         # -preset 1m-mesh8: all_pairs on 8 shards
MESH_STEPS = 3             # the preset's 20 steps, cut to 3
MESH_FRAMES = 8            # the 4M central-well runs (the timer skips 3)
N_MESH_RESCALE = 262_144   # live rescale 4 -> 2 -> 1 -> 4
N_MESH_TREE = 1_048_576    # p3m tree on 4 shards (G = 192, B = 512)
MESH_TREE_GRID = 192
MESH_BUDGET_S = 60.0       # the phase's wall-clock budget


def _mesh_adapters(d):
    """d logical shards of cuda:0, then the CPU: the adapter list phase 29
    swaps in for `devices.enumerate_adapters` (one card holds every
    shard)."""
    import torch

    from multi_adapter_particles_torch.runtime import devices

    name = torch.cuda.get_device_name(0)
    gpu = torch.device("cuda", 0)
    ads = [devices.AdapterInfo(i, gpu, "gpu", f"{name} (shard {i})")
           for i in range(d)]
    return ads + [devices.AdapterInfo(d, torch.device("cpu"), "cpu",
                                      "cpu (id 0)")]


class _Shards:
    """Within: `devices.enumerate_adapters()` lists d shards of the card."""

    def __init__(self, d):
        self.d = d

    def __enter__(self):
        from multi_adapter_particles_torch.runtime import devices

        self.old = devices.enumerate_adapters
        devices.enumerate_adapters = lambda: _mesh_adapters(self.d)

    def __exit__(self, *exc):
        from multi_adapter_particles_torch.runtime import devices

        devices.enumerate_adapters = self.old


def _mesh_init(dev, n):
    from multi_adapter_particles_torch.models import init as pinit

    import torch

    return pinit.initialize_particles_device(
        n, torch.Generator(device=dev).manual_seed(0), device=dev)


def _equal_states(label, got, want):
    import torch

    for name in ("position", "velocity"):
        a, b = getattr(got, name), getattr(want, name)
        if not torch.equal(a, b):
            fail(f"{label}: {name} differs ({int((a != b).sum())} values)")


def _mesh_preset(dev):
    """-preset 1m-mesh8 (cut to MESH_STEPS) vs the one-device -rectpair
    run, bitwise; the step and the rectangle kernel timed at the shard
    shapes; the ring schedule one step against the directed step."""
    import torch

    from multi_adapter_particles_torch.config import SimConfig
    from multi_adapter_particles_torch.models import integrator
    from multi_adapter_particles_torch.ops.allpairs import all_pairs_accel
    from multi_adapter_particles_torch.parallel import (
        make_mesh,
        make_sharded_step,
        shard_state,
    )
    from multi_adapter_particles_torch.parallel import mesh as M

    size = ["-width", str(WIDTH), "-height", str(HEIGHT)]
    with _Shards(8):
        (metrics, seen), launches = counted(lambda: _run_app(
            ["-preset", "1m-mesh8", "-numparticles", str(N_MESH), "-steps",
             str(MESH_STEPS)] + size, MESH_STEPS))
    log(f"  -preset 1m-mesh8 ({N_MESH:,} all_pairs, 8 shards, bit-stable), "
        f"depth cut to {MESH_STEPS} steps from 20: "
        f"{metrics['gauges']['mode_banner']!r}, device launches {launches}")
    if launches["all_pairs_rect"] != 8 * MESH_STEPS:
        fail(f"the mesh launched the rectangle kernel "
             f"{launches['all_pairs_rect']} times, not 8 a step")
    if launches["all_pairs_half"] or launches["central_well"]:
        fail("the mesh step ran another force kernel")
    for name in ("sort_kv_stable", "composite_tiles"):
        if launches[name] < MESH_STEPS:
            fail(f"{name}: {launches[name]} launches in {MESH_STEPS} frames")
    _, one = _run_app(["-force", "all_pairs", "-rectpair", "-numparticles",
                       str(N_MESH), "-steps", str(MESH_STEPS), "-nogui",
                       "-novsync"] + size, MESH_STEPS)
    if not torch.equal(seen["position"], one["position"]):
        fail("the 8-shard trajectory is not bitwise the one-device -rectpair "
             "run's")
    log(f"  positions after {MESH_STEPS} steps: bitwise the one-device "
        "-rectpair run's")

    cfg = SimConfig(num_particles=N_MESH, force_model="all_pairs",
                    all_pairs_half=False)
    st = _mesh_init(dev, N_MESH)
    mesh = make_mesh([dev] * 8)
    sst = shard_state(st, mesh)
    mstep = make_sharded_step(cfg, mesh)
    spare = sst.empty_like()
    ostep = integrator.make_step(cfg)
    out1 = st.empty_like()
    mesh_ms = time_ms(lambda: mstep(sst, out=spare), reps=2, warmup=1)
    one_ms = time_ms(lambda: ostep(st, out=out1), reps=2, warmup=1)
    shards = list(sst.position.shards)
    gather_ms = time_ms(lambda: M.over_groups(mesh, None, M.all_gather,
                                              shards, dim=1), reps=10)
    log(f"  step ms (CUDA events): mesh {mesh_ms:.3f} (the gather + 8 "
        f"rectangle launches of 131,072 x {N_MESH:,} + Euler), one device "
        f"-rectpair {one_ms:.3f}; the all-gather alone {gather_ms:.4f}")

    phys = _ap_phys(N_MESH)
    t = shards[0]
    mhz = busy_clock_mhz(lambda: all_pairs_accel(t, sources=st.position,
                                                 **phys), reps=4)
    shapes = {}
    for src, reps in ((st.position, 3), (t, 10)):
        label = f"{t.shape[1]}x{src.shape[1]}"
        ms = time_ms(lambda: all_pairs_accel(t, sources=src, **phys),
                     reps=reps)
        bound = issue_bound_ms(t.shape[1] * src.shape[1]
                               * INSTR["all_pairs_rect"], mhz)
        shapes[label] = {"ms": ms, "bound_ms": bound, "mhz": mhz}
        log(f"  rectangle kernel at the shard shape {label}: {ms:.4f} ms, "
            f"bound {bound:.4f} ms (FP32 issue, {mhz:.0f} MHz) -> "
            f"{bound / ms:.1%} of it")

    ring = make_sharded_step(cfg, mesh, bit_stable=False)
    got = ring(sst).gather(dev)
    want = ostep(st)
    torch.cuda.synchronize()
    check_close("ring (bit_stable=False) vs one device, positions",
                got.position, want.position, 1e-4, 1e-3)
    check_close("ring vs one device, velocities", got.velocity,
                want.velocity, 1e-4, 1e-3)
    return {"mesh_step_ms": mesh_ms, "one_device_step_ms": one_ms,
            "gather_ms": gather_ms, "rect": shapes,
            "launches": launches}, seen["position"]


def _mesh_render(dev):
    """4M central well at 1024^2 on 4 shards: -shardrender and the gather
    path, each frame and state bitwise the one-device split run's."""
    import statistics

    import torch

    argv = ["-numparticles", str(N_MAIN), "-steps", str(MESH_FRAMES),
            "-novsync", "-nogui", "-width", str(WIDTH), "-height",
            str(HEIGHT)]
    runs, counts = {}, {}
    for label, extra in (("sharded", ["-meshdevices", "4", "-shardrender"]),
                         ("gather", ["-meshdevices", "4"]), ("one", [])):
        with _Shards(4):
            runs[label], counts[label] = counted(
                lambda: _run_app(argv + extra, MESH_FRAMES))
    ms = {k: statistics.median(m["gauges"]["device_frame_ms"])
          for k, (m, _) in runs.items()}
    for label in ("sharded", "gather"):
        got, want = runs[label][1], runs["one"][1]
        if not torch.equal(got["position"], want["position"]):
            fail(f"4M central well, {label} mesh: state differs")
        if not torch.equal(got["frame"], want["frame"]):
            fail(f"4M central well, {label} mesh: frame differs from the "
                 "one-device split frame")
        c = counts[label]
        if c["central_well"] != 4 * MESH_FRAMES:
            fail(f"{label}: central-well kernel launched {c['central_well']}"
                 f" times, not 4 a frame")
        if not (c["sort_kv_stable"] == c["composite_tiles"]
                >= 4 * MESH_FRAMES):
            fail(f"{label}: sort / composite_tiles launches {c}")
    log(f"  4M central well, 1024^2, 4 shards: -shardrender and the gather "
        f"path each bitwise the one-device split run (frame and state) "
        f"after {MESH_FRAMES} frames; frame ms (CUDA events, median): "
        f"sharded {ms['sharded']:.3f}, gather {ms['gather']:.3f}, one "
        f"device {ms['one']:.3f} (under torch.profiler); device launches "
        f"{counts['sharded']}")
    return {"frame_ms": ms, "launches": counts["sharded"]}


def _mesh_forces(dev):
    """pm_grid (dist_fft) at 4M and the p3m tree at 1M on 4 shards, one
    step each, against the one-device step; `dropped` bitwise."""
    from multi_adapter_particles_torch.config import SimConfig
    from multi_adapter_particles_torch.models import integrator
    from multi_adapter_particles_torch.ops import p3m
    from multi_adapter_particles_torch.parallel import (
        make_mesh,
        make_sharded_step,
        shard_state,
    )

    import torch

    mesh = make_mesh([dev] * 4)
    pm_cfg = SimConfig(num_particles=N_MAIN, force_model="pm_grid",
                       pm_grid_size=PM_GRID, pm_distributed_fft=True)
    st = _mesh_init(dev, N_MAIN)
    want = integrator.make_step(pm_cfg)(st)
    step = make_sharded_step(pm_cfg, mesh)
    got, pm_ms = timed(lambda: step(shard_state(st, mesh)))
    got = got.gather(dev)
    check_close(f"pm_grid {N_MAIN:,} G={PM_GRID}, dist_fft on 4 shards vs one"
                " device, positions", got.position, want.position, 1e-5, 1e-3)
    del st, want, got
    torch.cuda.empty_cache()

    tcfg = SimConfig(num_particles=N_MESH_TREE, force_model="p3m",
                     p3m_near_mode="tree", pm_grid_size=MESH_TREE_GRID,
                     tree_half_force=False)
    st = _mesh_init(dev, N_MESH_TREE)
    _, dropped = p3m.p3m_accel_with_overflow(
        st.position, grid=MESH_TREE_GRID, box=tcfg.pm_box,
        g_const=tcfg.mass * tcfg.interaction_scale,
        softening_squared=tcfg.softening_squared,
        cutoff_cells=tcfg.p3m_cutoff_cells, near_mode="tree")
    want = integrator.make_step(tcfg)(st)
    step = make_sharded_step(tcfg, mesh)
    (got, tree_ms), sweeps = counted(
        lambda: timed(lambda: step(shard_state(st, mesh))), ["tree_sweep"])
    sweeps = sweeps["tree_sweep"]
    got = got.gather(dev)
    if sweeps != 4:
        fail(f"p3m tree on 4 shards: {sweeps} directed sweeps, not one a "
             "shard")
    if step.overflow != dropped:
        fail(f"p3m tree on 4 shards: dropped {step.overflow}, one device "
             f"{dropped}")
    check_close(f"p3m tree {N_MESH_TREE:,} G={MESH_TREE_GRID} on 4 shards vs"
                " the one-device directed step, positions", got.position,
                want.position, 1e-5, 1e-3)
    dv = (got.velocity - want.velocity).double()
    rms = float(dv.pow(2).mean().sqrt()) / float(
        (want.velocity - st.velocity).abs().max())
    log(f"  p3m tree: dropped {dropped} on every shard and on one device; "
        f"velocity RMS difference {rms:.3e} of the step's max |dv| (gate "
        "1%, the JAX suite's P3M RMS gate); "
        f"step ms: pm_grid {pm_ms:.2f}, p3m tree {tree_ms:.2f} (first "
        "call, host walk included)")
    if not rms < 0.01:  # the JAX suite's P3M RMS gate, 1%
        fail(f"p3m tree on 4 shards: RMS {rms:.3e} of the step's max |dv|")
    return {"pm_step_ms": pm_ms, "tree_step_ms": tree_ms,
            "dropped": int(dropped), "tree_rms": rms}


def _mesh_rescale(dev):
    """All-pairs 262,144 (bit-stable) through the meshdevices control 4 ->
    2 -> 1 -> 4, bitwise a bare one-device run; drain + reshard ms."""
    from multi_adapter_particles_torch.config import (
        AppConfig,
        RenderConfig,
        SimConfig,
    )
    from multi_adapter_particles_torch.runtime.compute_engine import (
        ComputeEngine,
    )
    from multi_adapter_particles_torch.runtime.controls import apply_control
    from multi_adapter_particles_torch.runtime.orchestrator import (
        ParticlesApp,
    )

    cfg = SimConfig(num_particles=N_MESH_RESCALE, force_model="all_pairs",
                    all_pairs_half=False)
    with _Shards(4):
        app = ParticlesApp(
            AppConfig(num_particles=N_MESH_RESCALE, vsync=False, gui=False),
            cfg, RenderConfig(width=512, height=512), compute_adapter=0,
            mesh_devices=4)
        ref = ComputeEngine(cfg, dev, seed=0)
        app.draw()
        ref.simulate()
        for k in (2, 1, 4):
            apply_control(app, "meshdevices", k)
            app.draw()
            ref.simulate()
        app.shutdown()
    if app.compute.mesh.size != 4:
        fail("the rescale did not end on 4 shards")
    _equal_states("live rescale 4 -> 2 -> 1 -> 4", app.compute.state,
                  ref.state)
    ms = app.metrics.gauges["reconfig_ms"]
    log(f"  live rescale 4 -> 2 -> 1 -> 4 @{N_MESH_RESCALE:,} all_pairs: "
        f"bitwise a bare one-device run after 4 steps; drain + reshard ms "
        + ", ".join(f"{x:.2f}" for x in ms))
    return {"reconfig_ms": ms}


def phase_mesh(dev):
    import torch

    t0 = time.perf_counter()
    log("phase 29: the one-process mesh — D logical shards of cuda:0 (one "
        "card holds every shard; no mesh over distinct GPUs is measured)")
    out = {}
    out["preset"], position = _mesh_preset(dev)
    torch.cuda.empty_cache()
    out["render"] = _mesh_render(dev)
    torch.cuda.empty_cache()
    out["forces"] = _mesh_forces(dev)
    torch.cuda.empty_cache()
    out["rescale"] = _mesh_rescale(dev)
    wall = time.perf_counter() - t0
    out["wall_s"] = wall
    log(f"  phase 29: {wall:.1f} s wall (budget {MESH_BUDGET_S:.0f} s)")
    if wall > MESH_BUDGET_S:
        fail(f"phase 29 took {wall:.1f} s, over its {MESH_BUDGET_S:.0f} s")
    return out, position


# -- phase 30: a process group on the one card --------------------------------
POD_BUDGET_S = 60.0        # the phase's wall-clock budget
POD_TIMEOUT_S = 50         # each spawn of workers
POD_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def _pod(world: int, shards: int, args) -> dict:
    """`world` processes of `tools/pod_worker.py`, `shards` shards of
    cuda:0 each; fails unless every one exits 0 with BOOTSTRAP_OK. Returns
    the primary's POD_RESULT."""
    import socket
    import sys

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k not in POD_ENV}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "multi_adapter_particles_torch.tools.pod_worker",
         str(port), str(rank), str(world), "--shards", str(shards),
         "--device", "cuda:0", *args], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=POD_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        fail(f"pod workers ({world} x {shards}) passed {POD_TIMEOUT_S} s:\n"
             + "\n".join(o[-2000:] for o in outs))
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or "BOOTSTRAP_OK" not in out:
            fail(f"pod worker {rank} of {world} exited {p.returncode}:\n"
                 f"{out[-4000:]}")
    line = [x for x in outs[0].splitlines() if x.startswith("POD_RESULT ")]
    return json.loads(line[-1][len("POD_RESULT "):])


def phase_pod(position_1m):
    """2 processes x 4 shards of cuda:0 (gloo, staged through host memory):
    -preset 1m-mesh8's bit-stable step for MESH_STEPS steps bitwise phase
    29's one-process positions (`position_1m`), the 4M central well
    rendered across the processes bitwise the one-process render_mesh; 4
    processes x 1 shard: pm_grid dist_fft at 4M, G = PM_GRID, within rtol
    1e-5 / atol 1e-3 of one device. Times are time-sliced across the
    processes: logged, gated on nothing."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    log("phase 30: a process group on the one card — 2 processes x 4 shards "
        "and 4 x 1 of cuda:0 (`tools/pod_worker.py`; NCCL over distinct "
        "cards is not measured)")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "positions.npy")
        two = _pod(2, 4, ["--only", "allpairs,render", "--n", str(N_MESH),
                          "--steps", str(MESH_STEPS), "--render-n",
                          str(N_MAIN), "--width", str(WIDTH), "--height",
                          str(HEIGHT), "--out", out])
        got = torch.from_numpy(np.load(out))
    if not torch.equal(got, position_1m.cpu()):
        fail("the 2-process mesh's all-pairs positions are not bitwise "
             "phase 29's one-process -preset 1m-mesh8 run's")
    log(f"  backend {two['backend']}: {two['reason']}")
    ap, rd = two["allpairs"], two["render"]
    log(f"  all-pairs {N_MESH:,} on 2 x 4 shards, {MESH_STEPS} steps: "
        f"bitwise the one-device -rectpair run (in the worker) and phase "
        f"29's -preset 1m-mesh8 positions; step {ap['step_ms']:.1f} ms, "
        f"process all-gather {ap['gather_ms']:.2f} ms (host clock, "
        f"time-sliced)")
    log(f"  central well {N_MAIN:,} rendered at {WIDTH}x{HEIGHT} across the "
        f"2 processes: bitwise the one-process render_mesh (8 shards), "
        f"{rd['vs_one_device_max_err']:.3e} from one device; frame "
        f"{rd['frame_ms']:.1f} ms (host clock, time-sliced, profiled); the "
        f"primary's device launches on its 4 shards: all-pairs "
        f"{ap['launches']}, render {rd['launches']}")
    ap_n, rd_n = (kernel_counts(x["launches"], ("all_pairs_rect",
                                                "central_well",
                                                "sort_kv_stable",
                                                "composite_tiles"))
                  for x in (ap, rd))
    if ap_n["all_pairs_rect"] != 4 * MESH_STEPS:
        fail(f"all-pairs: the primary's 4 shards launched the rectangle "
             f"kernel {ap_n['all_pairs_rect']} times in {MESH_STEPS} steps, "
             "not 4 a step")
    if rd_n["central_well"] != 4 or not (
            rd_n["sort_kv_stable"] == rd_n["composite_tiles"] >= 4):
        fail(f"render: the primary's 4 shards launched {rd_n}")
    four = _pod(4, 1, ["--only", "pm", "--pm-n", str(N_MAIN), "--pm-grid",
                       str(PM_GRID)])
    log(f"  pm_grid {N_MAIN:,} G={PM_GRID} dist_fft on 4 processes x 1 shard:"
        f" max abs err {four['pm']['max_abs_err']:.3e} vs one device (rtol "
        f"1e-5, atol 1e-3); step {four['pm']['step_ms']:.1f} ms (host "
        "clock, time-sliced)")
    wall = time.perf_counter() - t0
    log(f"  phase 30: {wall:.1f} s wall (budget {POD_BUDGET_S:.0f} s)")
    if wall > POD_BUDGET_S:
        fail(f"phase 30 took {wall:.1f} s, over its {POD_BUDGET_S:.0f} s")
    return {"two": two, "four": four, "wall_s": wall}


# -- phase 31: host init at the default scene ---------------------------------
HOST_BUDGET_S = 30.0
HOST_STEPS = 40


def phase_host_init(dev):
    """The native init tiers at 4,194,304 (host ms, one thread and every
    core), bitwise the port's oracle at 512, the upload, HOST_STEPS
    central-well kernel steps each against its plain twin, one frame."""
    import numpy as np
    import torch

    from multi_adapter_particles_torch import constants as C
    from multi_adapter_particles_torch.config import RenderConfig
    from multi_adapter_particles_torch.models import init as pinit
    from multi_adapter_particles_torch.models import oracle
    from multi_adapter_particles_torch.native import fastinit
    from multi_adapter_particles_torch.ops.central_well import (
        central_well_step,
        central_well_step_plain,
    )
    from multi_adapter_particles_torch.render.camera import Camera
    from multi_adapter_particles_torch.render.renderer import Renderer

    t0 = time.perf_counter()
    cores = os.cpu_count() or 1
    log(f"phase 31: host init tiers at {N_MAIN:,} (native, g++ at first use)"
        f", {cores} host cores")
    _, build_ms = _host_ms(lambda: fastinit.initialize_particles(
        8, variant="scalar"))
    ms = {}
    for variant in ("scalar", "simd"):
        for chunks in (1, cores):
            _, ms[f"{variant}/{chunks}"] = _host_ms(
                lambda: fastinit.initialize_particles(
                    N_MAIN, variant=variant, seed=0, chunks=chunks))
        a = fastinit.initialize_particles(512, variant=variant, seed=7)
        b = oracle.initialize_particles(512, variant=variant, seed=7)
        if not all(np.array_equal(x, y) for x, y in zip(a, b)):
            fail(f"native {variant} is not bitwise the oracle at 512")
    log(f"  native build + first call {build_ms:.0f} ms; host ms at "
        f"{N_MAIN:,} (variant/chunks): " + ", ".join(
            f"{k} {v:.1f}" for k, v in ms.items())
        + "; scalar and simd bitwise the port's oracle at 512 (chunks 1)")
    st, up_ms = _host_ms(lambda: pinit.initialize_particles_host(
        N_MAIN, variant="scalar", seed=0, device=dev))
    phys = dict(dt=C.TIMESTEP, damping=C.DAMPING, mass=C.PARTICLE_MASS,
                softening_squared=C.SOFTENING_SQUARED)
    p, v = st.position, st.velocity
    err = 0.0

    def steps():
        nonlocal p, v, err
        for _ in range(HOST_STEPS):
            kp, kv = central_well_step(p, v, **phys)
            pp, pv = central_well_step_plain(p, v, **phys)
            for got, want in ((kp, pp), (kv, pv)):
                e = (got - want).abs()
                if bool((e > 2e-5 + 2e-5 * want.abs()).any()):
                    fail(f"central well on the host-init scene: out of rtol "
                         f"/ atol 2e-5 (max abs err {float(e.max()):.3e})")
                err = max(err, float(e.max()))
            p, v = kp, kv

    _, launches = counted(steps, ["central_well"])
    if launches["central_well"] != HOST_STEPS:
        fail(f"{launches['central_well']} central-well launches, not "
             f"{HOST_STEPS}")
    frame = Renderer(RenderConfig(width=WIDTH, height=HEIGHT)).render(
        p, Camera(), C.INITIAL_PARTICLE_SIZE, C.INITIAL_PARTICLE_INTENSITY)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(frame).all()) or float(frame.max()) <= 0.0:
        fail("the host-init scene's frame is empty or not finite")
    wall = time.perf_counter() - t0
    log(f"  initialize_particles_host(scalar) + upload to {dev}: "
        f"{up_ms:.1f} ms; {HOST_STEPS} central-well kernel steps each "
        f"within 2e-5 of the twin (max abs err {err:.3e}); {WIDTH}x{HEIGHT}"
        f" frame finite, max {float(frame.max()):.4f}; {wall:.1f} s wall "
        f"(budget {HOST_BUDGET_S:.0f} s)")
    if wall > HOST_BUDGET_S:
        fail(f"phase 31 took {wall:.1f} s, over its {HOST_BUDGET_S:.0f} s")
    return {"build_ms": build_ms, "host_ms": ms, "upload_ms": up_ms,
            "max_abs_err": err, "wall_s": wall}


def _host_ms(fn):
    """(fn(), host-clock ms, the device drained after)."""
    import torch

    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def main() -> int:
    phase_device()
    import torch

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    cw = phase_central_well(dev)
    comp, main_call = phase_composite(dev)
    tiles = phase_tiles(dev, main_call)
    del main_call
    binning = phase_binning(dev)
    torch.cuda.empty_cache()
    phase_tiles_mesh(dev)
    torch.cuda.empty_cache()
    sort, gather_args = phase_sort(dev)
    gather = phase_gather(dev, gather_args)
    del gather_args
    torch.cuda.empty_cache()
    launches, seen, frame = phase_main_path(dev)
    split_4m = {"position": seen["position"], "frame": seen["frame"]}
    frame_err, frame["render_launches"] = phase_full_frame(seen)
    del seen
    torch.cuda.empty_cache()
    rect, rect_1m, sample = phase_allpairs_rect(dev)
    half, half_1m = phase_allpairs_half(dev, rect_1m, sample)
    del sample
    phase_allpairs_exact(dev, rect_1m, half_1m)
    del rect_1m
    torch.cuda.empty_cache()
    ap_launches, ap_path = phase_allpairs_main_path(
        {"half": half["ms_1m"], "rect": rect["ms_1m"]})
    torch.cuda.empty_cache()
    var_entries, var_check, var_1m = phase_allpairs_variants(dev)
    torch.cuda.empty_cache()
    gen_entries, gen_check, gen_1m = phase_halfpair_generations(dev, half,
                                                                half_1m)
    del half_1m
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
    torch.cuda.empty_cache()
    moves = phase_reassign(dev)
    interactive = phase_interactive()
    torch.cuda.empty_cache()
    utilities = phase_utilities(dev)
    torch.cuda.empty_cache()
    slots = phase_slots(dev)
    torch.cuda.empty_cache()
    mesh, mesh_position = phase_mesh(dev)
    torch.cuda.empty_cache()
    pod = phase_pod(mesh_position)
    del mesh_position
    host_init = phase_host_init(dev)

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
        entry("composite_tiles", "composite_tiles.cu", "composite.py:34",
              launches["composite_tiles"], {**tiles, "max_abs_err": max(
                  tiles["max_abs_err"], frame_err)}),
        entry("composite", "composite.cu", "composite.py:34",
              comp["launches"], comp),
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
              gather["launches"], gather),
    ] + [entry(name, "allpairs_variants.cu", replaces,
               var_entries[name]["launches"], var_entries[name])
         for name, _, replaces in VAR_ENTRIES] + [
        entry(name, "allpairs_halfpair.cu", replaces,
              gen_entries[name]["launches"], gen_entries[name])
        for name, _, replaces in GEN_ENTRIES]
    log(f"main path: {json.dumps(frame)}; composite_tiles: "
        f"{json.dumps(tiles)}; composite_rows @262K Q=64: kernel "
        f"{comp['ms_262k']:.4f} ms, plain {comp['plain_ms_262k']:.4f} ms")
    log(f"all-pairs @{N_AP:,}: rect kernel {rect['ms_1m']:.3f} ms, half "
        f"kernel {half['ms_1m']:.3f} ms; main path {json.dumps(ap_path)}; "
        f"composite_tiles launches on it (profiled frames) "
        f"{ap_launches['half']['composite_tiles']} + "
        f"{ap_launches['rect']['composite_tiles']}")
    log(f"tree-P3M @{N_TREE:,}: far field {json.dumps(tree['far_ms'])}; "
        f"RMS vs exact {rms:.4e} of max|a|; solve B/cell {json.dumps(solve)};"
        f" pm_grid @{N_MAIN:,} G={PM_GRID} {json.dumps(pm_path)}; main path "
        f"{json.dumps(tree_path)}; launches {json.dumps(tree_launches)}")
    log(f"diagnostics: 4M gauge sweep {json.dumps(gauge)}; exact vs mesh "
        f"@{N_TREE_CHECK:,} {json.dumps(exact)}; main paths "
        f"{json.dumps(diag_path)}; launches {json.dumps(diag_launches)}")
    log(f"exact binning @1M chunk: {json.dumps(binning)}")
    log(f"sort @E={N_MAIN:,}: {json.dumps(sort)}; row gather "
        f"{json.dumps(gather)}")
    log(f"fused: {json.dumps(fused)}")
    log(f"reassignment: {json.dumps(moves, default=str)}; interactive: "
        f"{json.dumps(interactive)}")
    log(f"utilities: {json.dumps(utilities)}; slots: {json.dumps(slots)}")
    log(f"all-pairs variants, kernel vs twin: {json.dumps(var_check)}; "
        f"@1M: {json.dumps(var_1m)}")
    log(f"half-pair generations, kernel vs twin: {json.dumps(gen_check)}; "
        f"@1M: {json.dumps(gen_1m)}")
    log(f"mesh (D shards of one card): {json.dumps(mesh, default=str)}")
    log(f"process group on the one card: {json.dumps(pod)}; host init: "
        f"{json.dumps(host_init)}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
