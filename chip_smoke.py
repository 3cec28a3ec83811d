"""Smoke test of the torch port on one CUDA GPU: builds the hand-written
kernels from `multi_adapter_particles_torch/csrc`, holds each against its
plain torch twin at the main paths' shapes, then runs the port's CLI main
paths (4,194,304 particles, central well; 1,048,576 particles, all-pairs
self-gravity; both 1024x1024 split frame loops) and checks that each went
through its kernels and produced a sane frame.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU):
1. device check + the card's name and power limit (nvidia-smi)
2. kernel build (nvcc, seconds printed; ptxas register report)
3. central-well kernel vs plain at 4,194,304 particles (+ num_sim freeze)
4. composite kernel vs plain on the rows the renderer builds for one 1M
   chunk of the 4M state (Q=256) and for 262,144 particles (Q=64)
5. main path: `multi_adapter_particles_torch.app.main`, launch counters
6. the final state's frame through the kernel vs through the plain twin
7. all-pairs rectangle kernel vs plain: 4,096 targets spread over the
   1,048,576-particle state against all its sources (float32 twin and a
   float64 evaluation); kernel time at the full 1M
8. all-pairs half-pair kernel vs plain at 131,072 and vs the rectangle
   kernel at 1,048,576; kernel times at 1M
9. half-pair fallback at an untileable N (100,096) is bitwise the rectangle
   kernel; both kernels run twice at 1M give equal results
10. all-pairs main path: `app.main -force all_pairs` at 1,048,576, 8 frames
    of the half-pair schedule, then 6 with -rectpair; launch counters

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import tempfile
import time

N_MAIN = 4_194_304
STEPS = 40
WIDTH = HEIGHT = 1024
N_AP = 1_048_576          # the all-pairs path (BASELINE.json's 1M)
AP_SAMPLE = 4_096         # rectangle targets held against the plain twin
N_HALF_CHECK = 131_072    # 256 tiles of 512: half-pair kernel vs plain
N_UNTILEABLE = 100_096    # padded 100,000: not a multiple of 512
AP_STEPS_HALF = 8
AP_STEPS_RECT = 6


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    raise SystemExit(1)


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
    from multi_adapter_particles_torch.ops import allpairs, central_well, composite

    log("phase 2: build")
    sources = (("central_well", central_well, ()),
               ("composite", composite, composite._NVCC_FLAGS),
               ("allpairs", allpairs, ()))

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
        return [line.strip() for line in (proc.stdout + proc.stderr)
                .splitlines() if "registers" in line or "spill" in line]

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
    log(f"  kernel {ms:.4f} ms ({gbs:.0f} GB/s of 56 B/particle), plain "
        f"{plain_ms:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


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
        ms = time_ms(lambda: composite_rows(sp, bases, TILE_H, TILE_W,
                                            "over", hi), reps=20)
        plain_ms = time_ms(lambda: composite_rows_plain(
            sp, bases, TILE_H, TILE_W, "over", hi), reps=3, warmup=1)
        log(f"  {label} over: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        times[label] = (ms, plain_ms)
        del sp, bases, hi
    ms, plain_ms = times["1M chunk of 4M"]
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "ms_262k": times["262K"][0], "plain_ms_262k": times["262K"][1]}


def _run_app(argv, steps):
    """app.main with -metrics; returns (metrics dict, what on_exit saw)."""
    import torch

    from multi_adapter_particles_torch import app

    seen = {}

    def on_exit(particles):
        out = particles.render.last_output
        seen["position"] = particles.compute.state.position.clone()
        seen["frame"] = out.frame.clone()
        seen["truncated"] = int(out.truncated)
        seen["frames"] = particles.frame_count
        seen["device"] = particles.compute.device
        seen["config"] = particles.compute.config
        seen["rate"] = particles.metrics.rate("interactions")
        seen["renderer"] = particles.render.renderer
        seen["camera"] = particles.render.camera

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

    from multi_adapter_particles_torch.ops.central_well import central_well_step
    from multi_adapter_particles_torch.ops.composite import composite_rows

    log(f"phase 5: main path — app.main -numparticles {N_MAIN} -steps {STEPS}"
        f" at {WIDTH}x{HEIGHT}")
    central_well_step.launches = 0
    composite_rows.launches = 0
    t0 = time.perf_counter()
    metrics, seen = _run_app(
        ["-numparticles", str(N_MAIN), "-steps", str(STEPS), "-novsync",
         "-nogui", "-width", str(WIDTH), "-height", str(HEIGHT)], STEPS)
    wall = time.perf_counter() - t0
    launches = {"central_well": central_well_step.launches,
                "composite": composite_rows.launches}
    log(f"  app.main: rc 0, {seen['frames']} frames in {wall:.2f} s wall "
        f"(first-frame costs included), launches {launches}")
    if launches["central_well"] < STEPS:
        fail(f"central-well kernel launched {launches['central_well']} times"
             f" in {STEPS} frames")
    if launches["composite"] < 4 * STEPS:
        fail(f"composite kernel launched {launches['composite']} times in "
             f"{STEPS} frames of 4 chunks")
    dev_frames = metrics["gauges"].get("device_frame_ms", [])[-30:]
    if len(dev_frames) < 10:
        fail(f"only {len(dev_frames)} CUDA-event frame samples")
    frame_ms = statistics.median(dev_frames)
    stages = metrics["stages_ms"]
    log(f"  ms/frame (CUDA events, median of last {len(dev_frames)}): "
        f"{frame_ms:.3f}; simulate ms {stages['simulate']:.3f}, render ms "
        f"{stages['render']:.3f} (20-sample EMA); host frameTime ms "
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

    log("phase 6: final state's frame, kernel vs plain composite")
    rend = seen["renderer"]
    pos = seen["position"]
    with_kernel = rend.render_arrays(pos, seen["camera"], 2.5, 0.15).frame
    rend.composite = composite_rows_plain
    with_plain = rend.render_arrays(pos, seen["camera"], 2.5, 0.15).frame
    torch.cuda.synchronize()
    return check_close("frame", with_kernel, with_plain, 0.0, 1e-5)


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
    full = all_pairs_accel(pos, **phys)  # the 1M result, kept for phase 8
    ms_1m = time_ms(lambda: all_pairs_accel(pos, **phys), reps=2, warmup=0)
    log(f"  sampled: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; full "
        f"{N_AP:,}: kernel {ms_1m:.3f} ms = {N_AP * N_AP / (ms_1m * 1e-3):.4e} "
        f"pairs/s")
    if not torch.equal(full[:, idx], k):
        fail("the sampled targets' rows differ from the full 1M result")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
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
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
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


def main() -> int:
    phase_device()
    import torch

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    cw = phase_central_well(dev)
    comp = phase_composite(dev)
    torch.cuda.empty_cache()
    launches, seen, frame = phase_main_path(dev)
    frame_err = phase_full_frame(seen)
    del seen
    torch.cuda.empty_cache()
    rect, rect_1m = phase_allpairs_rect(dev)
    half, half_1m = phase_allpairs_half(dev, rect_1m)
    phase_allpairs_exact(dev, rect_1m, half_1m)
    del rect_1m, half_1m
    torch.cuda.empty_cache()
    ap_launches, ap_path = phase_allpairs_main_path()
    kernels = [
        {"name": "central_well", "route": "cuda",
         "source": "multi_adapter_particles_torch/csrc/central_well.cu",
         "replaces": "multi_adapter_particles_tpu/ops/central_well.py:32",
         "launches": launches["central_well"],
         "max_abs_err": cw["max_abs_err"], "ms": cw["ms"],
         "plain_ms": cw["plain_ms"]},
        {"name": "composite", "route": "cuda",
         "source": "multi_adapter_particles_torch/csrc/composite.cu",
         "replaces": "multi_adapter_particles_tpu/ops/composite.py:34",
         "launches": launches["composite"],
         "max_abs_err": max(comp["max_abs_err"], frame_err),
         "ms": comp["ms"], "plain_ms": comp["plain_ms"]},
        {"name": "all_pairs_rect", "route": "cuda",
         "source": "multi_adapter_particles_torch/csrc/allpairs.cu",
         "replaces": "multi_adapter_particles_tpu/ops/allpairs.py:47",
         "launches": ap_launches["rect"]["all_pairs_rect"],
         "max_abs_err": rect["max_abs_err"], "ms": rect["ms"],
         "plain_ms": rect["plain_ms"]},
        {"name": "all_pairs_half", "route": "cuda",
         "source": "multi_adapter_particles_torch/csrc/allpairs.cu",
         "replaces": "multi_adapter_particles_tpu/ops/allpairs.py:269",
         "launches": ap_launches["half"]["all_pairs_half"],
         "max_abs_err": half["max_abs_err"], "ms": half["ms"],
         "plain_ms": half["plain_ms"]},
    ]
    log(f"main path: {json.dumps(frame)}; composite @262K Q=64: kernel "
        f"{comp['ms_262k']:.4f} ms, plain {comp['plain_ms_262k']:.4f} ms")
    log(f"all-pairs @{N_AP:,}: rect kernel {rect['ms_1m']:.3f} ms, half "
        f"kernel {half['ms_1m']:.3f} ms; main path {json.dumps(ap_path)}; "
        f"composite launches on it {ap_launches['half']['composite']} + "
        f"{ap_launches['rect']['composite']}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
