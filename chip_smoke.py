"""Smoke test of the torch port on one CUDA GPU: builds the hand-written
kernels from `multi_adapter_particles_torch/csrc`, holds each against its
plain torch twin at the main path's shapes, then runs the port's CLI main
path (4,194,304 particles, central well, 1024x1024 split frame loop) and
checks that it went through both kernels and produced a sane frame.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU):
1. device check + the card's name and power limit (nvidia-smi)
2. kernel build (nvcc, seconds printed; ptxas register report)
3. central-well kernel vs plain at 4,194,304 particles (+ num_sim freeze)
4. composite kernel vs plain on the rows the renderer builds for one 1M
   chunk of the 4M state (Q=256) and for 262,144 particles (Q=64)
5. main path: `multi_adapter_particles_torch.app.main`, launch counters
6. the final state's frame through the kernel vs through the plain twin

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
    from multi_adapter_particles_torch.ops import _build
    from multi_adapter_particles_torch.ops import central_well, composite

    log("phase 2: build")
    t0 = time.perf_counter()
    central_well._library()
    composite._library()
    log(f"  built/loaded both kernels in {time.perf_counter() - t0:.2f} s "
        f"({_build.BUILD_DIR})")
    # register / spill report of each kernel (compile only, no library)
    with tempfile.TemporaryDirectory() as tmp:
        for name, extra in (("central_well", ()),
                            ("composite", composite._NVCC_FLAGS)):
            cmd = [_build.nvcc_path(), "-gencode",
                   "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                   *extra, "-Xptxas", "-v", "-cubin",
                   "-o", os.path.join(tmp, f"{name}.cubin"),
                   str(_build.CSRC_DIR / f"{name}.cu")]
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
            if proc.returncode != 0:
                fail(f"ptxas report for {name}: {proc.stderr}")
            for line in (proc.stdout + proc.stderr).splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")


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


def phase_main_path(dev):
    import statistics

    import torch

    from multi_adapter_particles_torch import app
    from multi_adapter_particles_torch.ops.central_well import central_well_step
    from multi_adapter_particles_torch.ops.composite import composite_rows

    log(f"phase 5: main path — app.main -numparticles {N_MAIN} -steps {STEPS}"
        f" at {WIDTH}x{HEIGHT}")
    seen = {}

    def on_exit(particles):
        out = particles.render.last_output
        seen["position"] = particles.compute.state.position.clone()
        seen["frame"] = out.frame.clone()
        seen["truncated"] = int(out.truncated)
        seen["frames"] = particles.frame_count
        seen["device"] = particles.compute.device
        seen["renderer"] = particles.render.renderer
        seen["camera"] = particles.render.camera

    with tempfile.TemporaryDirectory() as tmp:
        metrics_path = os.path.join(tmp, "metrics.json")
        central_well_step.launches = 0
        composite_rows.launches = 0
        t0 = time.perf_counter()
        rc = app.main(["-numparticles", str(N_MAIN), "-steps", str(STEPS),
                       "-novsync", "-nogui", "-width", str(WIDTH),
                       "-height", str(HEIGHT), "-metrics", metrics_path],
                      on_exit=on_exit)
        wall = time.perf_counter() - t0
        launches = {"central_well": central_well_step.launches,
                    "composite": composite_rows.launches}
        if rc != 0:
            fail(f"app.main returned {rc}")
        with open(metrics_path) as f:
            metrics = json.load(f)
    log(f"  app.main: rc 0, {seen['frames']} frames in {wall:.2f} s wall "
        f"(first-frame costs included), launches {launches}")
    if seen["device"].type != "cuda":
        fail(f"compute ran on {seen['device']}, not the GPU")
    if launches["central_well"] < STEPS:
        fail(f"central-well kernel launched {launches['central_well']} times"
             f" in {STEPS} frames")
    if launches["composite"] < 4 * STEPS:
        fail(f"composite kernel launched {launches['composite']} times in "
             f"{STEPS} frames of 4 chunks")
    if not torch.isfinite(seen["position"]).all():
        fail("non-finite positions after the main path")
    frame = seen["frame"]
    if not torch.isfinite(frame).all():
        fail("non-finite values in the last frame")
    if float(frame.max()) <= 0.0:
        fail("the last frame is all zero")
    if seen["truncated"] != 0:
        fail(f"the last frame truncated {seen['truncated']} tile entries")
    dev_frames = metrics["gauges"].get("device_frame_ms", [])[-30:]
    if len(dev_frames) < 10:
        fail(f"only {len(dev_frames)} CUDA-event frame samples")
    frame_ms = statistics.median(dev_frames)
    stages = metrics["stages_ms"]
    log(f"  ms/frame (CUDA events, median of last {len(dev_frames)}): "
        f"{frame_ms:.3f}; simulate ms {stages['simulate']:.3f}, render ms "
        f"{stages['render']:.3f} (20-sample EMA); host frameTime ms "
        f"{metrics['frame_ms']:.3f}")
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
    ]
    log(f"main path: {json.dumps(frame)}; composite @262K Q=64: kernel "
        f"{comp['ms_262k']:.4f} ms, plain {comp['plain_ms_262k']:.4f} ms")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
