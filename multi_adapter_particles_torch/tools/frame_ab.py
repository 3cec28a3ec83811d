"""A/B timing of the torch port's main-path frames between checkouts, on
one CUDA GPU.

    python3 multi_adapter_particles_torch/tools/frame_ab.py ROOT [ROOT ...]

Each ROOT is a checkout of the repository (this one, or an unpacked
`git archive` of another commit); each runs in a fresh process, in the
order given, so list two as A B B A to cancel drift. For each it prints one
JSON line for the reference's default scene (4,194,304 particles, central
well, 1024x1024, device init, seed 0), split loop and, where the checkout
has it, the fused frame (`-fused`), the fused frame of 262,144 particles
at 1280x720 (keys `fused720_*`), and the split all-pairs frame of
1,048,576 particles at 1024x1024 (`-force all_pairs`, the half-pair
schedule; keys `allpairs1m_*`):

- `*_frame_ms`: the CLI's median CUDA-event device frame over `-steps 40`
  (all-pairs: 8, the frames past the timer's first 3) (`-novsync -nogui
  -metrics`), with the render / simulate stage EMAs;
- `*_busy`: the device's busy share over 10 steady frames of
  `ParticlesApp.draw()` under `torch.profiler` (kernel time over the
  CUDA-event time of the window), and `*_kernels_per_frame`, the device
  kernels those frames ran.

Kernels build into each checkout's own `build/torch_kernels/`.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile

N, SIDE, STEPS, WINDOW = 4_194_304, 1024, 40, 10
# (label, particles, width, height, fused, force model, steps)
SCENES = (("split", N, SIDE, SIDE, False, "central_well", STEPS),
          ("fused", N, SIDE, SIDE, True, "central_well", STEPS),
          ("fused720", 262_144, 1280, 720, True, "central_well", STEPS),
          ("allpairs1m", 1_048_576, SIDE, SIDE, False, "all_pairs", 8))


def _cli(app, n, width, height, fused: bool, force: str, steps: int) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "m.json")
        rc = app.main(["-numparticles", str(n), "-width", str(width),
                       "-height", str(height), "-steps", str(steps),
                       "-force", force, "-novsync", "-nogui", "-metrics",
                       path] + (["-fused"] if fused else []))
        if rc != 0:
            raise SystemExit(f"app.main returned {rc}")
        with open(path) as f:
            m = json.load(f)
    return {"frame_ms": statistics.median(m["gauges"]["device_frame_ms"]),
            "render_ms": m["stages_ms"]["render"],
            "simulate_ms": m["stages_ms"]["simulate"]}


def _profile(n, width, height, fused: bool, force: str, **sim) -> dict:
    """Busy share and kernels a frame over WINDOW steady frames (`sim`:
    more SimConfig fields)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from multi_adapter_particles_torch.config import (
        AppConfig,
        RenderConfig,
        SimConfig,
    )
    from multi_adapter_particles_torch.runtime.orchestrator import ParticlesApp

    kw = {"fused": True} if fused else {}
    p = ParticlesApp(AppConfig(num_particles=n, vsync=False, gui=False),
                     SimConfig(num_particles=n, force_model=force, **sim),
                     RenderConfig(width=width, height=height), **kw)
    for _ in range(5):
        p.draw()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(WINDOW):
            p.draw()
        end.record()
        torch.cuda.synchronize()
    p.shutdown()
    busy_us, kernels = 0.0, 0
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = ev.self_cuda_time_total
        if t > 0:
            busy_us += t
            kernels += ev.count
    window_ms = start.elapsed_time(end)
    return {"busy": busy_us / 1e3 / window_ms,
            "kernels_per_frame": kernels / WINDOW,
            "window_frame_ms": window_ms / WINDOW}


def measure(root: str) -> dict:
    """The numbers of one checkout (run in its own process)."""
    sys.path.insert(0, root)
    import torch

    from multi_adapter_particles_torch import app

    if not torch.cuda.is_available():
        raise SystemExit("frame_ab.py needs a CUDA GPU")
    out = {"root": root, "device": torch.cuda.get_device_name(0)}
    has_fused = "fused" not in getattr(app, "_LATER_FLAGS", {})
    for label, *scene in SCENES:
        if scene[3] and not has_fused:
            continue
        for k, v in {**_cli(app, *scene), **_profile(*scene[:5])}.items():
            out[f"{label}_{k}"] = v
    return out


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print("AB " + json.dumps(measure(os.path.abspath(argv[1]))),
              flush=True)
        return 0
    if not argv:
        raise SystemExit(__doc__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    for root in argv:
        proc = subprocess.run([sys.executable, __file__, "--one", root],
                              capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-2000:], proc.stderr[-4000:], flush=True)
            return 1
        print(lines[-1][3:], flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
