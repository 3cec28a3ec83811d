"""A/B timing of the torch port's main-path frames between checkouts, on
one CUDA GPU.

    python3 multi_adapter_particles_torch/tools/frame_ab.py \
        [--scenes LABEL,...] [--steps K] ROOT[+noext] [ROOT[+noext] ...]

Each ROOT is a checkout of the repository (this one, or an unpacked
`git archive` of another commit); each runs in a fresh process, in the
order given, so list two as A B B A to cancel drift. `ROOT+noext` runs
that checkout with the queue-throttle extension off (`-noext`), to time
the split step on the current stream against its high-priority stream.
`--scenes` keeps only the scenes named (labels below), `--steps` sets
every kept scene's `-steps`.

    python3 multi_adapter_particles_torch/tools/frame_ab.py --toggle ROOT

times the split 4M frame of one checkout with the extension on and off in
one process: ROUNDS rounds of two blocks of BLOCK frames (on, off; the
order flips every round), each block synced at both ends and timed with
CUDA events. It prints the per-block ms a frame of each setting, their
medians, the change of "on" against "off", the rounds "on" won, each
side's quartile spread (`summary`), and the host ms a frame took to
issue each block (`*_issue_ms`: near the frame's device time when the
host bounds it). For each it prints one
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
import time

N, SIDE, STEPS, WINDOW = 4_194_304, 1024, 40, 10
# (label, particles, width, height, fused, force model, steps)
SCENES = (("split", N, SIDE, SIDE, False, "central_well", STEPS),
          ("fused", N, SIDE, SIDE, True, "central_well", STEPS),
          ("fused720", 262_144, 1280, 720, True, "central_well", STEPS),
          ("allpairs1m", 1_048_576, SIDE, SIDE, False, "all_pairs", 8))


def _cli(app, n, width, height, fused: bool, force: str, steps: int,
         ext: bool) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "m.json")
        rc = app.main(["-numparticles", str(n), "-width", str(width),
                       "-height", str(height), "-steps", str(steps),
                       "-force", force, "-novsync", "-nogui", "-metrics",
                       path] + (["-fused"] if fused else [])
                      + ([] if ext else ["-noext"]))
        if rc != 0:
            raise SystemExit(f"app.main returned {rc}")
        with open(path) as f:
            m = json.load(f)
    return {"frame_ms": statistics.median(m["gauges"]["device_frame_ms"]),
            "render_ms": m["stages_ms"]["render"],
            "simulate_ms": m["stages_ms"]["simulate"]}


def _profile(n, width, height, fused: bool, force: str, ext: bool,
             **sim) -> dict:
    """Busy share and kernels a frame over WINDOW steady frames (`ext`:
    the queue-throttle extension on; `sim`: more SimConfig fields)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from multi_adapter_particles_torch.config import (
        AppConfig,
        RenderConfig,
        SimConfig,
    )
    from multi_adapter_particles_torch.runtime.orchestrator import ParticlesApp

    kw = {"fused": True} if fused else {}
    app_kw = {} if ext else {"use_queue_extension": False}
    p = ParticlesApp(AppConfig(num_particles=n, vsync=False, gui=False,
                               **app_kw),
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


ROUNDS, BLOCK = 12, 25


def toggle(root: str) -> dict:
    """The split 4M frame with the extension on against off, in one
    process (the `--toggle` mode)."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from multi_adapter_particles_torch.config import (
        AppConfig,
        RenderConfig,
        SimConfig,
    )
    from multi_adapter_particles_torch.runtime.orchestrator import ParticlesApp

    p = ParticlesApp(AppConfig(num_particles=N, vsync=False, gui=False),
                     SimConfig(num_particles=N),
                     RenderConfig(width=SIDE, height=SIDE))
    for _ in range(5):
        p.draw()
    ms = {True: [], False: []}
    issue = {True: [], False: []}
    for r in range(ROUNDS):
        for on in ((True, False) if r % 2 == 0 else (False, True)):
            p.app.use_queue_extension = on
            p.draw()   # the toggle takes effect from the next frame
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            for _ in range(BLOCK):
                p.draw()
            issue[on].append((time.perf_counter() - t0) * 1e3 / BLOCK)
            end.record()
            torch.cuda.synchronize()
            ms[on].append(start.elapsed_time(end) / BLOCK)
    p.shutdown()
    return {"root": root, "device": torch.cuda.get_device_name(0),
            "rounds": ROUNDS, "block": BLOCK, "on_ms": ms[True],
            "off_ms": ms[False], **summary(ms[True], ms[False]),
            "on_issue_ms": issue[True], "off_issue_ms": issue[False],
            "on_issue_median_ms": statistics.median(issue[True]),
            "off_issue_median_ms": statistics.median(issue[False])}


def summary(on_ms, off_ms) -> dict:
    """Medians of the paired blocks, the change of "on" against "off",
    the rounds "on" was faster in, and each side's quartile spread (the
    distance between its quartiles) as a share of its median."""
    def spread(xs):
        q = statistics.quantiles(xs, n=4)
        return (q[2] - q[0]) / statistics.median(xs)

    on, off = statistics.median(on_ms), statistics.median(off_ms)
    return {"on_median_ms": on, "off_median_ms": off,
            "on_vs_off": on / off - 1,
            "on_faster": sum(a < b for a, b in zip(on_ms, off_ms)),
            "on_spread": spread(on_ms), "off_spread": spread(off_ms)}


def measure(spec: str, labels, steps) -> dict:
    """The numbers of one checkout (run in its own process). `spec`: ROOT
    or ROOT+noext; `labels`: the scenes to run; `steps`: their -steps, or
    None for each scene's own."""
    root, noext = (spec[:-len("+noext")], True) if spec.endswith(
        "+noext") else (spec, False)
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    from multi_adapter_particles_torch import app

    if not torch.cuda.is_available():
        raise SystemExit("frame_ab.py needs a CUDA GPU")
    out = {"root": root, "ext": not noext,
           "device": torch.cuda.get_device_name(0)}
    has_fused = "fused" not in getattr(app, "_LATER_FLAGS", {})
    for label, *scene in SCENES:
        if label not in labels or (scene[3] and not has_fused):
            continue
        if steps is not None:
            scene[5] = steps
        cli = _cli(app, *scene, ext=not noext)
        for k, v in {**cli, **_profile(*scene[:5], ext=not noext)}.items():
            out[f"{label}_{k}"] = v
    return out


def main(argv) -> int:
    labels, steps = [s[0] for s in SCENES], None
    while argv[:1] in (["--scenes"], ["--steps"]):
        if argv[0] == "--scenes":
            labels = argv[1].split(",")
        else:
            steps = int(argv[1])
        argv = argv[2:]
    if len(argv) == 2 and argv[0] == "--toggle":
        print(json.dumps(toggle(argv[1])), flush=True)
        return 0
    if len(argv) == 2 and argv[0] == "--one":
        print("AB " + json.dumps(measure(argv[1], labels, steps)),
              flush=True)
        return 0
    if not argv:
        raise SystemExit(__doc__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    for root in argv:
        opts = ["--scenes", ",".join(labels)] + (
            [] if steps is None else ["--steps", str(steps)])
        proc = subprocess.run([sys.executable, __file__, *opts, "--one",
                               root], capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-2000:], proc.stderr[-4000:], flush=True)
            return 1
        print(lines[-1][3:], flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
