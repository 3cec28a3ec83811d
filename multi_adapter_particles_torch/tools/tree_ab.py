"""A/B timing of the torch port's tree-P3M force path between checkouts, on
one CUDA GPU.

    python3 multi_adapter_particles_torch/tools/tree_ab.py ROOT [ROOT ...]

Each ROOT is a checkout of the repository (this one, or an unpacked
`git archive` of another commit); each runs in a fresh process, in the
order given, so list two as A B B A to cancel drift. For each it prints one
JSON line: the directed and Newton-3rd sweep kernels at 1,048,576
particles (device init, seed 0; G=192, B=512, the probed pair budget; CUDA
events over 10 launches on lists built once), and the CLI's tree-P3M frame
time (median CUDA-event device frame of `-steps 10`, the Newton-3rd sweep
then `-treedirected`), and the busy share of each (kernel time over the
CUDA-event time of 10 steady frames of `ParticlesApp.draw()` at the same
grid and budget, torch.profiler; `frame_ab.py`'s measure). Kernels build
into each checkout's own `build/torch_kernels/`.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

N, GRID, BOX, CUTOFF = 1_048_576, 192, 2048.0, 6.75


def _time_ms(fn, reps=10):
    import torch

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


def measure(root: str) -> dict:
    """The numbers of one checkout (run in its own process)."""
    sys.path.insert(0, root)
    import torch

    from multi_adapter_particles_torch import app
    from multi_adapter_particles_torch import constants as C
    from multi_adapter_particles_torch.models import init as pinit
    from multi_adapter_particles_torch.ops import p3m, treeforce

    if not torch.cuda.is_available():
        raise SystemExit("tree_ab.py needs a CUDA GPU")
    dev = torch.device("cuda", 0)
    pos = pinit.initialize_particles_device(
        N, torch.Generator(device=dev).manual_seed(0), device=dev).position
    r_c, gn = p3m.near_grid_for(GRID, BOX, CUTOFF)
    coarse, _, _ = treeforce.host_tree_counts(pos.cpu().numpy(), BOX, r_c,
                                              gn)
    budget = int(coarse * treeforce.PAIR_HEADROOM) + 1
    eps2, sigma = C.SOFTENING_SQUARED, r_c * p3m._SIGMA_PER_CUTOFF
    out = {"root": root, "device": torch.cuda.get_device_name(0)}
    for half in (False, True):
        L = treeforce.tree_lists(pos, BOX, r_c, gn, pair_budget=budget,
                                 half_force=half)
        if half:
            prep = treeforce._n3_prepare(L.spos, L.sweep_i, L.sweep_j, L.nb,
                                         L.block)
            out["n3_kernel_ms"] = _time_ms(
                lambda: treeforce._launch_sweep_n3(L.spos, *prep, eps2,
                                                   sigma))
        else:
            b32, j32 = L.bounds.to(torch.int32), L.sweep_j.to(torch.int32)
            out["directed_kernel_ms"] = _time_ms(
                lambda: treeforce._launch_sweep(L.spos, L.sweep_nb,
                                                L.sweep_block, b32, j32,
                                                eps2, sigma))
    del pos
    spec = importlib.util.spec_from_file_location(
        "frame_ab", Path(__file__).with_name("frame_ab.py"))
    frame_ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(frame_ab)
    for half, label in ((True, "n3"), (False, "directed")):
        busy = frame_ab._profile(
            N, 1024, 1024, False, "p3m", p3m_near_mode="tree",
            pm_grid_size=GRID, p3m_pair_budget=budget, tree_half_force=half)
        out.update({f"{label}_{k}": v for k, v in busy.items()})
    for label, extra in (("n3", []), ("directed", ["-treedirected"])):
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "m.json")
            rc = app.main(["-force", "p3m", "-p3mnear", "tree",
                           "-numparticles", str(N), "-novsync", "-nogui",
                           "-width", "1024", "-height", "1024", "-steps",
                           "10", "-metrics", path] + extra)
            if rc != 0:
                raise SystemExit(f"app.main returned {rc}")
            with open(path) as f:
                frames = json.load(f)["gauges"]["device_frame_ms"]
        out[f"{label}_frame_ms"] = statistics.median(frames)
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
