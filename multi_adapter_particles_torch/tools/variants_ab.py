"""A/B timing of the all-pairs variants' kernels and of `composite_rows`
between checkouts, on one CUDA GPU.

    python3 multi_adapter_particles_torch/tools/variants_ab.py ROOT
        [ROOT ...] [--only PREFIX ...] [--reps K] [--composite]

Each ROOT is a checkout of the repository (this one, or an unpacked
`git archive` of another commit, or a copy with one change); each runs in
a fresh process, in the order given, so list two as A B B A to cancel
drift. For each it prints one JSON line:

- every case of `tools/allpairs_variants.py` whose label starts with a
  prefix in `--only` (all without it), on that harness's scene at
  1,048,576, or 1,047,552 where the case's shape rule needs it (hybrid):
  ms per call (CUDA events over `--reps` calls after one), the SM clock
  read while they ran (nvidia-smi), and the error against v0 with the NaN
  share, as the harness reports them;
- with `--composite`, `composite_rows` on the rows `chip_smoke.py` phase 4
  builds (the 1M chunk of the 4M device-init state, Q=256, and 262,144,
  Q=64; the checkout's own `chip_smoke._tiles_inputs` / `_rows_inputs`):
  ms over 20 calls, "over" blend.

Kernels build into each checkout's own `build/torch_kernels/`.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

SIZES = (1_048_576, 1_047_552)   # the first each case's shape rule allows
COMPOSITE = (("1M chunk of 4M", 4_194_304, 1_048_576),
             ("262K", 262_144, 262_144))


def sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return float(out.stdout.split()[0])


def time_and_clock(fn, reps: int):
    """(mean device ms of `reps` calls after one, the SM clock read while
    they run)."""
    import torch

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


def measure(root: str, only, reps: int, composite: bool) -> dict:
    """The numbers of one checkout (run in its own process)."""
    sys.path.insert(0, root)
    import torch

    from multi_adapter_particles_torch.tools import allpairs_variants as H

    if not torch.cuda.is_available():
        raise SystemExit("variants_ab.py needs a CUDA GPU")
    out = {"root": root, "device": torch.cuda.get_device_name(0)}
    refs = {}
    for label, fn, kw, wrong in H.CASES:
        if only and not label.startswith(tuple(only)):
            continue
        n = next((s for s in SIZES if H.tiles(fn, s, kw)), None)
        if n is None:
            continue
        if n not in refs:
            refs.clear()
            torch.cuda.empty_cache()
            pos = H.scene(n, "cuda")
            refs[n] = (pos, H.v0(pos))
        pos, ref = refs[n]
        row = {"n": n}
        if not wrong:
            row["rel_err"], row["nan_share"] = H.error_vs(fn(pos, **kw), ref)
        row["ms"], row["mhz"] = time_and_clock(lambda: fn(pos, **kw), reps)
        out[label] = row
    refs.clear()
    if composite:
        spec = importlib.util.spec_from_file_location(
            "root_chip_smoke", Path(root) / "chip_smoke.py")
        smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(smoke)
        from multi_adapter_particles_torch.ops.composite import (
            composite_rows,
        )
        from multi_adapter_particles_torch.render.renderer import (
            TILE_H,
            TILE_W,
        )

        dev = torch.device("cuda", 0)
        for label, n, chunk in COMPOSITE:
            pos = smoke._ap_state(dev, n)[:, :chunk].contiguous()
            sp, bases, hi = smoke._rows_inputs(*smoke._tiles_inputs(
                pos, smoke.WIDTH, smoke.HEIGHT))
            del pos
            ms, mhz = time_and_clock(lambda: composite_rows(
                sp, bases, TILE_H, TILE_W, "over", hi), 20)
            out[f"composite_rows {label}"] = {"ms": ms, "mhz": mhz}
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+", metavar="ROOT")
    ap.add_argument("--only", nargs="+", default=(), metavar="PREFIX")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--composite", action="store_true")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print("AB " + json.dumps(measure(os.path.abspath(args.roots[0]),
                                         args.only, args.reps,
                                         args.composite)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    flags = ["--reps", str(args.reps)] + (["--only", *args.only]
                                          if args.only else [])
    flags += ["--composite"] if args.composite else []
    for root in args.roots:
        proc = subprocess.run([sys.executable, __file__, "--one", root,
                               *flags], capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-2000:], proc.stderr[-4000:], flush=True)
            return 1
        print(lines[-1][3:], flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
