"""Readings for the limits of `check.py`, in one process.

    python3 benchmark/control.py --workload CELL --seeds S [S ...]
        [--seconds 2]

For each seed it runs the cell as the benchmark does (set-up, warm-up, a
window of `--seconds`, the check frame) and prints one JSON line: the
program's numbers on the first frame and on the check frame (the lower
readings), and the control's (the reference in bfloat16 put in the
program's place, on the benchmark's initial state and on state N: the
upper readings), each side's numbers taken as a run takes them (the worst
of its two frames) and held to the configuration's limits by the run's
own test (`check.verdict`): `program_correct` and `control_correct`. It
exits 1 where the program comes out not correct or the control correct.
The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

T_PROCESS = time.perf_counter()
HERE = Path(__file__).resolve().parent
sys.path[:] = [str(HERE.parent)] + [p for p in sys.path
                                    if Path(p or ".").resolve() != HERE]

import torch  # noqa: E402

from benchmark import check, harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda:0")
    c = harness.cell(harness.spec(), args.workload)
    cfg, mix = c["config"], c["traffic"]
    from multi_adapter_particles_torch.ops import _build
    _build.set_build_dir(str(harness.BUILD_DIR))
    limits = cfg["check"]["limits"]
    rc = 0
    for seed in args.seeds:
        first, before, after, _, rec = harness.drive(
            cfg, mix, args.workload, seed, args.seconds, False, device,
            time.perf_counter())
        torch.cuda.empty_cache()
        rows = check.sample_rows(cfg, seed, device)
        start = harness.initial_state(cfg, seed, device)
        out = {"workload": args.workload, "seed": seed,
               "frames": rec["window"]["frames"],
               "truncated": rec["truncated"],
               "program_first": check.compare(
                   cfg, mix, start, tuple(t.to(device) for t in first), rows),
               "program_last": check.compare(cfg, mix, before, after, rows),
               "control_first": check.control(cfg, mix, start, rows),
               "control_last": check.control(cfg, mix, before, rows)}
        for side in ("program", "control"):
            numbers = check.worst(out[f"{side}_first"], out[f"{side}_last"])
            out[f"{side}_correct"] = not check.verdict(numbers, limits)
        if not out["program_correct"] or out["control_correct"]:
            rc = 1
        print(json.dumps(out), flush=True)
        del first, before, after, start
        torch.cuda.empty_cache()
    return rc


if __name__ == "__main__":
    sys.exit(main())
