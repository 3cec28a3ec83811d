"""The benchmark's command.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

runs one cell of `BENCHMARK.json` on the first CUDA card (see
`harness.py` for what a run does) and prints, last on standard output,
one JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with `--trace 1` its per-layer ones), `device`,
with `--trace 1` `breakdown`, and last `checks`, each number compared
beside its limit. The same numbers and limits are the last lines on
standard error. It exits 1 without a result when there is no CUDA card,
or fewer than the cell asks for, and 3 when a module of JAX, Flax or the
JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# run as a script: import the benchmark as a package from the checkout's
# root, never its modules as top-level names from this directory
HERE = Path(__file__).resolve().parent
sys.path[:] = [str(ROOT)] + [p for p in sys.path
                             if Path(p or ".").resolve() != HERE]

FORBIDDEN = ("jax", "jaxlib", "flax", "multi_adapter_particles_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark import harness

    chips = harness.cell(harness.spec(), args.workload)["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print("benchmark: modules of JAX or the JAX package were loaded: "
              + ", ".join(bad), file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
