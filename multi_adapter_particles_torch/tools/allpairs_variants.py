"""Time the all-pairs A/B variants against the production rectangle (v0).

    python -m multi_adapter_particles_torch.tools.allpairs_variants [N]
        [--device cuda|cpu] [--reps K] [--only PREFIX ...]

The port's counterpart of the `main()`s of the JAX package's
`experiments/allpairs_*.py`: the same scene (uniform in ±400, w = 0,
seed 0), the same baseline (`ops/allpairs.all_pairs_accel` at
`PARTICLE_MASS`, interaction scale 1), one line per variant and mode: ms
per call, Tpairs/s, and the error against v0 as max |a - a0| over (ax, ay,
az) in units of max |a0|, with a NaN flag. attr's modes are wrong by
design (unscaled, op groups removed): no error is printed for them.

Without N each variant runs at its JAX harness's default: 131,072, and
98,304 for hybrid (192 tiles of 512). With N, a variant whose shape rule N
breaks (unroll: N // 2048 even; hybrid: N // 512 a multiple of 3) is
reported as skipped. v3 runs each force path at tj = 512 and 1024, as
its JAX harness does. `--only` keeps the cases whose label starts with one
of the prefixes (v0 always runs). It runs on the GPU; `--device cpu` runs
the plain twins (slow: minutes at the default sizes). A kernel's failure
is never caught.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from multi_adapter_particles_torch import constants as C
from multi_adapter_particles_torch.ops import allpairs_variants as V
from multi_adapter_particles_torch.ops.allpairs import all_pairs_accel

N_DEFAULT = 131_072
N_HYBRID_DEFAULT = 98_304
V3_TJ = (512, 1024)   # v3's j-tiles, as `allpairs_v3.py:203`

# (label, function, keywords, wrong by design)
CASES = (
    ("attr full", V.attr_accel, dict(mode="full"), True),
    ("attr no-rsqrt", V.attr_accel, dict(mode="norsqrt"), True),
    ("attr no-accum", V.attr_accel, dict(mode="noaccum"), True),
    ("v1b mma highest", V.v1b_accel, dict(precision="highest"), False),
    ("v1b mma default", V.v1b_accel, dict(precision="default"), False),
    ("unroll2", V.unroll_accel, {}, False),
    ("v1 mma default", V.v1_accel, dict(precision="default"), False),
    ("v1 mma highest", V.v1_accel, dict(precision="highest"), False),
    *((f"v3 {fp} tj={tj}", V.v3_accel, dict(force_path=fp, tj=tj), False)
      for fp in V.FORCE_PATHS for tj in V3_TJ),
    ("hybrid 2:1", V.hybrid_accel, {}, False),
    ("v4 plane", V.v4_accel, {}, False),
)


def scene(n: int, device) -> torch.Tensor:
    """[4, n] uniform in ±400, w = 0, seed 0."""
    p = np.random.default_rng(0).uniform(-400.0, 400.0,
                                         size=(4, n)).astype(np.float32)
    p[3] = 0.0
    return torch.from_numpy(p).to(device)


def v0(position: torch.Tensor) -> torch.Tensor:
    return all_pairs_accel(position, mass=C.PARTICLE_MASS,
                           softening_squared=C.SOFTENING_SQUARED)


def time_ms(fn, reps: int, cuda: bool = True) -> float:
    """Mean ms per call after one warm-up call: CUDA events on a GPU, the
    host clock on the CPU."""
    fn()
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def error_vs(out: torch.Tensor, ref: torch.Tensor):
    """(max |a - a0| / max |a0| over (ax, ay, az), NaN share) of an [4, N]
    or [N, 4] result against v0's [4, N]."""
    a = out.T if out.shape[0] != 4 else out
    a, a0 = a[:3].double(), ref[:3].double()
    nan = float(torch.isnan(a).double().mean())
    err = float(torch.nan_to_num(a - a0, nan=0.0).abs().max())
    return err / float(a0.abs().max()), nan


def tiles(fn, n: int, kw=None) -> bool:
    """Whether n meets fn's shape rules at the case's tiles (`kw`'s tj,
    else the JAX defaults)."""
    rule = {V.unroll_accel: V.unroll_fits, V.hybrid_accel: V.hybrid_fits,
            V.v3_accel: V.v3_fits}.get(fn)
    tj = {"tj": kw["tj"]} if kw and "tj" in kw else {}
    return n % V.TILE == 0 and (rule is None or rule(n, **tj))


def run(n=None, device="cuda", reps=3, log=print, only=()):
    """Time every case (those whose label starts with a prefix in `only`,
    if given) against v0; returns one dict a case run (label, n, ms,
    pairs_per_s, rel_err, nan_share, or skipped)."""
    rows, refs = [], {}
    cuda = torch.device(device).type == "cuda"
    for label, fn, kw, wrong in CASES:
        if only and not label.startswith(tuple(only)):
            continue
        size = n if n is not None else (
            N_HYBRID_DEFAULT if fn is V.hybrid_accel else N_DEFAULT)
        if not tiles(fn, size, kw):
            log(f"{label:24s}: skipped, N={size:,} does not tile")
            rows.append({"label": label, "n": size, "skipped": True})
            continue
        if size not in refs:
            pos = scene(size, device)
            ms0 = time_ms(lambda: v0(pos), reps, cuda)
            refs[size] = (pos, v0(pos))
            log(f"{'v0 rect (N=' + format(size, ',') + ')':24s}: {ms0:9.3f} "
                f"ms  {size * size / ms0 / 1e9:8.4f} Tpairs/s")
        pos, ref = refs[size]
        out = fn(pos, **kw)
        ms = time_ms(lambda: fn(pos, **kw), reps, cuda)
        row = {"label": label, "n": size, "ms": ms,
               "pairs_per_s": size * size / (ms * 1e-3)}
        line = (f"{label:24s}: {ms:9.3f} ms  {size * size / ms / 1e9:8.4f} "
                f"Tpairs/s")
        if wrong:
            line += "  (wrong by design: no error vs v0)"
        else:
            row["rel_err"], row["nan_share"] = error_vs(out, ref)
            line += (f"  vs v0: rel {row['rel_err']:.3e}, "
                     f"nan={row['nan_share'] > 0} ({row['nan_share']:.2e})")
        log(line)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--only", nargs="+", default=(), metavar="PREFIX",
                    help="run only the cases whose label starts with one")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device (pass --device cpu for the plain twins)",
                  file=sys.stderr)
            return 2
        torch.cuda.init()
        print(f"N={args.n or 'harness defaults'}, device "
              f"{torch.cuda.get_device_name(0)}", flush=True)
    else:
        print(f"N={args.n or 'harness defaults'}, device cpu (plain twins)",
              flush=True)
    run(args.n, args.device, args.reps,
        log=lambda s: print(s, flush=True), only=args.only)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
