"""Time the Newton-3rd half-pair generations against the rectangle (v0).

    python -m multi_adapter_particles_torch.tools.allpairs_halfpair [N]
        [--device cuda|cpu] [--reps K]
    python -m multi_adapter_particles_torch.tools.allpairs_halfpair v7 [N]
        [--device cuda|cpu] [--reps K]

The port's counterpart of `main()` and `main_v7()` of the JAX package's
`experiments/allpairs_halfpair.py`, on the scene, baseline, timer and error
of `tools/allpairs_variants.py` (uniform in ±400, w = 0, seed 0; v0 is
`ops/allpairs.all_pairs_accel` at `PARTICLE_MASS`). One line per case: ms
per call and Tpairs/s as N² over the time (effective pairs).

- Default mode (N = 131,072): v5 at t = 256 and 512; its attribution modes
  `reduce_only` and `tri_only` at t = 512, labelled "(attr)" and wrong by
  design (no error printed); v5s at t = 256 and 512; v6 at t = 256, 512 and
  1024; then one error line per full form against v0.
- `v7` mode (N = 1,048,576): v7 at (t, kb) = (512, 64), (512, 128),
  (512, 256), (256, 256), each followed by its error against v0.

The error is max |a - a0| over (ax, ay, az) in units of max |a0|. A case
whose t does not divide N is reported as skipped. It runs on the GPU;
`--device cpu` runs the plain twins (slow at the default sizes). It exits
2 when CUDA is missing and the CPU was not asked for. A kernel's failure is
never caught.
"""

from __future__ import annotations

import argparse
import sys

import torch

from multi_adapter_particles_torch.ops import allpairs_halfpair as H
from multi_adapter_particles_torch.tools.allpairs_variants import (
    error_vs,
    scene,
    time_ms,
    v0,
)

N_DEFAULT = 131_072
N_V7_DEFAULT = 1_048_576

# (label, function, keywords, wrong by design) of `main` (:398-416)
CASES = (
    ("v5 halfpair t=256", H.v5_accel, dict(t=256), False),
    ("v5 halfpair t=512", H.v5_accel, dict(t=512), False),
    ("v5 reduce_only t=512 (attr)", H.v5_accel,
     dict(t=512, mode="reduce_only"), True),
    ("v5 tri_only t=512 (attr)", H.v5_accel, dict(t=512, mode="tri_only"),
     True),
    ("v5s static t=256", H.v5s_accel, dict(t=256), False),
    ("v5s static t=512", H.v5s_accel, dict(t=512), False),
    ("v6 prefetch t=256", H.v6_accel, dict(t=256), False),
    ("v6 prefetch t=512", H.v6_accel, dict(t=512), False),
    ("v6 prefetch t=1024", H.v6_accel, dict(t=1024), False),
)
# (t, kb) of `main_v7` (:443)
V7_CASES = ((512, 64), (512, 128), (512, 256), (256, 256))


def cases(v7: bool = False) -> tuple:
    """(label, function, keywords, wrong by design) of each case of the
    mode, in the order it runs them."""
    if not v7:
        return CASES
    return tuple((f"v7 banded t={t} kb={kb}", H.v7_accel, dict(t=t, kb=kb),
                  False) for t, kb in V7_CASES)


def _line(label: str, n: int, ms: float) -> str:
    return f"{label:28s}: {ms:9.3f} ms  {n * n / ms / 1e9:8.4f} Tpairs/s"


def run(n=None, device="cuda", reps=3, v7=False, log=print):
    """Time every case of the mode against v0; returns one dict a case run
    (label, n, ms, pairs_per_s, and rel_err and nan_share for a full form,
    or skipped)."""
    size = n if n is not None else (N_V7_DEFAULT if v7 else N_DEFAULT)
    cuda = torch.device(device).type == "cuda"
    pos = scene(size, device)
    ms0 = time_ms(lambda: v0(pos), reps, cuda)
    ref = v0(pos)
    log(_line(f"v0 baseline (N={size:,})", size, ms0))
    rows, outs = [], []
    for label, fn, kw, wrong in cases(v7):
        if size % kw["t"]:
            log(f"{label:28s}: skipped, N={size:,} does not tile")
            rows.append({"label": label, "n": size, "skipped": True})
            continue
        out = fn(pos, **kw)
        ms = time_ms(lambda: fn(pos, **kw), reps, cuda)
        row = {"label": label, "n": size, "ms": ms,
               "pairs_per_s": size * size / (ms * 1e-3)}
        log(_line(label, size, ms))
        if not wrong:
            row["rel_err"], row["nan_share"] = error_vs(out, ref)
            if v7:
                log(f"   vs v0 rel {row['rel_err']:.3e}")
            else:
                outs.append(row)
        rows.append(row)
    for row in outs:
        log(f"{row['label']} vs v0: rel {row['rel_err']:.3e}, "
            f"nan={row['nan_share'] > 0}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("args", nargs="*", metavar="[v7] [N]")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    rest = list(args.args)
    v7 = bool(rest) and rest[0] == "v7"
    rest = rest[1:] if v7 else rest
    if len(rest) > 1 or (rest and not rest[0].isdigit()):
        ap.error(f"expected [v7] [N], got {' '.join(args.args)}")
    n = int(rest[0]) if rest else None
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device (pass --device cpu for the plain twins)",
                  file=sys.stderr)
            return 2
        torch.cuda.init()
        where = f"device {torch.cuda.get_device_name(0)}"
    else:
        where = "device cpu (plain twins)"
    print(f"{'v7 A/B: ' if v7 else ''}N={n or 'harness default'}, {where}",
          flush=True)
    run(n, args.device, args.reps, v7, log=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
