"""Time the Newton-3rd half-pair generations against the rectangle (v0).

    python -m multi_adapter_particles_torch.tools.allpairs_halfpair [N]
        [--device cuda|cpu] [--reps K] [--profile]
    python -m multi_adapter_particles_torch.tools.allpairs_halfpair v7 [N]
        [--device cuda|cpu] [--reps K] [--profile]

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
whose t does not divide N is reported as skipped. `--profile` adds one
call of each case under torch.profiler: its device ms in tile kernels,
folds and the rest, and for v7 the fold's byte bound and the band tile
kernels' ms above the best-packed band's rate. It runs on the GPU;
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
HBM_BYTES_PER_S = 3.35e12   # the H100 SXM data sheet's HBM rate

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


# Spin kernels that open a profiled window, left out of what it returns:
# the trace can drop a window's first records (2, 20 and over 64 short
# kernels seen on an H100), and the lead, 128 kernels and ~4 ms, takes the
# loss in place of the call's own.
PROFILE_LEAD = 128
PROFILE_LEAD_CYCLES = 60_000


def profile_call(fn):
    """(fn(), [(kernel or memset name, device ms)] in launch order) of one
    call of `fn` on the GPU under torch.profiler. Raises if the trace
    dropped the whole lead, and with it perhaps some of the call's."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_LEAD):
            torch.cuda._sleep(PROFILE_LEAD_CYCLES)
        torch.cuda.synchronize()
        result = fn()
        torch.cuda.synchronize()
    out, lead = [], 0
    for ev in prof.events():
        if ev.device_type.name != "CUDA":
            continue
        if "spin_kernel" in ev.name:
            lead += 1
            continue
        us = getattr(ev, "device_time", None)
        us = ev.cuda_time if us is None else us
        name = ev.name.replace("(anonymous namespace)::", "").split("(")[0]
        out.append((name.removeprefix("void ").strip(), us / 1e3))
    if not lead:
        raise RuntimeError("the profiler dropped every lead kernel of the "
                           "window: its count may miss launches")
    return result, out


def split_kernels(kernels) -> dict:
    """{"tiles", "folds", "other": (device ms, launches)} of a call's
    [(name, ms)]: the tile kernels (tri_kernel, pair_kernel), the slot
    folds (fold_kernel, pair_fold_kernel), the rest (finish, memset)."""
    parts = {"tiles": [0.0, 0], "folds": [0.0, 0], "other": [0.0, 0]}
    for name, ms in kernels:
        base = name.split("<")[0]
        part = ("folds" if base.endswith("fold_kernel") else
                "tiles" if base in ("tri_kernel", "pair_kernel") else "other")
        parts[part][0] += ms
        parts[part][1] += 1
    return {k: tuple(v) for k, v in parts.items()}


def band_tail_ms(band_ms, n: int, t: int, kb: int) -> float:
    """v7's tile-kernel ms above the best-packed band's rate: with each
    band's work its tile pairs weighted by FP32 a pair (15 off the
    diagonal, 12 on it), the sum over bands of ms - rate x work at the
    least ms per unit of work of any band. What partial waves and the
    in-band triangle's short CTAs cost, with every other per-band cost."""
    bands = H.v7_bands(n, t, kb)
    if len(band_ms) != len(bands):
        raise ValueError(f"{len(band_ms)} band times for {len(bands)} bands")
    work = [15 * off + 12 * kbb for _, kbb, off in bands]
    rate = min(ms / w for ms, w in zip(band_ms, work))
    return sum(ms - rate * w for ms, w in zip(band_ms, work))


def _profile_lines(fn, pos, kw: dict) -> list[str]:
    n = pos.shape[1]
    _, kernels = profile_call(lambda: fn(pos, **kw))
    parts = split_kernels(kernels)
    total = sum(ms for ms, _ in parts.values())
    lines = [f"   profile: {total:.3f} device ms = " + ", ".join(
        f"{k} {ms:.3f} ({c} launches)" for k, (ms, c) in parts.items())]
    if fn is H.v7_accel:
        t, kb = kw["t"], kw["kb"]
        fold_ms = parts["folds"][0]
        nbytes = H.v7_fold_bytes(n, t, kb)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        band_ms = [ms for name, ms in kernels
                   if name.startswith("tri_kernel")]
        tail = band_tail_ms(band_ms, n, t, kb)
        lines.append(f"   fold {fold_ms:.3f} ms, byte bound {bound:.3f} ms "
                     f"({nbytes / 1e9:.3f} GB at 3.35 TB/s) -> "
                     f"{bound / fold_ms:.1%}; band tiles above the "
                     f"best-packed band's rate {tail:.3f} ms "
                     f"({tail / total:.1%} of the call)")
    return lines


def run(n=None, device="cuda", reps=3, v7=False, log=print, profile=False):
    """Time every case of the mode against v0; returns one dict a case run
    (label, n, ms, pairs_per_s, and rel_err and nan_share for a full form,
    or skipped). `profile` (GPU only): also one call of each case under
    torch.profiler, its device time split into tile kernels, folds and the
    rest (v7: the fold's byte bound and the bands' tails)."""
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
        if profile:
            for line in _profile_lines(fn, pos, kw):
                log(line)
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
    ap.add_argument("--profile", action="store_true",
                    help="split one call of each case by kernel (GPU)")
    args = ap.parse_args(argv)
    rest = list(args.args)
    v7 = bool(rest) and rest[0] == "v7"
    rest = rest[1:] if v7 else rest
    if len(rest) > 1 or (rest and not rest[0].isdigit()):
        ap.error(f"expected [v7] [N], got {' '.join(args.args)}")
    n = int(rest[0]) if rest else None
    if args.profile and args.device != "cuda":
        ap.error("--profile needs --device cuda")
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
    run(n, args.device, args.reps, v7, log=lambda s: print(s, flush=True),
        profile=args.profile)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
