"""The comparison that decides a run's `correct`.

A frame of the program turns state N into state N+1 and an image of state
N. The reference (`reference/`) works both out again from state N in
float64: the step for the configuration's force model, on every particle
or on one row drawn from the seed in each block of `check.row_block`
consecutive rows (so every tile of the program's kernels has a row in the
sample), and the whole image. Two numbers compare them:

- `state_gap`: over seven planes, the largest |program - reference| over
  the compared rows, divided by the largest |reference| of that plane;
  the worst plane. The planes are the step's increments, p' - p (x, y, z)
  and v' - v (x, y, z), and |a| (position.w): an increment is a small
  change to a large state, so each is held to its own scale, and an error
  in the force's direction shows on the velocity increments.
- `frame_gap`: the largest |program - reference| over every pixel and
  channel of the [0, 1] image.

A value that is not finite reads as infinity. `verdict` holds the numbers
to the configuration's limits. The control is the same reference computed
in bfloat16 (`dtype`), put in the program's place.
"""

from __future__ import annotations

import importlib
import math

import torch

from benchmark.reference import camera, splat

NUMBERS = ("state_gap", "frame_gap")


def step_reference(cfg: dict):
    """The `step(position, velocity, physics, n, rows, dtype)` of the
    configuration's force model (`reference/<force_model>.py`)."""
    return importlib.import_module(
        f"benchmark.reference.{cfg['force_model']}").step


def sample_rows(cfg: dict, seed: int, device):
    """The rows the step is compared on: all n (None), or one row drawn
    from the seed in each block of `check.row_block` consecutive rows, the
    last block short where n does not divide (sorted)."""
    n, block = cfg["num_particles"], cfg["check"].get("row_block")
    if not block or block <= 1:
        return None
    starts = torch.arange(0, n, block)
    widths = torch.clamp(n - starts, max=block)
    gen = torch.Generator().manual_seed(int(seed) ^ 0x5EED5)
    u = torch.rand(starts.numel(), generator=gen, dtype=torch.float64)
    offsets = torch.minimum((u * widths).long(), widths - 1)
    return (starts + offsets).to(device)


def view_of(cfg: dict, mix: dict) -> dict:
    """The frame's settings, worked out from the configuration and the mix."""
    w, h = cfg["width"], cfg["height"]
    wvp, p00, p11 = camera.view_projection(cfg["camera"], w, h)
    return {"width": w, "height": h, "wvp": wvp, "p00": p00, "p11": p11,
            "size": mix["particle_size"],
            "intensity": mix["particle_intensity"],
            "near": cfg["camera"]["near"],
            "num_draw": cfg["num_particles"]}


def reference_frame(cfg: dict, mix: dict, position, velocity, rows,
                    dtype=torch.float64):
    """(position [4, R], velocity [3, R], image [H, W, 3]) that one frame
    makes of state (position, velocity), in `dtype`."""
    n = cfg["num_particles"]
    pos, vel = step_reference(cfg)(position, velocity, cfg["physics"], n,
                                   rows, dtype)
    image = splat.render(position, view_of(cfg, mix), n, dtype)
    return pos, vel, image


def _gap(a, b) -> float:
    d = (a.to(torch.float64) - b.to(torch.float64)).abs().max()
    v = float(d)
    return v if math.isfinite(v) else math.inf


def planes(before, pos, vel):
    """The seven planes a step is held to, in float64: p' - p (x, y, z),
    |a| and v' - v (x, y, z) of the new state (pos [4, R], vel [3, R])
    against the compared rows of state N, `before` ([4, R], [3, R])."""
    p0 = before[0][:3].to(torch.float64)
    v0 = before[1].to(torch.float64)
    pos, vel = pos.to(torch.float64), vel.to(torch.float64)
    return [pos[k] - p0[k] for k in range(3)] + [pos[3]] + [
        vel[k] - v0[k] for k in range(3)]


def state_gap(before, prog_pos, prog_vel, ref_pos, ref_vel) -> float:
    """The worst plane's largest gap over its largest reference value."""
    top = 0.0
    for p, r in zip(planes(before, prog_pos, prog_vel),
                    planes(before, ref_pos, ref_vel)):
        scale = float(r.abs().max())
        gap = _gap(p, r)
        top = max(top, gap / scale if scale > 0 else gap)
    return top


def frame_gap(prog_image, ref_image) -> float:
    return _gap(prog_image, ref_image)


def compare(cfg: dict, mix: dict, before, after, rows,
            dtype=torch.float64) -> dict:
    """The numbers of one frame: `before` = (position, velocity) it started
    from, `after` = (position, velocity, image) the program made."""
    pos, vel, image = reference_frame(cfg, mix, *before, rows, dtype)
    start = compared(cfg, before, rows)
    prog = compared(cfg, after[:2], rows)
    return {"state_gap": state_gap(start, *prog, pos, vel),
            "frame_gap": frame_gap(after[2], image)}


def compared(cfg: dict, state, rows):
    """The compared rows of (position, velocity)."""
    cols = slice(0, cfg["num_particles"]) if rows is None else rows
    return state[0][:, cols], state[1][:, cols]


def worst(a: dict, b: dict) -> dict:
    """Each number's worse reading of two frames: what a run compares."""
    return {k: max(a[k], b[k]) for k in NUMBERS}


def verdict(numbers: dict, limits: dict) -> list:
    """The names of the numbers over their limits (a number without a
    limit fails)."""
    return [k for k in NUMBERS
            if limits.get(k) is None or not numbers[k] <= limits[k]]


def control(cfg: dict, mix: dict, before, rows, dtype=torch.bfloat16) -> dict:
    """The numbers of the control: the reference computed in `dtype` put
    in the program's place for the frame that starts from `before`."""
    pos, vel, image = reference_frame(cfg, mix, *before, rows, dtype)
    rpos, rvel, rimage = reference_frame(cfg, mix, *before, rows)
    start = compared(cfg, before, rows)
    return {"state_gap": state_gap(start, pos, vel, rpos, rvel),
            "frame_gap": frame_gap(image, rimage)}
