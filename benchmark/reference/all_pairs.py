"""One step of exact softened self-gravity, the demo lineage's
`bodyBodyInteraction` (`nBodyGravityCS.hlsl:44-57`) summed over every
body: a_i = sum_j (p_j - p_i) * mass * scale / (|p_j - p_i|^2 +
eps^2)^(3/2), scale = 1 / n (the self pair adds exactly 0), then the
demo's Euler tail: v' = (v + a dt) damping, p' = p + v' dt, w' = |a|.

Targets are a sample of rows, or all of them; every one of the n bodies
is a source, taken in blocks so the pair planes stay a few hundred MiB.
"""

from __future__ import annotations

import torch

SOURCE_BLOCK = 4096


def accel(position, physics: dict, n: int, rows, dtype=torch.float64):
    """[3, R] accelerations of the `rows` (None: every body) against all
    n bodies."""
    src = position[:3, :n].to(dtype)
    if rows is None:
        rows = slice(0, n)
    tgt = src[:, rows][:, :, None]                       # [3, R, 1]
    acc = torch.zeros((3, tgt.shape[1]), dtype=dtype, device=src.device)
    for j0 in range(0, n, SOURCE_BLOCK):
        d = src[:, None, j0:j0 + SOURCE_BLOCK] - tgt     # [3, R, J]
        d2 = (d * d).sum(dim=0) + physics["softening_squared"]
        inv = torch.rsqrt(d2)
        acc += (d * (inv * inv * inv)).sum(dim=2)
    return acc * (physics["mass"] / n)


def step(position, velocity, physics: dict, n: int, rows,
         dtype=torch.float64):
    """(position [4, R], velocity [3, R]) of the `rows` (None: every body)
    after one step."""
    if rows is None:
        rows = slice(0, n)
    a = accel(position, physics, n, rows, dtype)
    v = (velocity[:, rows].to(dtype) + a * physics["dt"]) * physics["damping"]
    p = position[:3, rows].to(dtype) + v * physics["dt"]
    amag = torch.sqrt((a * a).sum(dim=0))
    return torch.cat([p, amag[None]]), v
