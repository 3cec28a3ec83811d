"""One step of the demo's shipped integrator, the central well of `CSMain`
(`nBodyGravityCS.hlsl:85-109`; the survey's Appendix A, constants
`Compute.cpp:543-546`). Every particle falls toward a single softened
point mass at the origin, on its own:

    r = p.xyz
    a = r * (-mass / (|r|^2 + eps^2)^(3/2))
    v' = (v + a dt) damping
    p'.xyz = p.xyz + v' dt,  p'.w = |a|

with mass, eps^2, dt and damping from the configuration's `physics`.

Where this departs from the shader:

- it computes in `dtype` (float64 for the reference), where the shader
  works in float32;
- it forms the well's factor as rsqrt(|r|^2 + eps^2) cubed times -mass,
  where the shader takes invDist = -1 / sqrt(distSqr), cubes it and
  scales by mass; in float64 that order moves the result by rounding
  alone;
- it steps only the `rows` it is asked for (None: the first n); the
  shader's dispatch runs every particle of its groups of 64, and the
  columns past n are padding that nothing compares.
"""

from __future__ import annotations

import torch


def step(position, velocity, physics: dict, n: int, rows,
         dtype=torch.float64):
    """(position [4, R], velocity [3, R]) of the `rows` (None: every body)
    after one step."""
    if rows is None:
        rows = slice(0, n)
    r = position[:3, rows].to(dtype)
    inv = torch.rsqrt((r * r).sum(dim=0) + physics["softening_squared"])
    a = r * (inv * inv * inv * -physics["mass"])
    v = (velocity[:, rows].to(dtype) + a * physics["dt"]) * physics["damping"]
    p = r + v * physics["dt"]
    amag = torch.sqrt((a * a).sum(dim=0))
    return torch.cat([p, amag[None]]), v
