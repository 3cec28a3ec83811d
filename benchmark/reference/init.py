"""The demo's two-cluster initial state, made on the device from a seed.

The reference initialises on the CPU (`Compute.cpp:667-923`): for each
particle it sums uniform(-1, 1)^3 draws until |delta|^2 >= 10
(`Compute.cpp:690-695`), places it at its cluster's centre (+/-0.75 *
spread, 0, 0) plus delta / |delta| * spread, and gives it a velocity of
length `speed` perpendicular-ish to its radius (`Compute.cpp:697-708`);
pos.w starts 0. Here the same rule draws from a `torch.Generator` on the
device, so the same seed gives the same state on the same kind of card.

The state is SoA: position [4, Np] (x, y, z, w) and velocity [3, Np],
float32, Np = n rounded up to 128, the padding parked at 1e9 with zero
velocity (the layout the program takes).
"""

from __future__ import annotations

import torch

LANE = 128
PARKED = 1.0e9
DELTA_MIN_SQ = 10.0
MAX_DRAWS = 256


def padded(n: int) -> int:
    return -(-n // LANE) * LANE


def _uniform3(count: int, gen: torch.Generator, device) -> torch.Tensor:
    u = torch.rand((count, 3), generator=gen, device=device,
                   dtype=torch.float32)
    return u * 2.0 - 1.0


def two_clusters(n: int, seed: int, device, spread: float, speed: float):
    """(position [4, Np], velocity [3, Np]) for `n` particles from `seed`."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    delta = _uniform3(n, gen, device)
    for _ in range(MAX_DRAWS):
        short = torch.nonzero((delta * delta).sum(dim=1) < DELTA_MIN_SQ)
        if short.numel() == 0:
            break
        short = short.squeeze(1)
        delta[short] += _uniform3(short.numel(), gen, device)
    delta = delta * torch.rsqrt((delta * delta).sum(dim=1, keepdim=True))
    centre = torch.zeros((n, 3), dtype=torch.float32, device=device)
    centre[: n // 2, 0] = spread * 0.75
    centre[n // 2:, 0] = -spread * 0.75
    pos = centre + delta * spread
    radial = pos * torch.rsqrt((pos * pos).sum(dim=1, keepdim=True))
    side = 1.0 - radial
    side = side * torch.rsqrt((side * side).sum(dim=1, keepdim=True))
    vel = torch.linalg.cross(radial, side, dim=1) * speed

    npad = padded(n)
    position = torch.full((4, npad), PARKED, dtype=torch.float32,
                          device=device)
    position[3] = 0.0
    position[:3, :n] = pos.T
    velocity = torch.zeros((3, npad), dtype=torch.float32, device=device)
    velocity[:, :n] = vel.T
    return position, velocity
