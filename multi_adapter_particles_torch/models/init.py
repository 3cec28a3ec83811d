"""Particle initialization, on the device or through the host tiers.

The reference initializes particles on the CPU (`Compute.cpp:667-923`) and
uploads them. The equivalents:

- `initialize_particles_device` runs the same rejection-accumulation
  algorithm (`Compute.cpp:690-695`) on the target device, drawing from an
  explicit `torch.Generator`. The JAX package draws it from `jax.random`
  threefry (`models/init.py:95,124` there), which torch cannot reproduce,
  so the two packages agree in distribution, not bit for bit; a parity
  test hands the JAX state across with `ParticleState.from_numpy`.
- `initialize_particles_host` runs an RNG tier of the reference ('orig' /
  'scalar' / 'simd') through the NumPy oracle (`models/oracle.py`) or the
  native C++ engine (`native/`), then places the state with
  `ParticleState.from_aos`: the upload path. Its states are bitwise the
  JAX package's `initialize_particles_host`.

Both produce two counter-orbiting clusters at (+/-0.75*spread, 0, 0)
(`Compute.cpp:832-844`).
"""

from __future__ import annotations

from typing import Optional

import torch

from multi_adapter_particles_torch import constants as C
from multi_adapter_particles_torch.models.state import (
    ParticleState,
    padded_count,
    parked_position,
)

# Bound on rejection-loop iterations (the JAX package's static ceiling).
# E[|delta|^2] grows by ~1 per draw and the threshold is 10, so ~11 draws
# are expected; the loop stops as soon as every particle is done.
_MAX_ACCUM_ITERS = 256


def _uniform3(count: int, generator: torch.Generator, device) -> torch.Tensor:
    """[count, 3] uniform(-1, 1) float32 draws."""
    u = torch.rand((count, 3), generator=generator, device=device,
                   dtype=torch.float32)
    return u * 2.0 - 1.0


def _cluster_deltas(count: int, generator: torch.Generator, device
                    ) -> torch.Tensor:
    """[count, 3] accumulated directions: sum uniform(-1,1)^3 draws until
    |sum|^2 >= 10 (`Compute.cpp:690-695`); each round draws only for the
    particles still below the threshold."""
    delta = _uniform3(count, generator, device)
    for _ in range(_MAX_ACCUM_ITERS):
        active = torch.nonzero(
            (delta * delta).sum(dim=1) < C.INIT_DELTA_LENGTH_SQ_MIN
        ).squeeze(1)
        if active.numel() == 0:
            break
        delta[active] += _uniform3(active.numel(), generator, device)
    return delta


def _current_cuda(caller: str, alt: str = "") -> torch.device:
    """The current CUDA device; raises where there is none (the port never
    falls back to the CPU unasked)."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"{caller}: no CUDA device; pass device='cpu' "
                           f"{alt}to init on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def initialize_particles_device(
    num_particles: int,
    generator: Optional[torch.Generator] = None,
    device=None,
    spread: float = C.PARTICLE_SPREAD,
    initial_speed: float = C.INITIAL_PARTICLE_SPEED,
) -> ParticleState:
    """Two clusters, born on `device`. pos.w starts 0 (`Compute.cpp:825-829`).

    `generator` must live on `device` (a CPU generator for a CPU device);
    None = a fresh generator seeded with 0. With no `device`, the state is
    born on the generator's device, or without a generator on the current
    CUDA device, as the JAX init uses the default (accelerator) device; it
    raises where there is no CUDA device. It never falls back to the CPU.
    """
    if device is None:
        device = (generator.device if generator is not None
                  else _current_cuda("initialize_particles_device",
                                     "(or a CPU generator) "))
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    n = int(num_particles)
    np_pad = padded_count(n)
    half = n // 2
    center_x = spread * 0.75

    delta = _cluster_deltas(n, generator, device)                  # [n, 3]
    delta = delta * torch.rsqrt((delta * delta).sum(dim=1, keepdim=True))
    center = torch.zeros((n, 3), dtype=torch.float32, device=device)
    center[:half, 0] = center_x
    center[half:, 0] = -center_x
    pos = center + delta * spread
    # velocity rule (`Compute.cpp:697-708`): perpendicular-ish to the
    # radius, |v| = initial_speed
    direction = pos * torch.rsqrt((pos * pos).sum(dim=1, keepdim=True))
    perp = 1.0 - direction
    perp = perp * torch.rsqrt((perp * perp).sum(dim=1, keepdim=True))
    vel = torch.linalg.cross(direction, perp, dim=1) * initial_speed

    position = parked_position(np_pad, device)
    position[:3, :n] = pos.T
    velocity = torch.zeros((3, np_pad), dtype=torch.float32, device=device)
    velocity[:, :n] = vel.T
    return ParticleState(position, velocity)


def initialize_particles_host(
    num_particles: int,
    variant: str = "orig",
    seed: int = 0,
    spread: float = C.PARTICLE_SPREAD,
    initial_speed: float = C.INITIAL_PARTICLE_SPEED,
    use_native: Optional[bool] = None,
    device=None,
) -> ParticleState:
    """Host-side init through an RNG tier, placed on `device` (default the
    current CUDA device; the CPU only when named): the staging-buffer
    upload's analog, the JAX package's `initialize_particles_host`.

    `use_native` None routes the LCG tiers ('scalar', 'simd') to the native
    engine, bitwise the oracle there, and 'orig' to the oracle (native
    'orig', std::mt19937, is deterministic but another stream than NumPy's
    MT19937); True forces native, False the oracle (per-particle Python,
    minutes at 4M). A native build failure raises."""
    device = torch.device(device if device is not None
                          else _current_cuda("initialize_particles_host"))
    if use_native or (use_native is None and variant in ("scalar", "simd")):
        from multi_adapter_particles_torch.native import fastinit as gen
    else:
        from multi_adapter_particles_torch.models import oracle as gen
    pos, vel = gen.initialize_particles(
        num_particles, variant=variant, seed=seed, spread=spread,
        initial_speed=initial_speed)
    return ParticleState.from_aos(pos, vel, device=device)
