"""NumPy oracle: bit-careful CPU reference for init and stepping.

The port's own copy of the JAX package's `models/oracle.py` (importing
any module of that package imports jax, and this package must not); the
two are held bitwise equal by tests/test_torch_host_init.py.

This module is the executable behavioral spec, transcribed from the survey's
Appendix A (reference: `Particles/Compute.cpp:592-923` for init,
`Particles/nBodyGravityCS.hlsl:85-109` for the step). Everything is float32
to match the HLSL/DirectXMath pipeline. All device implementations are tested
against this module.

Init variants mirror the reference's three compile-time tiers
(`Compute.cpp:580-582`):
- 'orig'   — USE_ORIG: uniform draws from a seeded Mersenne Twister
             (upstream seeds from std::random_device; we seed for determinism).
- 'scalar' — USE_SCALAR_OPTIMIZED: the fast_rand LCG
             (seed = 214013*seed + 2531011; out = (seed >> 16) & 0x7FFF,
             `Compute.cpp:596-609`).
- 'simd'   — USE_SIMD_OPTIMIZED: the 4-lane LCG with per-lane multipliers
             {214013, 17405, 214013, 69069} and adders
             {2531011, 10395331, 13737667, 1} (`Compute.cpp:617-661`),
             consuming xyz from 4-wide draws (the 4th lane participates in
             the rejection accumulation exactly as the SSE version's
             XMVectorAdd does — it adds all four lanes, with lane w unused
             by XMVector3LengthSq).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from multi_adapter_particles_torch import constants as C

RAND_MAX = 0x7FFF  # MSVC RAND_MAX, the k_scale divisor (Compute.cpp:722)

F32 = np.float32


# ---------------------------------------------------------------------------
# RNG tiers
# ---------------------------------------------------------------------------
class FastRand:
    """Scalar LCG of `Compute.cpp:602-609` (Intel fast_rand)."""

    def __init__(self, seed: int = 0):
        self.state = int(seed) & 0xFFFFFFFF

    def next(self) -> int:
        # g_seed = 214013 * g_seed + 2531011 (mod 2^32)
        self.state = (214013 * self.state + 2531011) & 0xFFFFFFFF
        return (self.state >> 16) & 0x7FFF

    def uniform3(self) -> np.ndarray:
        k_scale = F32((1.0 / RAND_MAX) * 2.0)
        return np.array(
            [F32(self.next()) * k_scale - F32(1.0) for _ in range(3)], dtype=F32
        )


class RandSse:
    """4-lane LCG of `Compute.cpp:625-661` (Intel rand_sse, compat mode).

    srand_sse(seed) sets lanes (from element 0 upward) to
    [seed+1, seed, seed+1, seed] — _mm_set_epi32 lists high lane first
    (`Compute.cpp:623`: _mm_set_epi32(seed, seed+1, seed, seed+1)).
    """

    MULT = np.array([214013, 17405, 214013, 69069], dtype=np.uint64)
    ADD = np.array([2531011, 10395331, 13737667, 1], dtype=np.uint64)

    def __init__(self, seed: int = 0):
        s = np.uint64(seed)
        self.state = np.array([s + np.uint64(1), s, s + np.uint64(1), s], dtype=np.uint64)

    def next4(self) -> np.ndarray:
        # The SSE code multiplies even/odd lanes with shuffled multipliers so
        # each lane i effectively computes state[i]*MULT[i] + ADD[i] mod 2^32.
        self.state = (self.state * self.MULT + self.ADD) & np.uint64(0xFFFFFFFF)
        # compat mode: arithmetic >> 16 then & 0x7FFF (Compute.cpp:650-652)
        out = (self.state.astype(np.int64) >> 16) & 0x7FFF
        return out.astype(np.int32)

    def uniform4(self) -> np.ndarray:
        k_scale = F32((1.0 / RAND_MAX) * 2.0)
        return self.next4().astype(F32) * k_scale - F32(1.0)


# ---------------------------------------------------------------------------
# Particle initialization (LoadParticles, Compute.cpp:667-812)
# ---------------------------------------------------------------------------
def _dot3(a: np.ndarray, b: np.ndarray) -> F32:
    """Sequential float32 dot — explicit rounding order so the native C++
    implementation (native/fastinit.cpp) can reproduce it bit-for-bit.
    (np.dot routes tiny float32 dots through BLAS, whose accumulation
    order/FMA use is platform-dependent.)"""
    return F32(F32(a[0] * b[0] + a[1] * b[1]) + a[2] * b[2])


def _cross3(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.array(
        [
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        ],
        dtype=F32,
    )


def _finalize(delta: np.ndarray, center: np.ndarray, speed: F32, spread: F32):
    """Shared tail of all LoadParticles variants (Compute.cpp:697-708)."""
    delta = delta[:3]
    delta = delta / F32(np.sqrt(_dot3(delta, delta)))
    pos = (center + delta * spread).astype(F32)
    # velocity perpendicular-ish to the direction to the center of gravity
    direction = pos / F32(np.sqrt(_dot3(pos, pos)))
    perp = np.array([1, 1, 1], dtype=F32) - direction
    perp = perp / F32(np.sqrt(_dot3(perp, perp)))
    vel = _cross3(direction, perp) * speed
    return pos, vel


def load_particles(
    num_particles: int,
    center: Tuple[float, float, float],
    initial_speed: float = C.INITIAL_PARTICLE_SPEED,
    spread: float = C.PARTICLE_SPREAD,
    variant: str = "orig",
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """One cluster: returns (positions [N, 4], velocities [N, 3]) float32.

    positions[:, 3] (the pos.w accel-magnitude channel) starts at 0
    (value-init upstream, `Compute.cpp:825-829`).
    """
    center = np.asarray(center, dtype=F32)
    speed = F32(initial_speed)
    spread_f = F32(spread)
    positions = np.zeros((num_particles, 4), dtype=F32)
    velocities = np.zeros((num_particles, 3), dtype=F32)

    if variant == "orig":
        rng = np.random.Generator(np.random.MT19937(seed))

        def draw3():
            return rng.uniform(-1.0, 1.0, size=3).astype(F32)

        for i in range(num_particles):
            delta = draw3()
            while _dot3(delta, delta) < C.INIT_DELTA_LENGTH_SQ_MIN:
                delta = delta + draw3()
            pos, vel = _finalize(delta, center, speed, spread_f)
            positions[i, :3] = pos
            velocities[i] = vel

    elif variant == "scalar":
        rng = FastRand(seed)
        for i in range(num_particles):
            delta = rng.uniform3()
            while _dot3(delta, delta) < C.INIT_DELTA_LENGTH_SQ_MIN:
                delta = delta + rng.uniform3()
            pos, vel = _finalize(delta, center, speed, spread_f)
            positions[i, :3] = pos
            velocities[i] = vel

    elif variant == "simd":
        rng = RandSse(seed)
        for i in range(num_particles):
            # SIMD variant accumulates full 4-lane draws; length check uses xyz
            delta = np.zeros(4, dtype=F32)
            while True:
                delta = delta + rng.uniform4()
                if _dot3(delta[:3], delta[:3]) >= C.INIT_DELTA_LENGTH_SQ_MIN:
                    break
            pos, vel = _finalize(delta, center, speed, spread_f)
            positions[i, :3] = pos
            velocities[i] = vel
    else:
        raise ValueError(f"unknown init variant {variant!r}")

    return positions, velocities


def initialize_particles(
    num_particles: int,
    variant: str = "orig",
    seed: int = 0,
    spread: float = C.PARTICLE_SPREAD,
    initial_speed: float = C.INITIAL_PARTICLE_SPEED,
) -> Tuple[np.ndarray, np.ndarray]:
    """Two counter-clusters, the `Compute::InitializeParticles` layout
    (`Compute.cpp:820-844`): first half centered at (+0.75*spread, 0, 0),
    second half at (-0.75*spread, 0, 0)."""
    half = num_particles // 2
    center_spread = spread * 0.75
    p0, v0 = load_particles(
        half, (center_spread, 0.0, 0.0), initial_speed, spread, variant, seed
    )
    p1, v1 = load_particles(
        num_particles - half,
        (-center_spread, 0.0, 0.0),
        initial_speed,
        spread,
        variant,
        seed + 1,
    )
    return np.concatenate([p0, p1]), np.concatenate([v0, v1])


# ---------------------------------------------------------------------------
# Simulation step oracles
# ---------------------------------------------------------------------------
def central_well_step(
    positions: np.ndarray,
    velocities: np.ndarray,
    dt: float = C.TIMESTEP,
    damping: float = C.DAMPING,
    mass: float = C.PARTICLE_MASS,
    softening_squared: float = C.SOFTENING_SQUARED,
) -> Tuple[np.ndarray, np.ndarray]:
    """The shipped CSMain (`nBodyGravityCS.hlsl:85-109`):
    one gravity well at the origin, semi-implicit Euler, pos.w = |accel|.
    AoS float32 in/out: positions [N, 4], velocities [N, 3].
    """
    positions = positions.astype(F32)
    velocities = velocities.astype(F32)
    r = positions[:, :3]
    dist_sqr = np.sum(r * r, axis=1, dtype=F32) + F32(softening_squared)
    inv_dist = F32(-1.0) / np.sqrt(dist_sqr, dtype=F32)
    inv_dist_cube = inv_dist * inv_dist * inv_dist
    s = F32(mass) * inv_dist_cube
    accel = r * s[:, None]
    vel = velocities + accel * F32(dt)
    vel = vel * F32(damping)
    pos_xyz = r + vel * F32(dt)
    accel_mag = np.sqrt(np.sum(accel * accel, axis=1, dtype=F32), dtype=F32)
    new_positions = np.concatenate([pos_xyz, accel_mag[:, None]], axis=1)
    return new_positions.astype(F32), vel.astype(F32)


def all_pairs_step(
    positions: np.ndarray,
    velocities: np.ndarray,
    dt: float = C.TIMESTEP,
    damping: float = C.DAMPING,
    mass: float = C.PARTICLE_MASS,
    softening_squared: float = C.SOFTENING_SQUARED,
    interaction_scale: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """O(N^2) softened gravity: `bodyBodyInteraction` applied over all pairs
    (`nBodyGravityCS.hlsl:44-57`; the upstream Microsoft sample's tiled loop),
    then the same Euler tail as CSMain. Self-interaction is included — the
    upstream shader does not exclude i==j (softening makes it zero force).
    float64 accumulation is NOT used: everything f32 like the GPU.
    """
    positions = positions.astype(F32)
    velocities = velocities.astype(F32)
    p = positions[:, :3]
    # r_ij = p_j - p_i
    r = p[None, :, :] - p[:, None, :]
    dist_sqr = np.sum(r * r, axis=2, dtype=F32) + F32(softening_squared)
    inv_dist = F32(1.0) / np.sqrt(dist_sqr, dtype=F32)
    s = F32(mass) * (inv_dist * inv_dist * inv_dist) * F32(interaction_scale)
    accel = np.sum(r * s[:, :, None], axis=1, dtype=F32)
    vel = velocities + accel * F32(dt)
    vel = vel * F32(damping)
    pos_xyz = p + vel * F32(dt)
    accel_mag = np.sqrt(np.sum(accel * accel, axis=1, dtype=F32), dtype=F32)
    new_positions = np.concatenate([pos_xyz, accel_mag[:, None]], axis=1)
    return new_positions.astype(F32), vel.astype(F32)
