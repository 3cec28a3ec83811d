"""Particle state on torch tensors.

The same contract as the JAX package's `models/state.py`, so tensors compare
1:1 with it:

- **SoA planes** `position[4, Np]` (x, y, z, |accel|) and `velocity[3, Np]`,
  both float32 (the reference keeps AoS float4/float3 buffers,
  `nBodyGravityCS.hlsl:107`, `Compute.h:66-69`).
- `Np` is padded up to a multiple of 128 (`constants.LANE`); padding
  particles are parked at `PAD_POSITION` with zero velocity so they never
  affect rendering.
- The reference's 2+2 ping-pong UAVs (`Compute.h:80,106-108`) are two
  preallocated states that the compute engine swaps (see
  `runtime/compute_engine.py`); a state object itself is plain data.

`from_numpy` / `to_numpy` carry a state across from (and back to) the JAX
package as numpy arrays in this same layout.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from multi_adapter_particles_torch import constants as C

# Padding particles park here: far outside the far plane (5000,
# Render.cpp:776) and the simulation region (spread 400).
PAD_POSITION = 1.0e9


class ParticleState:
    """SoA particle state: position[4, Np] (x, y, z, |accel|), velocity[3, Np].

    `Np` is the padded count. The logical count is not part of the state
    (it is config); use `make_mask` when it matters.
    """

    __slots__ = ("position", "velocity")

    def __init__(self, position: torch.Tensor, velocity: torch.Tensor):
        self.position = position
        self.velocity = velocity

    @property
    def padded_count(self) -> int:
        return self.position.shape[-1]

    @property
    def dtype(self) -> torch.dtype:
        return self.position.dtype

    @property
    def device(self) -> torch.device:
        return self.position.device

    def __repr__(self):
        return (
            f"ParticleState(padded_count={self.padded_count}, "
            f"dtype={self.position.dtype}, device={self.position.device})"
        )

    def to(self, device) -> "ParticleState":
        """A copy on `device` (always a copy, never an alias)."""
        return ParticleState(
            self.position.to(device, copy=True),
            self.velocity.to(device, copy=True),
        )

    def empty_like(self) -> "ParticleState":
        """An uninitialised state of the same shape, dtype and device."""
        return ParticleState(
            torch.empty_like(self.position), torch.empty_like(self.velocity)
        )

    # -- conversions ----------------------------------------------------------
    @classmethod
    def from_numpy(
        cls, position: np.ndarray, velocity: np.ndarray, device=None
    ) -> "ParticleState":
        """From SoA numpy planes ([4, Np], [3, Np]) — e.g. the JAX package's
        `np.asarray(state.position)` / `np.asarray(state.velocity)`."""
        position = np.asarray(position, dtype=np.float32)
        velocity = np.asarray(velocity, dtype=np.float32)
        if position.ndim != 2 or position.shape[0] != 4:
            raise ValueError(f"position must be [4, Np], got {position.shape}")
        if velocity.shape != (3, position.shape[1]):
            raise ValueError(f"velocity must be [3, Np], got {velocity.shape}")
        return cls(
            torch.tensor(position, device=device),
            torch.tensor(velocity, device=device),
        )

    def to_numpy(self) -> Tuple[np.ndarray, np.ndarray]:
        """SoA numpy copies ([4, Np], [3, Np]) of this state."""
        return (
            self.position.detach().cpu().numpy().copy(),
            self.velocity.detach().cpu().numpy().copy(),
        )

    @classmethod
    def from_aos(
        cls,
        positions: np.ndarray,
        velocities: np.ndarray,
        pad_to_lane: bool = True,
        device=None,
    ) -> "ParticleState":
        """Build from reference-layout arrays: positions [N, 4], velocities [N, 3]."""
        positions = np.asarray(positions, dtype=np.float32)
        velocities = np.asarray(velocities, dtype=np.float32)
        if positions.ndim != 2 or positions.shape[1] != 4:
            raise ValueError(f"positions must be [N, 4], got {positions.shape}")
        if velocities.shape != (positions.shape[0], 3):
            raise ValueError(f"velocities must be [N, 3], got {velocities.shape}")
        n = positions.shape[0]
        np_pad = padded_count(n) if pad_to_lane else n
        pos = np.full((4, np_pad), PAD_POSITION, dtype=np.float32)
        pos[3, :] = 0.0
        vel = np.zeros((3, np_pad), dtype=np.float32)
        pos[:, :n] = positions.T
        vel[:, :n] = velocities.T
        return cls.from_numpy(pos, vel, device=device)

    def to_aos(self, num_particles: int) -> Tuple[np.ndarray, np.ndarray]:
        """Back to reference layout ([N, 4], [N, 3]) for oracles and IO."""
        pos, vel = self.to_numpy()
        return (
            np.ascontiguousarray(pos[:, :num_particles].T),
            np.ascontiguousarray(vel[:, :num_particles].T),
        )

    def make_mask(self, num_particles: int) -> torch.Tensor:
        """[Np] float32 mask: 1 for real particles, 0 for padding."""
        idx = torch.arange(self.padded_count, device=self.device)
        return (idx < num_particles).to(self.dtype)


def padded_count(n: int, lane: int = C.LANE) -> int:
    """Round a particle count up to the lane multiple."""
    return -(-n // lane) * lane


def parked_position(np_pad: int, device=None) -> torch.Tensor:
    """[4, np_pad] float32 planes with every column parked (w = 0)."""
    pos = torch.full((4, np_pad), PAD_POSITION, dtype=torch.float32,
                     device=device)
    pos[3].zero_()
    return pos


def zeros(num_particles: int, device: Optional[torch.device] = None
          ) -> ParticleState:
    """All-zero state (padding parked), mostly for shape probing and tests."""
    pos = parked_position(padded_count(num_particles), device)
    pos[:3, :num_particles] = 0.0
    vel = torch.zeros((3, pos.shape[1]), dtype=torch.float32, device=device)
    return ParticleState(pos, vel)
