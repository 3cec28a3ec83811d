"""Fused central-well integrator: CUDA kernel + plain torch twin.

The shipped compute shader (`nBodyGravityCS.hlsl:85-109`) is O(N) and
memory-bound: per particle it reads pos/vel, computes the single-well
acceleration and writes pos/vel back. `central_well_step` runs it as one
pass over the SoA planes (`csrc/central_well.cu`, replacing the JAX
package's Pallas `ops/central_well.py::_kernel`).

- CUDA tensors go to the kernel, or the wrapper raises.
- CPU tensors go to `central_well_step_plain`, the same arithmetic as
  separate torch ops (the analog of the Pallas interpret mode).

`num_live` freezes the tail: columns at or past it are copied through
unchanged, which is how the engine's num_sim knob stays bitwise in a
freshly written buffer.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from multi_adapter_particles_torch.ops import _build

Tensor = torch.Tensor


def central_well_step_plain(
    position: Tensor,
    velocity: Tensor,
    *,
    dt: float,
    damping: float,
    mass: float,
    softening_squared: float,
    num_live: Optional[int] = None,
    out: Optional[Tuple[Tensor, Tensor]] = None,
) -> Tuple[Tensor, Tensor]:
    """Plain torch twin of the kernel (same op order as the Pallas
    `_kernel`): position [4, Np], velocity [3, Np] -> ([4, Np], [3, Np])."""
    x, y, z = position[0], position[1], position[2]
    d2 = x * x + y * y + z * z + softening_squared
    inv = torch.rsqrt(d2)
    s = (inv * inv * inv) * (-mass)  # -mass / d^3
    ax, ay, az = x * s, y * s, z * s
    vx = (velocity[0] + ax * dt) * damping
    vy = (velocity[1] + ay * dt) * damping
    vz = (velocity[2] + az * dt) * damping
    new_pos = torch.stack([
        x + vx * dt, y + vy * dt, z + vz * dt,
        torch.sqrt(ax * ax + ay * ay + az * az),
    ])
    new_vel = torch.stack([vx, vy, vz])
    if num_live is not None and num_live < position.shape[1]:
        new_pos[:, num_live:] = position[:, num_live:]
        new_vel[:, num_live:] = velocity[:, num_live:]
    if out is None:
        return new_pos, new_vel
    out[0].copy_(new_pos)
    out[1].copy_(new_vel)
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("central_well")
    fn = lib.central_well_step
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def central_well_step(
    position: Tensor,
    velocity: Tensor,
    *,
    dt: float,
    damping: float,
    mass: float,
    softening_squared: float,
    num_live: Optional[int] = None,
    out: Optional[Tuple[Tensor, Tensor]] = None,
) -> Tuple[Tensor, Tensor]:
    """One fused integration step. position [4, Np], velocity [3, Np] ->
    (position', velocity'), written into `out` when given (it must not
    alias the inputs). A CPU tensor runs the plain twin; a CUDA tensor
    launches the kernel (counted in `central_well_step.launches`)."""
    kw = dict(dt=dt, damping=damping, mass=mass,
              softening_squared=softening_squared, num_live=num_live,
              out=out)
    if position.device.type == "cpu":
        return central_well_step_plain(position, velocity, **kw)
    if position.device.type != "cuda":
        raise ValueError(
            f"central_well_step runs on cuda or cpu, got {position.device}"
        )
    n = position.shape[-1]
    dev = position.device
    f32 = torch.float32
    _build.check_arg(position, f32, (4, n), dev, "position")
    _build.check_arg(velocity, f32, (3, n), dev, "velocity")
    if out is None:
        out = (torch.empty_like(position), torch.empty_like(velocity))
    _build.check_arg(out[0], f32, (4, n), dev, "out position")
    _build.check_arg(out[1], f32, (3, n), dev, "out velocity")
    for o in out:
        for i in (position, velocity):
            if o.data_ptr() == i.data_ptr():
                raise ValueError("out must not alias the inputs")
    live = n if num_live is None else max(0, min(int(num_live), n))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _library().central_well_step(
            position.data_ptr(), velocity.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), n, live,
            float(dt), float(damping), float(mass), float(softening_squared),
            stream,
        )
    _build.check(rc, "central_well_step")
    central_well_step.launches += 1
    return out


central_well_step.launches = 0
