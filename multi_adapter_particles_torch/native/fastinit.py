"""ctypes binding for the native particle initializer (`fastinit.cpp`).

The port's counterpart of the JAX package's `native/fastinit.py`.
`initialize_particles` mirrors `models/oracle.py::initialize_particles`
(two counter-orbiting clusters, seeds `seed` and `seed+1`) and is
bit-identical to the oracle for variants 'scalar' and 'simd' when
`chunks=1`; 'orig' (std::mt19937) is deterministic but draws another
stream than NumPy's MT19937.

The library builds with g++ at first use (`ops/_build.build_host`, the
JAX package's Makefile flags, -ffp-contract=off among them), next to the
CUDA kernels' libraries. A failed build raises with the compiler's
output: there is no fall-through to the per-particle oracle.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import numpy as np

from multi_adapter_particles_torch import constants as C
from multi_adapter_particles_torch.ops import _build

SOURCE = Path(__file__).with_name("fastinit.cpp")
_ABI_VERSION = 1


@functools.cache
def _lib() -> ctypes.CDLL:
    """Build (if needed) and load the library, once per process."""
    lib = ctypes.CDLL(str(_build.build_host(SOURCE)))
    lib.map_fastinit_abi_version.restype = ctypes.c_int
    lib.map_fastinit_abi_version.argtypes = []
    if lib.map_fastinit_abi_version() != _ABI_VERSION:
        raise RuntimeError("native fastinit: ABI version mismatch")
    lib.map_load_particles.restype = ctypes.c_int
    lib.map_load_particles.argtypes = [
        ctypes.c_int64,
        ctypes.c_char_p,
        ctypes.c_uint32,
        ctypes.c_float,
        ctypes.c_float,
        ctypes.c_float,
        ctypes.c_float,
        ctypes.c_float,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
    ]
    return lib


def load_particles(
    num_particles: int,
    center: Tuple[float, float, float],
    initial_speed: float = C.INITIAL_PARTICLE_SPEED,
    spread: float = C.PARTICLE_SPREAD,
    variant: str = "scalar",
    seed: int = 0,
    chunks: int = 1,
) -> Tuple[np.ndarray, np.ndarray]:
    """One cluster -> (positions [N, 4], velocities [N, 3]) float32."""
    if num_particles < 0:
        raise ValueError(f"num_particles {num_particles} < 0")
    lib = _lib()
    pos = np.zeros((num_particles, 4), dtype=np.float32)
    vel = np.zeros((num_particles, 3), dtype=np.float32)
    rc = lib.map_load_particles(
        num_particles,
        variant.encode(),
        np.uint32(seed),
        np.float32(center[0]),
        np.float32(center[1]),
        np.float32(center[2]),
        np.float32(initial_speed),
        np.float32(spread),
        int(chunks),
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        vel.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc != 0:
        raise ValueError(f"native init failed (variant={variant!r}, rc={rc})")
    return pos, vel


def initialize_particles(
    num_particles: int,
    variant: str = "scalar",
    seed: int = 0,
    spread: float = C.PARTICLE_SPREAD,
    initial_speed: float = C.INITIAL_PARTICLE_SPEED,
    chunks: int = 1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Two counter-clusters (`Compute.cpp:820-844` layout)."""
    half = num_particles // 2
    center_spread = spread * 0.75
    p0, v0 = load_particles(
        half, (center_spread, 0.0, 0.0), initial_speed, spread, variant,
        seed, chunks,
    )
    p1, v1 = load_particles(
        num_particles - half, (-center_spread, 0.0, 0.0), initial_speed,
        spread, variant, seed + 1, chunks,
    )
    return np.concatenate([p0, p1]), np.concatenate([v0, v1])
