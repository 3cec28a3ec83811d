"""multi_adapter_particles_torch — the PyTorch / CUDA port of the particle
simulation + splat renderer.

It runs beside `multi_adapter_particles_tpu` (the JAX package, which stays
the reference) and imports `torch` and numpy only — never jax, never the JAX
package. Tensors keep that package's layout so the two compare 1:1:
SoA `position[4, Np]` / `velocity[3, Np]` float32, Np padded to 128.

The hot kernels are hand-written CUDA C++ for Hopper (`csrc/*.cu`, built at
first use by `ops/_build.py`); each has a plain torch twin in the same module
that runs for CPU tensors, so the CPU tests hold the port against the JAX
package.
"""

from multi_adapter_particles_torch import constants
from multi_adapter_particles_torch.config import (
    AppConfig,
    RenderConfig,
    SimConfig,
)
from multi_adapter_particles_torch.models.state import ParticleState

__version__ = "0.1.0"

__all__ = [
    "AppConfig",
    "RenderConfig",
    "SimConfig",
    "ParticleState",
    "constants",
    "__version__",
]
