"""The benchmark of `multi_adapter_particles_torch` (see README.md)."""
