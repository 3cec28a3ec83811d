"""`python -m multi_adapter_particles_torch` — the WinMain entry point analog."""

from multi_adapter_particles_torch.app import main

raise SystemExit(main())
