"""Checkpoint / resume: a host-side snapshot of the particle state on disk.

The port of the JAX package's `utils/checkpoint.py`, in its file format,
so either package reads the other's checkpoints. The reference has no
disk persistence; its in-memory state hand-off across device generations
(`Compute::CopyState`, `Compute.cpp:303-410`) is the analog.

Format (`FORMAT_VERSION` 1): one .npz with `position` float32 [4, Np],
`velocity` float32 [3, Np], and int64 scalars `step`, `num_particles`,
`version`. Written atomically: a temporary file in the target's directory,
then a rename.

`load_checkpoint` puts the state on the device its caller names; there is
no default, so a run on the GPU never resumes on the CPU by accident.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional, Tuple

import numpy as np
import torch

from multi_adapter_particles_torch.models.state import ParticleState

FORMAT_VERSION = 1


def save_checkpoint(
    path: str,
    state: ParticleState,
    step: int,
    num_particles: Optional[int] = None,
) -> None:
    """Write state + step atomically. Blocks until the state is readable
    (the device -> host copy)."""
    pos = state.position.detach().cpu().numpy()
    vel = state.velocity.detach().cpu().numpy()
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(
                f,
                position=pos,
                velocity=vel,
                step=np.int64(step),
                num_particles=np.int64(
                    num_particles if num_particles is not None else pos.shape[1]
                ),
                version=np.int64(FORMAT_VERSION),
            )
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_checkpoint(path: str, device) -> Tuple[ParticleState, int, int]:
    """-> (state on `device`, step, num_particles)."""
    with np.load(path) as z:
        version = int(z["version"])
        if version > FORMAT_VERSION:
            raise ValueError(f"checkpoint version {version} too new")
        device = torch.device(device)
        state = ParticleState(
            torch.from_numpy(np.array(z["position"], np.float32)).to(device),
            torch.from_numpy(np.array(z["velocity"], np.float32)).to(device),
        )
        return state, int(z["step"]), int(z["num_particles"])
