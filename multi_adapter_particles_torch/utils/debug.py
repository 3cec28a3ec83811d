"""Debug validation layer — the D3D12 debug-layer analog.

The port of the JAX package's `utils/debug.py`. The reference enables the
D3D12 debug layer and DXGI debug factory in debug builds
(`Particles.cpp:80-99`) to catch API misuse and resource hazards; its
fence protocol's single-writer rules are its correctness argument
(`Render.cpp:38-85`). Here, with `ParticlesApp(debug=True)` or `-debug`,
every frame checks:

- **finiteness**: the live columns of the state (position and velocity)
  hold no NaN or Inf (`validate_state`; one device -> host read a frame),
  in split and in fused mode;
- **the double-buffer hand-off** (`validate_handoff`): the positions the
  next frame draws are the compute engine's newest state and never the
  buffer its next step writes, and a render engine that keeps its own
  copy (another device, or a `num_copy` prefix) never shares storage with
  either compute buffer; in fused mode the render buffer and the step's
  output buffer are distinct storage.

The JAX package also turns buffer donation off in debug mode, so a stale
read cannot hide behind an aliased buffer. The port has nothing to turn
off: its engines never donate (each step writes into a second buffer it
allocated, and torch frees a tensor only when no reference is left), so
there is no CUDA counterpart and none is made up here.
"""

from __future__ import annotations

from typing import Optional

import torch


class DebugValidationError(AssertionError):
    pass


def validate_state(state, num_particles: Optional[int] = None,
                   where: str = "") -> None:
    """Raise unless the state's live columns are finite."""
    for name in ("position", "velocity"):
        arr = getattr(state, name)
        if num_particles is not None:
            arr = arr[:, :num_particles]
        bad = int((~torch.isfinite(arr)).sum())
        if bad:
            raise DebugValidationError(
                f"{where}: {name} has {bad} non-finite values"
            )


def _ptr(t):
    """A tensor's storage, or the tuple of a sharded plane's storages."""
    if not isinstance(t, torch.Tensor):
        return tuple(_ptr(s) for s in t.shards)
    return (t.device, t.untyped_storage().data_ptr())


def validate_handoff(compute, render, display_positions,
                     where: str = "") -> None:
    """Split mode: `display_positions` is the compute engine's newest
    state and not the spare buffer its next step writes; a render engine
    that owns its local copy shares storage with neither compute buffer.
    A mesh engine's buffers are its sharded planes."""
    state = compute.positions
    spare = compute._spare.position
    if _ptr(display_positions) != _ptr(state):
        raise DebugValidationError(
            f"{where}: the positions handed to the render engine are not "
            "the compute engine's newest state — fence-order violation "
            "analog")
    if _ptr(spare) == _ptr(state):
        raise DebugValidationError(
            f"{where}: the compute engine's two state buffers share "
            "storage — the next step would overwrite what is drawn")
    local = getattr(render, "_local", None)
    if local is not None and getattr(render, "_local_owned", False):
        if _ptr(local) in (_ptr(state), _ptr(spare)):
            raise DebugValidationError(
                f"{where}: the render engine's copy shares storage with the "
                "compute state — the copy-queue hand-off was skipped")


def validate_fused_handoff(engine, where: str = "") -> None:
    """Fused mode: the buffer the next frame renders and the one its step
    writes are distinct storage."""
    cur = engine._states[engine._cur]
    nxt = engine._states[1 - engine._cur]
    for name in ("position", "velocity"):
        if _ptr(getattr(cur, name)) == _ptr(getattr(nxt, name)):
            raise DebugValidationError(
                f"{where}: the fused engine's ping-pong {name} buffers share "
                "storage — the step would overwrite what is rendered")
