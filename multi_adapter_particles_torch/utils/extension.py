"""Performance-extension layer — the ExtensionHelper analog.

The reference probes for Intel's driver extension DLL and, when present,
creates the compute queue with `D3D12_COMMAND_QUEUE_THROTTLE_MAX_PERFORMANCE`
so the simulating adapter is not throttled (`include/ExtensionHelper.h:
62-154`); without driver support it falls back to a plain queue, and the
app toggles it at runtime (`Compute.cpp:148-157`, the `ext` checkbox). The
JAX package's analog compiles with extra XLA options.

On CUDA the closest thing a program can ask of the driver for its compute
queue is a stream priority: with the extension on and a GPU compute
device, the compute engine steps on a stream of the highest priority
`torch.cuda.Stream.priority_range()` offers, so its kernels are scheduled
ahead of the render's when both have work queued (the split frame's render
of state N and step to N+1 are independent). Off (`-noext`, the `ext`
control), the step runs on the device's current stream at the default
priority. On the CPU the helper reports "unavailable", as the JAX probe
does on a backend that refuses its options; it never moves work to
another device.

A live toggle is picked up at the next frame: the split engine asks for
its stream every step. Fused mode only records the toggle: its one
program on one device runs on the current stream, with no second stream
for a priority to beat.
"""

from __future__ import annotations

from typing import Optional

import torch


class ExtensionHelper:
    """A compute stream at the highest priority, when a GPU has one."""

    def __init__(self, device=None, enabled: bool = True):
        self.device = torch.device(device) if device is not None else None
        self.enabled = enabled
        self._stream: Optional[torch.cuda.Stream] = None

    # -- capability probe (the LoadLibrary analog) ---------------------------
    def available(self) -> bool:
        return (self.device is not None and self.device.type == "cuda"
                and torch.cuda.is_available())

    def set_enabled(self, enabled: bool) -> None:
        """Runtime toggle (`Compute::SetUseIntelCommandQueueExtension`)."""
        self.enabled = enabled

    @property
    def active(self) -> bool:
        return self.enabled and self.available()

    @property
    def priority(self) -> Optional[int]:
        """The stream priority the extension asks for (CUDA's greatest:
        the lowest number), None where it is unavailable."""
        if not self.available():
            return None
        return torch.cuda.Stream.priority_range()[1]

    def stream(self) -> Optional[torch.cuda.Stream]:
        """The high-priority compute stream while active, else None (run
        on the current stream)."""
        if not self.active:
            return None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device,
                                             priority=self.priority)
        return self._stream
