"""Adapter enumeration and role assignment.

The reference enumerates DXGI hardware adapters, skips software adapters,
and assigns roles by a UMA heuristic: integrated (UMA) adapter gets the
compute role, the discrete adapter renders; same adapter for both roles
selects single-adapter async-compute mode (`Particles.cpp:95-122,212-243`).

Here every CUDA device (`cuda:i`) is an adapter, and the host CPU is kept
in the list as the weak "integrated" analog (it exercises the cross-device
copy path without a second card). Role assignment, as in the JAX package:

- default with 2+ GPUs: SPLIT — compute on the first, render on the second;
- default with one GPU: both roles share it -> async-compute mode (zero
  copies);
- any explicit pair of distinct devices -> split mode with a positions copy
  each frame (the cross-adapter shared heap + copy queue analog).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdapterInfo:
    """One selectable adapter (`DXGI_ADAPTER_DESC1` analog)."""

    index: int
    device: torch.device
    platform: str        # 'gpu' | 'cpu'
    description: str

    @property
    def is_accelerator(self) -> bool:
        return self.platform != "cpu"

    # The UMA bit drove the reference's role heuristic (AdapterShared.h:93-101):
    # the CPU is the only adapter that shares memory with the host here.
    @property
    def is_uma(self) -> bool:
        return self.platform == "cpu"


def enumerate_adapters() -> List[AdapterInfo]:
    """All selectable devices, GPUs first, the CPU last
    (`Particles.cpp:95-122`)."""
    adapters: List[AdapterInfo] = []
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            adapters.append(AdapterInfo(
                index=len(adapters),
                device=torch.device("cuda", i),
                platform="gpu",
                description=f"{torch.cuda.get_device_name(i)} (id {i})",
            ))
    adapters.append(AdapterInfo(
        index=len(adapters), device=torch.device("cpu"), platform="cpu",
        description="cpu (id 0)",
    ))
    return adapters


def assign_adapters(
    adapters: Sequence[AdapterInfo],
    compute_index: Optional[int] = None,
    render_index: Optional[int] = None,
) -> Tuple[AdapterInfo, AdapterInfo]:
    """Pick (compute, render) adapters (`Particles.cpp:212-243`): with 2+
    GPUs compute takes the first and render the second; with one, both
    share it. The CPU never wins a default role next to a GPU."""
    pool = [a for a in adapters if a.is_accelerator] or list(adapters)
    same_platform = [a for a in pool if a.platform == pool[0].platform]
    default_compute = same_platform[0]
    default_render = (
        same_platform[1] if len(same_platform) > 1 else same_platform[0]
    )
    compute = (
        adapters[compute_index] if compute_index is not None else default_compute
    )
    render = (
        adapters[render_index] if render_index is not None else default_render
    )
    return compute, render


def mode_banner(compute: AdapterInfo, render: AdapterInfo) -> str:
    """The GUI status line (`Particles.cpp:354-368`)."""
    if compute.device == render.device:
        return "Single Adapter with Async Compute"
    if compute.is_uma or not render.is_uma:
        # split across devices with the weak one computing = the demo's
        # "Good" configuration
        return "Good: Multi-Adapter Split (compute/render on separate devices)"
    return "PERFORMANCE ISSUE: Compute is not UMA"
