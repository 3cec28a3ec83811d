"""Configuration dataclasses — the three-tier config system.

The port's own copy of the JAX package's `config.py` (that package cannot
be imported without jax): the same fields, defaults and `resolved_counts`.
Every force model is accepted here so configs round-trip between the two
packages; the port's engine runs all four, p3m with either near field.

The reference has compile-time defines (`defines.h`), a CLI (`ArgParser`,
`Particles.cpp:248-270`) and runtime GUI toggles with prev-value change
detection (`Particles.cpp:162-166,458-463`). Here the same split is:

- `SimConfig` / `RenderConfig`: per-engine parameters. Changing one
  rebuilds the engine, the analog of the reference's pipeline rebuild.
- `AppConfig`: runtime-mutable knobs (counts, size, intensity, mode flags)
  read every frame.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from multi_adapter_particles_torch import constants as C


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Physics + sizing parameters for the simulation step.

    Defaults reproduce the reference exactly (`Compute.cpp:543-546`,
    `nBodyGravityCS.hlsl:37-38`).
    """

    num_particles: int = C.DEFAULT_NUM_PARTICLES
    dt: float = C.TIMESTEP
    damping: float = C.DAMPING
    mass: float = C.PARTICLE_MASS
    softening_squared: float = C.SOFTENING_SQUARED
    # 'central_well' = the shipped CSMain (nBodyGravityCS.hlsl:85-109);
    # 'all_pairs' = the exact O(N^2) self-gravity (bodyBodyInteraction,
    # nBodyGravityCS.hlsl:44-57), half-pair schedule unless all_pairs_half
    # is False. pm_grid = FFT particle-mesh (ops/pm.py); p3m = PM far field
    # + exact pairwise near field (ops/p3m.py, ops/treeforce.py). The
    # fields below keep the JAX package's meaning and defaults;
    # tree_half_force picks the Newton-3rd halved tree sweep (-treedirected
    # turns it off).
    force_model: str = "central_well"
    # Per-interaction multiplier; None = auto: 1.0 for central_well, 1/N for
    # the self-gravity models (keeps the total mass at the well's value).
    interaction_scale: Optional[float] = None
    pm_grid_size: int = 64
    pm_box: float = 2048.0
    p3m_cutoff_cells: float = 6.75
    p3m_capacity: int = 64
    p3m_near_mode: str = "auto"
    p3m_pair_budget: Optional[int] = None
    p3m_sub_pair_budget: Optional[int] = None
    pm_distributed_fft: bool = False
    all_pairs_half: bool = True
    tree_half_force: bool = True

    def __post_init__(self):
        if self.num_particles <= 0:
            raise ValueError("num_particles must be positive")
        if self.force_model not in (
            "central_well", "all_pairs", "pm_grid", "p3m"
        ):
            raise ValueError(f"unknown force_model {self.force_model!r}")
        if self.interaction_scale is None:
            object.__setattr__(
                self,
                "interaction_scale",
                1.0
                if self.force_model == "central_well"
                else 1.0 / self.num_particles,
            )
        if self.p3m_near_mode not in ("auto", "slots", "tree"):
            raise ValueError(
                f"unknown p3m_near_mode {self.p3m_near_mode!r}"
            )
        if self.force_model == "p3m":
            from multi_adapter_particles_torch.ops.p3m import (
                validate_cutoff_cells,
            )

            validate_cutoff_cells(self.p3m_cutoff_cells)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Camera + splat parameters (`Render.cpp:139,776`, `defines.h:40-41`)."""

    width: int = C.DEFAULT_WINDOW_WIDTH
    height: int = C.DEFAULT_WINDOW_HEIGHT
    fov_y: float = C.CAMERA_FOV_Y
    near: float = C.CAMERA_NEAR
    far: float = C.CAMERA_FAR
    camera_position: Tuple[float, float, float] = C.CAMERA_POSITION
    # Quantize the frame to RGB8 on device — the reference swap chain's
    # R8G8B8A8_UNORM analog (`Render.cpp:292`); 4x cheaper host pulls.
    frame_uint8: bool = False
    # Borderless-fullscreen resolution (`Render.cpp:287-413`): the
    # headless stand-in for the display's native mode. Flipping
    # `AppConfig.fullscreen` live drains and rebuilds the render engine
    # at this resolution (`Particles.cpp:458-463,488-509`).
    fullscreen_width: int = 1920
    fullscreen_height: int = 1080

    @property
    def aspect(self) -> float:
        return self.width / self.height

    def resolved(self, fullscreen: bool) -> "RenderConfig":
        """The config the render engine should actually run at: this one,
        or the fullscreen-resolution variant of it when the runtime
        fullscreen toggle is on (the swap-chain rebuild analog)."""
        if not fullscreen:
            return self
        return dataclasses.replace(
            self, width=self.fullscreen_width, height=self.fullscreen_height
        )


@dataclasses.dataclass
class AppConfig:
    """Runtime-mutable application knobs.

    Field names intentionally track the reference's CLI flags
    (`Particles.cpp:251-267`): numparticles, numsim, numcopy, numdraw, size,
    intensity, nogui, novsync, fullscreen, noext.
    """

    num_particles: int = C.DEFAULT_NUM_PARTICLES
    # Decoupled pipeline-stage counts (`Particles.cpp:265-267`): number of
    # particles simulated / transferred / drawn each frame. None = linked to
    # num_particles (the GUI "link" toggle, `Particles.cpp:379-394`).
    num_sim: Optional[int] = None
    num_copy: Optional[int] = None
    num_draw: Optional[int] = None
    linked: bool = True

    particle_size: float = C.INITIAL_PARTICLE_SIZE
    particle_intensity: float = C.INITIAL_PARTICLE_INTENSITY

    gui: bool = True
    vsync: bool = True
    # -novsync dispatch-ahead bound: at most this many frames in flight
    # before the host blocks on the oldest (the latency-waitable swapchain's
    # SetMaximumFrameLatency, `Render.cpp:298-308`).
    max_frame_latency: int = 2
    fullscreen: bool = False
    # The Intel command-queue throttle extension analog: request
    # max-performance scheduling for the compute role (ExtensionHelper.h:138).
    # On CUDA: the compute engine steps on a stream of the highest priority
    # (utils/extension.py); nothing on the CPU.
    use_queue_extension: bool = True

    def resolved_counts(self) -> Tuple[int, int, int]:
        """(num_sim, num_copy, num_draw) with link semantics applied.

        Linked mode tracks the Rendered slider (`Particles.cpp:388-392`:
        copied and simulated counts snap to the rendered count while the
        link checkbox is on); an unset rendered count means everything.
        """
        if self.linked:
            n = (
                min(self.num_draw, self.num_particles)
                if self.num_draw is not None
                else self.num_particles
            )
            return n, n, n
        n = self.num_particles
        return (
            min(self.num_sim if self.num_sim is not None else n, n),
            min(self.num_copy if self.num_copy is not None else n, n),
            min(self.num_draw if self.num_draw is not None else n, n),
        )
