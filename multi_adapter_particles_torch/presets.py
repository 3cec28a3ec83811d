"""Named benchmark presets — the BASELINE.json staged configs.

The port's copy of the JAX package's `presets.py` (the same dict, so
`-preset NAME` means the same run in both CLIs). Each preset is a dict of
(AppConfig fields, extra CLI keys) applied by `-preset NAME`; later flags
override. Every preset of the JAX package runs on the port.
"""

from __future__ import annotations

from typing import Optional

PRESETS = {
    # 10k particles, softened all-pairs gravity + Euler, headless, 1 device
    "10k-allpairs": {
        "app": {"num_particles": 10_240, "gui": False, "vsync": False},
        "extra": {"force": "all_pairs", "draw": False, "steps": 200},
    },
    # 100k on one device: the blocked all-pairs force kernel
    "100k-pallas": {
        "app": {"num_particles": 102_400, "gui": False, "vsync": False},
        "extra": {"force": "all_pairs", "draw": False, "steps": 100},
    },
    # 256k with 720p splat render every step, per-phase timing
    "256k-720p": {
        "app": {"num_particles": 262_144, "vsync": False},
        "extra": {
            "width": 1280, "height": 720, "steps": 120, "profile_every": 10,
        },
    },
    # 1M sharded across 8 devices: the ring all-gather
    "1m-mesh8": {
        "app": {"num_particles": 1_048_576, "gui": False, "vsync": False},
        "extra": {"force": "all_pairs", "mesh_devices": 8, "steps": 20},
    },
    # 4M with fused async sim/render overlap (one device)
    "4m-fused": {
        "app": {"num_particles": 4_194_304, "vsync": False},
        "extra": {"fused": True, "steps": 60},
    },
    # 4M self-gravity via FFT particle-mesh
    "4m-pm": {
        "app": {"num_particles": 4_194_304, "gui": False, "vsync": False},
        "extra": {"force": "pm_grid", "draw": False, "steps": 30},
    },
    # 16.8M self-gravity (PM, G=128) + exact splat render on one device
    "16m-pm": {
        "app": {"num_particles": 16_777_216, "gui": False, "vsync": False},
        "extra": {
            "force": "pm_grid", "steps": 10, "pm_grid_size": 128,
            "interaction_scale": 1.0 / 16_777_216,
        },
    },
    # The reference's default scene (N = 4,194,304, defines.h:44) with
    # self-gravity exact at all separations: the tree-P3M near field plus a
    # scene-probed grid
    "4m-tree": {
        "app": {"num_particles": 4_194_304, "gui": False, "vsync": False},
        "extra": {
            "force": "p3m", "draw": False, "steps": 10,
            "p3m_near_mode": "tree",
            "interaction_scale": 1.0 / 4_194_304,
        },
    },
    # 64k P3M self-gravity, exact at all separations (the startup probe
    # picks the slot or the tree near field for the scene)
    "64k-p3m": {
        "app": {"num_particles": 65_536, "gui": False, "vsync": False},
        "extra": {
            "force": "p3m", "draw": False, "steps": 100,
            "pm_box": 4096.0, "interaction_scale": 1.0 / 65_536,
        },
    },
}


def apply_preset(name: str, app_cfg, extra: dict) -> Optional[str]:
    """Apply preset `name` to `app_cfg` / `extra`. Returns None, or the
    error for an unknown preset (nothing applied)."""
    if name not in PRESETS:
        return (f"unknown preset {name!r}; available: "
                f"{', '.join(sorted(PRESETS))}")
    p = PRESETS[name]
    for k, v in p["app"].items():
        setattr(app_cfg, k, v)
    extra.update(p["extra"])
    return None
