"""Runtime control surface — the imgui widget panel, decoupled from pixels.

The port's own copy of the JAX package's `runtime/controls.py` (same
names, ranges, key map and messages) over the port's `ParticlesApp`.

Every widget of the reference's control panel (`Particles.cpp:339-394`)
maps to a named control here: adapter list boxes (`:339-352`),
extension/vsync/fullscreen checkboxes (`:370-372`), Size/Intensity sliders
(`:373-374`), the Rendered/Copied/Simulated sliders with their link
checkbox (`:379-394`), plus the draw toggle. Three transports drive the
same registry:

- terminal keys in `-interactive` (`apply_key`, the WindowProc path),
- the HTTP dashboard's sliders/checkboxes (`utils/dashboard.py` queues
  `(name, value)` pairs, drained on the main thread),
- scripts calling `apply_control` directly.

Mutations go through `AppConfig` / `ParticlesApp` setters; the
orchestrator's prev-value change detection picks up anything that needs a
rebuild (`Particles.cpp:458-537`), exactly like imgui writing the members
each frame. An adapter change is applied at the end of the next frame
(drain, state migration, engine rebuild); in fused mode both roles must
move before that frame, or its rebuild raises `ValueError`.

`meshdevices` (the JAX package's mesh rescale) raises
`NotImplementedError`: the multi-device paths are ROADMAP queue 1 item 14.
"""

from __future__ import annotations

from typing import Dict, List, Optional

# slider ranges from the reference panel: Size 0..10, Intensity 0..1
# (`Particles.cpp:373-374`), counts 0..num_particles (`:379-394`).
SIZE_RANGE = (0.0, 10.0)
INTENSITY_RANGE = (0.0, 1.0)


def _clamp(v, lo, hi):
    return max(lo, min(hi, v))


def _set_count(particles, field: str, value: int) -> str:
    """Counts slider semantics (`Particles.cpp:379-394`): editing a count
    works on the unlinked sliders; with the link checkbox ON the three
    sliders move together (they track the Rendered value)."""
    app = particles.app
    n = app.num_particles
    v = int(_clamp(int(value), 0, n))
    if app.linked:
        app.num_sim = app.num_copy = app.num_draw = v
    else:
        setattr(app, field, v)
    return f"{field} = {v}" + (" (linked)" if app.linked else "")


def _set_linked(particles, on: bool) -> str:
    app = particles.app
    app.linked = bool(on)
    if app.linked:
        # snapping behavior of the reference: copied/simulated jump to the
        # rendered count the moment the link is checked
        app.num_sim = app.num_copy = app.num_draw
    return f"linked = {app.linked}"


def apply_control(particles, name: str, value) -> str:
    """Apply one named control; returns a human-readable confirmation.

    Raises KeyError for unknown names and ValueError for bad values —
    transports decide how to surface those.
    """
    name = name.lower()
    app = particles.app

    if name == "size":
        app.particle_size = _clamp(float(value), *SIZE_RANGE)
        return f"size = {app.particle_size:g}"
    if name == "intensity":
        app.particle_intensity = _clamp(float(value), *INTENSITY_RANGE)
        return f"intensity = {app.particle_intensity:g}"
    if name in ("numsim", "numcopy", "numdraw"):
        return _set_count(particles, "num_" + name[3:], value)
    if name == "linked":
        return _set_linked(particles, _as_bool(value))
    if name == "vsync":
        app.vsync = _as_bool(value)
        return f"vsync = {app.vsync}"
    if name == "fullscreen":
        app.fullscreen = _as_bool(value)
        return f"fullscreen = {app.fullscreen}"
    if name == "ext":
        app.use_queue_extension = _as_bool(value)
        return f"ext = {app.use_queue_extension}"
    if name == "draw":
        particles.draw_enabled = _as_bool(value)
        return f"draw = {particles.draw_enabled}"
    if name == "computeadapter":
        idx = int(value) % max(len(particles.adapters), 1)
        particles.set_compute_adapter(idx)
        return f"compute adapter -> {idx}"
    if name == "renderadapter":
        idx = int(value) % max(len(particles.adapters), 1)
        particles.set_render_adapter(idx)
        return f"render adapter -> {idx}"
    if name == "meshdevices":
        raise NotImplementedError(
            "meshdevices: the multi-device paths are not ported to "
            "multi_adapter_particles_torch yet (ROADMAP queue 1 item 14)")
    raise KeyError(f"unknown control {name!r}")


def _as_bool(value) -> bool:
    if isinstance(value, str):
        return value.strip().lower() in ("1", "true", "on", "yes", "y")
    return bool(value)


def control_specs(particles) -> List[Dict]:
    """Current widget states, for building UIs (the DrawGUI data)."""
    app = particles.app
    n = app.num_particles
    ns, nc, nd = app.resolved_counts()
    adapters = [
        f"{a.index}: {a.platform} {a.description}" for a in particles.adapters
    ]
    return [
        {"name": "renderadapter", "kind": "select", "options": adapters,
         "value": particles.render_adapter.index},
        {"name": "computeadapter", "kind": "select", "options": adapters,
         "value": particles.compute_adapter.index},
        {"name": "ext", "kind": "checkbox", "value": app.use_queue_extension},
        {"name": "vsync", "kind": "checkbox", "value": app.vsync},
        {"name": "fullscreen", "kind": "checkbox", "value": app.fullscreen},
        {"name": "size", "kind": "slider", "lo": SIZE_RANGE[0],
         "hi": SIZE_RANGE[1], "step": 0.1, "value": app.particle_size},
        {"name": "intensity", "kind": "slider", "lo": INTENSITY_RANGE[0],
         "hi": INTENSITY_RANGE[1], "step": 0.01,
         "value": app.particle_intensity},
        {"name": "numdraw", "kind": "slider", "lo": 0, "hi": n,
         "step": 1, "value": nd},
        {"name": "numcopy", "kind": "slider", "lo": 0, "hi": n,
         "step": 1, "value": nc},
        {"name": "numsim", "kind": "slider", "lo": 0, "hi": n,
         "step": 1, "value": ns},
        {"name": "linked", "kind": "checkbox", "value": app.linked},
        {"name": "draw", "kind": "checkbox", "value": particles.draw_enabled},
    ]


# -- keyboard transport (the -interactive widget set) ---------------------------
#
# SPACE (draw toggle), ESC/q (quit) and WASD/arrow camera keys are handled
# by the input layer / camera; everything else lands here.

_KEY_HELP = [
    ("c / r", "cycle compute / render adapter"),
    ("[ / ]", "particle size - / +"),
    ("- / =", "sprite intensity - / +"),
    ("v e f l", "toggle vsync / extension / fullscreen / link"),
    ("1/2 3/4 5/6", "simulated, copied, rendered count - / +"),
]


def key_help() -> str:
    return "\n".join(f"  {k:<12} {d}" for k, d in _KEY_HELP)


def _count_step(particles) -> int:
    return max(particles.app.num_particles // 16, 128)


def apply_key(particles, key: str) -> Optional[str]:
    """Map one pressed key to a control change; None if not a control key."""
    app = particles.app
    nad = len(particles.adapters)
    step = _count_step(particles)
    ns, nc, nd = app.resolved_counts()

    def bump(name: str, cur: int, delta: int) -> str:
        if app.linked and delta:
            # editing a count from the keyboard implies unlinking, like
            # grabbing an individual slider after unchecking the link
            app.linked = False
        return apply_control(particles, name, cur + delta)

    if key == "c" and nad > 1:
        return apply_control(
            particles, "computeadapter", particles.compute_adapter.index + 1
        )
    if key == "r" and nad > 1:
        return apply_control(
            particles, "renderadapter", particles.render_adapter.index + 1
        )
    if key == "[":
        return apply_control(particles, "size", app.particle_size - 0.5)
    if key == "]":
        return apply_control(particles, "size", app.particle_size + 0.5)
    if key == "-":
        return apply_control(
            particles, "intensity", app.particle_intensity - 0.05
        )
    if key == "=":
        return apply_control(
            particles, "intensity", app.particle_intensity + 0.05
        )
    if key == "v":
        return apply_control(particles, "vsync", not app.vsync)
    if key == "e":
        return apply_control(particles, "ext", not app.use_queue_extension)
    if key == "f":
        return apply_control(particles, "fullscreen", not app.fullscreen)
    if key == "l":
        return apply_control(particles, "linked", not app.linked)
    if key == "1":
        return bump("numsim", ns, -step)
    if key == "2":
        return bump("numsim", ns, +step)
    if key == "3":
        return bump("numcopy", nc, -step)
    if key == "4":
        return bump("numcopy", nc, +step)
    if key == "5":
        return bump("numdraw", nd, -step)
    if key == "6":
        return bump("numdraw", nd, +step)
    return None
