"""Headless CLI application — WinMain + message pump analog.

`python -m multi_adapter_particles_torch` runs the split frame loop of the
JAX package's app (`multi_adapter_particles_tpu/app.py`) on torch devices:
the central-well simulation plus the exact splat render, by default at the
reference's 4,194,304 particles in a 1024x1024 window on one GPU.

Flags follow the reference (`Particles.cpp:251-267`): numparticles, nogui,
noext, size, intensity, novsync, fullscreen, numCopy, numDraw, numSim; `?`
prints help (`ArgParser.h:105-127`). Extensions: steps, seed, force
(central_well only so far), adapter indices, frame size, frame dumping,
metrics JSON, hard-sync stage profiling. The JAX package's other flags
belong to slices not ported yet: they exit with status 2 and say so.
"""

from __future__ import annotations

import json
import sys
from typing import Callable, List, Optional

from multi_adapter_particles_torch.config import AppConfig, RenderConfig, SimConfig
from multi_adapter_particles_torch.utils.argparser import ArgParser

# Flags of the JAX package's CLI whose slice is not ported yet, with the
# ROADMAP queue 1 item that brings each.
_LATER_FLAGS = {
    "fused": "item 7",
    "meshdevices": "item 14",
    "shardrender": "item 14",
    "interactionscale": "items 8-10",
    "rectpair": "item 8",
    "halfpair": "item 8",
    "pmgrid": "items 9-10",
    "pmbox": "items 9-10",
    "p3mcutoff": "item 10",
    "p3mcapacity": "item 10",
    "p3mnear": "items 10-11",
    "p3mbudget": "item 11",
    "treedirected": "item 11",
    "probecache": "item 11",
    "diagnostics": "item 12",
    "diagmode": "item 12",
    "debug": "item 13",
    "checkpoint": "item 13",
    "checkpointevery": "item 13",
    "resume": "item 13",
    "dashboard": "item 13",
    "serve": "item 13",
    "preset": "item 6",
    "timerwindow": "item 5",
    "interactive": "item 5",
    "trace": "item 5",
    "compilecache": "(no CUDA counterpart)",
}
# flags among those that take a value
_LATER_VALUED = {
    "meshdevices", "interactionscale", "pmgrid", "pmbox", "p3mcutoff",
    "p3mcapacity", "p3mnear", "p3mbudget", "probecache", "diagnostics",
    "diagmode", "checkpoint", "checkpointevery", "resume", "dashboard",
    "serve", "preset", "timerwindow", "trace", "compilecache",
}


def build_parser(app: AppConfig, extra: dict) -> ArgParser:
    p = ArgParser("multi_adapter_particles_torch — particle sim + render "
                  "on torch / CUDA")

    def set_attr(name):
        return lambda v: setattr(app, name, v)

    p.add_int("numparticles", "number of particles", set_attr("num_particles"))
    p.add_float("size", "particle size", set_attr("particle_size"))
    p.add_float("intensity", "particle sprite intensity", set_attr("particle_intensity"))
    p.add_flag("nogui", "disable the text overlay",
               lambda: setattr(app, "gui", False))
    p.add_flag("novsync", "disable frame pacing",
               lambda: setattr(app, "vsync", False))
    p.add_flag("fullscreen",
               "borderless fullscreen: render at the fullscreen resolution "
               "(RenderConfig.fullscreen_width/height, default 1920x1080)",
               lambda: setattr(app, "fullscreen", True))
    p.add_flag("noext", "disable the queue-throttle extension (no-op on CUDA)",
               lambda: setattr(app, "use_queue_extension", False))
    p.add_int("framelatency",
              "max frames in flight under -novsync (SetMaximumFrameLatency)",
              set_attr("max_frame_latency"))

    def unlink_and_set(name):
        def h(v):
            app.linked = False
            setattr(app, name, v)
        return h

    p.add_int("numsim", "# particles simulated per frame", unlink_and_set("num_sim"))
    p.add_int("numcopy", "# particles transferred per frame", unlink_and_set("num_copy"))
    p.add_int("numdraw", "# particles drawn per frame", unlink_and_set("num_draw"))

    p.add_int("steps", "number of frames to run (0 = forever)",
              lambda v: extra.__setitem__("steps", v))
    p.add_int("seed", "init RNG seed", lambda v: extra.__setitem__("seed", v))
    p.add_str("force", "force model: central_well (the others are not "
              "ported yet)", lambda v: extra.__setitem__("force", v))
    p.add_int("computeadapter", "compute adapter index",
              lambda v: extra.__setitem__("compute_adapter", v))
    p.add_int("renderadapter", "render adapter index",
              lambda v: extra.__setitem__("render_adapter", v))
    p.add_int("width", "frame width", lambda v: extra.__setitem__("width", v))
    p.add_int("height", "frame height", lambda v: extra.__setitem__("height", v))
    p.add_str("dumpframe", "write the final frame to this .png/.npy path",
              lambda v: extra.__setitem__("dumpframe", v))
    p.add_flag("u8frame", "render to RGB8 on device (swap-chain UNORM "
               "format analog; 4x cheaper frame pulls)",
               lambda: extra.__setitem__("frame_uint8", True))
    p.add_str("metrics", "write metrics JSON to this path (turns on the "
              "CUDA-event stage timer)",
              lambda v: extra.__setitem__("metrics", v))
    p.add_int("profileevery", "hard-sync stage timing every K frames",
              lambda v: extra.__setitem__("profile_every", v))
    p.add_flag("nodraw", "simulate only (SPACE-toggle analog)",
               lambda: extra.__setitem__("draw", False))
    p.add_flag("listadapters", "print the adapter list and exit",
               lambda: extra.__setitem__("list_adapters", True))

    not_ported = extra.setdefault("not_ported", [])
    for name, item in _LATER_FLAGS.items():
        msg = f"-{name}: not yet ported (ROADMAP queue 1 {item})"
        if name in _LATER_VALUED:
            p.add_str(name, msg, lambda v, m=msg: not_ported.append(m))
        else:
            p.add_flag(name, msg, lambda m=msg: not_ported.append(m))
    return p


def write_frame(frame, path: str) -> None:
    import numpy as np

    arr = frame.cpu().numpy()
    if path.endswith(".npy"):
        np.save(path, arr)
        return
    from multi_adapter_particles_torch.utils.png import write_png

    write_png(path, arr)


def main(argv: Optional[List[str]] = None,
         on_exit: Optional[Callable] = None) -> int:
    """Run the CLI; returns the exit status. `on_exit(particles)`, when
    given, is called with the drained `ParticlesApp` after the last frame
    (for an embedding program that checks the final state and frame)."""
    app_cfg = AppConfig()
    extra: dict = {}
    parser = build_parser(app_cfg, extra)
    unmatched = parser.parse(argv)
    if unmatched:
        print(f"warning: unmatched args {unmatched}", file=sys.stderr)
    force = extra.get("force", "central_well")
    if force != "central_well":
        extra["not_ported"].append(
            f"-force {force}: not yet ported (ROADMAP queue 1 items 8-11)"
        )
    if extra["not_ported"]:
        for msg in extra["not_ported"]:
            print(f"error: {msg}", file=sys.stderr)
        return 2

    # Heavy imports after flag parsing so `-?` is instant.
    from multi_adapter_particles_torch.runtime.devices import enumerate_adapters
    from multi_adapter_particles_torch.runtime.orchestrator import ParticlesApp

    if extra.get("list_adapters"):
        for a in enumerate_adapters():
            print(f"[{a.index}] {a.platform:4s} {a.description}")
        return 0

    sim_cfg = SimConfig(num_particles=app_cfg.num_particles, force_model=force)
    render_cfg = RenderConfig(
        width=extra.get("width", RenderConfig.width),
        height=extra.get("height", RenderConfig.height),
        frame_uint8=extra.get("frame_uint8", False),
    )
    steps = extra.get("steps", 600)

    particles = ParticlesApp(
        app_cfg,
        sim_cfg,
        render_cfg,
        compute_adapter=extra.get("compute_adapter"),
        render_adapter=extra.get("render_adapter"),
        seed=extra.get("seed", 0),
        draw_enabled=extra.get("draw", True),
        profile_every=extra.get("profile_every", 0),
        # a -metrics dump with empty stage rows is useless: time the stages
        # with CUDA events (non-stalling) whenever one is asked for
        async_timers="metrics" in extra,
    )

    def overlay(p: ParticlesApp):
        if app_cfg.gui and p.frame_count % 30 == 0:
            print(f"--- frame {p.frame_count} ---")
            print(p.metrics.render_text())

    target_fps = 60.0 if app_cfg.vsync else None
    try:
        if steps <= 0:
            while True:
                particles.draw()
                overlay(particles)
        else:
            particles.run(steps, frame_callback=overlay, target_fps=target_fps)
    except KeyboardInterrupt:
        pass
    particles.shutdown()
    if on_exit is not None:
        on_exit(particles)

    print(particles.metrics.render_text())
    if "dumpframe" in extra and particles.render.last_frame is not None:
        write_frame(particles.render.last_frame, extra["dumpframe"])
    if "metrics" in extra:
        with open(extra["metrics"], "w") as f:
            f.write(json.dumps(particles.metrics.as_dict(), indent=2, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
