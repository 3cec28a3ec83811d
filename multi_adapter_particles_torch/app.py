"""Headless CLI application — WinMain + message pump analog.

`python -m multi_adapter_particles_torch` runs the split frame loop of the
JAX package's app (`multi_adapter_particles_tpu/app.py`) on torch devices:
the simulation (the central well, or `-force all_pairs | pm_grid | p3m`
self-gravity) plus the exact splat render, by default at the reference's
4,194,304 particles in a 1024x1024 window on one GPU. Without a GPU it
exits 2 unless `-computeadapter`/`-renderadapter` name an adapter (the CPU
is listed by `-listadapters`).

Flags follow the reference (`Particles.cpp:251-267`): numparticles, nogui,
noext, size, intensity, novsync, fullscreen, numCopy, numDraw, numSim; `?`
prints help (`ArgParser.h:105-127`). Extensions: preset, steps, seed,
force, interactionscale, rectpair / halfpair, the pm_grid / p3m knobs
(pmgrid, pmbox, p3mcutoff, p3mcapacity, p3mnear, p3mbudget,
treedirected), adapter indices, frame size, frame dumping, metrics JSON,
hard-sync stage profiling, the conservation gauges (diagnostics,
diagmode). For `-force p3m` the JAX CLI's startup probe
runs on the port's own device init: it resolves `-p3mnear auto`, picks the
grid when `-pmgrid` is absent and sizes the tree's pair budgets. The JAX
package's other flags, the slot near field and the presets that need them
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
    "probecache": "item 13",
    "debug": "item 13",
    "checkpoint": "item 13",
    "checkpointevery": "item 13",
    "resume": "item 13",
    "dashboard": "item 13",
    "serve": "item 13",
    "timerwindow": "item 5",
    "interactive": "item 5",
    "trace": "item 5",
    "compilecache": "(no CUDA counterpart)",
}
# flags among those that take a value
_LATER_VALUED = {
    "meshdevices", "probecache", "checkpoint", "checkpointevery", "resume",
    "dashboard", "serve", "timerwindow", "trace", "compilecache",
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

    not_ported = extra.setdefault("not_ported", [])

    def preset(name):
        from multi_adapter_particles_torch.presets import apply_preset

        err = apply_preset(name, app, extra)
        if err:
            not_ported.append(err)

    p.add_str("preset", "named benchmark config (see presets.py; later "
              "flags override it)", preset)
    p.add_int("steps", "number of frames to run (0 = forever)",
              lambda v: extra.__setitem__("steps", v))
    p.add_int("seed", "init RNG seed", lambda v: extra.__setitem__("seed", v))
    p.add_str("force", "force model: central_well | all_pairs | pm_grid | "
              "p3m", lambda v: extra.__setitem__("force", v))
    p.add_float("interactionscale",
                "per-pair force multiplier (default: auto — 1/N for the "
                "self-gravity models, keeping the total mass at the "
                "central-well value; 1.0 for central_well)",
                lambda v: extra.__setitem__("interaction_scale", v))
    p.add_flag("rectpair",
               "all_pairs: the directed rectangle kernel instead of the "
               "(default) Newton-3rd half-pair schedule",
               lambda: extra.__setitem__("all_pairs_half", False))
    p.add_flag("halfpair",
               "all_pairs: the Newton-3rd half-pair schedule (the default)",
               lambda: extra.__setitem__("all_pairs_half", True))
    p.add_int("pmgrid", "pm_grid/p3m mesh resolution per axis (omit with "
              "-p3mnear tree: a scene-probed cost model picks it)",
              lambda v: extra.__setitem__("pm_grid_size", v))
    p.add_float("pmbox", "pm_grid/p3m box extent (world units)",
                lambda v: extra.__setitem__("pm_box", v))
    p.add_float("p3mcutoff", "p3m short-range cutoff in mesh cells",
                lambda v: extra.__setitem__("p3m_cutoff_cells", v))
    p.add_int("p3mcapacity", "p3m near-cell particle capacity (the slot "
              "near field's; it sizes the auto probe)",
              lambda v: extra.__setitem__("p3m_capacity", v))
    p.add_str("p3mnear",
              "p3m near-field engine: auto | tree (auto probes the initial "
              "state and picks tree when the slot capacity would overflow; "
              "the slot near field is not yet ported, ROADMAP queue 1 item "
              "10)",
              lambda v: extra.__setitem__("p3m_near_mode", v))
    p.add_int("p3mbudget",
              "tree near-field block-pair budget (default: sized from the "
              "initial state)",
              lambda v: extra.__setitem__("p3m_pair_budget", v))
    p.add_flag("treedirected",
               "p3m tree: the directed (both-ways) near sweep instead of the "
               "(default) Newton-3rd halved sweep",
               lambda: extra.__setitem__("tree_half_force", False))
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
    p.add_int("diagnostics",
              "conservation gauges (energy/momentum/angular momentum + "
              "energy drift) every K frames; the self-gravity potential "
              "is the exact O(N^2) pairwise sum up to 262K particles and "
              "the P3M-split mesh gauge above (usable at the 4M default; "
              "-diagmode overrides)",
              lambda v: extra.__setitem__("diag_every", v))
    p.add_str("diagmode",
              "diagnostics potential: auto (default; exact <=262K, mesh "
              "above), exact (O(N^2) sum at any N), mesh (P3M-split gauge, "
              "~1e-4 of exact)",
              lambda v: extra.__setitem__("diag_mode", v))
    p.add_flag("nodraw", "simulate only (SPACE-toggle analog)",
               lambda: extra.__setitem__("draw", False))
    p.add_flag("listadapters", "print the adapter list and exit",
               lambda: extra.__setitem__("list_adapters", True))

    for name, item in _LATER_FLAGS.items():
        msg = f"-{name}: not yet ported (ROADMAP queue 1 {item})"
        if name == "probecache":
            msg += "; the port probes the scene on every launch"
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


def probe_p3m(app_cfg: AppConfig, extra: dict, device) -> Optional[str]:
    """The JAX CLI's startup probe (`multi_adapter_particles_tpu/app.py:
    213-331`) on the port's own device init (the engine's scene: same N,
    seed and device): `-p3mnear auto` -> the slot capacity's overflow ->
    tree; the grid from `auto_grid` when `-pmgrid` is absent; the pair and
    sub-pair budgets from one `host_tree_counts`. Fills `extra`; returns an
    error message when the scene needs the slot near field."""
    import time

    near_mode = extra.get("p3m_near_mode", "auto")
    pair_budget = extra.get("p3m_pair_budget")
    sub_pair_budget = extra.get("p3m_sub_pair_budget")
    if near_mode == "slots":
        return ("-p3mnear slots: the slot near field is not yet ported "
                "(ROADMAP queue 1 item 10)")
    if not (near_mode == "auto" or (near_mode == "tree" and (
            "pm_grid_size" not in extra or pair_budget is None
            or sub_pair_budget is None))):
        return None
    import torch

    from multi_adapter_particles_torch.models import init as pinit
    from multi_adapter_particles_torch.ops import p3m, treeforce

    t0 = time.perf_counter()
    grid = extra.get("pm_grid_size", SimConfig.pm_grid_size)
    box = extra.get("pm_box", SimConfig.pm_box)
    cutoff = extra.get("p3m_cutoff_cells", SimConfig.p3m_cutoff_cells)
    _pos0 = []

    def pos0():
        if not _pos0:
            gen = torch.Generator(device=device).manual_seed(
                extra.get("seed", 0))
            _pos0.append(pinit.initialize_particles_device(
                app_cfg.num_particles, generator=gen, device=device
            ).position.cpu().numpy())  # padding parked at 1e9: out of box
        return _pos0[0]

    if near_mode == "auto":
        cap = extra.get("p3m_capacity", SimConfig.p3m_capacity)
        ov = p3m.host_overflow_count(pos0(), grid, box, cutoff, cap)
        near_mode = "tree" if ov else "slots"
        print(f"p3m: near-field auto probe -> {near_mode}"
              + (f" ({ov} particles would overflow the slot capacity)" if ov
                 else " (slot capacity covers the scene)"), flush=True)
        if near_mode == "slots":
            return ("-p3mnear auto picked the slot near field, which is not "
                    "yet ported (ROADMAP queue 1 item 10); -p3mnear tree "
                    "runs the tree near field")
    extra["p3m_near_mode"] = near_mode
    counts: dict = {}
    if "pm_grid_size" not in extra:
        grid = treeforce.auto_grid(
            pos0, box, cutoff, treeforce.solve_budget(device),
            counts_cache=counts, num_particles=app_cfg.num_particles)
        extra["pm_grid_size"] = grid
        print(f"p3m: tree grid auto-selected G={grid} (scene-probed cost "
              "model; override with -pmgrid)", flush=True)
    if pair_budget is None or sub_pair_budget is None:
        r_c, gn = p3m.near_grid_for(grid, box, cutoff)
        ck = treeforce.counts_cache_key(gn, r_c)
        if ck not in counts:
            counts[ck] = treeforce.host_tree_counts(pos0(), box, r_c, gn)
        coarse, sub, _block = counts[ck]
        if pair_budget is None:
            extra["p3m_pair_budget"] = int(
                coarse * treeforce.PAIR_HEADROOM) + 1
            print(f"p3m: tree pair budget sized to "
                  f"{extra['p3m_pair_budget']} (from the initial state)",
                  flush=True)
        if sub_pair_budget is None and sub is not None:
            extra["p3m_sub_pair_budget"] = int(
                sub * treeforce.PAIR_HEADROOM) + 2
            print(f"p3m: sweep sub-pair list capped at "
                  f"{extra['p3m_sub_pair_budget']} (wide-block scene)",
                  flush=True)
    extra["probe_s"] = time.perf_counter() - t0
    print(f"p3m: startup probe {extra['probe_s']:.2f} s", flush=True)
    return None


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
    if extra["not_ported"]:
        for msg in extra["not_ported"]:
            print(f"error: {msg}", file=sys.stderr)
        return 2

    # Heavy imports after flag parsing so `-?` is instant.
    from multi_adapter_particles_torch.runtime.devices import (
        NoAcceleratorError,
        assign_adapters,
        enumerate_adapters,
    )
    from multi_adapter_particles_torch.runtime.orchestrator import ParticlesApp

    adapters = enumerate_adapters()
    if extra.get("list_adapters"):
        for a in adapters:
            print(f"[{a.index}] {a.platform:4s} {a.description}")
        return 0
    try:
        compute_ad, _ = assign_adapters(adapters, extra.get("compute_adapter"),
                                        extra.get("render_adapter"))
    except NoAcceleratorError as e:
        print(f"error: {e}; name an adapter with -computeadapter / "
              "-renderadapter (-listadapters prints them, the CPU among "
              "them)", file=sys.stderr)
        return 2

    diag_mode = extra.get("diag_mode", "auto")
    if diag_mode not in ("auto", "exact", "mesh"):
        print(f"error: -diagmode {diag_mode}: one of auto | exact | mesh",
              file=sys.stderr)
        return 2

    force = extra.get("force", "central_well")
    if force == "p3m":
        err = probe_p3m(app_cfg, extra, compute_ad.device)
        if err:
            print(f"error: {err}", file=sys.stderr)
            return 2

    sim_cfg = SimConfig(
        num_particles=app_cfg.num_particles,
        force_model=force,
        # None = auto: 1.0 for central_well, 1/N for the self-gravity models
        interaction_scale=extra.get("interaction_scale"),
        pm_grid_size=extra.get("pm_grid_size", SimConfig.pm_grid_size),
        pm_box=extra.get("pm_box", SimConfig.pm_box),
        p3m_cutoff_cells=extra.get("p3m_cutoff_cells",
                                   SimConfig.p3m_cutoff_cells),
        p3m_capacity=extra.get("p3m_capacity", SimConfig.p3m_capacity),
        p3m_near_mode=extra.get("p3m_near_mode", SimConfig.p3m_near_mode),
        p3m_pair_budget=extra.get("p3m_pair_budget"),
        p3m_sub_pair_budget=extra.get("p3m_sub_pair_budget"),
        all_pairs_half=extra.get("all_pairs_half", SimConfig.all_pairs_half),
        tree_half_force=extra.get("tree_half_force",
                                  SimConfig.tree_half_force),
    )
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
    if "probe_s" in extra:
        particles.metrics.gauge("probe_s", extra["probe_s"])

    diag = None
    if extra.get("diag_every"):
        from multi_adapter_particles_torch.models.diagnostics import (
            DiagnosticsProbe,
        )

        diag = DiagnosticsProbe(sim_cfg, extra["diag_every"],
                                potential_mode=diag_mode)

    def overlay(p: ParticlesApp):
        if diag is not None:
            # one host sync a sample (float() pulls the scalars); the
            # cadence keeps it off the frames in between
            diag.maybe_publish(p.frame_count, p.compute.state, p.metrics)
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
