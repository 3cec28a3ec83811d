"""Headless CLI application — WinMain + message pump analog.

`python -m multi_adapter_particles_torch` runs the split frame loop of the
JAX package's app (`multi_adapter_particles_tpu/app.py`) on torch devices:
the simulation (the central well, or `-force all_pairs | pm_grid | p3m`
self-gravity) plus the exact splat render, by default at the reference's
4,194,304 particles in a 1024x1024 window on one GPU; `-fused` runs the
fused single-program frame instead (captured CUDA graphs on a GPU).
Without a GPU it exits 2 unless `-computeadapter`/`-renderadapter` name an
adapter (the CPU is listed by `-listadapters`).

Flags follow the reference (`Particles.cpp:251-267`): numparticles, nogui,
noext, size, intensity, novsync, fullscreen, numCopy, numDraw, numSim; `?`
prints help (`ArgParser.h:105-127`). Extensions: preset, steps, seed,
force, interactionscale, rectpair / halfpair, the pm_grid / p3m knobs
(pmgrid, pmbox, p3mcutoff, p3mcapacity, p3mnear, p3mbudget,
treedirected, probecache), adapter indices, frame size, frame dumping,
metrics JSON, hard-sync stage profiling, the conservation gauges
(diagnostics, diagmode), the key-driven loop (interactive), the
validation layer (debug), a torch.profiler trace (trace, with the
program's `particles.*` spans, below; timerwindow is accepted and has no
effect), checkpoints (checkpoint, checkpointevery, resume), the
dashboard (dashboard, serve) and the one-process mesh
(meshdevices, shardrender: compute sharded over N devices of the compute
adapter's platform, the render gathered or sharded too). For `-force p3m` the JAX CLI's startup probe runs on
the port's own device init: it resolves `-p3mnear auto` to the slot or the
tree near field, picks the grid when `-pmgrid` is absent and sizes the
tree's pair budgets, optionally through the probe cache. `-compilecache`
picks where the kernels' built libraries live (the port's compile cost is
the kernel build): auto (`build/torch_kernels/`), off (a fresh temporary
directory for the run) or a directory.

`-trace DIR` writes DIR/trace.json, a chrome trace of the run's CPU and
CUDA activity with the program's own spans as `particles.*` ranges
(`runtime/trace.py`): `particles.frame` (one frame of the loop),
`particles.wait` (the host blocked on the device: the frame-latency bound,
present, a drain), `particles.step`, `particles.render.draw` and its stages
`particles.render.copy`, `particles.render.project`,
`particles.render.sort` and `particles.render.composite`,
`particles.fused.capture`, `particles.reconfigure` and
`particles.diagnostics`. Each kernel links to the span that launched it.
"""

from __future__ import annotations

import json
import sys
import traceback
from typing import Callable, List, Optional

from multi_adapter_particles_torch.config import AppConfig, RenderConfig, SimConfig
from multi_adapter_particles_torch.utils.argparser import ArgParser

# frames between two -dashboard page writes
DASHBOARD_EVERY = 30


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
    p.add_flag("noext", "disable the queue-throttle extension analog (on "
               "CUDA: the compute engine's stream at the highest priority; "
               "this gives it the default one)",
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

    flag_errors = extra.setdefault("flag_errors", [])

    def preset(name):
        from multi_adapter_particles_torch.presets import apply_preset

        err = apply_preset(name, app, extra)
        if err:
            flag_errors.append(err)

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
              "p3m near-field engine: auto | slots | tree (auto probes the "
              "initial state and picks tree when the slot capacity would "
              "overflow, e.g. the demo's cluster cores)",
              lambda v: extra.__setitem__("p3m_near_mode", v))
    p.add_int("p3mbudget",
              "tree near-field block-pair budget (default: sized from the "
              "initial state)",
              lambda v: extra.__setitem__("p3m_pair_budget", v))
    p.add_flag("treedirected",
               "p3m tree: the directed (both-ways) near sweep instead of the "
               "(default) Newton-3rd halved sweep",
               lambda: extra.__setitem__("tree_half_force", False))
    p.add_str("probecache",
              "startup-probe sidecar: off (default) | auto (~/.cache/"
              "multi_adapter_particles_torch/probes.json, or under "
              "$XDG_CACHE_HOME) | a path — repeat launches of the same (N, "
              "seed, box, cutoff, device kind) skip the device init and the "
              "host tree probes",
              lambda v: extra.__setitem__("probe_cache", v))
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
    p.add_flag("fused",
               "fused single-program frame: render state N and step to N+1 "
               "on one device, replayed as captured CUDA graphs on a GPU",
               lambda: extra.__setitem__("fused", True))
    p.add_flag("nodraw", "simulate only (SPACE-toggle analog)",
               lambda: extra.__setitem__("draw", False))
    p.add_flag("interactive",
               "read keys: SPACE toggles draw, ESC/q quits, WASD/arrows "
               "fly, mouse drag looks (xterm SGR reporting), and the "
               "control panel's keys (runtime/controls.py); a stdin that "
               "is not a terminal is a script, one line of keys a frame",
               lambda: extra.__setitem__("interactive", True))
    p.add_flag("debug", "validation layer: per-frame finiteness checks of "
               "the state and the double-buffer hand-off asserts (D3D12 "
               "debug layer analog; one host read a frame)",
               lambda: extra.__setitem__("debug", True))
    p.add_str("trace", "write a torch.profiler trace of the run (CPU and "
              "CUDA activities) to DIR/trace.json, with the program's spans "
              "as particles.* ranges: frame, wait, step, render.draw, "
              "render.copy, render.project, render.sort, render.composite, "
              "fused.capture, reconfigure, diagnostics; the profiler is "
              "known to drop events inside long calls",
              lambda v: extra.__setitem__("trace", v))
    p.add_int("timerwindow",
              "has no effect here: accepted for the JAX CLI's trace "
              "cadence and recorded as the timer_window_every gauge; the "
              "port's CUDA-event stage timer times every frame without a "
              "stall, so it has no trace window to space",
              lambda v: extra.__setitem__("timer_window_every", v))
    p.add_str("dashboard", "write a live HTML dashboard to this path (every "
              f"{DASHBOARD_EVERY} frames and at exit)",
              lambda v: extra.__setitem__("dashboard", v))
    p.add_int("serve", "serve the LIVE bidirectional dashboard on this "
              "port of 127.0.0.1 (0 = pick one); its widgets drive the app "
              "like the GUI (POST /set)",
              lambda v: extra.__setitem__("serve", v))
    p.add_str("checkpoint", "write a state checkpoint here at exit (.npz, "
              "the JAX package's format)",
              lambda v: extra.__setitem__("checkpoint", v))
    p.add_int("checkpointevery", "also checkpoint every K frames",
              lambda v: extra.__setitem__("checkpoint_every", v))
    p.add_str("resume", "resume state from a checkpoint (.npz)",
              lambda v: extra.__setitem__("resume", v))
    p.add_flag("listadapters", "print the adapter list and exit",
               lambda: extra.__setitem__("list_adapters", True))
    p.add_int("meshdevices", "run compute on a mesh of N devices (sharded "
              "sim) of the compute adapter's platform",
              lambda v: extra.__setitem__("mesh_devices", v))
    p.add_flag("shardrender", "with -meshdevices: shard the RENDER role "
               "over the mesh too (image-pair gather replaces the "
               "position copy)",
               lambda: extra.__setitem__("shard_render", True))
    p.add_str("compilecache",
              "where built kernel libraries live: auto (default, "
              "build/torch_kernels/) | off (a fresh temporary directory "
              "for this run) | a directory — warm launches load the "
              "libraries instead of rebuilding them",
              lambda v: extra.__setitem__("compile_cache", v))
    return p


def write_frame(frame, path: str) -> None:
    import numpy as np

    arr = frame.cpu().numpy()
    if path.endswith(".npy"):
        np.save(path, arr)
        return
    from multi_adapter_particles_torch.utils.png import write_png

    write_png(path, arr)


def probe_p3m(app_cfg: AppConfig, extra: dict, device) -> None:
    """The JAX CLI's startup probe (`multi_adapter_particles_tpu/app.py:
    213-331`) on the port's own device init (the engine's scene: same N,
    seed and device): `-p3mnear auto` -> the slot capacity's overflow ->
    slots, or tree where it overflows; for tree, the grid from `auto_grid`
    when `-pmgrid` is absent and the pair and sub-pair budgets from one
    `host_tree_counts`. Results go through the probe cache
    (`utils/probecache.py`, `-probecache`), so a warm cache needs neither
    the init nor the host counts. Fills `extra` (`probe_s`: its seconds)."""
    import time

    near_mode = extra.get("p3m_near_mode", "auto")
    pair_budget = extra.get("p3m_pair_budget")
    sub_pair_budget = extra.get("p3m_sub_pair_budget")
    if not (near_mode == "auto" or (near_mode == "tree" and (
            "pm_grid_size" not in extra or pair_budget is None
            or sub_pair_budget is None))):
        return
    import torch

    from multi_adapter_particles_torch.models import init as pinit
    from multi_adapter_particles_torch.ops import p3m, treeforce
    from multi_adapter_particles_torch.utils.probecache import open_cache

    t0 = time.perf_counter()
    grid = extra.get("pm_grid_size", SimConfig.pm_grid_size)
    box = extra.get("pm_box", SimConfig.pm_box)
    cutoff = extra.get("p3m_cutoff_cells", SimConfig.p3m_cutoff_cells)
    seed = extra.get("seed", 0)
    cache = open_cache(extra.get("probe_cache"), app_cfg.num_particles, seed,
                       box, cutoff, torch.device(device).type)
    _pos0 = []

    def pos0():
        if not _pos0:
            gen = torch.Generator(device=device).manual_seed(seed)
            _pos0.append(pinit.initialize_particles_device(
                app_cfg.num_particles, generator=gen, device=device
            ).position.cpu().numpy())  # padding parked at 1e9: out of box
        return _pos0[0]

    if near_mode == "auto":
        cap = extra.get("p3m_capacity", SimConfig.p3m_capacity)
        ov = cache.overflow.get((grid, cap))
        if ov is None:
            ov = p3m.host_overflow_count(pos0(), grid, box, cutoff, cap)
            cache.overflow[(grid, cap)] = int(ov)
        near_mode = "tree" if ov else "slots"
        print(f"p3m: near-field auto probe -> {near_mode}"
              + (f" ({ov} particles would overflow the slot capacity)" if ov
                 else " (slot capacity covers the scene)"), flush=True)
    extra["p3m_near_mode"] = near_mode
    if near_mode == "tree" and "pm_grid_size" not in extra:
        grid = treeforce.auto_grid(
            pos0, box, cutoff, treeforce.solve_budget(device),
            counts_cache=cache.counts, num_particles=app_cfg.num_particles)
        extra["pm_grid_size"] = grid
        print(f"p3m: tree grid auto-selected G={grid} (scene-probed cost "
              "model; override with -pmgrid)", flush=True)
    if near_mode == "tree" and (pair_budget is None
                                or sub_pair_budget is None):
        r_c, gn = p3m.near_grid_for(grid, box, cutoff)
        ck = treeforce.counts_cache_key(gn, r_c)
        if ck not in cache.counts:
            cache.counts[ck] = treeforce.host_tree_counts(pos0(), box, r_c,
                                                          gn)
        coarse, sub, _block = cache.counts[ck]
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
    cache.save()
    extra["probe_s"] = time.perf_counter() - t0
    print(f"p3m: startup probe {extra['probe_s']:.2f} s", flush=True)


def warn_slot_overflow(particles, sim_cfg: SimConfig) -> None:
    """The JAX CLI's startup warning (`app.py:383-400`): particles of the
    initial state past the slot capacity keep only the mesh force."""
    from multi_adapter_particles_torch.ops.p3m import host_overflow_count

    ov = host_overflow_count(
        particles.compute.state.position.cpu().numpy(), sim_cfg.pm_grid_size,
        sim_cfg.pm_box, sim_cfg.p3m_cutoff_cells, sim_cfg.p3m_capacity)
    if ov:
        print(
            f"p3m: {ov} of {sim_cfg.num_particles} particles exceed "
            f"near-cell capacity {sim_cfg.p3m_capacity} — they keep "
            "only the smooth long-range mesh force (WORSE than pure "
            "pm_grid at small separations). Use -p3mnear tree (exact "
            "on any density contrast), raise -p3mcapacity / -pmgrid, "
            "or prefer -force pm_grid for this scene.",
            flush=True,
        )


def _save_checkpoint(particles, path: str, num_particles: int) -> None:
    """Write the compute state (counted in `checkpoint_writes`, its host
    milliseconds in the `checkpoint_write_ms` gauge list)."""
    import time

    from multi_adapter_particles_torch.utils.checkpoint import save_checkpoint

    t0 = time.perf_counter()
    save_checkpoint(path, particles.compute.state,
                    particles.compute.get_fence_value(), num_particles)
    particles.metrics.count("checkpoint_writes")
    particles.metrics.gauges.setdefault("checkpoint_write_ms", []).append(
        (time.perf_counter() - t0) * 1e3)


def _resume(particles, path: str, num_particles: int) -> bool:
    """Load a checkpoint onto the compute device (its host milliseconds in
    the `checkpoint_read_ms` gauge); False, with the JAX CLI's message, when
    its particle count is not the run's."""
    import time

    from multi_adapter_particles_torch.utils.checkpoint import load_checkpoint

    t0 = time.perf_counter()
    state, step, ckpt_n = load_checkpoint(path, particles.compute.device)
    if ckpt_n != num_particles:
        print(
            f"error: checkpoint has {ckpt_n} particles but "
            f"-numparticles is {num_particles}; pass "
            f"-numparticles {ckpt_n} to resume",
            file=sys.stderr,
        )
        return False
    particles.compute.restore(state)
    particles.compute.step_count = step
    particles.share_handles()
    particles.compute.wait_for_gpu()
    particles.metrics.gauge("checkpoint_read_ms",
                            (time.perf_counter() - t0) * 1e3)
    return True


def _interactive(particles, steps: int, overlay, stream, gui: bool) -> None:
    """The key-driven frame loop (JAX `app.py:480-515`): poll, quit, the
    draw toggle, the control keys, the camera drag and keys, one frame. A
    control key that raises, or a frame whose reconfiguration raises (fused
    mode with one role moved), prints its error and the loop goes on."""
    from multi_adapter_particles_torch.runtime.controls import apply_key
    from multi_adapter_particles_torch.runtime.input import TerminalInput

    with TerminalInput(stream=stream) as ti:
        frames = 0
        while steps <= 0 or frames < steps:
            inp = ti.poll()
            if inp.quit:
                break
            if inp.toggle_draw:
                particles.draw_enabled = not particles.draw_enabled
            for key in inp.pressed:
                try:
                    msg = apply_key(particles, key)
                except Exception as e:  # reported; the loop goes on
                    traceback.print_exc()
                    print(f"error: key {key!r}: {e}", file=sys.stderr)
                    continue
                if msg and gui:
                    print(msg)
            camera = particles.render.camera
            if inp.mouse_dx or inp.mouse_dy:
                camera.drag(inp.mouse_dx, inp.mouse_dy)
            for key in inp.pressed:
                camera.key_down(key)
            try:
                particles.draw()
            except ValueError as e:
                print(f"error: {e}", file=sys.stderr)
            camera.update(particles.metrics.frame_timer.average)
            for key in inp.pressed:
                camera.key_up(key)
            overlay(particles)
            frames += 1


def main(argv: Optional[List[str]] = None,
         on_exit: Optional[Callable] = None, input_stream=None) -> int:
    """Run the CLI; returns the exit status. `on_exit(particles)`, when
    given, is called with the drained `ParticlesApp` after the last frame
    (for an embedding program that checks the final state and frame).
    `input_stream` replaces stdin as `-interactive`'s key source."""
    app_cfg = AppConfig()
    extra: dict = {}
    parser = build_parser(app_cfg, extra)
    unmatched = parser.parse(argv)
    if unmatched:
        print(f"warning: unmatched args {unmatched}", file=sys.stderr)
    if extra["flag_errors"]:
        for msg in extra["flag_errors"]:
            print(f"error: {msg}", file=sys.stderr)
        return 2

    from multi_adapter_particles_torch.ops import _build

    try:
        _build.set_build_dir(extra.get("compile_cache", "auto"))
    except OSError as e:
        print(f"error: -compilecache: {e}", file=sys.stderr)
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
        probe_p3m(app_cfg, extra, compute_ad.device)

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

    try:
        particles = ParticlesApp(
            app_cfg,
            sim_cfg,
            render_cfg,
            compute_adapter=extra.get("compute_adapter"),
            render_adapter=extra.get("render_adapter"),
            seed=extra.get("seed", 0),
            draw_enabled=extra.get("draw", True),
            profile_every=extra.get("profile_every", 0),
            debug=extra.get("debug", False),
            fused=extra.get("fused", False),
            # a -metrics dump with empty stage rows is useless: time the
            # stages with CUDA events (non-stalling) whenever one is asked
            # for
            async_timers="metrics" in extra,
            mesh_devices=extra.get("mesh_devices", 0),
            shard_render=extra.get("shard_render", False),
        )
    except ValueError as e:  # a mesh larger than the platform, fused + mesh
        print(f"error: {e}", file=sys.stderr)
        return 1
    if "probe_s" in extra:
        particles.metrics.gauge("probe_s", extra["probe_s"])
    if "timer_window_every" in extra:
        particles.metrics.gauge("timer_window_every",
                                extra["timer_window_every"])
    if sim_cfg.force_model == "p3m" and sim_cfg.p3m_near_mode == "slots":
        warn_slot_overflow(particles, sim_cfg)

    if "resume" in extra and not _resume(particles, extra["resume"],
                                         app_cfg.num_particles):
        particles.shutdown()
        return 2

    server = None
    if "serve" in extra:
        from multi_adapter_particles_torch.utils.dashboard import (
            DashboardServer,
        )

        try:
            server = DashboardServer(particles, port=extra["serve"])
        except OSError as e:
            print(f"error: -serve {extra['serve']}: cannot serve the "
                  f"dashboard ({e})", file=sys.stderr)
            particles.shutdown()
            return 2
        print(f"dashboard: http://127.0.0.1:{server.port}/", flush=True)

    diag = None
    if extra.get("diag_every"):
        from multi_adapter_particles_torch.models.diagnostics import (
            DiagnosticsProbe,
        )

        diag = DiagnosticsProbe(sim_cfg, extra["diag_every"],
                                potential_mode=diag_mode)
    ckpt_every = extra.get("checkpoint_every", 0)

    def overlay(p: ParticlesApp):
        if diag is not None:
            # one host sync a sample (float() pulls the scalars); the
            # cadence keeps it off the frames in between
            diag.maybe_publish(p.frame_count, p.compute.state, p.metrics)
        if server is not None:
            server.drain()
            # live viewer: push the frame to any connected /stream client
            # (free when none; rate-limited inside)
            server.publish_frame(p.render.last_frame)
        if app_cfg.gui and p.frame_count % 30 == 0:
            print(f"--- frame {p.frame_count} ---")
            print(p.metrics.render_text())
        if "dashboard" in extra and p.frame_count % DASHBOARD_EVERY == 0:
            from multi_adapter_particles_torch.utils import dashboard

            dashboard.write_html(p, extra["dashboard"],
                                 frame=p.render.last_frame)
        if (ckpt_every and "checkpoint" in extra
                and p.frame_count % ckpt_every == 0):
            _save_checkpoint(p, extra["checkpoint"], app_cfg.num_particles)

    target_fps = 60.0 if app_cfg.vsync else None
    prof = None
    if "trace" in extra:
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
    try:
        if extra.get("interactive"):
            _interactive(particles, steps, overlay, input_stream,
                         app_cfg.gui)
        elif steps <= 0:
            while True:
                particles.draw()
                overlay(particles)
        else:
            particles.run(steps, frame_callback=overlay, target_fps=target_fps)
    except KeyboardInterrupt:
        pass
    finally:
        if prof is not None:
            import os

            particles.compute.wait_for_gpu()
            particles.render.wait_for_gpu()
            prof.__exit__(None, None, None)
            os.makedirs(extra["trace"], exist_ok=True)
            prof.export_chrome_trace(os.path.join(extra["trace"],
                                                  "trace.json"))
        if server is not None:
            server.close()
    particles.shutdown()
    if on_exit is not None:
        on_exit(particles)

    print(particles.metrics.render_text())
    if "dashboard" in extra:
        from multi_adapter_particles_torch.utils import dashboard

        dashboard.write_html(particles, extra["dashboard"],
                             frame=particles.render.last_frame)
    if "checkpoint" in extra:
        _save_checkpoint(particles, extra["checkpoint"],
                         app_cfg.num_particles)
    if "dumpframe" in extra and particles.render.last_frame is not None:
        write_frame(particles.render.last_frame, extra["dumpframe"])
    if "metrics" in extra:
        with open(extra["metrics"], "w") as f:
            f.write(json.dumps(particles.metrics.as_dict(), indent=2, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
