"""Fused frames through the harness, on the CPU at a tiny size.

No cell runs a fused mix yet, so each test adds one to the spec the harness
reads (`harness.spec`, monkeypatched): the `fused-all` mix over the
`ap-1m-1024` configuration, as it stands (all-pairs) or with the central
well in its place. On the CPU the fused engine captures nothing and runs
every frame eagerly; its frame contract (render the current state, step
into the other buffer, swap) is the one the card's replays keep.
"""

import functools
import json
import time

import pytest
import torch

from benchmark import check, harness

torch.set_num_threads(2)
WORKLOAD = "fused-test"
SEED = 2**31 + 7
TINY = {"num_particles": 2048, "width": 64, "height": 64}
# the default scene's force model on ap-1m-1024's physics (mass 70000,
# eps^2 25, dt 0.1, damping 1: the shipped constants, Compute.cpp:543-546)
# the per-layer metrics of any frame, split or fused
FRAME_METRICS = ("simulate_ms", "render_ms", "launches_per_frame",
                 "device_busy_pct")
MODELS = {"central_well": dict(TINY, force_model="central_well", program={}),
          "all_pairs": dict(TINY)}


@pytest.fixture
def fused_cell(monkeypatch):
    spec = harness.spec()
    spec["workloads"].append({"name": WORKLOAD, "config": "ap-1m-1024",
                              "traffic": "fused-all", "chips": 1,
                              "why": "a test cell"})
    for m in spec["per_layer"]:
        if m["name"] in FRAME_METRICS:
            m["workloads"].append(WORKLOAD)
    monkeypatch.setattr(harness, "spec", lambda: spec)


def _run(over, trace=False):
    r = harness.run(WORKLOAD, SEED, 0.3, trace, time.perf_counter(),
                    device="cpu", overrides=dict(over))
    rec = json.loads((harness.RECORDS_DIR / WORKLOAD
                      / f"seed{SEED}-trace{int(trace)}.json").read_text())
    return r, rec


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_fused_run_is_correct(fused_cell, model, trace):
    r, rec = _run(MODELS[model], trace)
    assert r["correct"], r["checks"]
    assert rec["truncated"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    if trace:   # the stage marks split the fused frame at its "render" mark
        assert set(rec["trace"]["stage_ms"]) == {"render", "simulate"}
        # on the CPU only the stage marks have something to read
        assert set(r["metrics"]) == {"simulate_ms"}


def test_fused_outputs_pair_state_and_image(fused_cell):
    """`outputs` reads the fused engine: after a frame, the state it
    stepped into from state N and the image of state N, as in split."""
    from multi_adapter_particles_torch.models import integrator
    from multi_adapter_particles_torch.models.state import ParticleState
    from multi_adapter_particles_torch.render.camera import Camera
    from multi_adapter_particles_torch.runtime.fused import FusedEngine

    c = harness.cell(harness.spec(), WORKLOAD)
    cfg, mix = dict(c["config"], **MODELS["central_well"]), c["traffic"]
    app = harness.make_app(cfg, mix, 5, torch.device("cpu"))
    try:
        assert isinstance(app.render, FusedEngine)
        assert app.compute is app.render
        app.draw()
        before = tuple(t.clone() for t in harness.outputs(app)[:2])
        app.draw()
        pos, vel, image = harness.outputs(app)
        eng = app.fused_engine
        assert pos is eng.state.position and image is eng.last_frame
        step = integrator.make_step(app.sim_config)(ParticleState(*before))
        assert torch.equal(pos, step.position)
        assert torch.equal(vel, step.velocity)
        draw = functools.partial(
            eng.renderer.render, camera=Camera(
                position=tuple(cfg["camera"]["position"])),
            particle_size=mix["particle_size"],
            particle_intensity=mix["particle_intensity"])
        assert torch.equal(image, draw(before[0]))
        assert not torch.equal(image, draw(pos))
        assert int(app.render.last_output.truncated) == 0
    finally:
        app.shutdown()


def test_unknown_frame_mode_raises():
    cfg = dict(harness.config("ap-1m-1024"), **TINY)
    mix = dict(harness.traffic("fused-all"), frame_mode="mesh")
    with pytest.raises(ValueError, match="frame_mode"):
        harness.make_app(cfg, mix, 1, torch.device("cpu"))


def _planted_step(monkeypatch, **change):
    """The fused engine's step replaced by the plain central-well step with
    one of its parameters changed."""
    from multi_adapter_particles_torch.ops.central_well import (
        central_well_step_plain,
    )
    from multi_adapter_particles_torch.runtime import fused

    def step_into(config, step, state, out, num_sim):
        kw = dict(dt=config.dt, damping=config.damping, mass=config.mass,
                  softening_squared=config.softening_squared)
        kw.update({k: f(kw[k]) for k, f in change.items()})
        central_well_step_plain(state.position, state.velocity,
                                out=(out.position, out.velocity), **kw)

    monkeypatch.setattr(fused, "step_into", step_into)


@pytest.mark.parametrize("change", [
    pytest.param({"mass": lambda m: -m}, id="well_sign_flipped"),
    pytest.param({"dt": lambda dt: dt * 1.01}, id="dt_times_1.01"),
])
def test_central_well_fault_is_caught(fused_cell, monkeypatch, change):
    """Both faults read over `state_gap`'s limit (ap-1m-1024's 1e-2). The
    flipped well reads ~2 (every velocity increment reversed). dt x 1.01
    moves each increment by about 1% of itself: it reads 1.002e-2 on the
    first frame, which starts from the seed's own initial state and so
    reads the same in every run; a central-well configuration's limit,
    set from its own readings, decides how wide its margin is."""
    _planted_step(monkeypatch, **change)
    r, rec = _run(MODELS["central_well"])
    gap = r["checks"]["state_gap"]
    assert not r["correct"] and gap["value"] > gap["limit"]
    assert rec["numbers_first"]["state_gap"] > gap["limit"]


def test_sound_planted_step_is_correct(fused_cell, monkeypatch):
    """The same plain step unchanged passes: the faults above fail by what
    they change."""
    _planted_step(monkeypatch)
    r, _ = _run(MODELS["central_well"])
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("dup,caught", [((1, 1), True), ((2, 2), False)],
                         ids=["window_1x1", "window_2x2"])
def test_truncating_fused_frame_is_caught(fused_cell, monkeypatch, dup,
                                          caught):
    """Sprites of half-size 40 span ~5 pixels here, so many straddle a
    tile edge and cover two tiles. A dup window forced to 1 x 1 drops
    their far tiles (the class of defect of the 4M fused frame, whose
    window only `present()` grows): `frame_gap` reads over its limit. At
    the default 2 x 2 every sprite is drawn whole and the run is
    correct."""
    from multi_adapter_particles_torch.render.renderer import Renderer
    from multi_adapter_particles_torch.runtime import fused

    monkeypatch.setattr(fused, "Renderer", functools.partial(
        Renderer, dup_y=dup[0], dup_x=dup[1]))
    mix = dict(harness.traffic("fused-all"), particle_size=40.0)
    real = harness.traffic
    monkeypatch.setattr(harness, "traffic",
                        lambda name: mix if name == "fused-all"
                        else real(name))
    r, rec = _run(MODELS["central_well"])
    gap = r["checks"]["frame_gap"]
    assert (rec["truncated"] > 0) is caught
    assert (gap["value"] > gap["limit"]) is caught
    assert r["correct"] is not caught
    assert r["checks"]["state_gap"]["value"] <= r["checks"]["state_gap"][
        "limit"]



@pytest.mark.card
def test_fused_replay_on_the_card_ties_the_render(fused_cell):
    """On the card a fused run replays CUDA graphs in its window; traced,
    `render_ms` reads the program's own `render.draw` range, whose kernels
    tie to the `cudaGraphLaunch` of each replay, and no operation is left
    untied. 65,536 bodies of the all-pairs configuration at 1024 x 1024:
    no sprite there spans more than the 2 x 2 tile window."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    over = {"num_particles": 65_536}
    r = harness.run(WORKLOAD, SEED, 1.0, True, time.perf_counter(),
                    overrides=over)
    rec = json.loads((harness.RECORDS_DIR / WORKLOAD
                      / f"seed{SEED}-trace1.json").read_text())
    assert r["correct"], r["checks"]
    t = rec["trace"]
    assert t["untied_ops"] == []
    assert t["span_ops"]["render.draw"] >= t["frames"]
    assert r["metrics"]["render_ms"]["value"] > 0
    assert set(t["stage_ms"]) == {"render", "simulate"}
    assert r["device"]["platform"] == "gpu"
