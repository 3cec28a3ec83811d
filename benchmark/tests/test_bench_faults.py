"""A run with the timed path broken underneath comes out not correct.

Each test drives a whole run of the cell on the CPU at a tiny size (the
look for a card skipped), once sound and once with a fault planted in the
program: a step that returns its state unchanged, half of the particles
left out of the step, every answer of one 128-row tile altered, the
step's force turned by 50 mrad with its size kept, half of the sprites
left out of the frame, one pixel altered. The cell runs on one card, so
it has no exchange between cards to leave out.
"""

import math
import time

import pytest
import torch

from benchmark import check, harness

torch.set_num_threads(2)
WORKLOAD = "ap1m-split"
# the configuration's own row block (128): a 128-row tile always holds a
# compared row
TINY = {"num_particles": 2048, "width": 64, "height": 64}


def _run(trace=False):
    return harness.run(WORKLOAD, 2**31 + 99, 0.3, trace, time.perf_counter(),
                       device="cpu", overrides=dict(TINY))


def _patch_step(monkeypatch, broken):
    from multi_adapter_particles_torch.runtime import compute_engine
    real = compute_engine.step_into
    monkeypatch.setattr(compute_engine, "step_into",
                        lambda *a: broken(real, *a))


def unchanged(real, config, step, state, out, num_sim):
    out.position.copy_(state.position)
    out.velocity.copy_(state.velocity)


def half_left_out(real, config, step, state, out, num_sim):
    real(config, step, state, out, num_sim)
    h = state.position.shape[1] // 2
    out.position[:, h:] = state.position[:, h:]
    out.velocity[:, h:] = state.velocity[:, h:]


def tile_altered(real, config, step, state, out, num_sim):
    """Every answer of one 128-row tile off by 0.5 in x: a fault in one
    tile of the kernel lands in the sample of rows."""
    real(config, step, state, out, num_sim)
    out.position[0, 384:512] += 0.5


def turned(real, config, step, state, out, num_sim):
    """The velocity increment turned by 50 mrad about z (|a| and the
    increment's length kept), the position moved by the turned velocity."""
    real(config, step, state, out, num_sim)
    c, s = math.cos(0.05), math.sin(0.05)
    dv = out.velocity - state.velocity
    out.velocity[0] = state.velocity[0] + c * dv[0] - s * dv[1]
    out.velocity[1] = state.velocity[1] + s * dv[0] + c * dv[1]
    out.position[:3] = state.position[:3] + out.velocity * config.dt


def _patch_render(monkeypatch, change):
    from multi_adapter_particles_torch.render.renderer import Renderer
    real = Renderer.render_with

    def render_with(self, position, *a, **kw):
        return change(real, self, position, *a, **kw)

    monkeypatch.setattr(Renderer, "render_with", render_with)


def half_sprites(real, self, position, *a, **kw):
    pos = position.clone()
    pos[2, ::2] = 1.0e9          # behind the camera: never drawn
    return real(self, pos, *a, **kw)


def one_pixel(real, self, position, *a, **kw):
    out = real(self, position, *a, **kw)
    frame = out.frame.clone()
    frame[20, 30, 1] += 0.02
    return out._replace(frame=frame)


def test_sound_run_is_correct():
    r = _run()
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"


def test_sample_holds_a_row_of_every_tile():
    cfg = dict(harness.config("ap-1m-1024"), num_particles=1_048_576 + 77)
    rows = check.sample_rows(cfg, 2**33 + 5, "cpu")
    block = cfg["check"]["row_block"]
    assert torch.equal(rows // block, torch.arange(rows.numel()))
    assert int(rows[-1]) < cfg["num_particles"]
    other = check.sample_rows(cfg, 2**33 + 6, "cpu")
    assert not torch.equal(rows, other)


@pytest.mark.parametrize("fault", [unchanged, half_left_out, tile_altered,
                                   turned], ids=lambda f: f.__name__)
def test_step_fault_is_caught(fault, monkeypatch):
    _patch_step(monkeypatch, fault)
    r = _run()
    assert not r["correct"]
    assert r["checks"]["state_gap"]["value"] > r["checks"]["state_gap"][
        "limit"]


@pytest.mark.parametrize("fault", [half_sprites, one_pixel],
                         ids=lambda f: f.__name__)
def test_render_fault_is_caught(fault, monkeypatch):
    _patch_render(monkeypatch, fault)
    r = _run()
    assert not r["correct"]
    assert r["checks"]["frame_gap"]["value"] > r["checks"]["frame_gap"][
        "limit"]
