"""The plain references against the program's plain (CPU) paths at a tiny
size. The references import nothing of the program; these tests do, to
hold the two side by side."""

import numpy as np
import pytest
import torch

from benchmark import check, harness
from benchmark.reference import all_pairs, camera, central_well, splat
from benchmark.reference import init as ref_init

torch.set_num_threads(2)
N, SIDE = 2048, 64


def _cfg(name="ap-1m-1024", **over):
    cfg = harness.config(name)
    cfg.update(num_particles=N, width=SIDE, height=SIDE, **over)
    return cfg


def test_init_is_the_programs_rule():
    from multi_adapter_particles_torch.models.init import (
        initialize_particles_device,
    )
    for seed in (0, 7, 2**31 + 11):
        pos, vel = ref_init.two_clusters(N + 5, seed, "cpu", 400.0, 15.0)
        gen = torch.Generator().manual_seed(seed)
        prog = initialize_particles_device(N + 5, generator=gen)
        assert torch.equal(pos, prog.position)
        assert torch.equal(vel, prog.velocity)


def test_camera_is_the_programs():
    from multi_adapter_particles_torch.config import RenderConfig
    from multi_adapter_particles_torch.render.camera import Camera
    from multi_adapter_particles_torch.render.renderer import Renderer

    cfg = _cfg()
    wvp, p00, p11 = camera.view_projection(cfg["camera"], 1280, 720)
    rend = Renderer(RenderConfig(width=1280, height=720))
    host = rend.frame_args(Camera(), 2.5, 0.15)
    np.testing.assert_array_equal(wvp, host[0])
    assert (p00, p11) == host[1:3]


def test_all_pairs_step_against_the_plain_step():
    from multi_adapter_particles_torch.config import SimConfig
    from multi_adapter_particles_torch.models import integrator
    from multi_adapter_particles_torch.models.state import ParticleState

    cfg = _cfg("ap-1m-1024")
    pos, vel = ref_init.two_clusters(N, 4, "cpu", 400.0, 15.0)
    sim = SimConfig(num_particles=N, force_model="all_pairs")
    new = integrator.make_step(sim)(ParticleState(pos, vel))
    rows = torch.tensor([0, 5, 1023, 1024, 2047])
    p, v = all_pairs.step(pos, vel, cfg["physics"], N, rows)
    start = (pos[:, rows], vel[:, rows])
    assert check.state_gap(start, new.position[:, rows],
                           new.velocity[:, rows], p, v) < 1e-4
    # every row at once: the same rows
    p_all, v_all = all_pairs.step(pos, vel, cfg["physics"], N, None)
    assert torch.equal(p_all[:, rows], p) and torch.equal(v_all[:, rows], v)


@pytest.mark.parametrize("steps", [0, 40])
def test_central_well_step_against_the_plain_step(steps):
    """The reference against the program's plain central-well step, from
    the initial state and from the state 40 steps on. Tolerance 1e-4: the
    program rounds p' to float32, half an ulp at |p| < 2048 is at most
    6.1e-5, against position increments v' dt of order 1 or more (a
    velocity of 15 at dt 0.1); the velocity increments and |a| carry
    float32 rounding of their own size, ~1e-7. It reads 2.2e-5-2.3e-5
    here."""
    from multi_adapter_particles_torch.ops.central_well import (
        central_well_step_plain,
    )

    cfg = _cfg("ap-1m-1024", force_model="central_well")
    pos, vel = ref_init.two_clusters(N, 4, "cpu", 400.0, 15.0)
    kw = {k: cfg["physics"][k] for k in ("dt", "damping", "mass",
                                         "softening_squared")}
    for _ in range(steps):
        pos, vel = central_well_step_plain(pos, vel, **kw)
    new_pos, new_vel = central_well_step_plain(pos, vel, **kw)
    rows = check.sample_rows(cfg, 4, "cpu")
    p, v = central_well.step(pos, vel, cfg["physics"], N, rows)
    start = (pos[:, rows], vel[:, rows])
    assert check.state_gap(start, new_pos[:, rows], new_vel[:, rows],
                           p, v) < 1e-4
    p_all, v_all = central_well.step(pos, vel, cfg["physics"], N, None)
    assert torch.equal(p_all[:, rows], p) and torch.equal(v_all[:, rows], v)


@pytest.mark.parametrize("n_draw,block", [(N, 1 << 22), (N, 700),
                                          (N // 3, 1 << 22)])
def test_splat_against_the_plain_renderer(n_draw, block):
    from multi_adapter_particles_torch.config import RenderConfig
    from multi_adapter_particles_torch.render.camera import Camera
    from multi_adapter_particles_torch.render.renderer import Renderer

    cfg = _cfg()
    pos, _ = ref_init.two_clusters(N, 5, "cpu", 400.0, 15.0)
    pos[3] = torch.rand(N, generator=torch.Generator().manual_seed(1)) * 20
    rend = Renderer(RenderConfig(width=SIDE, height=SIDE))
    prog = rend.render(pos, Camera(), 2.5, 0.15, num_draw=n_draw)
    view = dict(check.view_of(cfg, harness.traffic("split-all")),
                num_draw=n_draw)
    ref = splat.render(pos, view, N, block=block)
    assert rend.last_truncated == 0
    assert float(prog.max()) > 0.05
    assert check.frame_gap(prog, ref) < 1e-5


def test_splat_draws_close_sprites_whole():
    """A sprite near the camera covers many pixels and tiles; the
    reference draws all of it."""
    cfg = _cfg()
    pos = torch.tensor([[0.0, 30.0], [0.0, -20.0], [1490.0, 1000.0],
                        [0.0, 4.0]])
    view = check.view_of(cfg, harness.traffic("split-all"))
    view["num_draw"] = 2
    img = splat.render(pos, view, 2)
    covered = (img.sum(-1) > 0).sum()
    assert covered > 100


@pytest.mark.parametrize("force_model", ["all_pairs", "central_well"])
def test_control_comes_out_not_correct(force_model):
    """The bfloat16 control, held to the configuration's limits by the
    run's own test, fails both numbers."""
    cfg = _cfg(force_model=force_model)
    mix = harness.traffic("split-all")
    pos, vel = ref_init.two_clusters(N, 6, "cpu", 400.0, 15.0)
    rows = check.sample_rows(cfg, 6, "cpu")
    c = check.control(cfg, mix, (pos, vel), rows)
    assert check.verdict(c, cfg["check"]["limits"]) == list(check.NUMBERS)


def test_state_gap_holds_each_increment_to_its_own_scale():
    """A step whose force is turned, with its size kept, moves v' by a
    small share of |v| but by a large share of the increment v' - v."""
    cfg = _cfg()
    pos, vel = ref_init.two_clusters(N, 8, "cpu", 400.0, 15.0)
    rows = check.sample_rows(cfg, 8, "cpu")
    p, v = all_pairs.step(pos, vel, cfg["physics"], N, rows)
    start = (pos[:, rows], vel[:, rows])
    dv = v - start[1].double()
    turned = v.clone()
    turned[0] = start[1][0] + dv[0] - 0.01 * dv[1]
    turned[1] = start[1][1] + dv[1] + 0.01 * dv[0]
    gap = check.state_gap(start, p, turned, p, v)
    assert gap > 3e-3
    assert float((turned - v).abs().max() / v.abs().max()) < 1e-4
