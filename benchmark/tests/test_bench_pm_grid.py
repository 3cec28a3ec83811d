"""The particle-mesh reference (`reference/pm_grid.py`) on its own, against
the program's pm_grid step, and the `pm4m-fused` cell's check with a fault
planted in the program, all on the CPU at a small size: n = 8,192, G = 32
(h = 64) over the configuration's box of 2,048, whose interior |x| < 928
holds the two clusters (|x| <= 700 at the start)."""

import math
import time

import pytest
import torch

from benchmark import check, harness
from benchmark.reference import all_pairs, pm_grid
from benchmark.reference import init as ref_init

torch.set_num_threads(2)
N, G = 8192, 32
WORKLOAD = "pm4m-fused"
SEEDS = (3, 2**31 + 5, 2**33 + 17)


def _cfg():
    cfg = harness.config("pm-4m-1024")
    cfg.update(num_particles=N, width=64, height=64,
               physics=dict(cfg["physics"], pm_grid_size=G),
               program=dict(cfg["program"], pm_grid_size=G))
    return cfg


def _node(i, box=2048.0):
    return (i + 0.5 - G / 2) * (box / G)


def test_config_names_one_grid_and_box():
    """The reference reads G and box from `physics`, the program from
    `program`: the two name the same mesh."""
    cfg = harness.config("pm-4m-1024")
    for key in ("pm_grid_size", "pm_box"):
        assert cfg["physics"][key] == cfg["program"][key]
    assert (cfg["program"]["pm_grid_size"], cfg["program"]["pm_box"]) == (
        128, 2048.0)
    assert check.step_reference(cfg) is pm_grid.step


@pytest.mark.parametrize("seed", SEEDS)
def test_program_step_against_the_reference(seed):
    """The program's float32 pm_grid step against the float64 reference on
    every row of the two-cluster state. The gap is the program's float32
    deposit (a cumsum of corner weights and differences of it) and FFT,
    carried through the solve: it reads 3.4e-5 here, and must stay under
    1e-3, far inside the configuration's limit."""
    from multi_adapter_particles_torch.config import SimConfig
    from multi_adapter_particles_torch.models import integrator
    from multi_adapter_particles_torch.models.state import ParticleState

    cfg = _cfg()
    pos, vel = ref_init.two_clusters(N, seed, "cpu", 400.0, 15.0)
    sim = SimConfig(num_particles=N, force_model="pm_grid",
                    **cfg["program"])
    new = integrator.make_step(sim)(ParticleState(pos, vel))
    p, v = pm_grid.step(pos, vel, cfg["physics"], N, None)
    start = check.compared(cfg, (pos, vel), None)
    prog = check.compared(cfg, (new.position, new.velocity), None)
    gap = check.state_gap(start, *prog, p, v)
    assert gap <= cfg["check"]["limits"]["state_gap"]
    assert gap <= 1e-3


def test_deposit_conserves_mass_and_places_a_node_whole():
    """Every particle inside the margin deposits exactly its unit mass;
    those outside it, and the padding past n, deposit nothing. A particle
    on a node lands wholly in that node."""
    n = N - 5                    # 5 columns of padding, parked at 1e9
    pos, _ = ref_init.two_clusters(n, 11, "cpu", 400.0, 15.0)
    pos[:3, :3] = 1000.0         # base cell 31 > G - 3: outside
    pos[0, 3] = -990.0           # base cell 0 on x: outside
    x = pos[:3]
    rho = pm_grid.deposit(x[:, :n], G, 2048.0, torch.float64)
    inside = pm_grid.cells(x[:, :n], G, 2048.0)[2]
    assert int(inside.sum()) == n - 4
    assert math.isclose(float(rho.sum()), n - 4, rel_tol=1e-12)
    assert x.shape[1] == N and float(
        pm_grid.deposit(x, G, 2048.0, torch.float64).sum()) == (
        pytest.approx(n - 4, rel=1e-12))   # the padding adds nothing

    one = torch.tensor([[_node(5)], [_node(20)], [_node(9)]])
    rho = pm_grid.deposit(one, G, 2048.0, torch.float64)
    assert float(rho[9, 20, 5]) == 1.0 and float(rho.sum()) == 1.0


def test_two_bodies_against_the_exact_pair_sum():
    """Two particles on nodes 13 cells apart along x (d = 832, h = 64):
    the mesh gives exactly the central difference of the sampled
    potential, m (phi(d + h) - phi(d - h)) / 2h, which exceeds the exact
    pair force m / (d^2 + eps^2) by about h^2 / (d^2 - h^2) = 1/168 =
    0.60% (the difference stencil's softening: CIC at a node is exact).
    Off the nodes, at about the same separation, CIC's smoothing adds a
    term of the same order: within 2 h^2 / d^2 = 1.2%."""
    physics = dict(_cfg()["physics"])
    h, eps2 = 2048.0 / G, physics["softening_squared"]
    pos = torch.zeros((4, 2))
    pos[0] = torch.tensor([_node(9), _node(22)])
    pos[1:3] = _node(16)
    a = pm_grid.accel(pos, physics, 2, None)
    exact = all_pairs.accel(pos, physics, 2, None)
    d, m = 13 * h, physics["mass"] / 2

    def phi(r):
        return -1.0 / math.sqrt(r * r + eps2)

    stencil = m * (phi(d + h) - phi(d - h)) / (2 * h)
    assert float(a[0, 0]) == pytest.approx(stencil, rel=1e-9)
    assert float(a[0, 1]) == pytest.approx(-stencil, rel=1e-9)
    assert float(a[1:].abs().max()) < 1e-12
    rel = (a - exact).norm(dim=0) / exact.norm(dim=0)
    assert float(rel.max()) == pytest.approx(1 / 168, rel=0.02)

    pos[:3, 0] = torch.tensor([-400.0, 13.7, -21.3])
    pos[:3, 1] = torch.tensor([410.3, -7.1, 30.9])
    a = pm_grid.accel(pos, physics, 2, None)
    exact = all_pairs.accel(pos, physics, 2, None)
    sep = float((pos[:3, 1] - pos[:3, 0]).norm())
    rel = (a - exact).norm(dim=0) / exact.norm(dim=0)
    assert float(rel.max()) < 2 * h * h / (sep * sep)


def test_bfloat16_control_reads_over_a_limit():
    cfg = _cfg()
    mix = harness.traffic("fused-all")
    start = harness.initial_state(cfg, SEEDS[2], "cpu")
    numbers = check.control(cfg, mix, start, None)
    assert check.verdict(numbers, cfg["check"]["limits"])
    assert numbers["state_gap"] > cfg["check"]["limits"]["state_gap"]


# -- the cell's check with a fault planted in the program -------------------

def _run():
    cfg = _cfg()
    over = {k: cfg[k] for k in ("num_particles", "width", "height",
                                "physics", "program")}
    return harness.run(WORKLOAD, 2**33 + 99, 0.3, False, time.perf_counter(),
                       device="cpu", overrides=over)


def periodic(monkeypatch):
    """The solve's convolution periodic: the density on the G-grid alone,
    no zero padding, against the potential at the G-grid's minimum-image
    offsets, so every cluster also pulls on the other's images."""
    from multi_adapter_particles_torch.ops import pm

    def accel_grids(rho, grid, box, g_const, softening_squared):
        m = torch.arange(grid)
        off = (((m + grid // 2) % grid) - grid // 2).float() * (box / grid)
        d2 = (off[:, None, None] ** 2 + off[None, :, None] ** 2
              + off[None, None, :] ** 2 + softening_squared)
        k = torch.fft.rfftn(-torch.rsqrt(d2))
        phi = torch.fft.irfftn(torch.fft.rfftn(rho) * k, s=rho.shape)
        return pm._grad(phi * g_const, grid, box)

    monkeypatch.setattr(pm, "_accel_grids", accel_grids)


def half_grid(monkeypatch):
    """The program's mesh G/2 a side over the same box."""
    from multi_adapter_particles_torch.ops import pm
    real = pm.make_accel_fn
    monkeypatch.setattr(pm, "make_accel_fn",
                        lambda *a, grid, **kw: real(*a, grid=grid // 2, **kw))


def test_sound_run_is_correct():
    r = _run()
    assert r["correct"], r["checks"]
    assert r["checks"]["state_gap"]["value"] <= 1e-3


@pytest.mark.parametrize("fault", [periodic, half_grid],
                         ids=lambda f: f.__name__)
def test_step_fault_is_caught(fault, monkeypatch):
    fault(monkeypatch)
    r = _run()
    assert not r["correct"]
    assert r["checks"]["state_gap"]["value"] > r["checks"]["state_gap"][
        "limit"]
