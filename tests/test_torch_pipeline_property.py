"""Property test: the port's frame pipeline never perturbs the simulation
(tests/test_pipeline_property.py on the port, in split and fused mode).

The reference's correctness argument is its fence protocol: whatever the
render and copy queues do, the simulation stream is a pure function of its
initial state (`Render.cpp:38-85`). So any seeded interleaving of draws,
draw toggles, adapter reassignments (drain, state migration, engine
rebuild), extension toggles and size changes leaves the trajectory equal
to a bare integrator run of the same step count. The reassignments run on
a test-only list of two CPU adapters; in fused mode both roles move
together. The JAX test's mesh rescale is left out (ROADMAP queue 1 item
14).
"""

import random

import pytest
import torch

from multi_adapter_particles_torch.config import AppConfig, RenderConfig, SimConfig
from multi_adapter_particles_torch.models import init as tinit
from multi_adapter_particles_torch.models import integrator
from multi_adapter_particles_torch.runtime import devices
from multi_adapter_particles_torch.runtime.controls import apply_control
from multi_adapter_particles_torch.runtime.orchestrator import ParticlesApp

torch.set_num_threads(1)

N = 512


def two_cpus():
    return [devices.AdapterInfo(0, torch.device("cpu"), "cpu", "cpu (id 0)"),
            devices.AdapterInfo(1, torch.device("cpu"), "cpu", "cpu (id 1)")]


def reference_positions(num_steps: int) -> torch.Tensor:
    step = integrator.make_step(SimConfig(num_particles=N))
    s = tinit.initialize_particles_device(
        N, torch.Generator().manual_seed(0), device="cpu")
    for _ in range(num_steps):
        s = step(s)
    return s.position


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("seq_seed", [1, 2, 3])
def test_random_pipeline_ops_do_not_perturb_sim(seq_seed, fused,
                                                monkeypatch):
    monkeypatch.setattr(devices, "enumerate_adapters", two_cpus)
    rng = random.Random(seq_seed)
    app = ParticlesApp(
        AppConfig(num_particles=N, particle_size=10.0, vsync=False,
                  gui=False),
        SimConfig(num_particles=N),
        RenderConfig(width=64, height=64),
        compute_adapter=0, render_adapter=0, seed=0, fused=fused,
    )
    steps = 0
    ops = [rng.choice(["draw", "draw", "draw", "toggle", "reassign", "ext",
                       "size"]) for _ in range(12)]
    ops[3] = "reassign"   # at least one real move a sequence
    for op in ops:
        if op == "draw":
            app.draw()
            steps += 1
        elif op == "toggle":
            app.draw_enabled = not app.draw_enabled
        elif op == "reassign":
            idx = 1 - app.compute_adapter.index
            apply_control(app, "computeadapter", idx)
            if fused or rng.random() < 0.5:
                apply_control(app, "renderadapter", idx)
            app.draw()  # reconfiguration applies post-present
            steps += 1
        elif op == "ext":
            app.app.use_queue_extension = not app.app.use_queue_extension
        elif op == "size":
            apply_control(app, "size", rng.uniform(0.5, 9.5))
    app.shutdown()
    assert app.metrics.counters["reconfigurations"] >= 1
    assert app.compute.get_fence_value() == steps
    torch.testing.assert_close(app.compute.positions,
                               reference_positions(steps),
                               rtol=1e-5, atol=1e-3)
