"""The port's one-process mesh against the JAX package's 8-device CPU mesh.

Mirrors tests/test_parallel.py (TestShardedCentralWell, TestRingAllPairs,
TestResharding, TestMeshEngine, TestMeshInOrchestrator, TestMultiSlice,
TestBitStableTrajectories) and tests/test_dist_fft.py (TestSupports,
TestConvolve, TestShardedPMDistFFT) at those tests' tolerances. The JAX side
runs on the `eight_devices` virtual CPU mesh; the port's mesh is D entries
of the one CPU device (each entry one shard), its plain twins running the
per-shard force math. Inputs are the JAX package's seeded device init,
handed to the port as numpy.

Bitwise, port against port: the bit-stable all-pairs trajectory against
the one-device directed step (`all_pairs_half=False`) at D = 1, 2, 4, 8,
on a 2-D mesh and across a live rescale; the central well at any D; the
num_sim freeze; the tree near field's owner partials summed against the
one-device sweep, and its `dropped` against the JAX package's. The
orchestrator's mesh runs on a test-only list of 8 CPU adapters
(`devices.enumerate_adapters` patched), as tests/test_torch_controls.py
patches two.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multi_adapter_particles_tpu import parallel as jpar
from multi_adapter_particles_tpu.config import SimConfig as JSimConfig
from multi_adapter_particles_tpu.models import init as jinit
from multi_adapter_particles_tpu.models import integrator as jintegrator
from multi_adapter_particles_tpu.ops import pm as jpm
from multi_adapter_particles_tpu.ops import treeforce as JT
from multi_adapter_particles_tpu.parallel import dist_fft as jdist
from multi_adapter_particles_tpu.parallel.mesh import (
    make_multislice_mesh as jmultislice,
)

from multi_adapter_particles_torch import app as cli
from multi_adapter_particles_torch.config import (
    AppConfig,
    RenderConfig,
    SimConfig,
)
from multi_adapter_particles_torch.models import integrator
from multi_adapter_particles_torch.models.state import ParticleState
from multi_adapter_particles_torch.ops import treeforce as T
from multi_adapter_particles_torch.parallel import (
    MeshComputeEngine,
    ShardedState,
    dist_fft,
    make_mesh,
    make_multislice_mesh,
    make_sharded_step,
    reshard_state,
    shard_state,
)
from multi_adapter_particles_torch.parallel import mesh as M
from multi_adapter_particles_torch.runtime import devices
from multi_adapter_particles_torch.runtime.compute_engine import ComputeEngine
from multi_adapter_particles_torch.runtime.controls import apply_control
from multi_adapter_particles_torch.runtime.orchestrator import ParticlesApp

torch.set_num_threads(1)

N = 1024  # padded count == N; divisible by 8 shards
REPO = Path(__file__).resolve().parents[1]


def _init(seed, n=N):
    """(JAX state, port state on the CPU) from the JAX device init."""
    js = jinit.initialize_particles_device(n, seed=seed)
    return js, ParticleState.from_numpy(np.asarray(js.position),
                                        np.asarray(js.velocity))


def _mesh(d):
    return make_mesh(["cpu"] * d)


def _np(x):
    if isinstance(x, ShardedState):
        x = x.gather("cpu")
    return x.position.numpy(), x.velocity.numpy()


def _one_device(cfg, state, steps=1):
    """The port's one-device step (all_pairs: the directed rectangle)."""
    step = integrator.make_step(SimConfig(**{**cfg.__dict__,
                                             "all_pairs_half": False}))
    for _ in range(steps):
        state = step(state)
    return state


def eight_cpus():
    return [devices.AdapterInfo(i, torch.device("cpu"), "cpu",
                                f"cpu (id {i})") for i in range(8)]


@pytest.fixture
def cpus(monkeypatch):
    monkeypatch.setattr(devices, "enumerate_adapters", eight_cpus)


class TestShardedCentralWell:
    def test_matches_single_device(self, eight_devices):
        cfg = SimConfig(num_particles=N)
        js, ts = _init(7)
        jout = jpar.make_sharded_step(
            JSimConfig(num_particles=N), jpar.make_mesh(eight_devices),
            donate=False)(jpar.shard_state(js, jpar.make_mesh(eight_devices)))
        out = make_sharded_step(cfg, _mesh(8))(shard_state(ts, _mesh(8)))
        pos, vel = _np(out)
        np.testing.assert_allclose(pos, np.asarray(jout.position),
                                   rtol=1e-6, atol=1e-4)
        ref = _one_device(cfg, ts)
        assert np.array_equal(pos, ref.position.numpy())
        assert np.array_equal(vel, ref.velocity.numpy())

    def test_output_stays_sharded(self):
        mesh = _mesh(8)
        _, ts = _init(0)
        out = make_sharded_step(SimConfig(num_particles=N), mesh)(
            shard_state(ts, mesh))
        assert out.mesh is mesh
        assert [tuple(s.shape) for s in out.position.shards] == [(4, 128)] * 8
        assert [tuple(s.shape) for s in out.velocity.shards] == [(3, 128)] * 8


class TestRingAllPairs:
    @pytest.mark.parametrize("ndev", [2, 4, 8])
    def test_ring_matches_single_device(self, eight_devices, ndev):
        js, ts = _init(3)
        jcfg = JSimConfig(num_particles=N, force_model="all_pairs")
        jref = jintegrator.make_step(jcfg, donate=False)(js)
        cfg = SimConfig(num_particles=N, force_model="all_pairs")
        out = make_sharded_step(cfg, _mesh(ndev), bit_stable=False)(
            shard_state(ts, _mesh(ndev)))
        pos, vel = _np(out)
        # ring accumulation order differs from the single-pass sum
        np.testing.assert_allclose(pos, np.asarray(jref.position),
                                   rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(vel, np.asarray(jref.velocity),
                                   rtol=1e-4, atol=1e-3)
        jmesh = jpar.make_mesh(eight_devices[:ndev])
        jring = jpar.make_sharded_step(jcfg, jmesh, donate=False,
                                       bit_stable=False)(
            jpar.shard_state(js, jmesh))
        np.testing.assert_allclose(pos, np.asarray(jring.position),
                                   rtol=1e-4, atol=1e-3)

    def test_multi_step_trajectory(self):
        js, ts = _init(1)
        jcfg = JSimConfig(num_particles=N, force_model="all_pairs")
        step_ref = jintegrator.make_step(jcfg, donate=False)
        mesh = _mesh(4)
        step = make_sharded_step(SimConfig(num_particles=N,
                                           force_model="all_pairs"),
                                 mesh, bit_stable=False)
        s = shard_state(ts, mesh)
        for _ in range(5):
            js = step_ref(js)
            s = step(s)
        np.testing.assert_allclose(_np(s)[0], np.asarray(js.position),
                                   rtol=1e-3, atol=1e-2)

    def test_num_sim_freeze(self, eight_devices):
        js, ts = _init(2)
        mesh = _mesh(4)
        before = ts.position.numpy().copy()
        out = make_sharded_step(SimConfig(num_particles=N,
                                          force_model="all_pairs"),
                                mesh, bit_stable=False)(
            shard_state(ts, mesh), 256)
        after = _np(out)[0]
        assert not np.array_equal(before[:, :256], after[:, :256])
        np.testing.assert_array_equal(before[:, 256:], after[:, 256:])
        jmesh = jpar.make_mesh(eight_devices[:4])
        jout = jpar.make_sharded_step(
            JSimConfig(num_particles=N, force_model="all_pairs"), jmesh,
            donate=False, bit_stable=False)(jpar.shard_state(js, jmesh), 256)
        np.testing.assert_allclose(after, np.asarray(jout.position),
                                   rtol=1e-4, atol=1e-3)


class TestResharding:
    def test_bitwise_across_mesh_change(self):
        _, ts = _init(4)
        state = shard_state(ts, _mesh(8))
        mesh2 = _mesh(2)
        moved = reshard_state(state, mesh2)
        assert moved.mesh is mesh2
        assert [s.shape[1] for s in moved.position.shards] == [N // 2] * 2
        np.testing.assert_array_equal(_np(moved)[0], ts.position.numpy())
        np.testing.assert_array_equal(_np(moved)[1], ts.velocity.numpy())

    def test_to_single_device(self):
        _, ts = _init(4)
        single = reshard_state(shard_state(ts, _mesh(8)),
                               torch.device("cpu"))
        assert isinstance(single, ParticleState)
        assert single.device == torch.device("cpu")
        assert torch.equal(single.position, ts.position)

    def test_trajectory_continues_after_reshard(self, eight_devices):
        """Drain -> re-place -> resume == uninterrupted run (bitwise for
        the bit-stable schedule; the JAX package's run to its tolerance)."""
        js, ts = _init(5)
        cfg = SimConfig(num_particles=N, force_model="all_pairs")
        mesh4, mesh8 = _mesh(4), _mesh(8)
        step4 = make_sharded_step(cfg, mesh4)
        ref = step4(step4(shard_state(ts, mesh4)))
        state = reshard_state(step4(shard_state(ts, mesh4)), mesh8)
        state = make_sharded_step(cfg, mesh8)(state)
        np.testing.assert_array_equal(_np(state)[0], _np(ref)[0])
        jcfg = JSimConfig(num_particles=N, force_model="all_pairs")
        jm4 = jpar.make_mesh(eight_devices[:4])
        jm8 = jpar.make_mesh(eight_devices)
        jstate = jpar.make_sharded_step(jcfg, jm4, donate=False)(
            jpar.shard_state(js, jm4))
        jstate = jpar.make_sharded_step(jcfg, jm8, donate=False)(
            jpar.reshard_state(jstate, jm8))
        np.testing.assert_allclose(_np(state)[0],
                                   np.asarray(jstate.position),
                                   rtol=1e-4, atol=1e-3)


class TestMeshEngine:
    def test_engine_runs_and_counts(self, eight_devices):
        cfg = SimConfig(num_particles=N, force_model="all_pairs")
        eng = MeshComputeEngine(cfg, _mesh(4), seed=0)
        eng.simulate()
        eng.simulate()
        assert eng.get_fence_value() == 2
        eng.wait_for_gpu()
        assert torch.isfinite(eng.state.position).all()
        assert eng.metrics.counters["interactions"] == 2.0 * N * N
        # the JAX engine from the JAX init, the port's restored to it
        js, ts = _init(0)
        jeng = jpar.MeshComputeEngine(
            JSimConfig(num_particles=N, force_model="all_pairs"),
            jpar.make_mesh(eight_devices[:4]), seed=0)
        eng.restore(ts)
        for _ in range(2):
            jeng.simulate()
            eng.simulate()
        np.testing.assert_allclose(eng.state.position.numpy(),
                                   np.asarray(jeng.positions),
                                   rtol=1e-4, atol=1e-3)

    def test_migration_from_single_device_engine(self):
        cfg = SimConfig(num_particles=N)
        single = ComputeEngine(cfg, "cpu", seed=6)
        single.simulate()
        before = single.positions.clone()
        eng = MeshComputeEngine(cfg, _mesh(8), prev=single)
        assert torch.equal(eng.positions.gather("cpu"), before)
        assert eng.get_fence_value() == 1
        eng.simulate()
        back = ComputeEngine(cfg, "cpu", prev=eng)
        single.simulate()
        assert torch.equal(back.state.position, single.state.position)
        assert back.get_fence_value() == 2

    def test_snapshot_restore(self):
        eng = MeshComputeEngine(SimConfig(num_particles=N), _mesh(2), seed=8)
        eng.simulate()
        snap = eng.snapshot()
        eng.simulate()
        eng.restore(snap)
        assert torch.equal(eng.positions.gather("cpu"), snap.position)
        assert torch.equal(eng.state.velocity, snap.velocity)


def _app(**kw):
    kw.setdefault("compute_adapter", 0)
    return ParticlesApp(
        AppConfig(num_particles=N, particle_size=10.0, vsync=False,
                  gui=False),
        kw.pop("sim", SimConfig(num_particles=N, force_model="all_pairs")),
        RenderConfig(width=256, height=256), **kw)


class TestMeshInOrchestrator:
    def test_mesh_compute_role(self, cpus, eight_devices):
        from multi_adapter_particles_tpu.config import (
            AppConfig as JAppConfig,
            RenderConfig as JRenderConfig,
        )
        from multi_adapter_particles_tpu.runtime import (
            ParticlesApp as JParticlesApp,
        )

        app = _app(mesh_devices=4)
        assert "Mesh Compute" in app.metrics.gauges["mode_banner"]
        _, ts = _init(0)
        app.compute.restore(ts)  # the JAX app's init (seed 0)
        app.share_handles()
        app.draw()
        app.draw()
        assert app.compute.get_fence_value() == 2
        app.render.present()
        frame = app.render.last_frame.numpy()
        assert np.isfinite(frame).all() and frame.max() > 0
        japp = JParticlesApp(
            JAppConfig(num_particles=N, particle_size=10.0),
            JSimConfig(num_particles=N, force_model="all_pairs"),
            JRenderConfig(width=256, height=256), mesh_devices=4)
        japp.draw()
        japp.draw()
        japp.render.present()
        np.testing.assert_allclose(app.compute.state.position.numpy(),
                                   np.asarray(japp.compute.positions),
                                   rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(frame, np.asarray(japp.render.last_frame),
                                   atol=2e-3)
        japp.shutdown()
        app.shutdown()

    def test_live_mesh_rescale(self, cpus):
        """2 -> 8 -> 1 devices through the control, the trajectory bitwise
        a bare one-device run (central well: every column independent)."""
        cfg = SimConfig(num_particles=N)
        ref = ComputeEngine(cfg, "cpu", seed=0)
        app = _app(sim=cfg, mesh_devices=2)
        app.draw(); ref.simulate()
        assert apply_control(app, "meshdevices", 8) == "mesh devices -> 8"
        assert app.compute.mesh.size == 8
        app.draw(); ref.simulate()
        apply_control(app, "meshdevices", 1)
        assert isinstance(app.compute, ComputeEngine)
        assert "mesh" not in app.metrics.gauges["mode_banner"].lower()
        app.draw(); ref.simulate()
        assert torch.equal(app.compute.state.position, ref.state.position)
        assert app.compute.get_fence_value() == 3
        assert app.metrics.counters["reconfigurations"] == 2
        app.shutdown()

    def test_rescale_bitwise_all_pairs(self, cpus):
        """The bit-stable schedule across 4 -> 2 -> 1 -> 4: bitwise the
        one-device directed run."""
        cfg = SimConfig(num_particles=N, force_model="all_pairs",
                        all_pairs_half=False)
        ref = ComputeEngine(cfg, "cpu", seed=0)
        app = _app(sim=cfg, mesh_devices=4)
        for k in (2, 1, 4):
            app.draw(); ref.simulate()
            app.set_mesh_devices(k)
        app.draw(); ref.simulate()
        assert app.compute.mesh.size == 4
        assert torch.equal(app.compute.state.position, ref.state.position)
        assert torch.equal(app.compute.state.velocity, ref.state.velocity)
        app.shutdown()

    def test_compute_adapter_change_collapses_mesh(self, cpus):
        app = _app(sim=SimConfig(num_particles=N), mesh_devices=4)
        app.draw()
        apply_control(app, "computeadapter", 3)
        app.draw()
        assert isinstance(app.compute, ComputeEngine)
        assert "mesh" not in app.metrics.gauges
        assert app.mesh_devices == 0
        app.shutdown()

    def test_mesh_refusals(self, cpus):
        with pytest.raises(ValueError, match="only 8 cpu devices"):
            _app(mesh_devices=16)
        with pytest.raises(ValueError, match="single shared device"):
            _app(mesh_devices=2, fused=True)
        app = _app(sim=SimConfig(num_particles=N))
        with pytest.raises(ValueError, match="only 8"):
            app.set_mesh_devices(9)
        app.shutdown()

    def test_debug_layer_on_the_mesh(self, cpus):
        app = _app(sim=SimConfig(num_particles=N), mesh_devices=4,
                   debug=True)
        for _ in range(3):
            app.draw()
        assert app.frame_count == 3
        app.shutdown()


class TestMultiSlice:
    @pytest.mark.parametrize("shape", [(2, 4), (4, 2), (2, 2)])
    def test_hierarchical_ring_matches_single_device(self, eight_devices,
                                                     shape):
        ns, nc = shape
        js, ts = _init(3)
        jcfg = JSimConfig(num_particles=N, force_model="all_pairs")
        jmesh = jmultislice(ns, eight_devices[:ns * nc])
        jout = jpar.make_sharded_step(jcfg, jmesh, donate=False,
                                      bit_stable=False)(
            jpar.shard_state(js, jmesh))
        mesh = make_multislice_mesh(ns, ["cpu"] * (ns * nc))
        out = make_sharded_step(SimConfig(num_particles=N,
                                          force_model="all_pairs"),
                                mesh, bit_stable=False)(shard_state(ts, mesh))
        np.testing.assert_allclose(_np(out)[0], np.asarray(jout.position),
                                   rtol=1e-4, atol=1e-3)
        ref = _one_device(SimConfig(num_particles=N,
                                    force_model="all_pairs"), ts)
        np.testing.assert_allclose(_np(out)[0], ref.position.numpy(),
                                   rtol=1e-4, atol=1e-3)

    def test_central_well_multislice(self, eight_devices):
        js, ts = _init(1)
        jmesh = jmultislice(2, eight_devices)
        jout = jpar.make_sharded_step(JSimConfig(num_particles=N), jmesh,
                                      donate=False)(
            jpar.shard_state(js, jmesh))
        mesh = make_multislice_mesh(2, ["cpu"] * 8)
        out = make_sharded_step(SimConfig(num_particles=N), mesh)(
            shard_state(ts, mesh))
        np.testing.assert_allclose(_np(out)[0], np.asarray(jout.position),
                                   rtol=1e-6, atol=1e-4)
        assert np.array_equal(
            _np(out)[0],
            _one_device(SimConfig(num_particles=N), ts).position.numpy())

    def test_num_sim_on_multislice(self):
        _, ts = _init(2)
        mesh = make_multislice_mesh(2, ["cpu"] * 8)
        before = ts.position.numpy().copy()
        out = make_sharded_step(SimConfig(num_particles=N,
                                          force_model="all_pairs"),
                                mesh)(shard_state(ts, mesh), 256)
        after = _np(out)[0]
        assert not np.array_equal(before[:, :256], after[:, :256])
        np.testing.assert_array_equal(before[:, 256:], after[:, 256:])

    def test_mesh_engine_on_multislice(self):
        eng = MeshComputeEngine(SimConfig(num_particles=N,
                                          force_model="all_pairs"),
                                make_multislice_mesh(2, ["cpu"] * 8), seed=0)
        eng.simulate()
        eng.wait_for_gpu()
        assert torch.isfinite(eng.state.position).all()

    def test_mesh_groups(self):
        mesh = make_multislice_mesh(2, ["cpu"] * 8)
        assert mesh.groups(M.AXIS) == [[0, 1, 2, 3], [4, 5, 6, 7]]
        assert mesh.groups(M.OUTER_AXIS) == [[0, 4], [1, 5], [2, 6], [3, 7]]
        assert M.particle_spec(mesh) == (M.OUTER_AXIS, M.AXIS)
        with pytest.raises(ValueError, match="divisible"):
            make_multislice_mesh(3, ["cpu"] * 8)


class TestBitStableTrajectories:
    def test_bitwise_across_mesh_sizes(self, eight_devices):
        cfg = SimConfig(num_particles=N, force_model="all_pairs")
        js, ts = _init(11)
        ref = _one_device(cfg, ts, steps=5)
        for ndev in (1, 2, 4, 8):
            mesh = _mesh(ndev)
            s = shard_state(ts, mesh)
            step = make_sharded_step(cfg, mesh)
            for _ in range(5):
                s = step(s)
            pos, vel = _np(s)
            assert np.array_equal(pos, ref.position.numpy()), ndev
            assert np.array_equal(vel, ref.velocity.numpy()), ndev
        jstep = jintegrator.make_step(
            JSimConfig(num_particles=N, force_model="all_pairs"),
            donate=False)
        for _ in range(5):
            js = jstep(js)
        np.testing.assert_allclose(pos, np.asarray(js.position),
                                   rtol=1e-3, atol=1e-2)

    def test_bitwise_multislice_vs_flat(self):
        cfg = SimConfig(num_particles=N, force_model="all_pairs")
        _, ts = _init(12)
        flat, twod = _mesh(4), make_multislice_mesh(2, ["cpu"] * 4)
        a, b = shard_state(ts, flat), shard_state(ts, twod)
        step_a = make_sharded_step(cfg, flat)
        step_b = make_sharded_step(cfg, twod)
        for _ in range(3):
            a, b = step_a(a), step_b(b)
        np.testing.assert_array_equal(_np(a)[0], _np(b)[0])

    def test_bitwise_across_live_rescale(self):
        cfg = SimConfig(num_particles=N, force_model="all_pairs")
        _, ts = _init(13)
        mesh2, mesh8 = _mesh(2), _mesh(8)
        step2 = make_sharded_step(cfg, mesh2)
        step8 = make_sharded_step(cfg, mesh8)
        ref = shard_state(ts, mesh2)
        for _ in range(4):
            ref = step2(ref)
        s = step2(step2(shard_state(ts, mesh2)))
        s = step8(step8(reshard_state(s, mesh8)))
        for a, b in zip(_np(s), _np(ref)):
            np.testing.assert_array_equal(a, b)

    def test_out_buffers_are_written(self):
        """The engine's ping-pong form (`out=`) gives the same bits."""
        cfg = SimConfig(num_particles=N, force_model="all_pairs")
        _, ts = _init(14)
        mesh = _mesh(4)
        s = shard_state(ts, mesh)
        step = make_sharded_step(cfg, mesh)
        spare = s.empty_like()
        got = step(s, 300, out=spare)
        assert got is spare
        for a, b in zip(_np(got), _np(step(s, 300))):
            np.testing.assert_array_equal(a, b)


class TestSupports:
    def test_gating(self):
        for args in ((32, 4), (256, 8), (32, 1), (48, 7), (30, 4)):
            assert dist_fft.supports(*args) == jdist.supports(*args)


class TestConvolve:
    @pytest.mark.parametrize("ndev", [4, 8])
    def test_matches_local_convolve(self, ndev):
        g, box, eps2 = 32, 2048.0, 25.0
        rng = np.random.default_rng(0)
        parts = rng.normal(size=(ndev, g, g, g)).astype(np.float32)
        mesh = _mesh(ndev)
        out = dist_fft.convolve_mesh(
            [torch.from_numpy(p) for p in parts],
            dist_fft.make_kernel_slabs(mesh, g, box, eps2), g, mesh)
        want = np.asarray(jpm._convolve_pruned(
            jnp.asarray(parts.sum(axis=0)),
            jpm._potential_kernel_rfft(g, box, eps2), g))
        scale = np.abs(want).max()
        for d in range(ndev):
            # every rank must hold the SAME, correct full phi
            np.testing.assert_allclose(out[d].numpy(), want, rtol=1e-4,
                                       atol=1e-4 * scale)
            assert torch.equal(out[d], out[0])


def _pm_cfg(n, **kw):
    kw = dict(num_particles=n, force_model="pm_grid", pm_grid_size=32,
              pm_box=4096.0, interaction_scale=1.0 / n, **kw)
    return JSimConfig(**kw), SimConfig(**kw)


class TestShardedPMDistFFT:
    def test_matches_single_device(self):
        jcfg, cfg = _pm_cfg(N, pm_distributed_fft=True)
        js, ts = _init(2)
        ref = jintegrator.make_step(jcfg, donate=False)(js)
        mesh = _mesh(4)
        out = make_sharded_step(cfg, mesh)(shard_state(ts, mesh))
        np.testing.assert_allclose(_np(out)[0], np.asarray(ref.position),
                                   rtol=1e-5, atol=1e-3)

    def test_multislice(self):
        jcfg, cfg = _pm_cfg(N, pm_distributed_fft=True)
        js, ts = _init(4)
        ref = jintegrator.make_step(jcfg, donate=False)(js)
        mesh = make_multislice_mesh(2, ["cpu"] * 8)
        out = make_sharded_step(cfg, mesh)(shard_state(ts, mesh))
        np.testing.assert_allclose(_np(out)[0], np.asarray(ref.position),
                                   rtol=1e-5, atol=1e-3)

    def test_multi_step_trajectory(self):
        jcfg, cfg = _pm_cfg(N, pm_distributed_fft=True)
        js, ts = _init(7)
        jstep = jintegrator.make_step(jcfg, donate=False)
        mesh = _mesh(4)
        step = make_sharded_step(cfg, mesh)
        s = shard_state(ts, mesh)
        for _ in range(3):
            js, s = jstep(js), step(s)
        np.testing.assert_allclose(_np(s)[0], np.asarray(js.position),
                                   rtol=1e-4, atol=5e-3)

    def test_grid_all_reduce_matches_jax_sharded(self, eight_devices):
        """The default pm path (every rank solves the summed grid)."""
        jcfg, cfg = _pm_cfg(N)
        js, ts = _init(9)
        jmesh = jpar.make_mesh(eight_devices[:4])
        jout = jpar.make_sharded_step(jcfg, jmesh, donate=False)(
            jpar.shard_state(js, jmesh))
        out = make_sharded_step(cfg, _mesh(4))(shard_state(ts, _mesh(4)))
        np.testing.assert_allclose(_np(out)[0], np.asarray(jout.position),
                                   rtol=1e-5, atol=1e-3)


# -- p3m on the mesh ---------------------------------------------------------
MASS, EPS2 = 70000.0, 25.0
BOX, R_C = 2048.0, 216.0
GN = int(BOX // R_C)


def _two_blobs(seed, n=1024):
    rng = np.random.default_rng(seed)
    p = np.zeros((4, n), np.float32)
    p[:3] = np.concatenate([rng.normal(0, 60, (n // 2, 3)),
                            rng.normal(300, 60, (n - n // 2, 3))]).T
    return p


def _owner(ndev, r):
    return lambda ids: ids % ndev == r


class TestShardedP3M:
    @pytest.mark.parametrize("near", ["tree", "slots"])
    def test_matches_jax_sharded(self, eight_devices, near):
        """A uniform scene that fits the slot capacity (with overflow the
        two packages' binning sorts, stable and not, drop different
        particles)."""
        kw = dict(num_particles=N, force_model="p3m", pm_grid_size=32,
                  pm_box=4096.0, interaction_scale=1.0 / N,
                  p3m_near_mode=near)
        rng = np.random.default_rng(1)
        pos = np.zeros((4, N), np.float32)
        pos[:3] = rng.uniform(-1500, 1500, (3, N))
        vel = rng.normal(0, 1, (3, N)).astype(np.float32)
        from multi_adapter_particles_tpu.models.state import (
            ParticleState as JState,
        )

        js = JState(jnp.asarray(pos), jnp.asarray(vel))
        ts = ParticleState.from_numpy(pos, vel)
        jmesh = jpar.make_mesh(eight_devices[:4])
        jout = jpar.make_sharded_step(JSimConfig(**kw), jmesh, donate=False)(
            jpar.shard_state(js, jmesh))
        mesh = _mesh(4)
        step = make_sharded_step(SimConfig(**kw), mesh)
        out = step(shard_state(ts, mesh))
        np.testing.assert_allclose(_np(out)[0], np.asarray(jout.position),
                                   rtol=1e-5, atol=1e-3)
        if near == "tree":
            assert step.overflow == 0
        else:
            assert int(step.overflow) == 0

    @pytest.mark.parametrize("ndev", [2, 4])
    def test_tree_owner_partials_and_dropped(self, ndev):
        """The ranks' partial near fields summed against the JAX
        owner-masked ones summed, `dropped` bitwise on every rank (a
        starved budget, so it is > 0), and the port's partials summed
        bitwise its one-device directed sweep. (Which particles a rank
        owns follows block membership, which the JAX package's unstable
        Morton sort may draw differently: the sums compare, not the
        partials.)"""
        p = _two_blobs(seed=5)
        tp = torch.from_numpy(p)
        whole, _ = T.near_field_tree(tp, BOX, MASS, EPS2, R_C, GN, block=64)
        _, d_whole = T.near_field_tree(tp, BOX, MASS, EPS2, R_C, GN,
                                       block=64, pair_budget=40)
        total = torch.zeros_like(whole)
        want = 0.0
        for r in range(ndev):
            own = dict(block_owner_fn=_owner(ndev, r))
            jown = dict(block_owner_fn=lambda ids, r=r: ids % ndev == r)
            a, d = T.near_field_tree(tp, BOX, MASS, EPS2, R_C, GN, block=64,
                                     **own)
            ja, jd = JT.near_field_tree(jnp.asarray(p), BOX, MASS, EPS2, R_C,
                                        GN, block=64, **jown)
            assert d == int(jd) == 0
            assert (a != 0).any()
            total = total + a
            want = want + np.asarray(ja)
            _, d = T.near_field_tree(tp, BOX, MASS, EPS2, R_C, GN, block=64,
                                     pair_budget=40, **own)
            _, jd = JT.near_field_tree(jnp.asarray(p), BOX, MASS, EPS2, R_C,
                                       GN, block=64, pair_budget=40, **jown)
            assert d == int(jd) == d_whole > 0
        assert torch.equal(total, whole)
        np.testing.assert_allclose(total.numpy(), want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())

    def test_tree_owner_under_expansion(self, monkeypatch):
        """Sweep width 32 under blocks of 128 (four-way split): the owner
        partials still sum bitwise to the whole, and a starved sub-pair
        budget counts the same global shortfall on every rank."""
        monkeypatch.setattr(T, "_SWEEP_MAX_BLOCK", 32)
        tp = torch.from_numpy(_two_blobs(seed=17))
        kw = dict(block=128)
        whole, _ = T.near_field_tree(tp, BOX, MASS, EPS2, R_C, GN, **kw)
        total = sum(T.near_field_tree(tp, BOX, MASS, EPS2, R_C, GN,
                                      block_owner_fn=_owner(4, r), **kw)[0]
                    for r in range(4))
        assert torch.equal(total, whole)
        sub = T.tree_lists(tp, BOX, R_C, GN, **kw).pairs
        _, d_whole = T.near_field_tree(tp, BOX, MASS, EPS2, R_C, GN,
                                       sub_pair_budget=sub // 2, **kw)
        for r in range(4):
            _, d = T.near_field_tree(tp, BOX, MASS, EPS2, R_C, GN,
                                     sub_pair_budget=sub // 2,
                                     block_owner_fn=_owner(4, r), **kw)
            assert d == d_whole == sub - sub // 2

    def test_tree_owner_potential_partials(self):
        """The potential variants' owner partials sum to the whole."""
        tp = torch.from_numpy(_two_blobs(seed=3))
        kw = dict(block=64, with_potential=True, potential_only=True)
        u, _ = T.near_field_tree(tp, BOX, MASS, EPS2, R_C, GN, **kw)
        parts = [T.near_field_tree(tp, BOX, MASS, EPS2, R_C, GN,
                                   block_owner_fn=_owner(2, r), **kw)[0]
                 for r in range(2)]
        assert torch.equal(parts[0] + parts[1], u)
        assert (parts[0] != 0).any() and (parts[1] != 0).any()

    def test_owner_turns_the_halved_sweep_off(self):
        tp = torch.from_numpy(_two_blobs(seed=7))
        lists = T.tree_lists(tp, BOX, R_C, GN, block=64, half_force=True,
                             block_owner_fn=_owner(2, 0))
        assert not lists.n3
        assert bool((lists.sweep_i % 2 == 0).all())


# -- the CLI on the mesh ------------------------------------------------------
def _run(argv, tmp_path, name):
    seen = {}
    m = tmp_path / f"{name}.json"
    rc = cli.main(argv + ["-metrics", str(m), "-computeadapter", "0"],
                  on_exit=lambda p: seen.update(
                      pos=p.compute.state.position.clone(),
                      fence=p.compute.get_fence_value()))
    assert rc == 0
    return json.loads(m.read_text()), seen


BASE = ["-force", "all_pairs", "-rectpair", "-numparticles", "1024",
        "-novsync", "-nogui", "-width", "64", "-height", "64"]


class TestMeshCLI:
    def test_diagnostics_with_meshdevices(self, cpus, tmp_path):
        """The gauges run on the gathered state: bitwise the one-device
        run's (the bit-stable schedule's state is)."""
        diag = ["-steps", "4", "-nodraw", "-diagnostics", "2"]
        single, s1 = _run(BASE + diag, tmp_path, "one")
        mesh, s4 = _run(BASE + diag + ["-meshdevices", "4"], tmp_path,
                        "mesh")
        assert torch.equal(s1["pos"], s4["pos"])
        keys = [k for k in single["gauges"] if "energy" in k
                or "momentum" in k]
        assert "energy_drift" in keys and len(keys) >= 4
        for k in keys:
            assert mesh["gauges"][k] == single["gauges"][k], k
        assert "Mesh Compute (4 devices)" in mesh["gauges"]["mode_banner"]

    def test_checkpoint_resume_across_mesh(self, cpus, tmp_path):
        """A mesh run's checkpoint resumes on one device and the other way
        round; both end bitwise where an uninterrupted run does."""
        _, straight = _run(BASE + ["-steps", "4"], tmp_path, "straight")
        ck1, ck2 = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
        _run(BASE + ["-steps", "2", "-meshdevices", "4", "-checkpoint", ck1],
             tmp_path, "m1")
        _, one = _run(BASE + ["-steps", "2", "-resume", ck1], tmp_path, "r1")
        assert torch.equal(one["pos"], straight["pos"]) and one["fence"] == 4
        _run(BASE + ["-steps", "2", "-checkpoint", ck2], tmp_path, "s1")
        _, mesh = _run(BASE + ["-steps", "2", "-resume", ck2,
                               "-meshdevices", "8"], tmp_path, "r2")
        assert torch.equal(mesh["pos"], straight["pos"])
        assert mesh["fence"] == 4

    @pytest.mark.parametrize("force", [
        ["-force", "pm_grid", "-pmgrid", "32"],
        ["-force", "p3m", "-p3mnear", "tree", "-pmgrid", "32"],
        ["-force", "p3m", "-p3mnear", "slots", "-pmgrid", "32"],
    ])
    def test_force_models_through_the_cli(self, cpus, tmp_path, force):
        """pm_grid and p3m (tree, slots) run on a 4-device mesh from the
        CLI, within the JAX suite's sharded-PM tolerance of one device."""
        argv = force + ["-numparticles", "1024", "-steps", "2", "-nodraw",
                        "-novsync", "-nogui", "-pmbox", "4096"]
        _, one = _run(argv, tmp_path, "one")
        m, mesh = _run(argv + ["-meshdevices", "4"], tmp_path, "mesh")
        assert "Mesh Compute (4 devices)" in m["gauges"]["mode_banner"]
        np.testing.assert_allclose(mesh["pos"].numpy(), one["pos"].numpy(),
                                   rtol=1e-4, atol=5e-3)

    def test_meshdevices_flag_with_too_few_devices(self, capsys):
        rc = cli.main(BASE + ["-steps", "1", "-meshdevices", "2",
                              "-computeadapter",
                              str(devices.cpu_adapter_index())])
        assert rc == 1
        assert "mesh of 2 requested" in capsys.readouterr().err

    def test_dryrun_tool(self):
        from multi_adapter_particles_torch.tools import dryrun_multichip

        msg = dryrun_multichip.dryrun(["cpu"] * 4)
        assert msg.startswith("dryrun_multichip(4): ok")


def test_parallel_never_imports_jax():
    code = (
        "import sys\n"
        "import multi_adapter_particles_torch.parallel\n"
        "import multi_adapter_particles_torch.parallel.dist_fft\n"
        "import multi_adapter_particles_torch.render.renderer\n"
        "import multi_adapter_particles_torch.runtime.render_engine\n"
        "import multi_adapter_particles_torch.tools.dryrun_multichip\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('multi_adapter_particles_tpu')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
