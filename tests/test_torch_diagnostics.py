"""Conservation diagnostics of the torch port against the JAX package: the
exact pairwise gauge, the conservation physics, the P3M mesh gauge, the
cadenced probe, and the `-diagnostics` / `-diagmode` CLI wiring, mirroring
tests/test_diagnostics.py.

Seeded numpy states go to both packages; the JAX side runs its XLA
fallback (the directed tree sweep). Gauges agree with the JAX package's
within rel 1e-5 in exact mode and rel 1e-4 in mesh mode (the mesh adds two
FFT libraries and another order of every tree sum; both measured below
1.5e-6 on these scenes, the momentum components being the worst: sums of
terms of both signs).
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multi_adapter_particles_tpu.config import SimConfig as JSimConfig
from multi_adapter_particles_tpu.models import diagnostics as JD
from multi_adapter_particles_tpu.models import init as jinit
from multi_adapter_particles_tpu.models.state import ParticleState as JState

from multi_adapter_particles_torch import app
from multi_adapter_particles_torch.config import SimConfig
from multi_adapter_particles_torch.models import diagnostics as D
from multi_adapter_particles_torch.models import init as pinit
from multi_adapter_particles_torch.models import integrator
from multi_adapter_particles_torch.models.state import (
    PAD_POSITION,
    ParticleState,
)
from multi_adapter_particles_torch.ops import treeforce
from multi_adapter_particles_torch.runtime.devices import cpu_adapter_index
from multi_adapter_particles_torch.utils.metrics import MetricsRegistry

# The suite runs one xdist worker per core; torch's own thread pool on top
# only oversubscribes them.
torch.set_num_threads(1)

CPU = ["-computeadapter", str(cpu_adapter_index())]
GAUGES = ("kinetic", "potential", "energy", "momentum_x", "momentum_y",
          "momentum_z", "momentum_mag", "angular_momentum_mag")


def _circular_orbit_state(n_pad=128):
    """One particle on an exact circular orbit of the softened well:
    v² = M r² / (r² + eps²)^{3/2} (padding parked)."""
    m, eps2, r = 70000.0, 25.0, 400.0
    v = np.sqrt(m * r * r / (r * r + eps2) ** 1.5)
    pos = np.full((4, n_pad), PAD_POSITION, np.float32)
    pos[3] = 0.0
    vel = np.zeros((3, n_pad), np.float32)
    pos[:3, 0] = (r, 0.0, 0.0)
    vel[:, 0] = (0.0, v, 0.0)
    return ParticleState.from_numpy(pos, vel)


def _clustered(n, seed=0):
    """Two Gaussian clusters with random velocities, padding parked ->
    numpy (position [4, Np], velocity [3, Np])."""
    rng = np.random.default_rng(seed)
    n_pad = -(-n // 128) * 128
    pos = np.full((4, n_pad), PAD_POSITION, np.float32)
    pos[3] = 0.0
    pos[:3, :n] = np.concatenate([rng.normal(0, 120, (3, n // 2)),
                                  rng.normal(300, 60, (3, n - n // 2))],
                                 axis=1)
    vel = np.zeros((3, n_pad), np.float32)
    vel[:, :n] = rng.normal(0, 2, (3, n))
    return pos, vel


def _state(n, seed=0):
    return ParticleState.from_numpy(*_clustered(n, seed))


def _floats(gauges):
    return {k: float(v) for k, v in gauges.items()}


def _assert_gauges_close(got, want, rel):
    """Each gauge within `rel` of the JAX package's; the energy, a
    difference of kinetic and potential, within `rel` of their magnitudes
    (one float32 ulp of the potential is ~1e-5 of a nearly virialized
    scene's energy)."""
    assert set(got) >= set(want)
    for k in want:
        if k == "energy":
            scale = abs(want["kinetic"]) + abs(want["potential"])
            assert abs(got[k] - want[k]) <= rel * scale, k
        else:
            assert got[k] == pytest.approx(want[k], rel=rel), k


class TestPairwisePotential:
    def test_matches_double_loop_oracle(self):
        rng = np.random.default_rng(3)
        n, n_pad = 48, 128
        g, eps2 = 7.5, 25.0
        p = np.zeros((4, n_pad), np.float32)
        p[:3, :n] = rng.uniform(-100, 100, (3, n))
        p[:3, n:] = 1e9
        mask = (np.arange(n_pad) < n).astype(np.float32)
        pe, acc = D.pairwise_potential_and_accel(
            torch.from_numpy(p), torch.from_numpy(mask), g, eps2)
        pe_ref, acc_ref = 0.0, np.zeros((3, n))
        for i in range(n):
            for j in range(n):
                if i != j:
                    d = p[:3, j].astype(np.float64) - p[:3, i]
                    d2 = float(d @ d) + eps2
                    pe_ref -= 0.5 * g / np.sqrt(d2)
                    acc_ref[:, i] += g * d / d2 ** 1.5
        assert float(pe) == pytest.approx(pe_ref, rel=1e-5)
        np.testing.assert_allclose(acc.numpy()[:, :n], acc_ref, rtol=2e-4,
                                   atol=1e-6)
        assert np.all(np.abs(acc.numpy()[:, n:]) < 1e-6)

    def test_padding_pairs_excluded(self):
        """Two co-located parked rows would add 1/eps pair terms if the mask
        leaked."""
        p = np.full((4, 128), 1e9, np.float32)
        p[3] = 0.0
        p[:3, 0] = 0.0
        mask = (np.arange(128) < 1).astype(np.float32)
        pe, acc = D.pairwise_potential_and_accel(
            torch.from_numpy(p), torch.from_numpy(mask), 1.0, 25.0)
        assert float(pe) == pytest.approx(0.0, abs=1e-7)
        assert np.all(np.abs(acc.numpy()) < 1e-12)

    def test_target_chunks_match_one_pass(self, monkeypatch):
        """Chunking the targets changes no sum: each row is still summed
        tile by tile in j order."""
        pos, _ = _clustered(1000, seed=4)
        p = torch.from_numpy(pos)
        mask = (torch.arange(p.shape[1]) < 1000).float()
        one = D.pairwise_potential_and_accel(p, mask, 3.0, 25.0, j_tile=256)
        monkeypatch.setattr(D, "_EXACT_I_CHUNK", 384)
        chunked = D.pairwise_potential_and_accel(p, mask, 3.0, 25.0,
                                                 j_tile=256)
        assert torch.equal(one[0], chunked[0])
        assert torch.equal(one[1], chunked[1])


class TestConservation:
    def test_circular_orbit_energy_bounded(self):
        """Semi-implicit Euler is symplectic at damping=1: the synchronized
        energy on a circular orbit stays in a tight bound."""
        cfg = SimConfig(num_particles=1, force_model="central_well")
        step = integrator.make_step(cfg)
        diag = D.make_diagnostics(cfg)
        state = _circular_orbit_state()
        e0 = float(diag(state)["energy"])
        worst = 0.0
        for _ in range(40):
            for _ in range(25):
                state = step(state)
            e = float(diag(state)["energy"])
            worst = max(worst, abs(e - e0) / abs(e0))
        assert worst < 2e-4, f"energy drift {worst:.2e}"

    def test_sync_removes_sawtooth(self):
        """On an eccentric orbit the raw half-step velocity's energy carries
        an O(dt) oscillation that the half-kick sync removes."""
        cfg = SimConfig(num_particles=1, force_model="central_well")
        step = integrator.make_step(cfg)
        d_sync = D.make_diagnostics(cfg, sync=True)
        d_raw = D.make_diagnostics(cfg, sync=False)
        state = _circular_orbit_state()
        state = ParticleState(state.position, state.velocity * 0.8)
        state = step(state)
        e0s = float(d_sync(state)["energy"])
        e0r = float(d_raw(state)["energy"])
        errs, errr = [], []
        for _ in range(200):
            state = step(state)
            errs.append(abs(float(d_sync(state)["energy"]) - e0s))
            errr.append(abs(float(d_raw(state)["energy"]) - e0r))
        assert max(errs) < 0.2 * max(errr)

    def test_all_pairs_momentum_and_energy(self):
        n = 512
        cfg = SimConfig(num_particles=n, force_model="all_pairs")
        step = integrator.make_step(cfg)
        diag = D.make_diagnostics(cfg)
        state = pinit.initialize_particles_device(
            n, torch.Generator().manual_seed(7))
        d0 = _floats(diag(state))
        for _ in range(100):
            state = step(state)
        d1 = _floats(diag(state))
        assert abs(d1["momentum_mag"] - d0["momentum_mag"]) < 0.3
        drift = abs(d1["energy"] - d0["energy"]) / abs(d0["energy"])
        assert drift < 5e-3, f"energy drift {drift:.2e}"

    def test_damping_dissipates(self):
        cfg = SimConfig(num_particles=1, force_model="central_well",
                        damping=0.99)
        step = integrator.make_step(cfg)
        diag = D.make_diagnostics(cfg)
        state = _circular_orbit_state()
        k0 = float(diag(state)["kinetic"])
        for _ in range(200):
            state = step(state)
        assert float(diag(state)["kinetic"]) < 0.9 * k0


PM_KW = dict(force_model="pm_grid", pm_grid_size=32)


class TestMeshPotential:
    def test_mesh_energy_matches_exact_clustered(self):
        """The mesh potential within rel 1e-3 of the exact pair sum on the
        clustered 4,096 scene (the JAX pin)."""
        n = 4096
        cfg = SimConfig(num_particles=n, **PM_KW)
        state = _state(n)
        ve = _floats(D.make_diagnostics(cfg, potential_mode="exact")(state))
        vm = _floats(D.make_diagnostics(cfg, potential_mode="mesh")(state))
        assert vm["potential"] == pytest.approx(ve["potential"], rel=1e-3)
        assert vm["diag_dropped_pairs"] == 0
        assert vm["kinetic"] == pytest.approx(ve["kinetic"], rel=1e-3)
        assert vm["energy"] == pytest.approx(ve["energy"], rel=1e-3)

    def test_auto_mode_thresholds(self):
        assert D._EXACT_MAX_N == 262_144
        small = SimConfig(num_particles=4096, **PM_KW)
        assert "diag_dropped_pairs" not in D.make_diagnostics(small)(
            _state(4096))
        assert D._uses_mesh(SimConfig(num_particles=262_145, **PM_KW),
                            "auto")
        assert not D._uses_mesh(SimConfig(num_particles=262_144, **PM_KW),
                                "auto")
        assert not D._uses_mesh(
            SimConfig(num_particles=1 << 22, force_model="central_well"),
            "mesh")
        with pytest.raises(ValueError, match="potential_mode"):
            D.make_diagnostics(small, potential_mode="fast")

    @pytest.mark.parametrize("n,grid,want", [
        (4096, 32, 32), (262_144, 64, 64), (1_048_576, 128, 192),
        (4_194_304, 128, 256), (4_194_304, 256, 256), (4_194_304, 64, 256)])
    def test_gauge_grid_table(self, n, grid, want):
        assert D._gauge_grid(n, grid) == JD._gauge_grid(n, grid) == want

    def test_potential_only_equals_fused(self):
        n = 2048
        cfg = SimConfig(num_particles=n, **PM_KW)
        pos = _state(n).position
        g = cfg.mass * cfg.interaction_scale
        pot_f, _, drop_f = D.mesh_potential_and_accel(
            pos, g, cfg.softening_squared, grid=32, box=cfg.pm_box)
        pot_o, drop_o = D.mesh_potential_only(
            pos, g, cfg.softening_squared, grid=32, box=cfg.pm_box)
        assert float(pot_o) == pytest.approx(float(pot_f), rel=1e-6)
        assert drop_f == drop_o == 0
        # the directed per-particle route of the potential-only gauge is
        # the fused sweep's potential bit for bit
        pot_d, _ = D.mesh_potential_only(
            pos, g, cfg.softening_squared, grid=32, box=cfg.pm_box,
            half_pairs=False, total_only=False)
        assert torch.equal(pot_d, pot_f)

    def test_external_accel_path_equals_internal(self):
        n = 2048
        cfg = SimConfig(num_particles=n, **PM_KW)
        state = _state(n)
        g = cfg.mass * cfg.interaction_scale
        _, accel, _ = D.mesh_potential_and_accel(
            state.position, g, cfg.softening_squared, grid=32,
            box=cfg.pm_box)
        vi = _floats(D.make_diagnostics(cfg, potential_mode="mesh")(state))
        ve = _floats(D.make_diagnostics(cfg, potential_mode="mesh",
                                        external_accel=True)(state, accel))
        assert set(vi) == set(ve)
        for k in vi:
            assert ve[k] == pytest.approx(vi[k], rel=1e-6, abs=1e-6), k

    def test_probe_run_accel_auto(self):
        n = 2048
        cfg = SimConfig(num_particles=n, **PM_KW)
        state = _state(n)
        m_fast, m_full = MetricsRegistry(), MetricsRegistry()
        fast = D.DiagnosticsProbe(cfg, 1, potential_mode="mesh")
        full = D.DiagnosticsProbe(cfg, 1, potential_mode="mesh",
                                  use_run_accel=False)
        assert fast.use_run_accel and not full.use_run_accel
        assert fast.maybe_publish(0, state, m_fast)
        assert full.maybe_publish(0, state, m_full)
        gf, gu = m_fast.gauges, m_full.gauges
        assert gf["potential"] == pytest.approx(gu["potential"], rel=1e-6)
        assert gf["energy"] == pytest.approx(gu["energy"], rel=1e-3)
        assert gf["energy_drift"] == 0.0 and gf["diag_sample_ms"][0] > 0
        for cfg_off in (SimConfig(num_particles=n,
                                  force_model="central_well"),
                        SimConfig(num_particles=n, **PM_KW),
                        SimConfig(num_particles=n, force_model="p3m",
                                  p3m_near_mode="tree", pm_grid_size=32)):
            mode = "mesh" if cfg_off.force_model == "p3m" else "auto"
            assert not D.DiagnosticsProbe(cfg_off, 1,
                                          potential_mode=mode).use_run_accel

    def test_probe_publishes_on_its_cadence(self):
        n = 1024
        cfg = SimConfig(num_particles=n, force_model="all_pairs")
        state = _state(n)
        m = MetricsRegistry()
        probe = D.DiagnosticsProbe(cfg, 3)
        assert not probe.maybe_publish(2, state, m) and not m.gauges
        assert probe.maybe_publish(3, state, m)
        assert probe.maybe_publish(6, state, m)
        for k in GAUGES + ("energy_drift",):
            assert np.isfinite(m.gauges[k]), k
        assert len(m.gauges["diag_sample_ms"]) == 2
        assert "diag_dropped_pairs" not in m.gauges


class TestProbeSubBudget:
    def test_probe_caches_both_budgets_and_drops_nothing(self,
                                                         monkeypatch):
        """The sweep width cut to 32 so the probe's scene expands: one
        host count sizes both budgets, cached for both gauge variants."""
        monkeypatch.setattr(treeforce, "_SWEEP_MAX_BLOCK", 32)
        n = 2048
        cfg = SimConfig(num_particles=n, **PM_KW)
        pos, _ = _clustered(n, seed=3)
        state = ParticleState.from_numpy(pos, np.zeros((3, pos.shape[1])))
        probe = D.DiagnosticsProbe(cfg, 1, potential_mode="mesh")
        m = MetricsRegistry()
        calls = []
        real = treeforce.host_tree_counts
        monkeypatch.setattr(treeforce, "host_tree_counts",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
        assert probe.maybe_publish(0, state, m)
        assert probe.maybe_publish(1, state, m, accel=None)
        probe.use_run_accel = False
        assert probe.maybe_publish(2, state, m)    # the fused variant
        assert len(calls) == 1
        assert probe._probed_budget is not None
        assert probe._probed_sub is not None and probe._probed_sub > 0
        assert m.gauges["diag_dropped_pairs"] == 0.0


class TestAgainstJax:
    """Every gauge of the port against the JAX package's `make_diagnostics`
    on the same seeded state."""

    @pytest.mark.parametrize("model,mode,ext", [
        ("all_pairs", "exact", False), ("central_well", "auto", False),
        ("pm_grid", "mesh", False), ("pm_grid", "mesh", True),
        ("p3m", "mesh", False), ("pm_grid", "mesh", "nosync")])
    def test_gauges_match_jax(self, model, mode, ext):
        n = 2048
        pos, vel = _clustered(n)
        kw = dict(num_particles=n, force_model=model, pm_grid_size=32)
        if model == "p3m":
            kw["p3m_near_mode"] = "tree"
        sync = ext != "nosync"
        ext = ext is True
        jfn = JD.make_diagnostics(JSimConfig(**kw), sync=sync,
                                  potential_mode=mode, external_accel=ext)
        tfn = D.make_diagnostics(SimConfig(**kw), sync=sync,
                                 potential_mode=mode, external_accel=ext)
        js = JState(jnp.asarray(pos), jnp.asarray(vel))
        ts = ParticleState.from_numpy(pos, vel)
        if ext:
            acc = np.random.default_rng(5).normal(
                0, 1e-3, (3, pos.shape[1])).astype(np.float32)
            want, got = jfn(js, jnp.asarray(acc)), tfn(ts,
                                                       torch.from_numpy(acc))
        else:
            want, got = jfn(js), tfn(ts)
        want, got = _floats(want), _floats(got)
        assert set(got) == set(want)
        _assert_gauges_close(got, want, 1e-5 if mode == "exact" else 1e-4)
        if "diag_dropped_pairs" in want:
            assert got["diag_dropped_pairs"] == want[
                "diag_dropped_pairs"] == 0


class TestCli:
    def test_diagnostics_flag_matches_jax_app(self, tmp_path, monkeypatch):
        """A 4-frame `-force all_pairs -diagnostics 2` slice of both CLIs
        from the JAX package's device init (handed to the port's engine),
        the port on the rectangle schedule the JAX CPU engine runs: the
        exact-mode gauges agree within rel 1e-5, the drift stays small."""
        from multi_adapter_particles_tpu import app as japp

        n = 1024
        j0 = jinit.initialize_particles_device(n, seed=0)
        monkeypatch.setattr(
            pinit, "initialize_particles_device",
            lambda *a, **k: ParticleState.from_numpy(
                np.asarray(j0.position), np.asarray(j0.velocity),
                device=k.get("device")))
        argv = ["-force", "all_pairs", "-numparticles", str(n), "-steps",
                "4", "-diagnostics", "2", "-nogui", "-novsync", "-nodraw",
                "-width", "32", "-height", "32"]
        jout, tout = tmp_path / "j.json", tmp_path / "t.json"
        assert japp.main(argv + ["-metrics", str(jout)]) == 0
        assert app.main(argv + ["-rectpair", "-metrics", str(tout)]
                        + CPU) == 0
        want = json.loads(jout.read_text())["gauges"]
        got = json.loads(tout.read_text())["gauges"]
        assert abs(got["energy_drift"]) < 1e-2
        assert np.isfinite(got["energy"])
        _assert_gauges_close({k: got[k] for k in GAUGES},
                             {k: want[k] for k in GAUGES}, 1e-5)
        # the drift: two energies, each within 1e-5 of |K| + |U|
        scale = (abs(want["kinetic"]) + abs(want["potential"])) / abs(
            want["energy"])
        assert abs(got["energy_drift"] - want["energy_drift"]) <= \
            2e-5 * scale

    def test_mesh_gauge_on_the_cli(self, tmp_path):
        out = tmp_path / "m.json"
        rc = app.main(["-force", "pm_grid", "-pmgrid", "32", "-numparticles",
                       "2048", "-steps", "2", "-diagnostics", "1",
                       "-diagmode", "mesh", "-nodraw", "-nogui", "-novsync",
                       "-metrics", str(out)] + CPU)
        assert rc == 0
        g = json.loads(out.read_text())["gauges"]
        assert g["diag_dropped_pairs"] == 0
        for k in GAUGES + ("energy_drift",):
            assert np.isfinite(g[k]), k
        assert len(g["diag_sample_ms"]) == 2

    def test_unknown_diagmode_exits_2(self, capsys):
        assert app.main(["-numparticles", "256", "-steps", "1",
                         "-diagnostics", "1", "-diagmode", "fast"]
                        + CPU) == 2
        assert "-diagmode fast" in capsys.readouterr().err
