"""Tree-P3M parity of the torch port against the JAX package: the long-range
mesh, the full force, the engine step, the CLI with its startup probe, and
a 4-frame slice of the split frame loop.

Seeded numpy inputs go to both packages; the JAX side runs its XLA fallback
(the directed tree sweep) or, with `dispatch.pallas_supported` patched, its
Newton-3rd Pallas kernel in interpret mode. Tolerances: the long-range
kernel spectra at 1e-5 of their largest value (two FFT libraries); full
accelerations at 1e-6 of max|a| against the same sweep schedule (the JAX
package's own halved-vs-directed pin) and at 1e-5 against the JAX mesh
alone; states after a few steps at rtol/atol 2e-5 and frames at 2e-3, as
tests/test_torch_slice.py holds the central well.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multi_adapter_particles_tpu.config import (
    AppConfig as JAppConfig,
    RenderConfig as JRenderConfig,
    SimConfig as JSimConfig,
)
from multi_adapter_particles_tpu.models import init as jinit
from multi_adapter_particles_tpu.models import integrator as jintegrator
from multi_adapter_particles_tpu.ops import dispatch
from multi_adapter_particles_tpu.ops import p3m as JP3
from multi_adapter_particles_tpu.runtime import ParticlesApp as JApp

from multi_adapter_particles_torch import app
from multi_adapter_particles_torch.config import (
    AppConfig,
    RenderConfig,
    SimConfig,
)
from multi_adapter_particles_torch.models import integrator
from multi_adapter_particles_torch.models.state import ParticleState
from multi_adapter_particles_torch.ops import p3m
from multi_adapter_particles_torch.runtime.compute_engine import ComputeEngine
from multi_adapter_particles_torch.runtime.devices import cpu_adapter_index
from multi_adapter_particles_torch.runtime.orchestrator import ParticlesApp

# The suite runs one xdist worker per core; torch's own thread pool on top
# only oversubscribes them.
torch.set_num_threads(1)

MASS = 70000.0
EPS2 = 25.0
CPU = ["-computeadapter", str(cpu_adapter_index())]


def _clustered(n=1536, seed=21):
    rng = np.random.default_rng(seed)
    p = np.zeros((4, n), np.float32)
    p[:3] = np.concatenate([rng.normal(0, 90, (n // 2, 3)),
                            rng.normal(250, 50, (n - n // 2, 3))]).T
    return p


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


class TestLongRange:
    def test_cutoff_validation_matches_jax(self):
        assert p3m.MIN_CUTOFF_CELLS == JP3.MIN_CUTOFF_CELLS
        for c in (2.0, 2.598, 2.6, 6.75):
            jax_ok = port_ok = True
            try:
                JP3.validate_cutoff_cells(c)
            except ValueError:
                jax_ok = False
            try:
                p3m.validate_cutoff_cells(c)
            except ValueError:
                port_ok = False
            assert jax_ok == port_ok
        with pytest.raises(ValueError, match="p3mcutoff"):
            SimConfig(num_particles=64, force_model="p3m",
                      p3m_cutoff_cells=2.0)

    def test_g_long_matches_jax(self):
        """rtol 1e-5 from r = σ/2 out. Nearer, the float32 numerator
        erf(u) - √(2/π)(r/σ)e^(..) cancels (the JAX package's own note:
        the erf form loses up to 45% at r ~ 0.01), which turns the two erf
        implementations' last-bit differences into large relative ones;
        the spectra below cover that range as a whole."""
        d2 = np.linspace(0.0, 4e5, 20001).astype(np.float32)
        for sigma in (20.0, 61.3):
            want = np.asarray(JP3._g_long(jnp.asarray(d2), sigma))
            got = p3m._g_long(torch.from_numpy(d2), sigma).numpy()
            far = d2 >= (sigma / 2) ** 2
            np.testing.assert_allclose(got[far], want[far], rtol=1e-5)
            assert got[0] == want[0] == 0.0

    @pytest.mark.parametrize("g,box", [(16, 2048.0), (32, 4096.0)])
    def test_kernel_spectra_match_jax(self, g, box, monkeypatch):
        """The three analytic gradient-kernel spectra, tabulated slab by
        slab (a slab of 4,096 cells forces several)."""
        r_c = 6.75 * box / g
        monkeypatch.setattr(p3m, "_KERNEL_SLAB_CELLS", 4096)
        p3m._long_grad_kernels_rfft.cache_clear()
        want = JP3._long_grad_kernels_rfft(g, box, r_c)
        got = p3m._long_grad_kernels_rfft(g, box, r_c, torch.device("cpu"))
        p3m._long_grad_kernels_rfft.cache_clear()
        for w, t in zip(want, got):
            assert _rel(t.numpy(), np.asarray(w)) < 1e-5

    def test_host_overflow_count_equals_jax(self):
        p = np.asarray(jinit.initialize_particles_device(4096, seed=1)
                       .position)
        for cap in (8, 64):
            assert p3m.host_overflow_count(p, 64, 2048.0, 6.75, cap) == \
                JP3.host_overflow_count(p, 64, 2048.0, 6.75, cap)


KW = dict(grid=16, box=2048.0, g_const=MASS, softening_squared=EPS2,
          near_mode="tree")


class TestTreeP3M:
    def test_directed_matches_jax(self):
        p = _clustered()
        want, d_jax = JP3.p3m_accel_with_overflow(jnp.asarray(p), **KW)
        got, d_port = p3m.p3m_accel_with_overflow(torch.from_numpy(p), **KW)
        assert int(d_jax) == d_port == 0
        assert _rel(got.numpy(), np.asarray(want)) < 1e-6

    def test_halved_matches_jax_halved_and_directed(self, monkeypatch):
        p = _clustered(seed=22)
        directed, _ = JP3.p3m_accel_with_overflow(jnp.asarray(p), **KW)
        monkeypatch.setattr(dispatch, "pallas_supported", lambda: True)
        n3, _ = JP3.p3m_accel_with_overflow(jnp.asarray(p), half_force=True,
                                            **KW)
        got, _ = p3m.p3m_accel_with_overflow(torch.from_numpy(p),
                                             half_force=True, **KW)
        assert _rel(got.numpy(), np.asarray(n3)) < 1e-6
        assert _rel(got.numpy(), np.asarray(directed)) < 1e-6

    @pytest.mark.parametrize("half", [False, True])
    def test_make_accel_fn_for_matches_jax(self, half):
        """g_const = mass * interaction_scale, tree_half_force reaching the
        sweep; against the JAX function (its CPU path is the directed XLA
        sweep either way)."""
        n = 1536
        p = _clustered(n, seed=4)
        kw = dict(num_particles=n, force_model="p3m", pm_grid_size=16,
                  p3m_near_mode="tree", tree_half_force=half)
        want = np.asarray(jintegrator.make_accel_fn_for(JSimConfig(**kw))(
            jnp.asarray(p)))
        got = integrator.make_accel_fn_for(SimConfig(**kw))(
            torch.from_numpy(p)).numpy()
        assert _rel(got, want) < 1e-6

    def test_engine_steps_match_jax(self):
        """Three steps of the compute engine from the JAX engine's state;
        the interactions counter counts simulated particles."""
        from multi_adapter_particles_tpu.runtime.compute_engine import (
            ComputeEngine as JEngine,
        )

        n = 2048
        kw = dict(num_particles=n, force_model="p3m", pm_grid_size=32,
                  p3m_near_mode="tree")
        jeng = JEngine(JSimConfig(**kw), jax.devices()[0], seed=3,
                       donate=False)
        teng = ComputeEngine(SimConfig(tree_half_force=False, **kw), "cpu")
        teng.restore(ParticleState.from_numpy(
            np.array(jeng.state.position), np.array(jeng.state.velocity)))
        for _ in range(3):
            jeng.simulate()
            teng.simulate()
        tpos, tvel = teng.state.to_numpy()
        np.testing.assert_allclose(tpos, np.asarray(jeng.state.position),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(tvel, np.asarray(jeng.state.velocity),
                                   rtol=2e-5, atol=2e-5)
        assert teng.metrics.counters["interactions"] == \
            jeng.metrics.counters["interactions"] == 3.0 * n


class TestPotential:
    """The diagnostics gauge's P3M potential against the JAX package's
    (`p3m_potential_*`, `with_potential`), and the scalar-total path
    against the per-particle one, as tests/test_p3m.py's
    TestPotentialTotal pins them. Port vs JAX: per-particle u within 1e-5
    of max|u| and totals within rel 1e-5 (two FFT libraries and another
    order of every sum; measured ~2e-7 on these scenes); total vs
    per-particle sum within the JAX pin, rel 2e-6."""

    PKW = dict(grid=16, box=2048.0, g_const=MASS, softening_squared=EPS2)

    @pytest.mark.parametrize("g,box", [(16, 2048.0), (32, 4096.0)])
    def test_potential_kernel_spectrum_matches_jax(self, g, box,
                                                   monkeypatch):
        r_c = 6.75 * box / g
        monkeypatch.setattr(p3m, "_KERNEL_SLAB_CELLS", 4096)
        p3m._long_potential_kernel_rfft.cache_clear()
        want = np.asarray(JP3._long_potential_kernel_rfft(g, box, r_c))
        got = p3m._long_potential_kernel_rfft(g, box, r_c,
                                              torch.device("cpu")).numpy()
        p3m._long_potential_kernel_rfft.cache_clear()
        assert _rel(got, want) < 1e-5

    @pytest.mark.parametrize("half", [False, True])
    def test_total_matches_per_particle_sum(self, half):
        p = torch.from_numpy(_clustered(768, seed=17))
        u, d0 = p3m.p3m_potential_with_overflow(p, half_pairs=half,
                                                **self.PKW)
        tot, d1 = p3m.p3m_potential_total_with_overflow(p, half_pairs=half,
                                                        **self.PKW)
        assert d0 == d1 == 0 and tot.dim() == 0
        assert float(tot) == pytest.approx(float(u.double().sum()), rel=2e-6)

    def test_total_with_out_of_box_particles(self):
        pos = _clustered(768, seed=29)
        pos[:3, :9] = 5000.0
        p = torch.from_numpy(pos)
        u, _ = p3m.p3m_potential_with_overflow(p, **self.PKW)
        tot, _ = p3m.p3m_potential_total_with_overflow(p, **self.PKW)
        assert (u[:9] == 0.0).all()
        assert float(tot) == pytest.approx(float(u.double().sum()), rel=2e-6)

    def test_total_only_requires_potential_only(self):
        from multi_adapter_particles_torch.ops import treeforce

        with pytest.raises(ValueError, match="requires potential_only"):
            treeforce.near_field_tree(torch.from_numpy(_clustered(256)),
                                      2048.0, MASS, EPS2, 216.0, 9,
                                      with_potential=True, total_only=True)

    @pytest.mark.parametrize("half", [False, True])
    def test_potential_matches_jax(self, half):
        pos = _clustered(seed=31)
        u_jax, d_jax = JP3.p3m_potential_with_overflow(
            jnp.asarray(pos), half_pairs=half, **self.PKW)
        t_jax, _ = JP3.p3m_potential_total_with_overflow(
            jnp.asarray(pos), half_pairs=half, **self.PKW)
        p = torch.from_numpy(pos)
        u, d = p3m.p3m_potential_with_overflow(p, half_pairs=half,
                                               **self.PKW)
        tot, _ = p3m.p3m_potential_total_with_overflow(p, half_pairs=half,
                                                       **self.PKW)
        assert int(d_jax) == d == 0
        if not half:   # halved entries are sums only
            assert _rel(u.numpy(), np.asarray(u_jax)) < 1e-5
        assert float(tot) == pytest.approx(float(t_jax), rel=1e-5)

    def test_with_potential_matches_jax(self):
        """The fused variant: u as the JAX package's, and the force bitwise
        the port's force-only accel."""
        pos = _clustered(seed=33)
        a_jax, u_jax, _ = JP3.p3m_accel_with_overflow(
            jnp.asarray(pos), with_potential=True, **KW)
        p = torch.from_numpy(pos)
        a, u, d = p3m.p3m_accel_with_overflow(p, with_potential=True,
                                              half_force=True, **KW)
        assert d == 0
        assert _rel(u.numpy(), np.asarray(u_jax)) < 1e-5
        assert _rel(a.numpy(), np.asarray(a_jax)) < 1e-6
        a_force, _ = p3m.p3m_accel_with_overflow(p, **KW)
        assert torch.equal(a, a_force)
        u_only, _ = p3m.p3m_potential_with_overflow(p, **self.PKW)
        assert torch.equal(u_only, u)


class TestCli:
    def _run(self, argv, capsys=None):
        seen = {}
        rc = app.main(argv + CPU + ["-novsync", "-nogui", "-width", "32",
                                    "-height", "32"],
                      on_exit=lambda p: seen.update(
                          cfg=p.compute.config, frames=p.frame_count,
                          pos=p.compute.state.position.clone(),
                          gauges=dict(p.metrics.gauges)))
        return rc, seen

    def test_p3m_tree_runs_with_probed_grid_and_budget(self, capsys):
        rc, seen = self._run(["-force", "p3m", "-p3mnear", "tree",
                              "-numparticles", "4096", "-steps", "2"])
        out = capsys.readouterr().out
        assert rc == 0 and seen["frames"] == 2
        cfg = seen["cfg"]
        assert cfg.force_model == "p3m" and cfg.p3m_near_mode == "tree"
        assert cfg.tree_half_force is True
        assert "tree grid auto-selected G=" in out
        assert f"tree pair budget sized to {cfg.p3m_pair_budget}" in out
        # the probe's grid and budget are the JAX functions' on this scene
        from multi_adapter_particles_torch.models import init as tinit
        from multi_adapter_particles_tpu.ops import treeforce as JT

        pos0 = tinit.initialize_particles_device(
            4096, torch.Generator().manual_seed(0)).position.numpy()
        assert cfg.pm_grid_size == JT.auto_grid(pos0, 2048.0, 6.75)
        r_c = 6.75 * 2048.0 / cfg.pm_grid_size
        assert cfg.p3m_pair_budget == JT.host_pair_budget(
            pos0, 2048.0, r_c, int(2048.0 // r_c))
        assert torch.isfinite(seen["pos"]).all()
        assert seen["gauges"]["probe_s"] > 0

    def test_treedirected_reaches_the_config(self):
        rc, seen = self._run(["-force", "p3m", "-p3mnear", "tree",
                              "-treedirected", "-pmgrid", "32",
                              "-p3mbudget", "5000", "-numparticles", "2048",
                              "-steps", "1"])
        assert rc == 0
        cfg = seen["cfg"]
        assert cfg.tree_half_force is False
        assert (cfg.pm_grid_size, cfg.p3m_pair_budget) == (32, 5000)

    def test_auto_probe_picks_tree_on_the_demo_scene(self, capsys):
        rc, seen = self._run(["-force", "p3m", "-numparticles", "8192",
                              "-pmgrid", "64", "-steps", "1"])
        assert rc == 0 and seen["cfg"].p3m_near_mode == "tree"
        assert "near-field auto probe -> tree" in capsys.readouterr().out

    def test_pm_grid_runs(self):
        rc, seen = self._run(["-force", "pm_grid", "-pmgrid", "32", "-pmbox",
                              "4096", "-numparticles", "2048", "-steps", "2"])
        assert rc == 0 and seen["frames"] == 2
        cfg = seen["cfg"]
        assert (cfg.force_model, cfg.pm_grid_size, cfg.pm_box) == \
            ("pm_grid", 32, 4096.0)
        assert torch.isfinite(seen["pos"]).all()

    def test_p3m_preset_runs(self):
        """`64k-p3m` is no longer refused (cut to 4,096 particles)."""
        rc, seen = self._run(["-preset", "64k-p3m", "-numparticles", "4096",
                              "-pmgrid", "32", "-steps", "1"])
        assert rc == 0
        cfg = seen["cfg"]
        assert (cfg.force_model, cfg.pm_box, cfg.p3m_near_mode) == \
            ("p3m", 4096.0, "tree")


def test_split_frame_loop_matches_jax():
    """4 frames of the tree-P3M main path, `-treedirected`, against the JAX
    app (whose CPU engine runs the directed XLA sweep) from the same
    initial state. The forces agree to ~1e-7 of max|a| (summation order),
    so 4 Euler steps stay within rtol/atol 2e-5."""
    n, frames = 2048, 4
    kw = dict(num_particles=n, force_model="p3m", pm_grid_size=32,
              p3m_near_mode="tree")

    def app_kw():
        return dict(num_particles=n, particle_size=40.0, vsync=False,
                    gui=False)

    japp = JApp(JAppConfig(**app_kw()), JSimConfig(**kw),
                JRenderConfig(width=64, height=64), async_timers=False)
    cpu = cpu_adapter_index()
    tapp = ParticlesApp(AppConfig(**app_kw()),
                        SimConfig(tree_half_force=False, **kw),
                        RenderConfig(width=64, height=64),
                        compute_adapter=cpu, render_adapter=cpu)
    tapp.compute.restore(ParticleState.from_numpy(
        np.array(japp.compute.state.position),
        np.array(japp.compute.state.velocity)))
    tapp.share_handles()
    for a in (japp, tapp):
        for _ in range(frames):
            a.draw()
        a.shutdown()
    tpos, tvel = tapp.compute.state.to_numpy()
    np.testing.assert_allclose(tpos, np.asarray(japp.compute.state.position),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(tvel, np.asarray(japp.compute.state.velocity),
                               rtol=2e-5, atol=2e-5)
    tframe = tapp.render.last_frame.numpy()
    assert tframe.max() > 0
    np.testing.assert_allclose(tframe, np.asarray(japp.render.last_frame),
                               rtol=0, atol=2e-3)
    assert tapp.metrics.counters["interactions"] == \
        japp.metrics.counters["interactions"] == frames * float(n)
