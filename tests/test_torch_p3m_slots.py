"""The p3m static-K slot near field of the port (`ops/p3m.py`: binning, the
27-cell shifted-slice sweep, the un-binning) against the JAX package.

Mirrors the slot classes of tests/test_p3m.py (TestShortRangeFactor,
TestTwoBody, TestCluster, TestOverflow, TestIntegration) on the port, and
holds `near_field_correction` against the JAX function on the same seeded
numpy inputs: forces within 1e-5 of max|a_near| where nothing overflows
(the port bins with a stable sort and the JAX package with an unstable
one, so which particles of an overflowing cell keep their slot differs),
the overflow count bitwise on scenes that overflow. Then the CLI paths:
`-p3mnear slots`, an `auto` probe that picks slots, the startup warning,
the `p3m_overflow` gauge, and split against fused.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_adapter_particles_tpu.ops import p3m as JP3

from multi_adapter_particles_torch import app
from multi_adapter_particles_torch.config import SimConfig
from multi_adapter_particles_torch.models import init as tinit
from multi_adapter_particles_torch.models import integrator
from multi_adapter_particles_torch.ops import p3m, pm
from multi_adapter_particles_torch.runtime.devices import cpu_adapter_index
from multi_adapter_particles_torch.runtime.fused import CAPTURED, capture_key

torch.set_num_threads(1)

MASS = 70000.0
EPS2 = 25.0
CPU = ["-computeadapter", str(cpu_adapter_index())]


def aos(pos3):
    p = torch.zeros((4, pos3.shape[0]), dtype=torch.float32)
    p[:3] = torch.from_numpy(np.ascontiguousarray(pos3.T))
    return p


def exact(pos3):
    return integrator.all_pairs_accel(aos(pos3), mass=MASS,
                                      softening_squared=EPS2).numpy()


def _cell_counts(pos, gn, box):
    hn = box / gn
    ib = np.floor(pos[:3] / hn + gn / 2).astype(np.int64)
    inb = ((ib >= 0) & (ib <= gn - 1)).all(axis=0)
    cid = ib[2] * gn * gn + ib[1] * gn + ib[0]
    return np.bincount(cid[inb], minlength=gn ** 3)


class TestShortRangeFactor:
    def test_negligible_beyond_cutoff(self):
        r_c = 432.0
        sigma = r_c * p3m._SIGMA_PER_CUTOFF
        r = torch.tensor([432.0, 500.0, 900.0])
        s = p3m._short_factor(r * r, EPS2, sigma).abs().numpy()
        s_exact = (r.numpy() ** 2 + EPS2) ** -1.5
        assert np.all(s <= 4e-4 * s_exact)
        s_park = p3m._short_factor(torch.tensor([3e18]), EPS2, sigma)
        assert abs(float(s_park[0])) * 1.8e9 < 1e-12

    def test_split_identity(self):
        r_c = 96.0
        sigma = r_c * p3m._SIGMA_PER_CUTOFF
        r = torch.tensor([0.5, 2.0, 20.0, 50.0, 95.0])
        d2 = r * r
        s_short = p3m._short_factor(d2, EPS2, sigma).numpy()
        s_long = p3m._g_long(d2, sigma).numpy()
        s_exact = (d2.numpy() + EPS2) ** -1.5
        np.testing.assert_allclose(s_short + s_long, s_exact, rtol=1e-5)
        s0 = p3m._short_factor(torch.tensor([0.0]), EPS2, sigma)
        assert float(s0[0]) == pytest.approx(EPS2 ** -1.5, rel=1e-6)

    def test_matches_jax(self):
        sigma = 432.0 * p3m._SIGMA_PER_CUTOFF
        d2 = np.geomspace(1e-2, 1e7, 64).astype(np.float32)
        got = p3m._short_factor(torch.from_numpy(d2), EPS2, sigma).numpy()
        want = np.asarray(JP3._short_factor(jnp.asarray(d2), EPS2, sigma))
        # s_exact - g_long cancels: hold it to its scale, s(0) = eps2^-1.5
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


class TestTwoBody:
    @pytest.mark.parametrize("r", [3.0, 10.0, 40.0, 100.0, 160.0, 600.0])
    def test_all_separations(self, r):
        g, box = 32, 2048.0
        pos3 = np.array([[-r / 2, 0, 0], [r / 2, 0, 0]], np.float32)
        acc, overflow = p3m.p3m_accel_with_overflow(
            aos(pos3), grid=g, box=box, g_const=MASS,
            softening_squared=EPS2)
        acc = acc.numpy()
        assert int(overflow) == 0
        want = MASS / (r * r + EPS2) ** 1.5 * r
        assert acc[0, 0] == pytest.approx(want, rel=0.04), f"r={r}"
        assert acc[0, 1] == pytest.approx(-want, rel=0.04)

    def test_tiny_near_grid_covers_cutoff(self):
        g, box = 8, 2048.0
        r = 500.0
        pos3 = np.array([[-r / 2, 0, 0], [r / 2, 0, 0]], np.float32)
        acc, overflow = p3m.p3m_accel_with_overflow(
            aos(pos3), grid=g, box=box, g_const=MASS,
            softening_squared=EPS2)
        assert int(overflow) == 0
        want = MASS / (r * r + EPS2) ** 1.5 * r
        assert acc.numpy()[0, 0] == pytest.approx(want, rel=0.04)

    @pytest.mark.parametrize("r", [10.0, 130.0, 300.0, 432.0])
    def test_higher_cutoff_tightens(self, r):
        g, box = 32, 2048.0
        pos3 = np.array([[-r / 2, 0, 0], [r / 2, 0, 0]], np.float32)
        acc, overflow = p3m.p3m_accel_with_overflow(
            aos(pos3), grid=g, box=box, g_const=MASS,
            softening_squared=EPS2, cutoff_cells=9.0)
        assert int(overflow) == 0
        want = MASS / (r * r + EPS2) ** 1.5 * r
        assert acc.numpy()[0, 0] == pytest.approx(want, rel=0.02)

    def test_close_pair_beats_pm(self):
        g, box = 32, 2048.0
        r = 32.0
        pos3 = np.array([[-r / 2, 0, 0], [r / 2, 0, 0]], np.float32)
        want = MASS / (r * r + EPS2) ** 1.5 * r
        a_p3m = p3m.p3m_accel(aos(pos3), grid=g, box=box, g_const=MASS,
                              softening_squared=EPS2).numpy()
        a_pm = pm.pm_accel(aos(pos3), grid=g, box=box, g_const=MASS,
                           softening_squared=EPS2).numpy()
        err_p3m = abs(a_p3m[0, 0] - want) / want
        err_pm = abs(a_pm[0, 0] - want) / want
        assert err_p3m < 0.02
        assert err_pm > 5 * err_p3m


class TestCluster:
    def test_matches_all_pairs_rms(self):
        rng = np.random.default_rng(11)
        pos3 = rng.normal(0, 300, (512, 3)).astype(np.float32)
        acc, overflow = p3m.p3m_accel_with_overflow(
            aos(pos3), grid=64, box=4096.0, g_const=MASS,
            softening_squared=EPS2, capacity=128)
        a_ex = exact(pos3)
        rms = np.sqrt(np.mean((acc.numpy() - a_ex) ** 2)) / np.abs(a_ex).max()
        assert int(overflow) == 0
        assert rms < 0.01, f"P3M rms error {rms:.4f}"

    def test_tight_cluster_near_field(self):
        rng = np.random.default_rng(13)
        pos3 = rng.normal(0, 20, (128, 3)).astype(np.float32)
        acc, overflow = p3m.p3m_accel_with_overflow(
            aos(pos3), grid=32, box=2048.0, g_const=MASS,
            softening_squared=EPS2, capacity=256)
        a_ex = exact(pos3)
        rms = np.sqrt(np.mean((acc.numpy() - a_ex) ** 2)) / np.abs(a_ex).max()
        assert int(overflow) == 0
        assert rms < 0.02, f"tight-cluster rms {rms:.4f}"

    def test_momentum_conservation(self):
        rng = np.random.default_rng(17)
        pos3 = rng.normal(0, 200, (256, 3)).astype(np.float32)
        acc = p3m.p3m_accel(aos(pos3), grid=32, box=2048.0, g_const=MASS,
                            softening_squared=EPS2).numpy()
        total = np.abs(acc.sum(axis=1))
        assert np.all(total < 1e-2 * np.abs(acc).max() * 256)


class TestOverflow:
    def test_overflow_counts_and_degrades_gracefully(self):
        rng = np.random.default_rng(19)
        pos3 = (rng.normal(0, 5, (64, 3)) + 256.0).astype(np.float32)
        acc, overflow = p3m.p3m_accel_with_overflow(
            aos(pos3), grid=32, box=2048.0, g_const=MASS,
            softening_squared=EPS2, capacity=16)
        assert int(overflow) == 64 - 16
        assert torch.isfinite(acc).all()

    def test_zero_capacity_equals_mesh_only(self):
        """Capacity 1 with one particle a cell at most corrects nothing
        here but keeps the sweep's shapes; a blob whose cells overflow
        everywhere keeps only the mesh force for the overflowing ones."""
        rng = np.random.default_rng(23)
        pos3 = rng.normal(0, 300, (64, 3)).astype(np.float32)
        a_full, _ = p3m.p3m_accel_with_overflow(
            aos(pos3), grid=32, box=4096.0, g_const=MASS,
            softening_squared=EPS2, capacity=1)
        assert torch.isfinite(a_full).all()

    def test_overflowing_particles_keep_the_mesh_force(self):
        """With a stable sort, the particles past the capacity are the
        later ones of their cell in particle order: their near correction
        is exactly 0, the others' is not."""
        rng = np.random.default_rng(29)
        pos3 = (rng.normal(0, 5, (40, 3)) + 256.0).astype(np.float32)
        near, overflow = p3m.near_field_correction(
            aos(pos3), 2048.0, MASS, EPS2, 432.0, 4, 24)
        assert int(overflow) == 16
        assert torch.all(near[:, 24:] == 0.0)
        assert torch.all(near[:, :24].abs().sum(dim=0) > 0.0)


class TestAgainstJax:
    def _scene(self, n, seed, spread):
        rng = np.random.default_rng(seed)
        p = np.zeros((4, n), np.float32)
        p[:3] = rng.normal(0, spread, (3, n))
        p[:3, :7] = 5e8   # out of the box: no correction
        return p

    @pytest.mark.parametrize("n,seed,spread,cutoff", [
        (1024, 1, 400.0, 6.75), (768, 2, 200.0, 6.75),
        (512, 3, 500.0, 4.0)])
    def test_near_field_matches_jax(self, n, seed, spread, cutoff):
        """No overflow: forces within 1e-5 of max|a_near|; the count 0."""
        p = self._scene(n, seed, spread)
        r_c, gn = p3m.near_grid_for(32, 2048.0, cutoff)
        cap = int(_cell_counts(p, gn, 2048.0).max())
        want, ov_j = JP3.near_field_correction(jnp.asarray(p), 2048.0, MASS,
                                               EPS2, r_c, gn, cap)
        got, ov_t = p3m.near_field_correction(torch.from_numpy(p), 2048.0,
                                              MASS, EPS2, r_c, gn, cap)
        assert int(ov_j) == int(ov_t) == 0
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err < 1e-5, err
        assert np.all(got.numpy()[:, :7] == 0.0)

    @pytest.mark.parametrize("cap", [4, 16, 48])
    def test_overflow_count_bitwise(self, cap):
        p = self._scene(3072, 5, 120.0)
        r_c, gn = p3m.near_grid_for(32, 2048.0, 6.75)
        _, ov_j = JP3.near_field_correction(jnp.asarray(p), 2048.0, MASS,
                                            EPS2, r_c, gn, cap)
        _, ov_t = p3m.near_field_correction(torch.from_numpy(p), 2048.0,
                                            MASS, EPS2, r_c, gn, cap)
        assert int(ov_t) == int(ov_j) > 0
        assert ov_t.dtype == torch.int64 and ov_t.dim() == 0
        assert int(ov_t) == p3m.host_overflow_count(p, 32, 2048.0, 6.75, cap)

    def test_full_accel_matches_jax(self):
        p = self._scene(1024, 7, 400.0)
        r_c, gn = p3m.near_grid_for(32, 2048.0, 6.75)
        cap = int(_cell_counts(p, gn, 2048.0).max())
        kw = dict(grid=32, box=2048.0, g_const=MASS, softening_squared=EPS2,
                  capacity=cap, near_mode="slots")
        want, _ = JP3.p3m_accel_with_overflow(jnp.asarray(p), **kw)
        got, _ = p3m.p3m_accel_with_overflow(torch.from_numpy(p), **kw)
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() / np.abs(want).max() < 1e-5

    def test_slab_chunking_is_exact(self, monkeypatch):
        """The sweep over one z-plane a slab gives the one-slab result."""
        p = torch.from_numpy(self._scene(1536, 8, 300.0))
        r_c, gn = p3m.near_grid_for(32, 2048.0, 6.75)
        whole, _ = p3m.near_field_correction(p, 2048.0, MASS, EPS2, r_c, gn,
                                             64)
        monkeypatch.setattr(p3m, "_SWEEP_TEMP_BYTES", 1)
        sliced, _ = p3m.near_field_correction(p, 2048.0, MASS, EPS2, r_c, gn,
                                              64)
        assert torch.equal(whole, sliced)

    def test_with_potential_requires_tree(self):
        with pytest.raises(ValueError, match="with_potential"):
            p3m.p3m_accel_with_overflow(torch.zeros((4, 128)), grid=16,
                                        near_mode="slots",
                                        with_potential=True)


class TestIntegration:
    def test_p3m_force_model_steps(self):
        """The engine's step with the default near mode ("auto" = slots)
        keeps its overflow count on the accel function."""
        cfg = SimConfig(num_particles=512, force_model="p3m",
                        pm_grid_size=32, pm_box=4096.0,
                        interaction_scale=1.0 / 512)
        step = integrator.make_step(cfg)
        s = tinit.initialize_particles_device(
            512, torch.Generator().manual_seed(0), device="cpu")
        for _ in range(3):
            s = step(s)
        pos = s.position.numpy()
        assert np.isfinite(pos[:, :512]).all()
        assert pos[3, :512].max() > 0
        ov = step.accel_fn.overflow
        assert ov is not None and ov.dtype == torch.int64

    def test_slot_step_is_captured(self):
        """The slot step makes no host read: fused mode captures it."""
        for mode in ("slots", "auto"):
            cfg = SimConfig(num_particles=512, force_model="p3m",
                            p3m_near_mode=mode)
            assert capture_key(cfg) == "p3m:slots" and "p3m:slots" in CAPTURED
        assert capture_key(SimConfig(num_particles=512, force_model="p3m",
                                     p3m_near_mode="tree")) not in CAPTURED


class TestCli:
    def _run(self, argv):
        seen = {}
        rc = app.main(argv + CPU + ["-novsync", "-nogui", "-width", "32",
                                    "-height", "32"],
                      on_exit=lambda p: seen.update(
                          cfg=p.compute.config, frames=p.frame_count,
                          pos=p.compute.state.position.clone(),
                          gauges=dict(p.metrics.gauges)))
        return rc, seen

    def test_slots_runs_and_warns(self, capsys):
        """`-p3mnear slots` on the demo init (cluster cores overflow the
        default capacity): the warning, and the gauge equals the host count
        of the state its one step read."""
        rc, seen = self._run(["-force", "p3m", "-p3mnear", "slots",
                              "-numparticles", "4096", "-steps", "1"])
        out = capsys.readouterr().out
        assert rc == 0 and seen["frames"] == 1
        assert seen["cfg"].p3m_near_mode == "slots"
        pos0 = tinit.initialize_particles_device(
            4096, torch.Generator().manual_seed(0)).position.numpy()
        ov = p3m.host_overflow_count(pos0, 64, 2048.0, 6.75, 64)
        assert ov > 0
        assert f"p3m: {ov} of 4096 particles exceed" in out
        assert seen["gauges"]["p3m_overflow"] == ov
        assert torch.isfinite(seen["pos"]).all()

    def test_auto_probe_picks_slots(self, capsys):
        """A capacity that covers the scene: the probe picks slots and the
        run takes them."""
        pos0 = tinit.initialize_particles_device(
            2048, torch.Generator().manual_seed(0)).position.numpy()
        r_c, gn = p3m.near_grid_for(64, 2048.0, 6.75)
        cap = int(_cell_counts(pos0, gn, 2048.0).max())
        rc, seen = self._run(["-force", "p3m", "-numparticles", "2048",
                              "-pmgrid", "64", "-p3mcapacity", str(cap),
                              "-steps", "2"])
        assert rc == 0 and seen["cfg"].p3m_near_mode == "slots"
        assert "near-field auto probe -> slots" in capsys.readouterr().out
        assert seen["gauges"]["p3m_overflow"] == 0

    def test_split_and_fused_agree_bitwise(self):
        argv = ["-force", "p3m", "-p3mnear", "slots", "-numparticles",
                "1024", "-steps", "2"]
        rc_a, split = self._run(argv)
        rc_b, fused = self._run(argv + ["-fused"])
        assert rc_a == rc_b == 0
        assert torch.equal(split["pos"], fused["pos"])
        assert fused["gauges"]["fused_graph"] is False  # nothing on the CPU
        assert split["gauges"]["p3m_overflow"] == \
            fused["gauges"]["p3m_overflow"]
