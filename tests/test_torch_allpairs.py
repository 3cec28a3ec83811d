"""All-pairs parity of the torch port against the JAX package.

The CUDA kernels (`csrc/allpairs.cu`) are held against their plain twins on
the card by chip_smoke.py; here each twin is held against the JAX package's
Pallas kernel in interpret mode (as tests/test_ops.py runs it), the
integrator's masked sum against the JAX integrator's, and the port's engine,
CLI and frame loop with `force_model="all_pairs"` against the JAX ones.

Inputs are made with seeded numpy and handed to both packages. Tolerances:
the twins and the Pallas kernels add the same terms in another order, so
the pair sums agree to ~1e-6 of the largest |a| (1e-5 for the rectangle,
as tests/test_ops.py holds Pallas against XLA; 5e-6 for the half-pair, its
own test's bound); states after a few steps at rtol/atol 2e-5 and frames at
2e-3, as tests/test_torch_slice.py holds the central well.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multi_adapter_particles_tpu import presets as jpresets
from multi_adapter_particles_tpu.config import (
    AppConfig as JAppConfig,
    RenderConfig as JRenderConfig,
    SimConfig as JSimConfig,
)
from multi_adapter_particles_tpu.models import integrator as jintegrator
from multi_adapter_particles_tpu.models import oracle
from multi_adapter_particles_tpu.models.state import ParticleState as JState
from multi_adapter_particles_tpu.ops.allpairs import (
    all_pairs_accel_halfpair as j_halfpair,
    all_pairs_accel_pallas as j_rect,
)
from multi_adapter_particles_tpu.runtime import ParticlesApp as JApp
from multi_adapter_particles_tpu.runtime.compute_engine import (
    ComputeEngine as JEngine,
)

from multi_adapter_particles_torch import constants as C
from multi_adapter_particles_torch import presets
from multi_adapter_particles_torch.config import (
    AppConfig,
    RenderConfig,
    SimConfig,
)
from multi_adapter_particles_torch.models import integrator
from multi_adapter_particles_torch.models.state import ParticleState
from multi_adapter_particles_torch.ops.allpairs import (
    all_pairs_accel,
    all_pairs_accel_halfpair,
    all_pairs_accel_halfpair_plain,
    all_pairs_accel_plain,
    make_accel_fn,
)
from multi_adapter_particles_torch.runtime.compute_engine import ComputeEngine
from multi_adapter_particles_torch.runtime.devices import cpu_adapter_index
from multi_adapter_particles_torch.runtime.orchestrator import ParticlesApp

# The suite runs one xdist worker per core; torch's own thread pool on top
# only oversubscribes them.
torch.set_num_threads(1)

PHYS = dict(mass=C.PARTICLE_MASS, softening_squared=C.SOFTENING_SQUARED)


def _pos(n, seed):
    """[4, n] positions uniform in a 800-wide cube, w = 0 (as
    tests/test_ops.py draws them)."""
    p = np.random.default_rng(seed).uniform(
        -400.0, 400.0, size=(4, n)).astype(np.float32)
    p[3] = 0.0
    return p


def _oracle_planes(n, seed):
    pos, vel = oracle.initialize_particles(n, variant="scalar", seed=seed)
    st = JState.from_aos(pos, vel)
    return np.array(st.position), np.array(st.velocity)


def _assert_accel_close(got, want, rel):
    """|got - want| <= rel * max|want| on (ax, ay, az); |a| at rtol 1e-5
    (atol 1e-6 * max|a| for near-zero sums)."""
    scale = np.abs(want[:3]).max()
    assert np.abs(got[:3] - want[:3]).max() <= rel * scale
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5,
                               atol=1e-6 * scale)


class TestRectangleTwin:
    @pytest.mark.parametrize("n,ti,tj", [(256, 128, 128), (768, 256, 256)])
    def test_plain_matches_pallas(self, n, ti, tj):
        """n = 256 in 128-wide tiles, and n = 768 with three j-tiles (the
        Pallas kernel's odd tail, tests/test_ops.py:112-133)."""
        pos = _pos(n, seed=n)
        want = np.asarray(j_rect(jnp.asarray(pos), C.PARTICLE_MASS,
                                 C.SOFTENING_SQUARED, ti=ti, tj=tj))
        got = all_pairs_accel_plain(torch.from_numpy(pos), **PHYS).numpy()
        assert got.shape == want.shape == (4, n)
        _assert_accel_close(got, want, 1e-5)
        np.testing.assert_allclose(
            got[3], np.linalg.norm(got[:3], axis=0), rtol=1e-5, atol=1e-6)

    def test_sources_split_form(self):
        """256 targets against 640 other sources, as a ring stage does."""
        pos, src = _pos(256, seed=1), _pos(640, seed=2)
        want = np.asarray(j_rect(jnp.asarray(pos), C.PARTICLE_MASS,
                                 C.SOFTENING_SQUARED, ti=128, tj=128,
                                 sources=jnp.asarray(src)))
        got = all_pairs_accel_plain(torch.from_numpy(pos),
                                    sources=torch.from_numpy(src), **PHYS)
        _assert_accel_close(got.numpy(), want, 1e-5)
        via_wrapper = all_pairs_accel(torch.from_numpy(pos),
                                      sources=torch.from_numpy(src), **PHYS)
        assert torch.equal(via_wrapper, got)

    def test_interaction_scale_is_linear(self):
        pos = torch.from_numpy(_pos(384, seed=3))
        a1 = all_pairs_accel_plain(pos, **PHYS)
        a2 = all_pairs_accel_plain(pos, interaction_scale=2.0, **PHYS)
        # a power-of-two scale is exact in float32
        assert torch.equal(a2[:3], a1[:3] * 2.0)
        want = np.asarray(j_rect(jnp.asarray(pos.numpy()), C.PARTICLE_MASS,
                                 C.SOFTENING_SQUARED, interaction_scale=1e-3,
                                 ti=128, tj=128))
        got = all_pairs_accel_plain(pos, interaction_scale=1e-3, **PHYS)
        _assert_accel_close(got.numpy(), want, 1e-5)

    def test_wrapper_on_cpu_is_the_twin(self):
        pos = torch.from_numpy(_pos(256, seed=4))
        a = all_pairs_accel(pos, **PHYS)
        assert torch.equal(a, all_pairs_accel_plain(pos, **PHYS))

    def test_integrator_masked_sum_matches_jax(self):
        """The integrator's masked form (the JAX package's XLA sum) at
        n = 1000, padded to 1024, against the JAX integrator; the kernels'
        unmasked twin differs from it by the parked padding's pull, which
        is far below float32 resolution."""
        n = 1000
        pos, _ = _oracle_planes(n, seed=5)
        mask = (np.arange(pos.shape[1]) < n).astype(np.float32)
        kw = dict(mass=C.PARTICLE_MASS,
                  softening_squared=C.SOFTENING_SQUARED,
                  interaction_scale=1.0 / n)
        want = np.asarray(jintegrator.all_pairs_accel(
            jnp.asarray(pos), mask=jnp.asarray(mask), **kw))
        got = integrator.all_pairs_accel(
            torch.from_numpy(pos), mask=torch.from_numpy(mask), **kw).numpy()
        assert got.shape == (3, 1024)
        scale = np.abs(want[:, :n]).max()
        assert np.abs(got[:, :n] - want[:, :n]).max() <= 1e-5 * scale
        unmasked = all_pairs_accel_plain(torch.from_numpy(pos), **kw).numpy()
        assert np.abs(unmasked[:3, :n] - got[:, :n]).max() <= 1e-5 * scale


class TestHalfPairTwin:
    @pytest.mark.parametrize("n,kb", [(2048, 2), (4096, 2)])
    def test_plain_matches_pallas(self, n, kb):
        """Four tiles of 512 in two bands, and eight tiles in four bands
        (the JAX kernel's band loop; the port has no bands)."""
        pos = _pos(n, seed=10 + n)
        want = np.asarray(j_halfpair(jnp.asarray(pos), mass=C.PARTICLE_MASS,
                                     softening_squared=C.SOFTENING_SQUARED,
                                     t=512, kb=kb))
        got = all_pairs_accel_halfpair_plain(torch.from_numpy(pos), **PHYS)
        _assert_accel_close(got.numpy(), want, 5e-6)

    def test_matches_rectangle_twin(self):
        pos = torch.from_numpy(_pos(2048, seed=6))
        half = all_pairs_accel_halfpair_plain(pos, **PHYS).numpy()
        rect = all_pairs_accel_plain(pos, **PHYS).numpy()
        _assert_accel_close(half, rect, 5e-6)

    @pytest.mark.parametrize("n", [640, 512, 1152])
    def test_untileable_n_falls_back_bitwise(self, n):
        """n % 512 != 0 or a single tile: the rectangle, bit for bit (the
        JAX function's rule, tests/test_ops.py:182-195)."""
        pos = torch.from_numpy(_pos(n, seed=7))
        rect = all_pairs_accel_plain(pos, **PHYS)
        assert torch.equal(all_pairs_accel_halfpair_plain(pos, **PHYS), rect)
        assert torch.equal(all_pairs_accel_halfpair(pos, **PHYS), rect)

    def test_wrapper_on_cpu_is_the_twin(self):
        pos = torch.from_numpy(_pos(1024, seed=8))
        a = all_pairs_accel_halfpair(pos, **PHYS)
        assert torch.equal(a, all_pairs_accel_halfpair_plain(pos, **PHYS))

    @pytest.mark.parametrize("half", [True, False])
    def test_make_accel_fn(self, half):
        pos = torch.from_numpy(_pos(1024, seed=9))
        fn = make_accel_fn(interaction_scale=0.5, half=half, **PHYS)
        twin = (all_pairs_accel_halfpair_plain if half
                else all_pairs_accel_plain)
        want = twin(pos, interaction_scale=0.5, **PHYS)[:3]
        assert torch.equal(fn(pos), want)


N_ENGINE = 1024


def _engine_pair(half, seed=7):
    """A JAX engine running its Pallas kernels (interpret mode) and the
    port's engine (the kernels' twins on the CPU) from the same state."""
    jcfg = JSimConfig(num_particles=N_ENGINE, force_model="all_pairs",
                      all_pairs_half=half)
    jeng = JEngine(jcfg, jax.devices()[0], seed=seed, use_pallas=True,
                   donate=False)
    pos0 = np.array(jeng.state.position)
    vel0 = np.array(jeng.state.velocity)
    teng = ComputeEngine(SimConfig(num_particles=N_ENGINE,
                                   force_model="all_pairs",
                                   all_pairs_half=half), "cpu")
    teng.restore(ParticleState.from_numpy(pos0, vel0))
    return jeng, teng, pos0, vel0


class TestEngine:
    @pytest.mark.parametrize("half", [True, False])
    def test_engine_matches_jax_pallas_engine(self, half):
        """Each schedule against itself: 3 steps, then the interactions
        counter (pairs: n_sim x padded count a step, both schedules)."""
        jeng, teng, _, _ = _engine_pair(half)
        for _ in range(3):
            jeng.simulate()
            teng.simulate()
        tpos, tvel = teng.state.to_numpy()
        np.testing.assert_allclose(tpos, np.asarray(jeng.state.position),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(tvel, np.asarray(jeng.state.velocity),
                                   rtol=2e-5, atol=2e-5)
        assert teng.metrics.counters["interactions"] == \
            jeng.metrics.counters["interactions"] == 3.0 * N_ENGINE * 1024

    def test_num_sim_freeze_bitwise(self):
        num_sim = 300
        jeng, teng, pos0, vel0 = _engine_pair(True, seed=3)
        jeng.simulate(num_sim)
        teng.simulate(num_sim)
        live = -(-num_sim // 64) * 64
        tpos, tvel = teng.state.to_numpy()
        jpos = np.asarray(jeng.state.position)
        np.testing.assert_array_equal(tpos[:, live:], pos0[:, live:])
        np.testing.assert_array_equal(tvel[:, live:], vel0[:, live:])
        np.testing.assert_array_equal(tpos[:, live:], jpos[:, live:])
        np.testing.assert_allclose(tpos[:, :live], jpos[:, :live],
                                   rtol=2e-5, atol=2e-5)
        # pairs: the simulated count against every padded source
        assert teng.metrics.counters["interactions"] == num_sim * 1024.0

    @pytest.mark.parametrize("model,half", [("central_well", True),
                                            ("all_pairs", True),
                                            ("all_pairs", False)])
    def test_make_accel_fn_for(self, model, half):
        """The run's own force: the central well, or the twin of the kernel
        `all_pairs_half` picks; against the JAX package's function (on the
        CPU its all_pairs branch is the XLA rectangle: with no padding at
        n = 1024 the two differ only in summation order)."""
        n = 1024
        pos, _ = _oracle_planes(n, seed=11)
        kw = dict(num_particles=n, force_model=model, all_pairs_half=half)
        want = np.asarray(jintegrator.make_accel_fn_for(JSimConfig(**kw))(
            jnp.asarray(pos)))
        fn = integrator.make_accel_fn_for(SimConfig(**kw))
        got = fn(torch.from_numpy(pos)).numpy()
        assert got.shape == want.shape == (3, n)
        if model == "central_well":
            np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)
        else:
            scale = np.abs(want).max()
            assert np.abs(got - want).max() <= 1e-5 * scale
            twin = (all_pairs_accel_halfpair_plain if half
                    else all_pairs_accel_plain)
            assert torch.equal(fn(torch.from_numpy(pos)), twin(
                torch.from_numpy(pos), interaction_scale=1.0 / n,
                **PHYS)[:3])


def test_split_frame_loop_matches_jax():
    """8 frames of the all-pairs main path (half-pair twin) against the JAX
    app's (its CPU engine runs the masked XLA rectangle) from the same
    initial state."""
    n, frames = 1024, 8

    def app_kw():
        return dict(num_particles=n, particle_size=40.0, vsync=False,
                    gui=False)

    japp = JApp(JAppConfig(**app_kw()),
                JSimConfig(num_particles=n, force_model="all_pairs"),
                JRenderConfig(width=64, height=64), async_timers=False)
    cpu = cpu_adapter_index()
    tapp = ParticlesApp(AppConfig(**app_kw()),
                        SimConfig(num_particles=n, force_model="all_pairs"),
                        RenderConfig(width=64, height=64),
                        compute_adapter=cpu, render_adapter=cpu)
    tapp.compute.restore(ParticleState.from_numpy(
        np.array(japp.compute.state.position),
        np.array(japp.compute.state.velocity)))
    tapp.share_handles()
    for app in (japp, tapp):
        for _ in range(frames):
            app.draw()
        app.shutdown()
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
        japp.metrics.counters["interactions"] == frames * n * 1024.0


class TestCli:
    def test_rectpair_and_interaction_scale(self):
        from multi_adapter_particles_torch import app

        seen = {}
        rc = app.main(
            ["-force", "all_pairs", "-rectpair", "-interactionscale",
             "0.001", "-numparticles", "512", "-steps", "2", "-novsync",
             "-nogui", "-width", "32", "-height", "32",
             "-computeadapter", str(cpu_adapter_index())],
            on_exit=lambda p: seen.update(cfg=p.compute.config,
                                          frames=p.frame_count),
        )
        assert rc == 0 and seen["frames"] == 2
        cfg = seen["cfg"]
        assert cfg.force_model == "all_pairs"
        assert cfg.all_pairs_half is False
        assert cfg.interaction_scale == 0.001

    def test_preset_with_later_flags(self):
        from multi_adapter_particles_torch import app

        seen = {}
        rc = app.main(["-preset", "10k-allpairs", "-numparticles", "512",
                       "-steps", "2", "-halfpair",
                       "-computeadapter", str(cpu_adapter_index())],
                      on_exit=lambda p: seen.update(cfg=p.compute.config,
                                                    frames=p.frame_count,
                                                    draw=p.draw_enabled))
        assert rc == 0 and seen["frames"] == 2
        assert seen["cfg"].force_model == "all_pairs"
        assert seen["cfg"].num_particles == 512
        assert seen["cfg"].interaction_scale == 1.0 / 512  # auto 1/N
        assert seen["draw"] is False

    @pytest.mark.parametrize("argv", [["-compilecache", "{file}"]])
    def test_later_slices_exit_2(self, argv, capsys, tmp_path):
        """Every flag of the JAX CLI runs on the port (`-compilecache`:
        test_compilecache); what still exits 2 is a flag the port cannot
        honour, here a `-compilecache` directory that is a file."""
        from multi_adapter_particles_torch import app

        path = tmp_path / "a-file"
        path.write_text("")
        argv = [a.format(file=path) for a in argv]
        assert app.main(argv + ["-steps", "1", "-computeadapter",
                                str(cpu_adapter_index())]) == 2
        assert "-compilecache" in capsys.readouterr().err

    @pytest.mark.parametrize("spec", ["auto", "off", "dir"])
    def test_compilecache(self, spec, tmp_path, monkeypatch):
        """`-compilecache` picks where kernel libraries are built and
        loaded: auto = build/torch_kernels/, off = a fresh temporary
        directory, else the one named (created)."""
        from multi_adapter_particles_torch import app
        from multi_adapter_particles_torch.native import fastinit
        from multi_adapter_particles_torch.ops import _build

        monkeypatch.setattr(_build, "_build_dir", tmp_path / "before")
        arg = str(tmp_path / "libs" / "here") if spec == "dir" else spec
        seen = {}
        rc = app.main(["-compilecache", arg, "-numparticles", "256",
                       "-steps", "1", "-width", "32", "-height", "32",
                       "-computeadapter", str(cpu_adapter_index())],
                      on_exit=lambda p: seen.update(frames=p.frame_count))
        assert rc == 0 and seen["frames"] == 1
        where = _build.build_dir()
        if spec == "auto":
            assert where == _build.DEFAULT_BUILD_DIR
        elif spec == "dir":
            assert where == tmp_path / "libs" / "here"
        else:
            assert where not in (_build.DEFAULT_BUILD_DIR,
                                 tmp_path / "before")
            assert where.is_dir() and not list(where.iterdir())
        if spec != "auto":  # a build lands there
            assert _build.build_host(fastinit.SOURCE).parent == where

    def test_unknown_preset_exits_2(self, capsys):
        from multi_adapter_particles_torch import app

        assert app.main(["-preset", "nope"]) == 2
        assert "unknown preset" in capsys.readouterr().err

    def test_presets_equal_jax_package(self):
        assert presets.PRESETS == jpresets.PRESETS
