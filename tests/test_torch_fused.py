"""The port's fused single-program frame (`runtime/fused.py`, `-fused`).

Mirrors the JAX package's fused tests (`tests/test_runtime.py::
TestFusedMode`, the fused adapter move, `TestFusedPm`, the fused `-novsync`
bound in `tests/test_pacing.py`, the `-fused` flag in `tests/test_app.py`)
on the CPU, where nothing is captured: the same frame function runs
eagerly. The port's fused run equals its own split run bit for bit
(positions and frames), and tracks the JAX package's fused app from the
same initial state. The CUDA-graph capture runs on the card
(chip_smoke.py phases 22-24)."""

import numpy as np
import pytest
import torch

from multi_adapter_particles_tpu.config import (
    AppConfig as JAppConfig,
    RenderConfig as JRenderConfig,
    SimConfig as JSimConfig,
)
from multi_adapter_particles_tpu.runtime import ParticlesApp as JApp

from multi_adapter_particles_torch import app as tapp_cli
from multi_adapter_particles_torch import presets
from multi_adapter_particles_torch.config import (
    AppConfig,
    RenderConfig,
    SimConfig,
)
from multi_adapter_particles_torch.models.state import ParticleState
from multi_adapter_particles_torch.render.renderer import Renderer
from multi_adapter_particles_torch.runtime import devices
from multi_adapter_particles_torch.runtime.devices import cpu_adapter_index
from multi_adapter_particles_torch.runtime.fused import CAPTURED, FusedEngine
from multi_adapter_particles_torch.runtime.orchestrator import ParticlesApp

# The suite runs one xdist worker per core; torch's own thread pool on top
# only oversubscribes them.
torch.set_num_threads(1)

N = 512
SMALL_RENDER = RenderConfig(width=64, height=64)
CPU = dict(compute_adapter=cpu_adapter_index(),
           render_adapter=cpu_adapter_index())


def _app(fused: bool, sim: SimConfig = None, **kw) -> ParticlesApp:
    return ParticlesApp(
        AppConfig(num_particles=N, particle_size=10.0, vsync=False,
                  gui=False),
        sim or SimConfig(num_particles=N), SMALL_RENDER, fused=fused,
        **CPU, **kw)


def _run_both(frames: int, sim: SimConfig = None, setup=None):
    split, fused = _app(False, sim), _app(True, sim)
    if setup is not None:
        setup(split, fused)
    for _ in range(frames):
        split.draw()
        fused.draw()
    split.shutdown()
    fused.shutdown()
    return split, fused


def _assert_same_run(split, fused):
    assert torch.equal(split.compute.state.position,
                       fused.compute.state.position)
    assert torch.equal(split.compute.state.velocity,
                       fused.compute.state.velocity)
    assert torch.equal(split.render.last_frame, fused.render.last_frame)
    assert (fused.compute.get_fence_value()
            == split.compute.get_fence_value())


class TestFusedMode:
    def test_fused_matches_split_pipeline(self):
        """The fused frame == the split engines bit for bit: same
        trajectory, same stale-by-one frame."""
        split, fused = _run_both(3)
        _assert_same_run(split, fused)
        assert fused.render.last_frame.max() > 0
        assert fused.metrics.gauges["mode_banner"] == (
            "Single Adapter with Async Compute (fused single-program)")
        assert fused.metrics.gauges["fused_graph"] is False   # CPU: eager
        # the JAX fused frame counts no interactions; the split engine does
        assert "interactions" not in fused.metrics.counters
        assert split.metrics.counters["interactions"] == 3 * N

    def test_fused_chunked_matches_split_chunked(self):
        """Above chunk_threshold the fused frame runs the id-ordered chunk
        fold, as split mode does, with the same association."""
        def chunked(split, fused):
            for r in (split.render.renderer, fused.compute.renderer):
                r.chunk_threshold = 256   # N=512 -> 2 chunks on both paths
                r.chunk_size = 256

        split, fused = _run_both(3, setup=chunked)
        assert fused.compute.renderer._last_sort_n < N  # fold engaged
        _assert_same_run(split, fused)

    def test_fused_present_auto_raises_dup(self):
        """A truncating fused frame grows the dup window at present(),
        and the next frame runs with it (on a card: a recapture). The
        window is given: the default renderer draws every sprite whole."""
        app = AppConfig(num_particles=1, particle_size=200.0)
        cfg = RenderConfig(width=256, height=256)
        eng = FusedEngine(SimConfig(num_particles=1), cfg, "cpu",
                          renderer=Renderer(cfg, dup_y=2, dup_x=2))
        pos = np.array([[0.0, 0.0, 0.0, 0.0]], dtype=np.float32)
        eng.restore(ParticleState.from_aos(pos, np.zeros((1, 3),
                                                         np.float32)))
        out = eng.frame(app)
        assert int(out.truncated) > 0   # giant sprite exceeds the 2x2 window
        key0 = eng._key(None)
        eng.present()
        assert eng._key(None) != key0   # a captured frame would be stale
        assert eng.renderer.last_truncated == int(out.truncated)
        out2 = eng.frame(app)
        assert int(out2.truncated) == 0   # lossless after the raise

    def test_fused_draw_toggle(self):
        fused = _app(True)
        fused.draw_enabled = False
        fused.draw()  # still advances the sim, draws 0 sprites
        assert fused.compute.get_fence_value() == 1
        assert float(fused.render.last_frame.max()) == 0.0
        fused.draw_enabled = True
        fused.draw()
        assert fused.render.last_frame.max() > 0
        fused.shutdown()

    def test_fused_rejects_split_devices(self, monkeypatch):
        """Naming two devices with fused mode raises (the JAX message)."""
        two = [devices.AdapterInfo(0, torch.device("cpu"), "cpu", "cpu"),
               devices.AdapterInfo(1, torch.device("meta"), "cpu", "meta")]
        monkeypatch.setattr(devices, "enumerate_adapters", lambda: two)
        with pytest.raises(ValueError, match="fused"):
            ParticlesApp(AppConfig(num_particles=N), SimConfig(num_particles=N),
                         SMALL_RENDER, compute_adapter=0, render_adapter=1,
                         fused=True)

    def test_captured_models_are_fixed(self):
        """Which models capture is decided up front: p3m with the tree near
        field (host syncs in the tree walk) is not among them, p3m with the
        slot near field is, and nothing captures on the CPU."""
        assert set(CAPTURED) == {"central_well", "all_pairs", "pm_grid",
                                 "p3m:slots"}
        assert not _app(True).fused_engine.use_graph


class TestFusedReconfiguration:
    def test_fused_adapter_move_rebuilds_engine(self):
        """An adapter change rebuilds the fused engine with the state
        migrated, the camera and the learned capacity kept, and the same
        trajectory as an undisturbed fused run."""
        a, b = _app(True), _app(True)
        a.draw()
        b.draw()
        old = b.fused_engine
        old.renderer.entry_factor = 5
        b._prev_compute_index = -1   # re-assign to the same (only) adapter
        b._prev_render_index = -1
        a.draw()
        b.draw()                     # reconfigures after the frame
        assert b.fused_engine is not old
        assert b.compute is b.render is b.fused_engine
        assert b.fused_engine.camera is old.camera
        assert b.fused_engine.renderer.entry_factor == 5
        a.fused_engine.renderer.entry_factor = 5
        a.draw()
        b.draw()
        a.shutdown()
        b.shutdown()
        assert b.compute.get_fence_value() == 3
        _assert_same_run(a, b)

    def test_restore_keeps_the_buffers(self):
        """restore() copies into the current buffers, which captured
        graphs read, instead of rebinding them."""
        eng = FusedEngine(SimConfig(num_particles=N), SMALL_RENDER, "cpu")
        ptrs = {s.position.data_ptr() for s in eng._states}
        snap = eng.snapshot()
        eng.frame(AppConfig(num_particles=N))
        eng.restore(snap)
        assert eng.state.position.data_ptr() in ptrs
        assert torch.equal(eng.state.position, snap.position)


class TestFusedForceModels:
    def test_fused_with_pm_grid(self):
        sim = SimConfig(num_particles=N, force_model="pm_grid",
                        pm_grid_size=32, pm_box=4096.0,
                        interaction_scale=1.0 / N)
        split, fused = _run_both(2, sim)
        assert torch.isfinite(fused.compute.state.position).all()
        _assert_same_run(split, fused)

    def test_fused_with_p3m_tree(self):
        sim = SimConfig(num_particles=N, force_model="p3m",
                        pm_grid_size=32, pm_box=4096.0,
                        interaction_scale=1.0 / N, p3m_near_mode="tree")
        split, fused = _run_both(2, sim)
        assert torch.isfinite(fused.compute.state.position).all()
        _assert_same_run(split, fused)

    def test_fused_with_all_pairs(self):
        sim = SimConfig(num_particles=N, force_model="all_pairs")
        split, fused = _run_both(2, sim)
        _assert_same_run(split, fused)
        assert "interactions" not in fused.metrics.counters
        assert split.metrics.counters["interactions"] == 2 * N * N


def test_fused_novsync_bounded():
    fused = _app(True)
    for _ in range(8):
        fused.draw()
        assert len(fused.pacing) <= fused.pacing.max_latency
    fused.shutdown()
    assert len(fused.pacing) == 0


def _fused_apps(n, frames, render_kw=None):
    """The port's fused app and the JAX package's, run `frames` frames from
    the same initial state (the JAX device init handed across)."""
    kw = dict(num_particles=n, particle_size=40.0, vsync=False, gui=False)
    rkw = dict(width=64, height=64, **(render_kw or {}))
    japp = JApp(JAppConfig(**kw), JSimConfig(num_particles=n),
                JRenderConfig(**rkw), async_timers=False, fused=True)
    tapp = ParticlesApp(AppConfig(**kw), SimConfig(num_particles=n),
                        RenderConfig(**rkw), fused=True, **CPU)
    jst = japp.fused_engine.state
    tapp.compute.restore(ParticleState.from_numpy(
        np.array(jst.position), np.array(jst.velocity)))
    tapp.share_handles()
    for _ in range(frames):
        japp.draw()
        tapp.draw()
    japp.shutdown()
    tapp.shutdown()
    return tapp, japp


def test_fused_matches_jax_fused_app():
    """The port's fused app against the JAX package's from the same
    initial state: positions at the slice tests' 2e-5, the last frame
    within 2e-5, and the same metric counters (the JAX fused frame counts
    frames and no interactions)."""
    tapp, japp = _fused_apps(2048, 3)
    tpos, tvel = tapp.compute.state.to_numpy()
    jst = japp.fused_engine.state
    np.testing.assert_allclose(tpos, np.asarray(jst.position), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(tvel, np.asarray(jst.velocity), rtol=2e-5,
                               atol=2e-5)
    tframe = tapp.render.last_frame.numpy()
    assert tframe.max() > 0
    np.testing.assert_allclose(tframe, np.asarray(japp.render.last_frame),
                               rtol=0, atol=2e-5)
    assert tapp.metrics.counters == japp.metrics.counters == {"frames": 3.0}


def test_fused_u8frame_stays_float_as_jax():
    """`-u8frame` with `-fused`: the JAX fused frame stays float
    (its runtime/fused.py:166), and so does the port's, with the same
    values within 2e-5; the split engine still quantizes."""
    tapp, japp = _fused_apps(2048, 2, dict(frame_uint8=True))
    tframe = tapp.render.last_frame
    jframe = np.asarray(japp.render.last_frame)
    assert tframe.dtype == torch.float32 and jframe.dtype == np.float32
    assert tframe.max() > 0
    np.testing.assert_allclose(tframe.numpy(), jframe, rtol=0, atol=2e-5)
    split = ParticlesApp(
        AppConfig(num_particles=N, particle_size=10.0, vsync=False,
                  gui=False), SimConfig(num_particles=N),
        RenderConfig(width=64, height=64, frame_uint8=True), **CPU)
    split.draw()
    split.draw()
    split.shutdown()
    assert split.render.last_frame.dtype == torch.uint8


class TestCli:
    def test_fused_flag_runs(self):
        seen = {}
        rc = tapp_cli.main(
            ["-numparticles", "1024", "-steps", "2", "-novsync", "-nogui",
             "-width", "64", "-height", "64", "-fused",
             "-computeadapter", str(cpu_adapter_index())],
            on_exit=lambda p: seen.update(eng=p.fused_engine,
                                          frames=p.frame_count))
        assert rc == 0 and seen["frames"] == 2
        assert seen["eng"] is not None and seen["eng"].step_count == 2

    def test_4m_fused_preset_applies(self):
        """`-preset 4m-fused` is no longer refused: it sets fused mode (and
        4M particles, which a later flag overrides here)."""
        seen = {}
        rc = tapp_cli.main(
            ["-preset", "4m-fused", "-numparticles", "1024", "-steps", "2",
             "-nogui", "-width", "64", "-height", "64",
             "-computeadapter", str(cpu_adapter_index())],
            on_exit=lambda p: seen.update(eng=p.fused_engine,
                                          vsync=p.app.vsync))
        assert rc == 0
        assert seen["eng"] is not None and seen["vsync"] is False
