"""The port's single-device utilities against the JAX package's, on the CPU:
checkpoint / resume (`utils/checkpoint.py`; the file format both ways,
bitwise), the debug validation layer (`utils/debug.py`), the
queue-throttle extension as a stream priority (`utils/extension.py`) and
the stage timer that follows its stream (`runtime/trace.py`), the
startup-probe cache (`utils/probecache.py`), and the CLI flags that drive
them, with `-trace` and `-timerwindow`.

Mirrors tests/test_utils.py::TestCheckpoint, tests/test_debug.py,
tests/test_extension.py and tests/test_probecache.py.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_adapter_particles_tpu.models import init as jinit
from multi_adapter_particles_tpu.models.state import ParticleState as JState
from multi_adapter_particles_tpu.utils import checkpoint as jckpt
from multi_adapter_particles_tpu.utils import probecache as jprobe

from multi_adapter_particles_torch import app as cli
from multi_adapter_particles_torch.config import AppConfig, RenderConfig, SimConfig
from multi_adapter_particles_torch.models import init as tinit
from multi_adapter_particles_torch.models import integrator
from multi_adapter_particles_torch.models.state import ParticleState
from multi_adapter_particles_torch.ops.treeforce import (
    auto_grid,
    counts_cache_key,
    host_tree_counts,
)
from multi_adapter_particles_torch.runtime.compute_engine import ComputeEngine
from multi_adapter_particles_torch.runtime.devices import cpu_adapter_index
from multi_adapter_particles_torch.runtime.trace import SKIP, EventStageTimer
from multi_adapter_particles_torch.runtime.orchestrator import ParticlesApp
from multi_adapter_particles_torch.utils import checkpoint as ckpt
from multi_adapter_particles_torch.utils import debug as dbg
from multi_adapter_particles_torch.utils.extension import ExtensionHelper
from multi_adapter_particles_torch.utils.metrics import MetricsRegistry
from multi_adapter_particles_torch.utils.probecache import (
    ProbeCache,
    default_path,
    open_cache,
)

torch.set_num_threads(1)

N = 512
CPU = ["-computeadapter", str(cpu_adapter_index())]
SMALL = ["-novsync", "-nogui", "-width", "64", "-height", "64"]


def _state(n, seed):
    return tinit.initialize_particles_device(
        n, torch.Generator().manual_seed(seed), device="cpu")


def _app(**kw):
    return ParticlesApp(
        AppConfig(num_particles=N, particle_size=10.0, vsync=False,
                  gui=False),
        SimConfig(num_particles=N), RenderConfig(width=64, height=64),
        compute_adapter=cpu_adapter_index(), **kw)


# -- checkpoint ------------------------------------------------------------------

class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        state = _state(256, 5)
        p = str(tmp_path / "c.npz")
        ckpt.save_checkpoint(p, state, step=42, num_particles=256)
        loaded, step, n = ckpt.load_checkpoint(p, "cpu")
        assert step == 42 and n == 256
        assert torch.equal(state.position, loaded.position)
        assert torch.equal(state.velocity, loaded.velocity)
        assert not list(tmp_path.glob("*.tmp"))  # the write was atomic

    def test_resume_continues_trajectory(self, tmp_path):
        step = integrator.make_step(SimConfig(num_particles=256))
        s = step(_state(256, 1))
        p = str(tmp_path / "c.npz")
        ckpt.save_checkpoint(p, s, step=1)
        ref = step(step(s))
        loaded, _, _ = ckpt.load_checkpoint(p, "cpu")
        out = step(step(loaded))
        assert torch.equal(out.position, ref.position)

    def test_jax_file_loads_in_the_port(self, tmp_path):
        js = jinit.initialize_particles_device(384, seed=3)
        p = str(tmp_path / "j.npz")
        jckpt.save_checkpoint(p, js, step=17, num_particles=300)
        loaded, step, n = ckpt.load_checkpoint(p, "cpu")
        assert (step, n) == (17, 300)
        np.testing.assert_array_equal(loaded.position.numpy(),
                                      np.asarray(js.position))
        np.testing.assert_array_equal(loaded.velocity.numpy(),
                                      np.asarray(js.velocity))

    def test_port_file_loads_in_jax(self, tmp_path):
        s = _state(384, 4)
        p = str(tmp_path / "t.npz")
        ckpt.save_checkpoint(p, s, step=9, num_particles=300)
        loaded, step, n = jckpt.load_checkpoint(p)
        assert (step, n) == (9, 300)
        np.testing.assert_array_equal(np.asarray(loaded.position),
                                      s.position.numpy())
        np.testing.assert_array_equal(np.asarray(loaded.velocity),
                                      s.velocity.numpy())

    def test_format_equals_jax_package(self, tmp_path):
        """The same state and step give the same arrays, keys and dtypes."""
        s = _state(256, 6)
        a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
        ckpt.save_checkpoint(a, s, step=5)
        jckpt.save_checkpoint(b, JState(jnp.asarray(s.position.numpy()),
                                        jnp.asarray(s.velocity.numpy())),
                              step=5)
        assert ckpt.FORMAT_VERSION == jckpt.FORMAT_VERSION
        with np.load(a) as za, np.load(b) as zb:
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                assert za[k].dtype == zb[k].dtype, k
                np.testing.assert_array_equal(za[k], zb[k])

    def test_too_new_version_raises(self, tmp_path):
        p = str(tmp_path / "c.npz")
        ckpt.save_checkpoint(p, _state(128, 0), step=0)
        with np.load(p) as z:
            d = dict(z)
        d["version"] = np.int64(ckpt.FORMAT_VERSION + 1)
        np.savez(p, **d)
        with pytest.raises(ValueError, match="too new"):
            ckpt.load_checkpoint(p, "cpu")


class TestCheckpointCli:
    def _run(self, argv):
        seen = {}
        rc = cli.main(["-numparticles", "1024"] + SMALL + CPU + argv,
                      on_exit=lambda p: seen.update(
                          pos=p.compute.state.position.clone(),
                          fence=p.compute.get_fence_value(),
                          counters=dict(p.metrics.counters),
                          gauges=json.loads(json.dumps(p.metrics.gauges,
                                                       default=str))))
        return rc, seen

    @pytest.mark.parametrize("fused", [False, True])
    def test_checkpoint_resume_equals_uninterrupted(self, tmp_path, fused):
        """6 frames with a checkpoint every 3, then a resume for 4 more:
        bitwise the uninterrupted 10-frame run."""
        f = ["-fused"] if fused else []
        c = str(tmp_path / "c.npz")
        rc, first = self._run(f + ["-steps", "6", "-checkpointevery", "3",
                                   "-checkpoint", c])
        assert rc == 0
        # frames 3 and 6; the exit write follows on_exit
        assert first["counters"]["checkpoint_writes"] == 2
        assert len(first["gauges"]["checkpoint_write_ms"]) == 2
        rc, resumed = self._run(f + ["-steps", "4", "-resume", c])
        assert rc == 0 and resumed["fence"] == 10
        assert resumed["gauges"]["checkpoint_read_ms"] > 0
        rc, whole = self._run(f + ["-steps", "10"])
        assert torch.equal(resumed["pos"], whole["pos"])

    def test_mismatched_n_exits_2(self, tmp_path, capsys):
        c = str(tmp_path / "c.npz")
        ckpt.save_checkpoint(c, _state(512, 0), step=3, num_particles=512)
        rc, _ = self._run(["-steps", "1", "-resume", c])
        assert rc == 2
        assert ("checkpoint has 512 particles but -numparticles is 1024; "
                "pass -numparticles 512 to resume") in capsys.readouterr().err


# -- debug --------------------------------------------------------------------------

class TestDebug:
    def test_validate_state_accepts_finite(self):
        st = ParticleState(torch.zeros((4, 128)), torch.zeros((3, 128)))
        dbg.validate_state(st, where="t")

    def test_validate_state_rejects_nan(self):
        pos = torch.zeros((4, 128))
        pos[0, 5] = float("nan")
        st = ParticleState(pos, torch.zeros((3, 128)))
        with pytest.raises(dbg.DebugValidationError, match="non-finite"):
            dbg.validate_state(st, where="t")

    def test_validate_state_ignores_padding(self):
        pos = torch.zeros((4, 128))
        pos[0, 100] = float("nan")
        st = ParticleState(pos, torch.zeros((3, 128)))
        dbg.validate_state(st, num_particles=64, where="t")

    @pytest.mark.parametrize("fused", [False, True])
    def test_app_debug_mode_runs_clean(self, fused):
        app = _app(debug=True, fused=fused)
        for _ in range(3):
            app.draw()
        assert app.compute.get_fence_value() == 3
        app.shutdown()

    @pytest.mark.parametrize("fused", [False, True])
    def test_injected_nan_raises(self, fused):
        app = _app(debug=True, fused=fused)
        app.draw()
        app.compute.state.velocity[1, 7] = float("inf")
        with pytest.raises(dbg.DebugValidationError, match="non-finite"):
            app.draw()
        app.shutdown()

    def test_handoff_detects_shared_storage(self):
        app = _app(debug=True)
        app.draw()
        eng = app.compute
        with pytest.raises(dbg.DebugValidationError, match="newest state"):
            dbg.validate_handoff(eng, app.render, eng._spare.position)
        eng._spare = eng.state      # the step would write what is drawn
        with pytest.raises(dbg.DebugValidationError, match="share"):
            dbg.validate_handoff(eng, app.render, eng.state.position)
        app.shutdown()

    def test_fused_handoff_detects_shared_storage(self):
        app = _app(debug=True, fused=True)
        app.draw()
        eng = app.fused_engine
        eng._states[1 - eng._cur] = eng._states[eng._cur]
        with pytest.raises(dbg.DebugValidationError, match="ping-pong"):
            dbg.validate_fused_handoff(eng)
        app.shutdown()

    def test_cli_debug_runs(self):
        seen = {}
        rc = cli.main(["-numparticles", "1024", "-steps", "2", "-debug"]
                      + SMALL + CPU,
                      on_exit=lambda p: seen.update(debug=p.debug))
        assert rc == 0 and seen["debug"] is True


# -- extension ---------------------------------------------------------------------

class TestExtension:
    def test_probe(self):
        ext = ExtensionHelper("cpu")
        assert ext.available() is False  # the JAX probe's "unavailable"
        assert not ext.active
        assert ext.priority is None and ext.stream() is None

    def test_disabled_passthrough(self):
        ext = ExtensionHelper(torch.device("cuda", 0), enabled=False)
        assert not ext.active and ext.stream() is None

    def test_engine_with_extension_matches_without(self):
        cfg = SimConfig(num_particles=N)
        e1 = ComputeEngine(cfg, "cpu", seed=4,
                           extension=ExtensionHelper("cpu"))
        e2 = ComputeEngine(cfg, "cpu", seed=4)
        for _ in range(3):
            e1.simulate()
            e2.simulate()
        assert torch.equal(e1.positions, e2.positions)
        assert e1.state.device.type == "cpu"  # never moved elsewhere

    def test_runtime_toggle_in_app(self):
        app = _app()
        app.draw()
        app.app.use_queue_extension = False  # GUI checkbox analog
        app.draw()
        assert app.extension.enabled is False
        app.app.use_queue_extension = True
        app.draw()
        assert app.extension.enabled is True
        app.shutdown()

    def test_noext_flag(self):
        seen = {}
        rc = cli.main(["-numparticles", "1024", "-steps", "1", "-noext"]
                      + SMALL + CPU,
                      on_exit=lambda p: seen.update(on=p.extension.enabled))
        assert rc == 0 and seen["on"] is False


# -- stage timer -------------------------------------------------------------------

class _Event:
    """A CUDA event stand-in at a given device time (ms)."""

    def __init__(self, t):
        self.t, self.done = t, True

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return end.t - self.t


class TestEventStageTimer:
    """The split frame's stage bookkeeping (`runtime/trace.py`), with
    events at given device times: a step on the extension's stream is timed
    from its `begin` on that stream, not from the render's end."""

    def _run(self, monkeypatch, frames):
        """`frames`: per frame, the marks as (stage or None for `begin`,
        ms after the frame's start); frames start 20 ms apart."""
        monkeypatch.setattr(EventStageTimer, "_event",
                            lambda timer: _Event(t0 + offset))
        metrics = MetricsRegistry()
        timer = EventStageTimer(metrics, "cpu")
        for i, marks in enumerate(frames):
            t0, offset = 20.0 * i, 0.0
            timer.begin_frame()
            for stage, offset in marks:
                if stage is None:
                    timer.begin()
                else:
                    timer.mark(stage)
            timer.end_frame()
        return timer, metrics

    @pytest.mark.parametrize("marks,render,simulate", [
        # the step on the current stream, after the render
        ([("render", 2.0), ("simulate", 12.0)], 2.0, 10.0),
        # the step on its own stream, beside a shorter render
        ([("render", 2.0), (None, 0.5), ("simulate", 10.5)], 2.0, 10.0),
        # beside a longer render, which ends after the step
        ([("render", 9.0), (None, 0.5), ("simulate", 4.5)], 9.0, 4.0),
    ])
    def test_stage_samples(self, monkeypatch, marks, render, simulate):
        n = SKIP + 3
        timer, metrics = self._run(monkeypatch, [marks] * n)
        assert metrics.stage("render").milliseconds == pytest.approx(
            render)
        assert metrics.stage("simulate").milliseconds == pytest.approx(
            simulate)
        assert list(timer.frame_ms) == pytest.approx([20.0] * (n - SKIP))

    def test_frame_waits_for_every_mark(self, monkeypatch):
        events = []
        monkeypatch.setattr(EventStageTimer, "_event", lambda timer: (
            events.append(_Event(len(events))) or events[-1]))
        timer = EventStageTimer(MetricsRegistry(), "cpu")
        timer.begin_frame()
        timer.mark("render")
        timer.begin()
        timer.mark("simulate")
        events[1].done = False   # the render, still running
        timer.end_frame()
        assert len(timer._pending) == 1   # not resolved past the step
        events[1].done = True
        timer.poll()
        assert not timer._pending


# -- probe cache -------------------------------------------------------------------

def _scene(n=4096, seed=3):
    rng = np.random.default_rng(seed)
    pos = np.full((4, n), 1e9, np.float32)
    pos[:3] = np.concatenate([
        rng.normal(0, 120, (3, n // 2)),
        rng.normal(400, 80, (3, n - n // 2)),
    ], axis=1).astype(np.float32)
    return pos


class TestProbeCache:
    def test_round_trip(self, tmp_path):
        p = str(tmp_path / "probes.json")
        c = open_cache(p, 4096, 0, 2048.0, 6.75, "cuda")
        ck = counts_cache_key(9, 216.0)
        c.counts[ck] = (123, None, 512)
        c.counts[counts_cache_key(15, 108.5)] = (44, 99, 4096)
        c.overflow[(128, 8)] = 7
        c.save()
        c2 = open_cache(p, 4096, 0, 2048.0, 6.75, "cuda")
        assert c2.counts[ck] == (123, None, 512)
        assert c2.counts[counts_cache_key(15, 108.5)] == (44, 99, 4096)
        assert c2.overflow[(128, 8)] == 7

    def test_scene_and_device_keys_isolate(self, tmp_path):
        p = str(tmp_path / "probes.json")
        c = open_cache(p, 4096, 0, 2048.0, 6.75, "cuda")
        c.counts[counts_cache_key(9, 216.0)] = (1, None, 512)
        c.save()
        for other in [(4096, 1, "cuda"), (4096, 0, "cpu"), (2048, 0, "cuda")]:
            n, seed, kind = other
            assert not open_cache(p, n, seed, 2048.0, 6.75, kind).counts
        c2 = open_cache(p, 4096, 0, 2048.0, 6.75, "cpu")
        c2.counts[counts_cache_key(9, 216.0)] = (2, None, 512)
        c2.save()
        assert open_cache(p, 4096, 0, 2048.0, 6.75, "cuda").counts[
            counts_cache_key(9, 216.0)] == (1, None, 512)
        assert open_cache(p, 4096, 0, 2048.0, 6.75, "cpu").counts[
            counts_cache_key(9, 216.0)] == (2, None, 512)

    def test_corrupt_file_degrades_to_empty(self, tmp_path):
        p = tmp_path / "probes.json"
        p.write_text("{ not json !!")
        c = open_cache(str(p), 4096, 0, 2048.0, 6.75, "cpu")
        assert c.counts == {} and c.overflow == {}
        c.counts[counts_cache_key(9, 216.0)] = (5, None, 512)
        c.save()
        assert json.loads(p.read_text())

    @pytest.mark.parametrize("spec", ["off", None])
    def test_off_spec_disables_persistence(self, tmp_path, monkeypatch,
                                           spec):
        monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
        c = open_cache(spec, 4096, 0, 2048.0, 6.75, "cpu")
        assert c.path is None
        c.counts[counts_cache_key(9, 216.0)] = (5, None, 512)
        c.save()
        assert not list(tmp_path.rglob("*.json"))

    def test_auto_spec_uses_xdg_cache(self, tmp_path, monkeypatch):
        monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
        c = open_cache("auto", 4096, 0, 2048.0, 6.75, "cpu")
        c.save()
        assert (tmp_path / "multi_adapter_particles_torch"
                / "probes.json").exists()
        assert default_path() == str(tmp_path / "multi_adapter_particles_torch"
                                     / "probes.json")

    def test_encoding_equals_jax_package(self, tmp_path):
        """The port's copy writes the JAX package's entry layout under its
        own key (which adds the device kind)."""
        entries = {counts_cache_key(9, 216.0): (123, None, 512),
                   counts_cache_key(15, 108.5): (44, 99, 4096)}
        a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
        tc = open_cache(a, 4096, 0, 2048.0, 6.75, "cuda")
        jc = jprobe.open_cache(b, 4096, 0, 2048.0, 6.75)
        for c in (tc, jc):
            c.counts.update(entries)
            c.overflow[(128, 8)] = 7
            c.save()
        ta, jb = json.load(open(a)), json.load(open(b))
        assert list(ta.values()) == list(jb.values())
        assert tc.key.replace("|dev=cuda", "") == jc.key
        assert ProbeCache._ckey_in("9|216") == jprobe.ProbeCache._ckey_in(
            "9|216")

    def test_warm_cache_skips_positions_entirely(self):
        pos = _scene()
        cache: dict = {}
        g_cold = auto_grid(pos, 2048.0, 6.75, 1 << 40, counts_cache=cache,
                           num_particles=pos.shape[1])
        assert cache

        def boom():
            raise AssertionError("warm auto_grid touched positions")

        assert auto_grid(boom, 2048.0, 6.75, 1 << 40, counts_cache=cache,
                         num_particles=pos.shape[1]) == g_cold

    def test_cache_entries_match_direct_probes(self):
        pos = _scene(seed=7)
        cache: dict = {}
        auto_grid(pos, 2048.0, 6.75, 1 << 40, counts_cache=cache,
                  num_particles=pos.shape[1])
        for (gn, rc_s), triple in cache.items():
            assert tuple(triple) == tuple(host_tree_counts(
                pos, 2048.0, float(rc_s), gn))

    def test_cli_cold_then_warm(self, tmp_path, capsys):
        """The second launch of the same scene reads the probes back: the
        same grid and budget, and no device init (patched to fail)."""
        p = str(tmp_path / "probes.json")
        argv = ["-force", "p3m", "-p3mnear", "tree", "-numparticles", "4096",
                "-steps", "1", "-probecache", p] + SMALL + CPU
        seen = {}
        assert cli.main(argv, on_exit=lambda q: seen.update(
            cold=q.compute.config)) == 0
        cold_out = capsys.readouterr().out
        import multi_adapter_particles_torch.models.init as init_mod

        real = init_mod.initialize_particles_device
        calls = []

        def counted(*a, **kw):
            calls.append(1)
            return real(*a, **kw)

        init_mod.initialize_particles_device = counted
        try:
            assert cli.main(argv, on_exit=lambda q: seen.update(
                warm=q.compute.config)) == 0
        finally:
            init_mod.initialize_particles_device = real
        assert len(calls) == 1   # the engine's own init, no probe init
        assert seen["warm"] == seen["cold"]
        assert "tree pair budget sized to" in cold_out
        assert os.path.exists(p)


# -- trace and timer window ---------------------------------------------------------

class TestTraceFlags:
    def test_trace_writes_a_profile(self, tmp_path):
        d = tmp_path / "trace"
        rc = cli.main(["-numparticles", "1024", "-steps", "2", "-trace",
                       str(d)] + SMALL + CPU)
        assert rc == 0
        events = json.loads((d / "trace.json").read_text())["traceEvents"]
        assert any("aten::" in e.get("name", "") for e in events)

    def test_timerwindow_is_recorded(self, tmp_path):
        m = tmp_path / "m.json"
        rc = cli.main(["-numparticles", "1024", "-steps", "1",
                       "-timerwindow", "16", "-metrics", str(m)]
                      + SMALL + CPU)
        assert rc == 0
        assert json.loads(m.read_text())["gauges"]["timer_window_every"] == 16
