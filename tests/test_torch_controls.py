"""The port's control surface (`runtime/controls.py`) and the `-interactive`
loop, mirroring tests/test_controls.py on the CPU.

Every widget of the reference panel (`Particles.cpp:339-394`) must be
live-drivable through keys, through `apply_control` and through the HTTP
dashboard. Adapter moves run on a test-only list of two CPU adapters (the
CPU machine has one device), so the drain, the state migration and the
engine rebuild really run; in fused mode a move of one role only is
undone and raises, and the CLI loop prints it and goes on.
"""

import io
import json
import urllib.request

import pytest
import torch

from multi_adapter_particles_tpu.runtime import controls as jcontrols

from multi_adapter_particles_torch import app as cli
from multi_adapter_particles_torch.config import AppConfig, RenderConfig, SimConfig
from multi_adapter_particles_torch.runtime import devices
from multi_adapter_particles_torch.runtime.controls import (
    apply_control,
    apply_key,
    control_specs,
    key_help,
)
from multi_adapter_particles_torch.runtime.devices import cpu_adapter_index
from multi_adapter_particles_torch.runtime.orchestrator import ParticlesApp
from multi_adapter_particles_torch.utils.dashboard import DashboardServer

torch.set_num_threads(1)

N = 512
SMALL_RENDER = RenderConfig(width=64, height=64)


def two_cpus():
    return [devices.AdapterInfo(0, torch.device("cpu"), "cpu", "cpu (id 0)"),
            devices.AdapterInfo(1, torch.device("cpu"), "cpu", "cpu (id 1)")]


def make_app(**kw):
    kw.setdefault("compute_adapter", cpu_adapter_index())
    return ParticlesApp(
        AppConfig(num_particles=N, particle_size=10.0, vsync=False,
                  gui=False),
        SimConfig(num_particles=N), SMALL_RENDER, **kw
    )


def test_ranges_and_key_help_equal_jax_package():
    from multi_adapter_particles_torch.runtime import controls

    assert controls.SIZE_RANGE == jcontrols.SIZE_RANGE
    assert controls.INTENSITY_RANGE == jcontrols.INTENSITY_RANGE
    assert key_help() == jcontrols.key_help()


class TestApplyControl:
    def test_every_reference_widget_is_drivable(self, monkeypatch):
        """One flip per widget of Particles.cpp:339-394."""
        monkeypatch.setattr(devices, "enumerate_adapters", two_cpus)
        app = make_app(compute_adapter=0, render_adapter=0)
        apply_control(app, "size", 7.5)
        assert app.app.particle_size == 7.5
        apply_control(app, "intensity", 0.4)
        assert app.app.particle_intensity == pytest.approx(0.4)
        apply_control(app, "vsync", "on")
        assert app.app.vsync is True
        apply_control(app, "fullscreen", 1)
        assert app.app.fullscreen is True
        apply_control(app, "ext", "false")
        assert app.app.use_queue_extension is False
        apply_control(app, "linked", False)
        apply_control(app, "numdraw", 256)
        apply_control(app, "numcopy", 384)
        apply_control(app, "numsim", 128)
        assert app.app.resolved_counts() == (128, 384, 256)
        apply_control(app, "draw", 0)
        assert app.draw_enabled is False
        apply_control(app, "renderadapter", 1)
        assert app.render_adapter.index == 1
        apply_control(app, "computeadapter", 1)
        assert app.compute_adapter.index == 1
        app.shutdown()

    def test_slider_clamps(self):
        app = make_app()
        apply_control(app, "size", 99.0)
        assert app.app.particle_size == 10.0  # slider max (Particles.cpp:373)
        apply_control(app, "intensity", -3)
        assert app.app.particle_intensity == 0.0
        apply_control(app, "numdraw", 10 ** 9)
        assert app.app.resolved_counts()[2] == N
        app.shutdown()

    def test_linked_sliders_move_together(self):
        """Link ON: the three counts track the Rendered value
        (`Particles.cpp:388-392`)."""
        app = make_app()
        assert app.app.linked
        apply_control(app, "numdraw", 256)
        assert app.app.resolved_counts() == (256, 256, 256)
        apply_control(app, "linked", False)
        apply_control(app, "numsim", 128)
        assert app.app.resolved_counts() == (128, 256, 256)
        apply_control(app, "linked", True)
        assert app.app.resolved_counts() == (256, 256, 256)
        app.shutdown()

    def test_unknown_control_raises(self):
        app = make_app()
        with pytest.raises(KeyError):
            apply_control(app, "warp", 9)
        app.shutdown()

    def test_meshdevices_raises_not_ported(self):
        """The control rescales the mesh (tests/test_torch_parallel.py); on
        the one CPU adapter a mesh of 2 does not fit and raises as the JAX
        orchestrator does."""
        app = make_app()
        with pytest.raises(ValueError, match="only 1 cpu devices"):
            apply_control(app, "meshdevices", 2)
        app.shutdown()

    def test_changes_take_effect_in_frames(self):
        """A control change visibly alters the next frame (end-to-end)."""
        app = make_app()
        app.draw()
        apply_control(app, "intensity", 0.0)
        app.draw()
        assert float(app.render.last_frame.max()) == 0.0
        apply_control(app, "intensity", 0.5)
        app.draw()
        assert float(app.render.last_frame.max()) > 0.0
        app.shutdown()

    def test_ext_toggle_reaches_reconfiguration(self):
        app = make_app()
        app.draw()
        before = app.extension.enabled
        apply_control(app, "ext", not before)
        app.draw()  # change detection runs post-present
        assert app.extension.enabled == (not before)
        assert app.compute.extension is app.extension
        app.shutdown()

    def test_values_equal_jax_package(self):
        """The same control sequence gives the same messages and settings
        in both packages (the JAX app on its CPU device)."""
        from multi_adapter_particles_tpu.config import (
            AppConfig as JAppConfig,
            RenderConfig as JRenderConfig,
            SimConfig as JSimConfig,
        )
        from multi_adapter_particles_tpu.runtime import ParticlesApp as JApp

        japp = JApp(JAppConfig(num_particles=N, particle_size=10.0,
                               vsync=False, gui=False),
                    JSimConfig(num_particles=N),
                    JRenderConfig(width=64, height=64), async_timers=False)
        tapp = make_app()
        seq = [("size", 3.3), ("intensity", 2.0), ("numdraw", 300),
               ("linked", "0"), ("numsim", 64), ("vsync", "yes"),
               ("ext", 0), ("draw", "off")]
        for name, v in seq:
            assert apply_control(tapp, name, v) == \
                jcontrols.apply_control(japp, name, v)
        for key in "[]-=vefl135246":
            assert apply_key(tapp, key) == jcontrols.apply_key(japp, key)
        assert tapp.app.resolved_counts() == japp.app.resolved_counts()
        # the adapter lists differ (the JAX suite runs 8 virtual devices)
        ts = [s for s in control_specs(tapp) if s["kind"] != "select"]
        js = [s for s in jcontrols.control_specs(japp)
              if s["kind"] != "select"]
        assert ts == js
        tapp.shutdown()
        japp.shutdown()


class TestApplyKey:
    def test_key_map_covers_the_panel(self):
        app = make_app()
        apply_key(app, "[")
        assert app.app.particle_size == 9.5
        apply_key(app, "]")
        assert app.app.particle_size == 10.0
        apply_key(app, "-")
        assert app.app.particle_intensity == pytest.approx(0.1)
        apply_key(app, "=")
        assert app.app.particle_intensity == pytest.approx(0.15)
        apply_key(app, "v")
        assert app.app.vsync is True
        apply_key(app, "e")
        assert app.app.use_queue_extension is False
        apply_key(app, "f")
        assert app.app.fullscreen is True
        apply_key(app, "l")
        assert app.app.linked is False
        apply_key(app, "l")
        assert app.app.linked is True
        apply_key(app, "1")
        assert app.app.linked is False
        assert app.app.resolved_counts()[0] == N - 128
        apply_key(app, "2")
        assert app.app.resolved_counts()[0] == N
        apply_key(app, "5")
        assert app.app.resolved_counts()[2] == N - 128
        assert apply_key(app, "w") is None  # camera keys pass through
        app.shutdown()

    def test_adapter_cycle_keys(self, monkeypatch):
        """`c` and `r` move the roles; the next frame drains, migrates the
        state and rebuilds both engines, counted as reconfigurations."""
        monkeypatch.setattr(devices, "enumerate_adapters", two_cpus)
        app = make_app(compute_adapter=0, render_adapter=0)
        old_compute, old_render = app.compute, app.render
        app.draw()
        apply_key(app, "c")
        apply_key(app, "r")
        app.draw()  # reconfiguration applies post-present
        assert app.compute_adapter.index == 1
        assert app.render_adapter.index == 1
        assert app.compute is not old_compute and app.render is not old_render
        assert app.compute.get_fence_value() == 2
        assert app.metrics.counters["reconfigurations"] == 1
        assert len(app.metrics.gauges["reconfig_ms"]) == 1
        app.shutdown()

    def test_terminal_input_forwards_control_keys(self):
        from multi_adapter_particles_torch.runtime.input import TerminalInput

        ti = TerminalInput()
        st = ti.feed("[]-=vefl123456")
        for k in "[]-=vefl123456":
            assert k in st.pressed


class TestFusedMoves:
    def _fused(self, monkeypatch, adapters):
        monkeypatch.setattr(devices, "enumerate_adapters", lambda: adapters)
        return ParticlesApp(
            AppConfig(num_particles=N, particle_size=10.0, vsync=False,
                      gui=False),
            SimConfig(num_particles=N), SMALL_RENDER, compute_adapter=0,
            render_adapter=0, fused=True)

    def test_one_role_move_raises_and_is_undone(self, monkeypatch):
        """Fused mode binds both roles to one device: moving one raises at
        the next frame's rebuild, and the move is undone."""
        ads = [devices.AdapterInfo(0, torch.device("cpu"), "cpu", "cpu"),
               devices.AdapterInfo(1, torch.device("meta"), "cpu", "meta")]
        app = self._fused(monkeypatch, ads)
        eng = app.fused_engine
        apply_key(app, "c")
        with pytest.raises(ValueError, match="same device"):
            app.draw()
        assert app.compute_adapter.index == app.render_adapter.index == 0
        assert app.fused_engine is eng
        app.draw()  # the next frame runs as before
        assert app.compute.get_fence_value() == 2
        app.shutdown()

    def test_both_roles_move_rebuilds(self, monkeypatch):
        app = self._fused(monkeypatch, two_cpus())
        eng = app.fused_engine
        app.draw()
        apply_control(app, "computeadapter", 1)
        apply_control(app, "renderadapter", 1)
        app.draw()
        assert app.fused_engine is not eng
        assert app.compute_adapter.index == app.render_adapter.index == 1
        assert app.metrics.counters["reconfigurations"] == 1
        app.shutdown()


class TestInteractiveCli:
    def _run(self, argv, script, monkeypatch, adapters=None, capsys=None):
        if adapters is not None:
            monkeypatch.setattr(devices, "enumerate_adapters",
                                lambda: adapters)
        seen = {}
        rc = cli.main(
            ["-numparticles", "1024", "-novsync", "-nogui", "-width", "64",
             "-height", "64", "-computeadapter", "0", "-interactive"] + argv,
            on_exit=lambda p: seen.update(
                frames=p.frame_count, draw=p.draw_enabled,
                size=p.app.particle_size, compute=p.compute_adapter.index,
                counters=dict(p.metrics.counters),
                fence=p.compute.get_fence_value()),
            input_stream=io.StringIO(script))
        return rc, seen

    def test_scripted_keys_drive_the_loop(self, monkeypatch):
        """c, c, SPACE, [, ], w, q: two reassignments (away and back),
        the draw toggle, size down and up, a camera key, quit."""
        rc, seen = self._run(["-steps", "20"], "c\nc\n \n[\n]\nw\nq\n",
                             monkeypatch, two_cpus())
        assert rc == 0
        assert seen["frames"] == seen["fence"] == 6
        assert seen["counters"]["reconfigurations"] == 2
        assert seen["compute"] == 0 and seen["draw"] is False
        assert seen["size"] == 2.5

    def test_fused_one_role_move_prints_and_continues(self, monkeypatch,
                                                      capsys):
        ads = [devices.AdapterInfo(0, torch.device("cpu"), "cpu", "cpu"),
               devices.AdapterInfo(1, torch.device("meta"), "cpu", "meta")]
        rc, seen = self._run(["-fused", "-steps", "4"], "c\n\n\n\n", monkeypatch,
                             ads)
        assert rc == 0 and seen["frames"] == 4
        assert "same device" in capsys.readouterr().err

    def test_control_error_is_printed_not_fatal(self, monkeypatch, capsys):
        def boom(particles, key):
            raise RuntimeError(f"bad key {key}")

        monkeypatch.setattr("multi_adapter_particles_torch.runtime.controls."
                            "apply_key", boom)
        rc, seen = self._run(["-steps", "3"], "v\nv\n", monkeypatch)
        assert rc == 0 and seen["frames"] == 3
        assert "bad key v" in capsys.readouterr().err


class TestDashboardServer:
    def test_http_round_trip(self):
        app = make_app()
        app.draw()
        srv = DashboardServer(app, port=0)
        try:
            base = f"http://127.0.0.1:{srv.port}"
            index = urllib.request.urlopen(f"{base}/", timeout=10).read()
            assert b"controls" in index and b"size" in index
            state = json.loads(
                urllib.request.urlopen(f"{base}/state", timeout=10).read()
            )
            assert any(c["name"] == "intensity" for c in state["controls"])
            png = urllib.request.urlopen(f"{base}/frame.png", timeout=10).read()
            assert png[:8] == b"\x89PNG\r\n\x1a\n"
            r = urllib.request.urlopen(
                f"{base}/set?name=size&value=3.25", timeout=10
            ).read()
            assert r == b"ok"
            urllib.request.urlopen(urllib.request.Request(
                f"{base}/set", data=b"name=vsync&value=1", method="POST"),
                timeout=10).read()
            assert app.app.particle_size == 10.0  # not yet applied
            assert srv.drain() == 2
            assert app.app.particle_size == 3.25
            assert app.app.vsync is True
            urllib.request.urlopen(
                f"{base}/set?name=warp&value=9", timeout=10
            ).read()
            srv.drain()
            assert any("error" in m for m in srv.messages)
        finally:
            srv.close()
            app.shutdown()

    def test_cli_serve_flag(self):
        rc = cli.main([
            "-numparticles", "1024", "-steps", "2", "-novsync", "-nogui",
            "-width", "64", "-height", "64", "-serve", "0",
            "-computeadapter", str(cpu_adapter_index()),
        ])
        assert rc == 0

    def test_specs_reflect_state(self):
        app = make_app()
        apply_control(app, "size", 4.0)
        specs = {s["name"]: s for s in control_specs(app)}
        assert specs["size"]["value"] == 4.0
        assert specs["renderadapter"]["kind"] == "select"
        assert len(specs["renderadapter"]["options"]) == len(app.adapters)
        app.shutdown()
