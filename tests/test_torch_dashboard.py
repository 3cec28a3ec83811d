"""The port's dashboard (`utils/dashboard.py`) and panel compositing
(`utils/overlay.py`), mirroring tests/test_dashboard.py on the CPU; plus
the pins of both copies to the JAX package's (the same panel text, pixels
and hit tests), the POST route, and the CLI's `-dashboard` and `-serve`
(a port that cannot be bound exits non-zero)."""

import json
import os
import socket
import types
import urllib.request

import numpy as np
import pytest
import torch

from multi_adapter_particles_tpu.utils import dashboard as jdash
from multi_adapter_particles_tpu.utils import overlay as joverlay

from multi_adapter_particles_torch import app as cli
from multi_adapter_particles_torch.config import AppConfig, RenderConfig, SimConfig
from multi_adapter_particles_torch.runtime.devices import cpu_adapter_index
from multi_adapter_particles_torch.runtime.orchestrator import ParticlesApp
from multi_adapter_particles_torch.utils import dashboard
from multi_adapter_particles_torch.utils import overlay

torch.set_num_threads(1)


def make_app():
    return ParticlesApp(
        AppConfig(num_particles=256, particle_size=10.0),
        SimConfig(num_particles=256),
        RenderConfig(width=128, height=64),
        compute_adapter=cpu_adapter_index(),
    )


def test_ansi_panel_contains_controls():
    app = make_app()
    app.draw()
    text = dashboard.render_ansi(app, clear=False)
    assert app.metrics.gauges["mode_banner"] in text
    for token in (
        "size", "intensity", "simulated", "copied",
        "rendered", "linked", "vsync", "frameTime",
    ):
        assert token in text, token
    # the adapter role markers
    assert "[CR]" in text or "[C " in text


def test_html_with_frame(tmp_path):
    app = make_app()
    app.draw()
    app.render.present()
    p = str(tmp_path / "dash.html")
    dashboard.write_html(app, p, frame=app.render.last_frame)
    content = open(p).read()
    assert "data:image/png;base64," in content
    assert "frameTime" in content
    assert os.path.getsize(p) > 1000


def test_stream_pushes_frames():
    """/stream is a push channel: published frames arrive as multipart PNG
    parts at frame rate (VERDICT r2: replace the 1 Hz <img> poll)."""
    import time

    app = make_app()
    app.draw()
    app.render.present()
    frame = app.render.last_frame

    srv = dashboard.DashboardServer(app, port=0, stream_fps=1e6)
    try:
        s = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
        s.sendall(b"GET /stream HTTP/1.1\r\nHost: t\r\n\r\n")
        deadline = time.time() + 10
        while srv.stream_clients == 0 and time.time() < deadline:
            time.sleep(0.01)
        assert srv.stream_clients == 1

        buf = b""
        s.settimeout(10)
        while buf.count(b"\x89PNG") < 2 and time.time() < deadline:
            srv.publish_frame(frame)  # frame loop pushing
            try:
                chunk = s.recv(65536)
            except socket.timeout:
                break
            if not chunk:
                break
            buf += chunk
        assert b"multipart/x-mixed-replace" in buf
        assert buf.count(b"\x89PNG") >= 2  # at least two distinct pushes
        s.close()
    finally:
        srv.close()
    # publishing with no viewers is free and a no-op
    assert srv.publish_frame(frame) is False


def test_publish_rate_limit():
    app = make_app()
    srv = dashboard.DashboardServer(app, port=0, stream_fps=0.5)
    try:
        with srv._stream_cond:
            srv._stream_clients = 1  # simulate a viewer
        f = np.zeros((8, 8, 3), np.uint8)
        assert srv.publish_frame(f) is True
        assert srv.publish_frame(f) is False  # inside the 2 s window
    finally:
        with srv._stream_cond:
            srv._stream_clients = 0
        srv.close()


def test_panel_composited_into_frame():
    """The viewer surfaces draw the text panel INTO the frame pixels —
    the reference renders imgui into the swap-chain image
    (`Render.cpp:894`). -dumpframe stays clean."""
    from multi_adapter_particles_torch.utils.overlay import composite_panel

    frame = np.zeros((128, 256, 3), np.float32)
    out = composite_panel(frame, "FRAME 42\nSIZE: 2.5")
    assert out.dtype == np.uint8
    assert out.sum() > 0                        # glyph pixels landed
    assert (out[:, :, 0] == 255).any()          # white text present
    # original array untouched (composite works on a copy)
    assert frame.sum() == 0.0


def test_stream_carries_overlay():
    import time

    app = make_app()
    app.draw()
    app.render.present()
    frame = app.render.last_frame
    srv = dashboard.DashboardServer(app, port=0, stream_fps=1e6)
    try:
        s = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
        s.sendall(b"GET /stream HTTP/1.1\r\nHost: t\r\n\r\n")
        deadline = time.time() + 10
        while srv.stream_clients == 0 and time.time() < deadline:
            time.sleep(0.01)
        assert srv.publish_frame(frame) is True  # composites + pushes
        buf = b""
        s.settimeout(10)
        while b"\x89PNG" not in buf and time.time() < deadline:
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
        assert b"\x89PNG" in buf
        s.close()
    finally:
        srv.close()


# -- click-on-frame (imgui-in-the-window parity) ---------------------------------


def _px(col):  # panel char column -> frame pixel (glyph center-ish)
    from multi_adapter_particles_torch.utils import overlay
    return overlay.TEXT_X + col * overlay.CHAR_W + 2


def _py(line):
    from multi_adapter_particles_torch.utils import overlay
    return overlay.TEXT_Y + line * overlay.LINE_H + 3


def _panel_lines(app):
    return dashboard.render_ansi(app, clear=False).splitlines()


def test_hit_test_slider_sets_proportional_value():
    from multi_adapter_particles_torch.utils.overlay import hit_test

    app = make_app()
    app.draw()
    panel = dashboard.render_ansi(app, clear=False)
    lines = panel.splitlines()
    li = next(i for i, l in enumerate(lines) if l.startswith("size"))
    b0 = lines[li].index("[") + 1
    b1 = lines[li].index("]", b0)
    # click the middle of the size bar -> ~5.0 of the 0..10 range
    mid = (b0 + b1 - 1) // 2
    act = hit_test(panel, _px(mid), _py(li), app.app.num_particles)
    assert act is not None and act[0] == "size"
    assert abs(float(act[1]) - 5.0) < 0.5
    # far left / far right ends clamp to the range ends
    lo = hit_test(panel, _px(b0), _py(li), 256)
    hi = hit_test(panel, _px(b1 - 1), _py(li), 256)
    assert float(lo[1]) < 1.0 and float(hi[1]) > 9.0


def test_hit_test_count_slider_scales_to_n():
    from multi_adapter_particles_torch.utils.overlay import hit_test

    app = make_app()
    app.draw()
    panel = dashboard.render_ansi(app, clear=False)
    lines = panel.splitlines()
    li = next(i for i, l in enumerate(lines) if l.startswith("rendered"))
    b1 = lines[li].index("]")
    act = hit_test(panel, _px(b1 - 1), _py(li), app.app.num_particles)
    assert act[0] == "numdraw"
    assert int(act[1]) > 0.9 * app.app.num_particles


def test_hit_test_checkbox_toggles():
    from multi_adapter_particles_torch.utils.overlay import hit_test

    app = make_app()
    app.draw()
    panel = dashboard.render_ansi(app, clear=False)
    lines = panel.splitlines()
    li = next(i for i, l in enumerate(lines) if "vsync" in l and "[" in l)
    c = lines[li].index("vsync")
    act = hit_test(panel, _px(c + 1), _py(li), 256)
    assert act is not None and act[0] == "vsync"
    # vsync defaults ON -> clicking turns it off
    assert act[1] == ("0" if app.app.vsync else "1")


def test_hit_test_adapter_rows_assign_roles():
    from multi_adapter_particles_torch.utils.overlay import hit_test

    app = make_app()
    app.draw()
    panel = dashboard.render_ansi(app, clear=False)
    lines = panel.splitlines()
    li = next(
        i for i, l in enumerate(lines)
        if l.startswith("  [") and ":" in l
    )
    idx = lines[li][6:].strip().split(":", 1)[0].strip()
    act_c = hit_test(panel, _px(3), _py(li), 256)
    act_r = hit_test(panel, _px(10), _py(li), 256)
    assert act_c == ("computeadapter", idx)
    assert act_r == ("renderadapter", idx)


def test_hit_test_misses_return_none():
    from multi_adapter_particles_torch.utils.overlay import hit_test

    app = make_app()
    app.draw()
    panel = dashboard.render_ansi(app, clear=False)
    assert hit_test(panel, 5000, 5000, 256) is None
    assert hit_test(panel, _px(0), _py(0), 256) is None  # the title row


def test_click_endpoint_round_trip():
    """A /click on the streamed frame's slider bar lands through drain()
    exactly like a /set — the full imgui-in-the-window loop."""
    import json as _json
    import urllib.request

    app = make_app()
    app.draw()
    srv = dashboard.DashboardServer(app, port=0)
    try:
        base = f"http://127.0.0.1:{srv.port}"
        lines = _panel_lines(app)
        li = next(i for i, l in enumerate(lines) if l.startswith("size"))
        b1 = lines[li].index("]")
        url = f"{base}/click?x={_px(b1 - 1)}&y={_py(li)}"
        with urllib.request.urlopen(url, timeout=5) as r:
            act = _json.loads(r.read())
        assert act["name"] == "size"
        assert app.app.particle_size == 10.0  # queued, not yet applied
        srv.drain()
        assert app.app.particle_size == float(act["value"])
        # a miss answers "miss" and queues nothing
        with urllib.request.urlopen(f"{base}/click?x=4000&y=4000",
                                    timeout=5) as r:
            assert r.read() == b"miss"
        assert srv.drain() == 0
    finally:
        srv.close()
        app.shutdown()


# -- the pins: the port's copies are the JAX package's ------------------------

def _fake_app():
    """A duck-typed app both packages' `render_ansi` read."""
    from multi_adapter_particles_torch.utils.metrics import MetricsRegistry

    m = MetricsRegistry(frame_skip=0)
    m.stage("simulate").add_sample(0.0021)
    m.stage("render").add_sample(0.0052)
    m.count("frames", 42)
    m.count("transfer_bytes", 3 * 2 ** 20)
    m.gauge("mode_banner", "Single Adapter with Async Compute")
    m.gauge("energy", -12.5)
    m.gauge("energy_drift", 1e-6)
    ads = [types.SimpleNamespace(index=0, platform="gpu", description="x"),
           types.SimpleNamespace(index=1, platform="cpu", description="y")]
    return types.SimpleNamespace(
        metrics=m, adapters=ads, compute_adapter=ads[0],
        render_adapter=ads[1],
        app=AppConfig(num_particles=1000, num_draw=700, particle_size=3.5))


def test_panel_text_equals_jax_package():
    fake = _fake_app()
    ours = dashboard.render_ansi(fake, clear=False).splitlines()
    theirs = jdash.render_ansi(fake, clear=False).splitlines()
    assert ours[0].replace("(torch)", "(TPU)") == theirs[0]
    assert ours[1:] == theirs[1:]


def test_overlay_pixels_and_hits_equal_jax_package():
    panel = dashboard.render_ansi(_fake_app(), clear=False)
    frame = np.random.default_rng(0).random((96, 256, 3)).astype(np.float32)
    np.testing.assert_array_equal(overlay.composite_panel(frame, panel),
                                  joverlay.composite_panel(frame, panel))
    for x in range(0, 256, 7):
        for y in range(0, 96, 5):
            assert overlay.hit_test(panel, x, y, 1000) == \
                joverlay.hit_test(panel, x, y, 1000), (x, y)


def test_widgets_post_through_the_control_registry():
    """The page's widgets POST /set; the body reaches apply_control."""
    spec = {"name": "size", "kind": "slider", "lo": 0, "hi": 10,
            "step": 0.1, "value": 2.5}
    assert "method:'POST'" in dashboard._widget_html(spec)
    app = make_app()
    srv = dashboard.DashboardServer(app, port=0)
    try:
        base = f"http://127.0.0.1:{srv.port}"
        urllib.request.urlopen(urllib.request.Request(
            f"{base}/set", data=b"name=size&value=4.5", method="POST"),
            timeout=10).read()
        urllib.request.urlopen(urllib.request.Request(
            f"{base}/set", data=json.dumps({"name": "intensity",
                                            "value": 0.25}).encode(),
            headers={"Content-Type": "application/json"}, method="POST"),
            timeout=10).read()
        urllib.request.urlopen(urllib.request.Request(
            f"{base}/set", data=b"name=meshdevices&value=2", method="POST"),
            timeout=10).read()
        assert srv.drain() == 2
        assert app.app.particle_size == 4.5
        assert app.app.particle_intensity == 0.25
        assert any("item 14" in m for m in srv.messages)
    finally:
        srv.close()
        app.shutdown()


def test_cli_dashboard_writes_html(tmp_path):
    p = tmp_path / "d.html"
    rc = cli.main(["-numparticles", "1024", "-steps", "31", "-novsync",
                   "-nogui", "-width", "64", "-height", "64",
                   "-computeadapter", str(cpu_adapter_index()),
                   "-dashboard", str(p)])
    assert rc == 0
    content = p.read_text()
    assert "data:image/png;base64," in content and "frames: 31" in content


def test_cli_serve_unbindable_port_exits_nonzero(capsys):
    blocker = socket.socket()
    blocker.bind(("127.0.0.1", 0))
    blocker.listen(1)
    try:
        rc = cli.main(["-numparticles", "1024", "-steps", "2", "-novsync",
                       "-nogui", "-width", "64", "-height", "64",
                       "-computeadapter", str(cpu_adapter_index()),
                       "-serve", str(blocker.getsockname()[1])])
    finally:
        blocker.close()
    assert rc != 0
    assert "cannot serve the dashboard" in capsys.readouterr().err
