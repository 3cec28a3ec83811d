"""Cheap checks of the torch port: its own copies of the JAX package's
JAX-free modules (constants, config, camera) equal the originals, the
package never imports jax, the state converters round-trip, the device
init has the reference's distribution (its RNG differs from jax.random, so
the comparison is distributional, as tests/test_init.py does), and the
runtime pieces around the kernels behave."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from multi_adapter_particles_tpu import config as jconfig
from multi_adapter_particles_tpu import constants as JC
from multi_adapter_particles_tpu.models import init as jinit
from multi_adapter_particles_tpu.render import camera as jcam

from multi_adapter_particles_torch import config as tconfig
from multi_adapter_particles_torch import constants as C
from multi_adapter_particles_torch.models import init as tinit
from multi_adapter_particles_torch.models.state import (
    PAD_POSITION,
    ParticleState,
    padded_count,
    zeros,
)
from multi_adapter_particles_torch.render import camera as tcam

# The suite runs one xdist worker per core; torch's own thread pool on top
# only oversubscribes them.
torch.set_num_threads(1)

REPO =Path(__file__).resolve().parents[1]


def _public(mod):
    return {k: v for k, v in vars(mod).items()
            if k.isupper() and not k.startswith("_")}


def test_constants_equal_jax_package():
    assert _public(C) == _public(JC)


@pytest.mark.parametrize("cls", ["SimConfig", "RenderConfig", "AppConfig"])
def test_config_fields_equal_jax_package(cls):
    a, b = getattr(jconfig, cls), getattr(tconfig, cls)
    fa = [(f.name, f.default) for f in dataclasses.fields(a)]
    fb = [(f.name, f.default) for f in dataclasses.fields(b)]
    assert fa == fb


@pytest.mark.parametrize("kw", [
    {}, {"num_draw": 700}, {"linked": False, "num_sim": 300},
    {"linked": False, "num_sim": 5000, "num_copy": 10, "num_draw": 999},
])
def test_resolved_counts_equal_jax_package(kw):
    a = jconfig.AppConfig(num_particles=1000, **kw)
    b = tconfig.AppConfig(num_particles=1000, **kw)
    assert a.resolved_counts() == b.resolved_counts()


@pytest.mark.parametrize("pose", [
    {}, {"position": (0.0, 0.0, 60.0)},
    {"position": (100.0, -40.0, 900.0), "yaw": np.pi - 0.3, "pitch": -0.35},
])
def test_camera_matrices_equal_jax_package(pose):
    a, b = jcam.Camera(**pose), tcam.Camera(**pose)
    for aspect in (1.0, 16 / 9):
        np.testing.assert_array_equal(
            a.world_view_projection(aspect), b.world_view_projection(aspect))
        np.testing.assert_array_equal(
            a.projection_matrix(aspect), b.projection_matrix(aspect))
    np.testing.assert_array_equal(a.view_matrix(), b.view_matrix())


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "import multi_adapter_particles_torch.app\n"
        "import multi_adapter_particles_torch.runtime.orchestrator\n"
        "import multi_adapter_particles_torch.ops.central_well\n"
        "import multi_adapter_particles_torch.ops.composite\n"
        "import multi_adapter_particles_torch.ops.allpairs\n"
        "import multi_adapter_particles_torch.ops.treeforce\n"
        "import multi_adapter_particles_torch.ops.p3m\n"
        "import multi_adapter_particles_torch.ops.pm\n"
        "import multi_adapter_particles_torch.presets\n"
        "import multi_adapter_particles_torch.runtime.controls\n"
        "import multi_adapter_particles_torch.runtime.input\n"
        "import multi_adapter_particles_torch.runtime.fused\n"
        "import multi_adapter_particles_torch.utils.checkpoint\n"
        "import multi_adapter_particles_torch.utils.debug\n"
        "import multi_adapter_particles_torch.utils.extension\n"
        "import multi_adapter_particles_torch.utils.probecache\n"
        "import multi_adapter_particles_torch.utils.overlay\n"
        "import multi_adapter_particles_torch.utils.dashboard\n"
        "import multi_adapter_particles_torch.utils.timers\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('multi_adapter_particles_tpu')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_stage_timer_equals_jax_package():
    """`utils/timers.py::StageTimer` is the JAX class: the same EMA on the
    same samples, bit for bit."""
    from multi_adapter_particles_tpu.utils.timers import StageTimer as J
    from multi_adapter_particles_torch.utils.timers import StageTimer as T

    rng = np.random.default_rng(0)
    for window in (1, 20, 64):
        a, b = T("x", window=window), J("x", window=window)
        assert a.alpha == b.alpha and a.name == b.name
        for s in rng.random(50):
            a.add_sample(float(s))
            b.add_sample(float(s))
            assert a.ema_seconds == b.ema_seconds
            assert a.milliseconds == b.milliseconds


def test_state_numpy_round_trip_and_layout():
    rng = np.random.default_rng(0)
    aos_p = rng.normal(size=(300, 4)).astype(np.float32)
    aos_v = rng.normal(size=(300, 3)).astype(np.float32)
    st = ParticleState.from_aos(aos_p, aos_v)
    assert st.position.shape == (4, padded_count(300)) == (4, 384)
    assert torch.all(st.position[:3, 300:] == PAD_POSITION)
    assert torch.all(st.position[3, 300:] == 0)
    p, v = st.to_aos(300)
    np.testing.assert_array_equal(p, aos_p)
    np.testing.assert_array_equal(v, aos_v)
    pos, vel = st.to_numpy()
    back = ParticleState.from_numpy(pos, vel)
    assert torch.equal(back.position, st.position)
    assert torch.equal(back.velocity, st.velocity)
    np.testing.assert_array_equal(st.make_mask(300).numpy(),
                                  (np.arange(384) < 300).astype(np.float32))
    z = zeros(100)
    assert torch.all(z.position[:, :100] == 0)
    assert torch.all(z.position[:3, 100:] == PAD_POSITION)


class TestDeviceInit:
    def test_shapes_and_padding(self):
        st = tinit.initialize_particles_device(300, device="cpu")
        assert st.position.shape == (4, 384) and st.velocity.shape == (3, 384)
        pos = st.position.numpy()
        assert np.all(np.abs(pos[:3, 300:]) > 1e8)
        assert np.all(pos[3] == 0.0)
        assert np.all(st.velocity.numpy()[:, 300:] == 0.0)

    def test_on_sphere_and_velocity_rule(self):
        n = 1024
        st = tinit.initialize_particles_device(
            n, torch.Generator().manual_seed(1), device="cpu")
        pos = st.position.numpy()[:3, :n].T.astype(np.float64)
        c0 = np.array([C.CLUSTER_CENTER_X, 0, 0])
        np.testing.assert_allclose(np.linalg.norm(pos[: n // 2] - c0, axis=1),
                                   C.PARTICLE_SPREAD, rtol=1e-4)
        np.testing.assert_allclose(np.linalg.norm(pos[n // 2:] + c0, axis=1),
                                   C.PARTICLE_SPREAD, rtol=1e-4)
        vel = st.velocity.numpy()[:, :n].T.astype(np.float64)
        d = pos / np.linalg.norm(pos, axis=1, keepdims=True)
        perp = 1.0 - d
        perp /= np.linalg.norm(perp, axis=1, keepdims=True)
        np.testing.assert_allclose(vel, np.cross(d, perp)
                                   * C.INITIAL_PARTICLE_SPEED,
                                   rtol=1e-3, atol=1e-3)

    def test_deterministic_per_seed(self):
        def run(seed):
            return tinit.initialize_particles_device(
                128, torch.Generator().manual_seed(seed),
                device="cpu").position

        assert torch.equal(run(5), run(5))
        assert not torch.equal(run(5), run(6))

    def test_distribution_matches_jax_init(self):
        """Directions from the rejection-accumulated walk: both inits are
        ~uniform on the sphere, with the same second moments."""
        n = 4096
        t = tinit.initialize_particles_device(
            n, torch.Generator().manual_seed(3),
            device="cpu").position.numpy()
        j = np.asarray(jinit.initialize_particles_device(n, seed=3).position)
        c0 = np.array([C.CLUSTER_CENTER_X, 0, 0])[:, None]
        for pos in (t, j):
            d = (pos[:3, : n // 2] - c0) / C.PARTICLE_SPREAD
            assert np.all(np.abs(d.mean(axis=1)) < 0.05)
            np.testing.assert_allclose((d * d).mean(axis=1), 1 / 3, atol=0.03)
        # two-sample Kolmogorov-Smirnov per axis; 0.061 is the critical D
        # at alpha = 0.001 for 2048 vs 2048 samples
        for axis in range(3):
            a = np.sort(t[axis, : n // 2])
            b = np.sort(j[axis, : n // 2])
            both = np.concatenate([a, b])
            d = np.abs(np.searchsorted(a, both, "right")
                       - np.searchsorted(b, both, "right")).max() / a.size
            assert d < 0.061, (axis, d)

    def test_no_device_follows_generator_or_raises(self, monkeypatch):
        """With no device the state is born on the generator's device;
        with neither a device nor a generator it needs CUDA and raises
        without it (no fallback to the CPU)."""
        st = tinit.initialize_particles_device(
            128, torch.Generator().manual_seed(0))
        assert st.position.device.type == "cpu"
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tinit.initialize_particles_device(128)


def _cpu_only():
    from multi_adapter_particles_torch.runtime import devices

    return [devices.AdapterInfo(0, torch.device("cpu"), "cpu", "cpu (id 0)")]


class TestRuntimePieces:
    def test_adapters_and_banner(self):
        """The CPU is listed last and never takes a role unasked: with no
        GPU and no index, assignment raises (the CLI exits 2)."""
        from multi_adapter_particles_torch.runtime import devices

        ads = devices.enumerate_adapters()
        assert ads[-1].platform == "cpu"
        assert all(a.index == i for i, a in enumerate(ads))
        assert devices.cpu_adapter_index(ads) == ads[-1].index
        with pytest.raises(devices.NoAcceleratorError):
            devices.assign_adapters(_cpu_only())

    @pytest.mark.parametrize("indices", [(0, 0), (0, None), (None, 0)])
    def test_explicit_cpu_pair(self, indices):
        """Naming the CPU for either role runs both there, in the
        single-adapter async-compute mode."""
        from multi_adapter_particles_torch.runtime import devices

        c, r = devices.assign_adapters(_cpu_only(), *indices)
        assert c.device == r.device == torch.device("cpu")
        assert "Async Compute" in devices.mode_banner(c, r)

    def test_pacing_bound_on_cpu(self):
        from multi_adapter_particles_torch.runtime.pacing import (
            FrameLatencyQueue,
        )

        q = FrameLatencyQueue(2)
        for _ in range(5):
            q.push(torch.zeros(4))  # CPU frames are finished when pushed
        assert len(q) == 0
        q.close()

    def test_metrics_text_and_dict(self):
        from multi_adapter_particles_torch.utils.metrics import MetricsRegistry

        m = MetricsRegistry(frame_skip=0)
        for _ in range(3):
            m.frame_tick()
        m.stage("simulate").add_sample(0.002)
        m.count("interactions", 10)
        m.gauge("mode_banner", "Single Adapter with Async Compute")
        d = m.as_dict()
        assert d["stages_ms"]["simulate"] == pytest.approx(2.0)
        assert d["counters"]["frames"] == 3
        text = m.render_text()
        assert "simulate ms:" in text and "frameTime ms:" in text


class TestCli:
    def test_main_path_small(self, tmp_path):
        from multi_adapter_particles_torch import app

        metrics = tmp_path / "m.json"
        frame = tmp_path / "f.npy"
        seen = {}
        from multi_adapter_particles_torch.runtime.devices import (
            cpu_adapter_index,
        )

        rc = app.main(
            ["-numparticles", "1024", "-steps", "3", "-novsync", "-nogui",
             "-width", "64", "-height", "32", "-size", "40",
             "-computeadapter", str(cpu_adapter_index()),
             "-metrics", str(metrics), "-dumpframe", str(frame)],
            on_exit=lambda p: seen.update(frames=p.frame_count),
        )
        assert rc == 0 and seen["frames"] == 3
        d = json.loads(metrics.read_text())
        assert d["counters"]["frames"] == 3
        assert np.load(frame).shape == (32, 64, 3)

    def test_no_gpu_and_no_adapter_exits_2(self, capsys, monkeypatch):
        from multi_adapter_particles_torch import app
        from multi_adapter_particles_torch.runtime import devices

        monkeypatch.setattr(devices, "enumerate_adapters", _cpu_only)
        assert app.main(["-numparticles", "256", "-steps", "1"]) == 2
        err = capsys.readouterr().err
        assert "-computeadapter" in err and "-listadapters" in err

    @pytest.mark.parametrize("argv", [
        ["-fused", "-shardrender"], ["-meshdevices", "4"],
    ])
    def test_later_flags_exit_nonzero(self, argv, capsys):
        from multi_adapter_particles_torch import app

        assert app.main(argv + ["-steps", "1"]) == 2
        assert "not yet ported" in capsys.readouterr().err
