"""The port's mesh-sharded render against the JAX package's `render_mesh`.

Mirrors tests/test_render_mesh.py (TestRenderMesh). Each rank renders its
id-contiguous shard to a (color, transmittance) pair and the pairs fold in
id order, so the frame is BITWISE the port's chunked render at the
matching partition (the same `_render` per chunk, the same fold); it is
within 2e-5 of the JAX package's `render_mesh` on its 8-device CPU mesh
(the tolerance tests/test_torch_render.py holds the two renderers to) and
within 2e-3 of the single-pass frame (blend reassociation). The
orchestrator runs on a test-only list of 8 CPU adapters.
"""

import json

import numpy as np
import pytest
import torch

from multi_adapter_particles_tpu import parallel as jpar
from multi_adapter_particles_tpu.config import RenderConfig as JRenderConfig
from multi_adapter_particles_tpu.models.state import ParticleState as JState
from multi_adapter_particles_tpu.parallel.mesh import (
    make_multislice_mesh as jmultislice,
)
from multi_adapter_particles_tpu.render import camera as jcam
from multi_adapter_particles_tpu.render.renderer import Renderer as JRenderer

from multi_adapter_particles_torch import app as cli
from multi_adapter_particles_torch.config import (
    AppConfig,
    RenderConfig,
    SimConfig,
)
from multi_adapter_particles_torch.models.state import ParticleState
from multi_adapter_particles_torch.parallel import (
    make_mesh,
    make_multislice_mesh,
)
from multi_adapter_particles_torch.parallel.mesh import shard
from multi_adapter_particles_torch.render import camera as cam
from multi_adapter_particles_torch.render.renderer import Renderer
from multi_adapter_particles_torch.runtime import devices
from multi_adapter_particles_torch.runtime.orchestrator import ParticlesApp

torch.set_num_threads(1)

N = 2048  # 8 shards x 256


def _aos(seed=5, n=N, spread=350.0):
    rng = np.random.default_rng(seed)
    pos = np.zeros((n, 4), dtype=np.float32)
    pos[:, :3] = rng.uniform(-spread, spread, size=(n, 3)).astype(np.float32)
    pos[:, 3] = rng.uniform(0, 12, size=n).astype(np.float32)
    return pos


def _state(pos):
    return ParticleState.from_aos(pos, np.zeros((pos.shape[0], 3),
                                                np.float32))


def _mesh(d):
    return make_mesh(["cpu"] * d)


def _jax_mesh_frame(pos, jmesh, cfg, size, intensity, num_draw=None):
    st = JState.from_aos(pos, np.zeros((pos.shape[0], 3), np.float32))
    sh = jpar.shard_state(st, jmesh)
    out = JRenderer(JRenderConfig(width=cfg.width, height=cfg.height)) \
        .render_mesh(sh.position, jcam.Camera(), size, intensity, jmesh,
                     num_draw=num_draw)
    return out


def eight_cpus():
    return [devices.AdapterInfo(i, torch.device("cpu"), "cpu",
                                f"cpu (id {i})") for i in range(8)]


@pytest.fixture
def cpus(monkeypatch):
    monkeypatch.setattr(devices, "enumerate_adapters", eight_cpus)


class TestRenderMesh:
    def test_equals_chunked_at_matching_partition(self, eight_devices):
        pos = _aos()
        st = _state(pos)
        mesh = _mesh(8)
        cfg = RenderConfig(width=256, height=128)
        out_m = Renderer(cfg).render_mesh(shard(st.position, mesh),
                                          cam.Camera(), 4.0, 0.4, mesh)
        r_chunk = Renderer(cfg)
        r_chunk.chunk_threshold = N - 1    # force the chunked path
        r_chunk.chunk_size = N // 8        # same partition as the mesh
        out_c = r_chunk.render_arrays(st.position, cam.Camera(), 4.0, 0.4)
        assert torch.equal(out_m.frame, out_c.frame)
        for name in ("truncated", "span_y", "span_x"):
            assert int(getattr(out_m, name)) == int(getattr(out_c, name))
        jout = _jax_mesh_frame(pos, jpar.make_mesh(eight_devices), cfg, 4.0,
                               0.4)
        np.testing.assert_allclose(out_m.frame.numpy(),
                                   np.asarray(jout.frame), rtol=0, atol=2e-5)
        for name in ("truncated", "span_y", "span_x"):
            assert int(getattr(out_m, name)) == int(getattr(jout, name))

    def test_close_to_single_pass_frame(self):
        st = _state(_aos(seed=9))
        mesh = _mesh(4)
        cfg = RenderConfig(width=256, height=128)
        out_m = Renderer(cfg).render_mesh(shard(st.position, mesh),
                                          cam.Camera(), 5.0, 0.6, mesh)
        single = Renderer(cfg).render_arrays(st.position, cam.Camera(), 5.0,
                                             0.6)
        np.testing.assert_allclose(out_m.frame.numpy(), single.frame.numpy(),
                                   atol=2e-3)

    def test_multislice_mesh(self, eight_devices):
        pos = _aos(seed=3)
        st = _state(pos)
        mesh = make_multislice_mesh(2, ["cpu"] * 8)
        cfg = RenderConfig(width=128, height=64)
        out_m = Renderer(cfg).render_mesh(shard(st.position, mesh),
                                          cam.Camera(), 4.0, 0.5, mesh)
        single = Renderer(cfg).render_arrays(st.position, cam.Camera(), 4.0,
                                             0.5)
        np.testing.assert_allclose(out_m.frame.numpy(), single.frame.numpy(),
                                   atol=2e-3)
        jout = _jax_mesh_frame(pos, jmultislice(2, eight_devices), cfg, 4.0,
                               0.5)
        np.testing.assert_allclose(out_m.frame.numpy(),
                                   np.asarray(jout.frame), rtol=0, atol=2e-5)

    def test_num_draw_prefix_crosses_shards(self, eight_devices):
        """num_draw is a GLOBAL id prefix: a count landing mid-shard draws
        all of shards 0..k-1, part of shard k, none after."""
        pos = _aos(seed=11)
        st = _state(pos)
        mesh = _mesh(8)
        cfg = RenderConfig(width=256, height=128)
        nd = N // 8 * 3 + 64
        out_m = Renderer(cfg).render_mesh(shard(st.position, mesh),
                                          cam.Camera(), 4.0, 0.4, mesh,
                                          num_draw=nd)
        single = Renderer(cfg).render_arrays(st.position, cam.Camera(), 4.0,
                                             0.4, num_draw=nd)
        np.testing.assert_allclose(out_m.frame.numpy(), single.frame.numpy(),
                                   atol=2e-3)
        full = Renderer(cfg).render_arrays(st.position, cam.Camera(), 4.0,
                                           0.4)
        assert (full.frame - single.frame).abs().max() > 1e-3
        jout = _jax_mesh_frame(pos, jpar.make_mesh(eight_devices), cfg, 4.0,
                               0.4, num_draw=nd)
        np.testing.assert_allclose(out_m.frame.numpy(),
                                   np.asarray(jout.frame), rtol=0, atol=2e-5)

    def test_span_metrics_aggregate_across_shards(self):
        """A giant sprite in a LATE shard surfaces in the folded span and
        truncated scalars (the auto-raise feed), on the dup-window path
        (the window given, as the JAX package's)."""
        pos = _aos(seed=13)
        pos[N - 10, :3] = (0.0, 0.0, 1400.0)  # 100 units from the eye
        mesh = _mesh(8)
        sh = shard(_state(pos).position, mesh)
        cfg = RenderConfig(width=256, height=128)
        r = Renderer(cfg, dup_y=2, dup_x=2)
        out = r.render_mesh(sh, cam.Camera(), 8.0, 0.4, mesh)
        assert int(out.truncated) > 0
        assert int(out.span_y) > r.dup_y or int(out.span_x) > r.dup_x
        # raise_dup_for budgets against the SHARD sort size, then a
        # re-render is lossless
        assert r.raise_dup_for(out)
        out2 = r.render_mesh(sh, cam.Camera(), 8.0, 0.4, mesh)
        assert int(out2.truncated) == 0

    def test_app_pipeline_matches_gather_path(self, cpus):
        """-meshdevices 8 -shardrender draws the frames of the mesh +
        gather pipeline (to the blend's reassociation)."""

        def run(shard_render):
            app = ParticlesApp(
                AppConfig(num_particles=N, gui=False, vsync=False),
                SimConfig(num_particles=N),
                RenderConfig(width=256, height=128),
                seed=4, mesh_devices=8, shard_render=shard_render,
                compute_adapter=0,
            )
            banner = app.metrics.gauges["mode_banner"]
            for _ in range(3):
                app.draw()
            app.compute.wait_for_gpu()
            app.render.present()
            frame = app.render.last_frame.numpy()
            tb = app.metrics.counters.get("transfer_bytes", 0.0)
            app.shutdown()
            return frame, banner, tb

        f_sh, b_sh, tb_sh = run(True)
        f_ga, b_ga, tb_ga = run(False)
        np.testing.assert_allclose(f_sh, f_ga, atol=2e-3)
        assert "sharded render" in b_sh and "sharded render" not in b_ga
        # traffic: image pairs (O(pixels x devices)) vs the position copy
        assert tb_sh == 3 * 8 * 256 * 128 * 16
        assert tb_ga == 3 * N * 16

    def test_shard_render_survives_elastic_rescale(self, cpus):
        """Rescale 8 -> 2 -> 1 with -shardrender: the render follows the
        mesh (sharded at 8 and 2, the gather at 1) and the last frame is
        a never-sharded run's to the blend's reassociation."""

        def make(mesh_devices, shard_render):
            return ParticlesApp(
                AppConfig(num_particles=N, gui=False, vsync=False),
                SimConfig(num_particles=N),
                RenderConfig(width=128, height=64),
                seed=6, mesh_devices=mesh_devices, shard_render=shard_render,
                compute_adapter=0,
            )

        app = make(8, True)
        assert "sharded render" in app.metrics.gauges["mode_banner"]
        for _ in range(2):
            app.draw()
        app.set_mesh_devices(2)
        assert app.render.mesh is not None and app.render.mesh.size == 2
        for _ in range(2):
            app.draw()
        app.set_mesh_devices(1)
        assert app.render.mesh is None
        for _ in range(2):
            app.draw()
        app.compute.wait_for_gpu()
        app.render.present()
        frame = app.render.last_frame.numpy()
        state = app.compute.state.position.clone()
        app.shutdown()

        ref = make(0, False)
        for _ in range(6):
            ref.draw()
        ref.render.present()
        assert torch.equal(state, ref.compute.state.position)
        np.testing.assert_allclose(frame, ref.render.last_frame.numpy(),
                                   atol=2e-3)
        ref.shutdown()

    def test_cli_flag_end_to_end(self, tmp_path, cpus):
        metrics = str(tmp_path / "m.json")
        rc = cli.main([
            "-numparticles", "1024", "-steps", "2", "-novsync", "-nogui",
            "-width", "128", "-height", "64", "-meshdevices", "8",
            "-shardrender", "-metrics", metrics, "-computeadapter", "0",
        ])
        assert rc == 0
        m = json.loads(open(metrics).read())
        assert "sharded render" in m["gauges"]["mode_banner"]

    def test_preset_1m_mesh8_at_small_count(self, cpus):
        """`-preset 1m-mesh8` (all_pairs on 8 shards), its count cut by a
        later flag, bitwise the one-device `-rectpair` run."""
        seen = {}

        def grab(key):
            return lambda p: seen.update({key: (
                p.compute, p.compute.state.position.clone())})

        common = ["-numparticles", "1024", "-steps", "2", "-width", "64",
                  "-height", "64", "-computeadapter", "0"]
        assert cli.main(["-preset", "1m-mesh8"] + common,
                        on_exit=grab("mesh")) == 0
        assert cli.main(["-force", "all_pairs", "-rectpair", "-nogui",
                         "-novsync"] + common, on_exit=grab("one")) == 0
        eng, pos = seen["mesh"]
        assert eng.mesh.size == 8 and eng.config.force_model == "all_pairs"
        assert eng.get_fence_value() == 2
        assert torch.equal(pos, seen["one"][1])

    def test_rejects_unaligned_counts(self):
        mesh = _mesh(8)
        st = _state(_aos(n=1024 + 128))     # 1152: not divisible by 8 x 128
        sh = shard(st.position, make_mesh(["cpu"] * 9))
        with pytest.raises(ValueError, match="divisible"):
            Renderer(RenderConfig(width=128, height=64)).render_mesh(
                sh, cam.Camera(), 4.0, 0.4, mesh)
