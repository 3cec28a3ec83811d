"""Golden-image corpus for the port's renderer (one device and sharded).

Mirrors tests/test_render_corpus.py (TestSliderCorpus,
TestAdversarialCorpus, TestQuantizedPerceptual) against the port's
`Renderer`, with the JAX package's sequential NumPy rasterizer
(`render/reference.py`) as the golden image and its bound, 2e-3 of a
channel. The adversarial scenes (coincident sprites, one depth plane,
culled and giant sprites) also go through `Renderer.render_mesh` at D = 2
and 4, placed so that their stacks and overlaps straddle a shard boundary:
the fold across shards must keep the id order the golden image draws in.
"""

import math

import numpy as np
import pytest
import torch

from multi_adapter_particles_tpu.config import RenderConfig as JRenderConfig
from multi_adapter_particles_tpu.render import camera as jcam
from multi_adapter_particles_tpu.render import reference as ref

from multi_adapter_particles_torch.config import RenderConfig
from multi_adapter_particles_torch.models.state import (
    PAD_POSITION,
    ParticleState,
)
from multi_adapter_particles_torch.parallel import make_mesh
from multi_adapter_particles_torch.parallel.mesh import shard
from multi_adapter_particles_torch.render import camera as cam
from multi_adapter_particles_torch.render.renderer import Renderer

torch.set_num_threads(1)

BOUND = 2e-3
W, H = 256, 128


def _scene(seed, n=40):
    rng = np.random.default_rng(seed)
    pos = np.zeros((n, 4), dtype=np.float32)
    pos[:, :3] = rng.uniform(-350, 350, size=(n, 3)).astype(np.float32)
    pos[:, 3] = rng.uniform(0, 12, size=n).astype(np.float32)
    return pos


def luma_psnr(a, b) -> float:
    """Perceptual-diff harness: PSNR of the Rec.601 luma plane, dB."""
    w = np.asarray([0.299, 0.587, 0.114])
    ya = np.asarray(a, np.float64) @ w
    yb = np.asarray(b, np.float64) @ w
    mse = np.mean((ya - yb) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(1.0 / mse))


def _cams(yaw_off=None, pitch=None, position=None):
    """(port camera, JAX camera) of the same pose."""
    out = []
    for mod in (cam, jcam):
        c = mod.Camera() if position is None else mod.Camera(
            position=position)
        if yaw_off is not None:
            c.yaw = math.pi + yaw_off
            c.pitch = pitch
        out.append(c)
    return out


def _golden(pos, size, intensity, jc=None, cfg=None):
    cfg = cfg or JRenderConfig(width=W, height=H)
    return ref.render_reference(pos, cfg, camera=jc or jcam.Camera(),
                                particle_size=size,
                                particle_intensity=intensity)


def _render(pos, size, intensity, c=None, cfg=None):
    st = ParticleState.from_aos(pos, np.zeros((pos.shape[0], 3), np.float32))
    r = Renderer(cfg or RenderConfig(width=W, height=H))
    return r.render(st.position, c or cam.Camera(), size, intensity).numpy()


class TestSliderCorpus:
    @pytest.mark.parametrize(
        "size,intensity",
        [(1.0, 0.15), (2.5, 0.5), (6.0, 1.0), (10.0, 2.0), (4.0, 0.05)],
    )
    def test_exact_across_slider_ranges(self, size, intensity):
        pos = _scene(int(size * 10 + intensity * 100))
        golden = _golden(pos, size, intensity)
        frame = _render(pos, size, intensity)
        assert np.abs(frame - golden).max() < BOUND
        assert luma_psnr(frame, golden) > 60.0

    @pytest.mark.parametrize("dist", [400.0, 900.0, 2200.0])
    def test_exact_across_camera_distance(self, dist):
        pos = _scene(3)
        c, jc = _cams(position=(0.0, 0.0, dist))
        golden = _golden(pos, 6.0, 0.5, jc)
        frame = _render(pos, 6.0, 0.5, c)
        assert np.abs(frame - golden).max() < BOUND


def _coincident():
    """Stacks of EXACT position duplicates (8 sprites a point): every sort
    key ties and the over-blend is order-sensitive."""
    rng = np.random.default_rng(7)
    stacks = rng.uniform(-200, 200, size=(6, 3)).astype(np.float32)
    pos = np.zeros((48, 4), dtype=np.float32)
    pos[:, :3] = np.repeat(stacks, 8, axis=0)
    pos[:, 3] = rng.uniform(0, 12, size=48).astype(np.float32)
    return pos


def _equal_depth():
    """All sprites on one eye-space depth, overlapping across tiles."""
    xs = np.linspace(-240, 240, 9, dtype=np.float32)
    ys = np.linspace(-120, 120, 5, dtype=np.float32)
    gx, gy = np.meshgrid(xs, ys)
    pos = np.zeros((gx.size, 4), dtype=np.float32)
    pos[:, 0] = gx.ravel()
    pos[:, 1] = gy.ravel()
    pos[:, 3] = np.arange(gx.size, dtype=np.float32) % 13
    return pos


def _behind_and_giant():
    """Sprites behind the eye, near-eye giants straddling many tiles and
    the frame edge, and normal sprites, in one scene."""
    pos = np.zeros((12, 4), dtype=np.float32)
    pos[:, 3] = np.arange(12, dtype=np.float32)
    pos[0, :3] = (0.0, 0.0, 2000.0)
    pos[1, :3] = (300.0, 100.0, 1700.0)
    pos[2, :3] = (0.0, 0.0, 1400.0)
    pos[3, :3] = (-350.0, -160.0, 1350.0)
    rng = np.random.default_rng(21)
    pos[4:, :3] = rng.uniform(-300, 300, size=(8, 3)).astype(np.float32)
    return pos


# (scene, size, intensity, columns it starts before the first shard
# boundary): the coincident stack 124..131 and the plane's rows straddle it
ADVERSARIAL = {
    "coincident": (_coincident, 6.0, 0.5, 28),
    "equal_depth": (_equal_depth, 9.0, 0.8, 20),
    "behind_and_giant": (_behind_and_giant, 8.0, 0.4, 6),
}


class TestAdversarialCorpus:
    """Draw order is particle-id order with no depth test (`Render.cpp:891`,
    one DrawInstanced call): ties must composite in id order."""

    def test_exact_with_coincident_particles(self):
        pos = _coincident()
        golden = _golden(pos, 6.0, 0.5)
        assert np.abs(_render(pos, 6.0, 0.5) - golden).max() < BOUND
        # order sensitivity is real: reversed draw order changes the image
        rev = _golden(pos[::-1].copy(), 6.0, 0.5)
        assert np.abs(rev - golden).max() > 1e-3

    def test_exact_on_equal_depth_plane(self):
        pos = _equal_depth()
        golden = _golden(pos, 9.0, 0.8)
        assert np.abs(_render(pos, 9.0, 0.8) - golden).max() < BOUND

    def test_exact_with_behind_camera_and_giant_sprites(self):
        pos = _behind_and_giant()
        golden = _golden(pos, 8.0, 0.4)
        assert np.abs(_render(pos, 8.0, 0.4) - golden).max() < BOUND
        assert _golden(pos[:2], 8.0, 0.4).max() == 0.0

    @pytest.mark.parametrize(
        "yaw_off,pitch",
        [(0.7, 0.0), (0.0, 0.9), (2.4, -0.8), (3.14159, 0.0)],
    )
    def test_exact_under_extreme_poses(self, yaw_off, pitch):
        pos = _scene(int(yaw_off * 10 + pitch * 100) & 0x7fffffff, n=60)
        c, jc = _cams(yaw_off, pitch, position=(200.0, -300.0, 1100.0))
        golden = _golden(pos, 7.0, 0.6, jc)
        assert np.abs(_render(pos, 7.0, 0.6, c) - golden).max() < BOUND


def _placed(scene, d, before):
    """The scene in a parked [128 d, 4] state, starting `before` columns
    ahead of the first shard boundary (column 128)."""
    n = 128 * d
    full = np.full((n, 4), PAD_POSITION, np.float32)
    full[:, 3] = 0.0
    lo = 128 - before
    full[lo:lo + scene.shape[0]] = scene
    return full


class TestAdversarialOnMesh:
    @pytest.mark.parametrize("d", [2, 4])
    @pytest.mark.parametrize("name", sorted(ADVERSARIAL))
    def test_sharded_render_exact(self, name, d):
        make, size, intensity, before = ADVERSARIAL[name]
        pos = _placed(make(), d, before)
        golden = _golden(pos, size, intensity)
        st = ParticleState.from_aos(pos, np.zeros((pos.shape[0], 3),
                                                  np.float32))
        mesh = make_mesh(["cpu"] * d)
        cfg = RenderConfig(width=W, height=H)
        r = Renderer(cfg)
        out = r.render_mesh(shard(st.position, mesh), cam.Camera(), size,
                            intensity, mesh)
        if r.raise_dup_for(out):  # giants: the lossless re-render
            out = r.render_mesh(shard(st.position, mesh), cam.Camera(),
                                size, intensity, mesh)
        assert int(out.truncated) == 0
        assert np.abs(out.frame.numpy() - golden).max() < BOUND
        assert golden.max() > 0.0


class TestQuantizedPerceptual:
    def test_rgb8_frame_is_perceptually_lossless(self):
        """RGB8 quantization (frame_uint8) vs the fp32 frame: > 48 dB luma
        PSNR (perceptual quality is the contract, not pixel identity)."""
        pos = _scene(9, n=80)
        f32 = _render(pos, 6.0, 0.8)
        f8 = _render(pos, 6.0, 0.8,
                     cfg=RenderConfig(width=W, height=H, frame_uint8=True))
        assert luma_psnr(f8.astype(np.float64) / 255.0, f32) > 48.0
