"""Renderer parity of the torch port against the JAX package.

The same positions, camera and scalars go through the JAX `_render` (its
XLA-scan composite on the CPU) and the port's `_render` (the composite
kernel's plain twin on the CPU). Frames agree to 2e-5 (the tolerance
tests/test_render.py holds the chunked fold to); the integer outputs —
truncated, span_y and span_x — are bitwise. Part 2,
`test_torch_render_engine.py`, covers the fold, the Renderer class, the
virtual-row map and present()."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multi_adapter_particles_tpu.render import renderer as jr

from multi_adapter_particles_torch.config import RenderConfig
from multi_adapter_particles_torch.render import camera as tcam
from multi_adapter_particles_torch.render import renderer as tr

# The suite runs one xdist worker per core; torch's own thread pool on top
# only oversubscribes them.
torch.set_num_threads(1)


def _positions(n, seed, spread=300.0, pad_to=None):
    rng = np.random.default_rng(seed)
    npad = pad_to or -(-n // 128) * 128
    pos = np.full((4, npad), 1e9, np.float32)
    pos[3] = 0.0
    pos[:3, :n] = rng.uniform(-spread, spread, size=(3, n)).astype(np.float32)
    pos[3, :n] = rng.uniform(0, 12, size=n).astype(np.float32)
    return pos


def _scalars(width, height, size, intensity):
    """(jax args, torch args): wvp, p00, p11, radius, intensity."""
    cfg = RenderConfig(width=width, height=height)
    cam = tcam.Camera()
    proj = cam.projection_matrix(cfg.aspect, cfg.fov_y, cfg.near, cfg.far)
    wvp = cam.world_view_projection(cfg.aspect, fov_y=cfg.fov_y,
                                    near=cfg.near, far=cfg.far)
    vals = (abs(proj[0, 0]), abs(proj[1, 1]), size, intensity)
    j = (jnp.asarray(wvp),) + tuple(jnp.float32(x) for x in vals)
    t = (torch.tensor(wvp),) + tuple(
        torch.tensor(float(np.float32(x)), dtype=torch.float32) for x in vals)
    return cfg, j, t


def _compare(jout, tout, atol=2e-5):
    np.testing.assert_allclose(tout.frame.numpy(), np.asarray(jout.frame),
                               rtol=0, atol=atol)
    for name in ("truncated", "span_y", "span_x"):
        assert int(getattr(tout, name)) == int(getattr(jout, name)), name
    if jout.trans is not None:
        np.testing.assert_allclose(tout.trans.numpy(),
                                   np.asarray(jout.trans), rtol=0, atol=atol)


class TestRenderParity:
    @pytest.mark.parametrize("width,height,seg_q,blend", [
        (64, 32, 8, "over"), (64, 32, 32, "over"), (128, 64, 8, "over"),
        (128, 64, 32, "over"), (128, 64, 8, "additive"),
    ])
    def test_frame_matches_jax(self, width, height, seg_q, blend):
        n = 300
        pos = _positions(n, seed=width + seg_q)
        cfg, j, t = _scalars(width, height, 40.0, 0.4)
        kw = dict(width=width, height=height, seg_q=seg_q, dup_y=2, dup_x=2,
                  near=cfg.near, blend=blend)
        jout = jr._render(jnp.asarray(pos), *j, jnp.int32(n),
                          use_pallas_composite=False, **kw)
        tout = tr._render(torch.from_numpy(pos), *t, n, **kw)
        _compare(jout, tout)
        assert float(tout.frame.max()) > 0

    @pytest.mark.parametrize("seg_q", [8, 32])
    def test_truncation_counts_bitwise(self, seg_q):
        """Sprites far bigger than the 2x2 tile window: truncated > 0 and
        the spans that drive the auto-raise, bitwise."""
        n = 40
        pos = _positions(n, seed=11, spread=200.0)
        cfg, j, t = _scalars(128, 64, 250.0, 0.3)
        kw = dict(width=128, height=64, seg_q=seg_q, dup_y=2, dup_x=2,
                  near=cfg.near, blend="over")
        jout = jr._render(jnp.asarray(pos), *j, jnp.int32(n),
                          use_pallas_composite=False, **kw)
        tout = tr._render(torch.from_numpy(pos), *t, n, **kw)
        assert int(tout.truncated) > 0
        _compare(jout, tout)

    def test_num_draw_id_offset_trans_uint8(self):
        """A num_draw prefix, a global id offset (the chunk color rule),
        the return_trans fold state and the uint8 frame."""
        n = 500
        pos = _positions(n, seed=5)
        cfg, j, t = _scalars(128, 64, 40.0, 0.4)
        kw = dict(width=128, height=64, seg_q=16, dup_y=2, dup_x=2,
                  near=cfg.near, blend="over")
        jout = jr._render(jnp.asarray(pos), *j, jnp.int32(321),
                          jnp.int32(4000), use_pallas_composite=False,
                          return_trans=True, **kw)
        tout = tr._render(torch.from_numpy(pos), *t, 321, 4000,
                          return_trans=True, **kw)
        _compare(jout, tout)
        j8 = jr._render(jnp.asarray(pos), *j, jnp.int32(n),
                        use_pallas_composite=False, frame_uint8=True, **kw)
        t8 = tr._render(torch.from_numpy(pos), *t, n, frame_uint8=True, **kw)
        assert t8.frame.dtype == torch.uint8
        diff = np.abs(t8.frame.numpy().astype(int)
                      - np.asarray(j8.frame).astype(int))
        assert diff.max() <= 1  # a 2e-5 color difference may cross .5 LSB
