"""Renderer parity of the torch port against the JAX package, part 2:
the chunked (C, T) fold, the `Renderer` class (adaptive seg_q, dup
auto-raise), the virtual-row map (bitwise) and the render engine's
present(). Part 1, `test_torch_render.py`, holds `_render` itself."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multi_adapter_particles_tpu.config import RenderConfig as JRenderConfig
from multi_adapter_particles_tpu.render import camera as jcam
from multi_adapter_particles_tpu.render import renderer as jr

from multi_adapter_particles_torch.config import RenderConfig
from multi_adapter_particles_torch.render import camera as tcam
from multi_adapter_particles_torch.render import renderer as tr

from test_torch_render import _compare, _positions, _scalars

# The suite runs one xdist worker per core; torch's own thread pool on top
# only oversubscribes them.
torch.set_num_threads(1)


def test_chunked_fold_matches_jax():
    """The associative (C, T) fold at a tiny chunk size, against the
    JAX package's at the same partition (a divisor-free N and a
    num_draw prefix that cuts mid-chunk)."""
    n = 640
    pos = _positions(n, seed=33)
    cfg, j, t = _scalars(128, 64, 40.0, 0.4)
    kw = dict(width=128, height=64, seg_q=8, dup_y=2, dup_x=2,
              near=cfg.near, blend="over", chunk_size=256,
              frame_uint8=False)
    for nd in (n, 300):
        jout = jr._chunked_fold(jnp.asarray(pos), *j, jnp.int32(nd),
                                use_pallas_composite=False, **kw)
        tout = tr._chunked_fold(torch.from_numpy(pos), *t, nd, **kw)
        _compare(jout, tout)
    assert tr._chunk_width(n, 256) == jr._chunk_width(n, 256)


def test_renderer_class_matches_jax():
    """`Renderer.render` (adaptive seg_q, the auto-raise re-render) on
    a close-up that truncates at the default window."""
    rng = np.random.default_rng(7)
    n = 24
    aos = np.zeros((n, 4), np.float32)
    aos[:, :3] = rng.uniform(-20, 20, size=(n, 3))
    aos[:, 3] = rng.uniform(0, 9, size=n)
    pos = np.full((4, 128), 1e9, np.float32)
    pos[3] = 0
    pos[:, :n] = aos.T
    jrend = jr.Renderer(JRenderConfig(width=128, height=64))
    trend = tr.Renderer(RenderConfig(width=128, height=64))
    jframe = jrend.render(jnp.asarray(pos),
                          jcam.Camera(position=(0.0, 0.0, 60.0)), 10.0,
                          0.15)
    tframe = trend.render(torch.from_numpy(pos),
                          tcam.Camera(position=(0.0, 0.0, 60.0)), 10.0,
                          0.15)
    assert (trend.dup_y, trend.dup_x) == (jrend.dup_y, jrend.dup_x)
    assert (trend.dup_y, trend.dup_x) > (2, 2)
    assert trend.last_truncated == jrend.last_truncated == 0
    np.testing.assert_allclose(tframe.numpy(), np.asarray(jframe),
                               rtol=0, atol=2e-5)


def test_resolve_seg_q_matches_jax():
    for w, h in ((1024, 1024), (128, 64)):
        a = jr.Renderer(JRenderConfig(width=w, height=h))
        b = tr.Renderer(RenderConfig(width=w, height=h))
        for n in (1000, 262_144, 1_048_576, 4_194_304):
            assert b.resolve_seg_q(n) == a.resolve_seg_q(n)
    assert tr.Renderer().resolve_seg_q(1_048_576) == 256
    assert tr.Renderer().resolve_seg_q(262_144) == 64


def _jax_merge_map(starts, counts, segs, row_end, num_rows):
    """The JAX package's merge-sort virtual-row map, as written in its
    `_render` (render/renderer.py:363-390)."""
    num_tiles = row_end.shape[0]
    v = jnp.arange(num_rows, dtype=jnp.int32)
    zq = jnp.zeros((num_rows,), jnp.int32)
    mkey = jnp.concatenate([row_end, v])
    mflag = jnp.concatenate([jnp.ones((num_tiles,), jnp.int32), zq])
    d_sta = jnp.concatenate([counts, zq])
    d_end = jnp.concatenate([counts[1:], jnp.zeros((1,), jnp.int32), zq])
    d_rs = jnp.concatenate([segs.astype(jnp.int32), zq])
    _, sf, sd1, sd2, sd3 = jax.lax.sort(
        (mkey, mflag, d_sta, d_end, d_rs), dimension=0, num_keys=1,
        is_stable=True)
    _, tile_m, s1m, s2m, s3m = jax.lax.sort(
        (sf, jnp.cumsum(sf), jnp.cumsum(sd1), jnp.cumsum(sd2),
         jnp.cumsum(sd3)), dimension=0, num_keys=1, is_stable=True)
    return (tile_m[:num_rows], s1m[:num_rows], s2m[:num_rows] + starts[1],
            s3m[:num_rows])


@pytest.mark.parametrize("seed,q", [(0, 8), (1, 32), (2, 4)])
def test_virtual_row_map_bitwise(seed, q):
    """searchsorted + gathers reproduce the merge-sort map's integers."""
    rng = np.random.default_rng(seed)
    num_tiles = 64
    # sorted tile keys with empty tiles, hot tiles and the sentinel tail
    keys = np.sort(np.concatenate([
        rng.integers(0, num_tiles, size=700),
        np.full(40, 17), np.full(90, num_tiles),
    ])).astype(np.float32)
    starts = np.searchsorted(keys, np.arange(num_tiles + 1), "left").astype(
        np.int32)
    counts = starts[1:] - starts[:-1]
    ends = starts[1:]
    j_lo = starts[:-1] // q
    j_hi = np.where(counts > 0, (ends - 1) // q, j_lo)
    segs = np.where(counts > 0, j_hi - j_lo + 1, 1).astype(np.int32)
    row_end = np.cumsum(segs).astype(np.int32)
    row_start = (row_end - segs).astype(np.int32)
    num_rows = num_tiles + -(-keys.size // q)
    want = _jax_merge_map(*(jnp.asarray(a) for a in (starts, counts, segs,
                                                     row_end)), num_rows)
    got = tr.virtual_rows(torch.from_numpy(starts), torch.from_numpy(row_end),
                          torch.from_numpy(row_start), num_rows)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_present_raises_dup_for_future_frames():
    """present()'s one packed read (fence + truncated + spans) grows the
    dup window, so the NEXT frame is lossless — as the JAX render engine
    does (tests/test_render.py::test_present_raises_for_future_frames)."""
    from multi_adapter_particles_torch.config import AppConfig
    from multi_adapter_particles_torch.runtime.render_engine import (
        RenderEngine,
    )

    pos = torch.full((4, 128), 1e9)
    pos[:, 0] = 0.0
    pos[3] = 0.0
    eng = RenderEngine(RenderConfig(width=256, height=256), "cpu")
    app = AppConfig(num_particles=1, particle_size=200.0)
    assert int(eng.draw(pos, app).truncated) > 0
    eng.present()
    assert (eng.renderer.dup_y, eng.renderer.dup_x) > (2, 2)
    assert int(eng.draw(pos, app).truncated) == 0
