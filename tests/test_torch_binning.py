"""The exact sprite binning (`ops/binning.py`, the default `Renderer`), on
the CPU through its plain twin.

- Against the dup-window path raised to the frame's largest span, which
  then drops nothing: bitwise in the image, the transmittance and the
  sorted live stream, over segment sizes, a close-up of giant sprites, the
  chunked fold and the mesh render.
- The entries themselves against a per-sprite loop: keys in particle
  order, each sprite's tiles row-major, the sentinel tail, the capacity's
  overflow counted.
- An overflow past the capacity is counted, and `present()` grows the
  capacity so the next frame draws whole, in the split and the fused
  engine, with the `render_entries` / `render_truncated` gauges.
- A small fused central-well run against the benchmark's plain
  references (`benchmark/reference/central_well.py`, `splat.py`), with
  sprites a 2 x 2 window would cut.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import check
from benchmark.reference import init as ref_init
from multi_adapter_particles_torch.config import (
    AppConfig,
    RenderConfig,
    SimConfig,
)
from multi_adapter_particles_torch.models.state import ParticleState
from multi_adapter_particles_torch.ops.binning import (
    bin_sprites,
    bin_sprites_plain,
)
from multi_adapter_particles_torch.parallel import make_mesh
from multi_adapter_particles_torch.parallel.mesh import shard
from multi_adapter_particles_torch.render import renderer as R
from multi_adapter_particles_torch.render.camera import Camera
from multi_adapter_particles_torch.runtime.fused import FusedEngine
from multi_adapter_particles_torch.runtime.render_engine import RenderEngine
from multi_adapter_particles_torch.utils.metrics import MetricsRegistry

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
W, H = 128, 64
NUM_TILES = (W // R.TILE_W) * (H // R.TILE_H)


def _scene(n, seed, spread=30.0, lo=-1.0, hi=1.0):
    """[4, Np] positions (Np = n padded to 128, parked tail) around the
    origin."""
    rng = np.random.default_rng(seed)
    npad = -(-n // 128) * 128
    pos = np.full((4, npad), 1e9, np.float32)
    pos[3] = 0.0
    pos[:3, :n] = rng.uniform(lo, hi, size=(3, n)) * spread
    pos[3, :n] = rng.uniform(0.0, 9.0, size=n)
    return torch.from_numpy(pos)


def _args(renderer, size, eye=200.0, intensity=0.15):
    return renderer._device_args(Camera(position=(0.0, 0.0, eye)), size,
                                 intensity, torch.device("cpu"))


def _recording_sort(seen):
    def sort(*args):
        out = R.sort_kv_stable(*args)
        seen.append(out)
        return out
    return sort


def _render_both(pos, size, seg_q, eye=200.0, num_draw=None):
    """(exact out, window out, exact sorted, window sorted): one chunk at
    the given seg_q, the window raised to the exact frame's spans."""
    nd = pos.shape[1] if num_draw is None else num_draw
    args = _args(R.Renderer(RenderConfig(width=W, height=H)), size, eye)
    kw = dict(width=W, height=H, seg_q=seg_q, near=1.0, blend="over",
              return_trans=True)
    s_exact, s_window = [], []
    exact = R._render(pos, *args, nd, sort=_recording_sort(s_exact), **kw)
    dup = (max(int(exact.span_y), 1), max(int(exact.span_x), 1))
    window = R._render(pos, *args, nd, dup_y=dup[0], dup_x=dup[1],
                       sort=_recording_sort(s_window), **kw)
    return exact, window, s_exact[0], s_window[0]


def _assert_same_live_stream(a, b, entries):
    """The sorted live stream (keys below num_tiles) of two sorts, bitwise,
    `entries` long in both."""
    for sa, sb in ((a, b), (b, a)):
        assert int((sa[0] < NUM_TILES).sum()) == entries
    for xa, xb in zip(a, b):
        assert torch.equal(xa[:entries], xb[:entries])


@pytest.mark.parametrize("seg_q", [4, 16, 64])
def test_exact_matches_raised_window(seg_q):
    pos = _scene(900, seed=seg_q)
    exact, window, se, sw = _render_both(pos, 10.0, seg_q)
    entries = int(exact.entries)
    assert int(exact.truncated) == int(window.truncated) == 0
    assert (int(exact.span_y), int(exact.span_x)) > (1, 1)
    assert torch.equal(exact.frame, window.frame)
    assert torch.equal(exact.trans, window.trans)
    _assert_same_live_stream(se, sw, entries)
    assert bool((se[0][entries:] == NUM_TILES).all())


def test_exact_draws_giant_close_up_whole():
    """Sprites near the eye spanning many tiles: the 2 x 2 window drops
    their far tiles, the exact binning draws them as the raised window."""
    pos = _scene(24, seed=7, spread=20.0)
    exact, window, se, sw = _render_both(pos, 10.0, 8, eye=60.0)
    assert int(exact.span_y) > 2 or int(exact.span_x) > 2
    assert int(exact.truncated) == 0
    assert torch.equal(exact.frame, window.frame)
    assert torch.equal(exact.trans, window.trans)
    _assert_same_live_stream(se, sw, int(exact.entries))
    args = _args(R.Renderer(RenderConfig(width=W, height=H)), 10.0, 60.0)
    small = R._render(pos, *args, pos.shape[1], width=W, height=H, seg_q=8,
                      near=1.0, blend="over", dup_y=2, dup_x=2)
    assert int(small.truncated) > 0


def test_exact_honours_num_draw_and_id_offset():
    pos = _scene(600, seed=3)
    exact, window, se, sw = _render_both(pos, 10.0, 16, num_draw=333)
    assert torch.equal(exact.frame, window.frame)
    _assert_same_live_stream(se, sw, int(exact.entries))
    args = _args(R.Renderer(RenderConfig(width=W, height=H)), 10.0)
    kw = dict(width=W, height=H, near=1.0, capacity=4 * pos.shape[1])
    draw = torch.tensor(640, dtype=torch.int32)
    a = bin_sprites(pos, *args[:4], 640, 1000, **kw)
    b = bin_sprites(pos, *args[:4], draw, 1000, **kw)
    c = bin_sprites(pos, *args[:4], 640, 0, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(a[0], c[0]) and not torch.equal(a[4], c[4])


def test_exact_chunked_fold_matches_raised_window():
    """The chunked fold (3 chunks of 256), a num_draw cutting mid-chunk."""
    pos = _scene(700, seed=11)
    rend = R.Renderer(RenderConfig(width=W, height=H))
    args = _args(rend, 12.0)
    kw = dict(width=W, height=H, seg_q=16, near=1.0, blend="over",
              chunk_size=256, frame_uint8=False)
    for nd in (pos.shape[1], 500):
        exact = R._chunked_fold(pos, *args, nd, **kw)
        dup = (int(exact.span_y), int(exact.span_x))
        window = R._chunked_fold(pos, *args, nd, dup_y=dup[0], dup_x=dup[1],
                                 **kw)
        assert max(dup) > 2 and int(exact.truncated) == 0
        assert torch.equal(exact.frame, window.frame)
        assert int(exact.entries) > 0
        assert int(window.truncated) == 0 and window.entries is None


@pytest.mark.parametrize("d", [2, 4])
def test_exact_render_mesh_matches_raised_window(d):
    pos = _scene(1024, seed=d)
    cfg = RenderConfig(width=W, height=H)
    mesh = make_mesh(["cpu"] * d)
    exact_r = R.Renderer(cfg, seg_q=16)
    cam = Camera(position=(0.0, 0.0, 200.0))
    exact = exact_r.render_mesh(shard(pos, mesh), cam, 12.0, 0.15, mesh)
    dup = (int(exact.span_y), int(exact.span_x))
    window_r = R.Renderer(cfg, seg_q=16, dup_y=dup[0], dup_x=dup[1])
    window = window_r.render_mesh(shard(pos, mesh), cam, 12.0, 0.15, mesh)
    assert max(dup) > 2 and int(exact.truncated) == 0
    assert torch.equal(exact.frame, window.frame)
    chunked = exact_r.render_arrays(pos, cam, 12.0, 0.15)
    assert int(exact.entries) == int(chunked.entries)


def _loop_entries(pos, args, num_draw, id_offset, capacity):
    """The entries as a per-sprite Python loop over the twin's projection:
    (keys, cx payloads) of the live slots, and the total."""
    wvp, p00, p11, radius = args[:4]
    cx, cy, hx, hy, w = R._project(pos, wvp, p00, p11, float(W), float(H),
                                   radius)
    keys, xs, total = [], [], 0
    for p in range(pos.shape[1]):
        x0, x1 = (int(R._pixel_bound(v, W)) for v in (cx[p] - hx[p],
                                                       cx[p] + hx[p]))
        y0, y1 = (int(R._pixel_bound(v, H)) for v in (cy[p] - hy[p],
                                                       cy[p] + hy[p]))
        if not (p < num_draw and float(w[p]) > 1.0 and x0 < x1 and y0 < y1):
            continue
        for ty in range(y0 // R.TILE_H, (y1 - 1) // R.TILE_H + 1):
            for tx in range(x0 // R.TILE_W, (x1 - 1) // R.TILE_W + 1):
                total += 1
                if len(keys) < capacity:
                    keys.append(ty * (W // R.TILE_W) + tx)
                    xs.append(float(cx[p]))
    return keys, xs, total


@pytest.mark.parametrize("factor", [4, 1])
def test_entries_follow_the_sprites(factor):
    """Each drawn sprite's tiles, row-major, at its offset in particle
    order; the tail holds the sentinel and zero payloads; past the capacity
    the last sprites' entries are dropped and counted."""
    pos = _scene(256, seed=5)
    args = _args(R.Renderer(RenderConfig(width=W, height=H)), 10.0)
    cap = factor * pos.shape[1]
    key, cx, cy, w, cgb, stats = bin_sprites_plain(
        pos, *args[:4], 200, 0, width=W, height=H, near=1.0, capacity=cap)
    keys, xs, total = _loop_entries(pos, args, 200, 0, cap)
    entries, truncated, span_y, span_x = (int(v) for v in stats)
    assert entries == len(keys) == min(total, cap)
    assert truncated == total - entries
    assert (truncated > 0) == (factor == 1)
    assert key[:entries].tolist() == keys
    assert cx[:entries].tolist() == xs
    assert bool((key[entries:] == NUM_TILES).all())
    for a in (cx, cy, w, cgb):
        assert bool((a[entries:] == 0).all())
    assert span_y >= 1 and span_x >= 1


def _giants():
    """Two particles at the origin, the rest parked: drawn at size 5000
    each covers the whole 256 x 256 frame, 512 tiles; the two hold twice
    the 4 x 128 entries' capacity."""
    pos = torch.full((4, 128), 1e9)
    pos[:, :2] = 0.0
    pos[3] = 0.0
    return pos


def test_split_present_grows_the_capacity():
    metrics = MetricsRegistry()
    eng = RenderEngine(RenderConfig(width=256, height=256), "cpu", metrics)
    app = AppConfig(num_particles=2, particle_size=5000.0)
    out = eng.draw(_giants(), app)
    assert (int(out.entries), int(out.truncated)) == (512, 512)
    eng.present()
    assert eng.renderer.entry_factor == 8 and not eng.renderer.window
    assert eng.renderer.last_truncated == 512
    assert metrics.gauges["render_truncated"] == 512
    assert metrics.gauges["render_entries"] == 512
    out = eng.draw(_giants(), app)
    assert (int(out.entries), int(out.truncated)) == (1024, 0)
    eng.present()
    assert metrics.gauges["render_truncated"] == 0
    assert metrics.gauges["render_entries"] == 1024
    assert eng.renderer.entry_factor == 8


def test_fused_present_grows_the_capacity():
    """The fused engine: the growth changes the capture key (a recapture
    on a card), and the next frame draws both sprites whole."""
    cfg = RenderConfig(width=256, height=256)
    metrics = MetricsRegistry()
    eng = FusedEngine(SimConfig(num_particles=2), cfg, "cpu", metrics)
    pos = _giants()
    eng.restore(ParticleState(pos, torch.zeros((3, 128))))
    app = AppConfig(num_particles=2, particle_size=5000.0)
    out = eng.frame(app)
    assert int(out.truncated) == 512
    key0 = eng._key(None)
    eng.present()
    assert eng._key(None) != key0
    assert metrics.gauges["render_truncated"] == 512
    eng.restore(ParticleState(pos, torch.zeros((3, 128))))
    out = eng.frame(app)
    assert (int(out.entries), int(out.truncated)) == (1024, 0)


def test_growth_is_bounded_by_the_entry_budget():
    rend = R.Renderer(RenderConfig(width=256, height=256))
    rend._last_sort_n = 128
    rend.entry_budget = 6 * 128
    assert rend.raise_dup_values(10_000, 32, 16)
    assert rend.entry_factor == 6
    assert not rend.raise_dup_values(10_000, 32, 16)
    assert not rend.raise_dup_values(0, 32, 16)


def test_renderer_takes_both_window_sides_or_neither():
    with pytest.raises(ValueError, match="both"):
        R.Renderer(RenderConfig(width=W, height=H), dup_y=2)
    assert R.Renderer(RenderConfig(width=W, height=H), dup_y=3,
                      dup_x=1).window


def test_fused_central_well_matches_the_references():
    """A fused central-well frame of 2,048 particles at 128 x 64, sprites
    of size 100 (up to three tile rows): state and image against the
    benchmark's float64 references, under `cw-4m-1024`'s limits; the same
    frame through a 2 x 2 window reads over the image's limit."""
    cfg = json.loads((ROOT / "benchmark/configs/cw-4m-1024.json")
                     .read_text())
    cfg.update(num_particles=2048, width=W, height=H)
    mix = {"particle_size": 100.0, "particle_intensity": 0.15}
    ph, cam = cfg["physics"], cfg["camera"]
    start = ref_init.two_clusters(2048, 2**31 + 9, "cpu",
                                  cfg["init"]["spread"], cfg["init"]["speed"])
    limits = cfg["check"]["limits"]
    gaps = {}
    for name, window in (("exact", {}), ("2x2", {"dup_y": 2, "dup_x": 2})):
        rcfg = RenderConfig(width=W, height=H, fov_y=cam["fov_y"],
                            near=cam["near"], far=cam["far"],
                            camera_position=tuple(cam["position"]))
        eng = FusedEngine(
            SimConfig(num_particles=2048, force_model="central_well",
                      dt=ph["dt"], damping=ph["damping"], mass=ph["mass"],
                      softening_squared=ph["softening_squared"]),
            rcfg, "cpu", renderer=R.Renderer(rcfg, **window))
        eng.restore(ParticleState(*(t.clone() for t in start)))
        out = eng.frame(AppConfig(num_particles=2048, **mix))
        after = (eng.state.position, eng.state.velocity, eng.last_frame)
        gaps[name] = check.compare(cfg, mix, start, after, None)
        if name == "exact":
            assert int(out.truncated) == 0
            assert max(int(out.span_y), int(out.span_x)) > 2
    assert not check.verdict(gaps["exact"], limits), gaps
    assert gaps["2x2"]["frame_gap"] > limits["frame_gap"]
    assert gaps["2x2"]["state_gap"] == gaps["exact"]["state_gap"]
