"""The render composite `composite_tiles` of the torch port.

- `_render` through `composite_tiles_plain` (what the wrapper runs for a
  CPU tensor) against the JAX `_render` (its XLA-scan composite on the
  CPU), on a clustered scene whose hot tiles span nine or more data rows
  at Q = 8 (a fold three or more levels deep) and on a sparse scene with
  empty tiles, in both blends, as a frame and in the `return_trans` form.
- The fold order the CUDA fold kernel relies on: a sequential
  binary-counter stack fold is bitwise the eager tree passes
  (`tree_combine`) for 1 to 70 rows a tile.
- A host model of the two kernels (each row's live slots read straight
  from the sorted streams, dead slots skipped; each warp's 32-pixel block
  blending only the slots whose disc reaches it, from its own list; each
  tile's rows folded by the stack) is bitwise `composite_tiles_plain` on
  real scenes and on chip_smoke's adversarial ones (`TILE_SCENES`: disc
  edges exactly 0.5 from a pixel centre on a block border, zeroed
  1/(2h), sprites over the whole tile, zero alpha scale, two stages of
  slots, a scale past 2, tiles that do not split into 8 x 4 blocks), and
  counts the blends the plain version counts.
- The reach test (`reach_blocks`) against brute force: it keeps exactly
  the (slot, block) pairs where some pixel's distance is below 0.5, so it
  never skips a pixel of nonzero alpha; `render_blend_share` reads that
  count over entries x blocks.
- The wrapper: CPU tensors take the plain version;
  other devices, shapes and dtypes raise.

The CUDA kernels are held bitwise against the plain version on the card
by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke

from multi_adapter_particles_tpu.render import renderer as jr

from multi_adapter_particles_torch.config import AppConfig, RenderConfig
from multi_adapter_particles_torch.ops import composite as comp
from multi_adapter_particles_torch.render import renderer as tr
from multi_adapter_particles_torch.runtime.render_engine import RenderEngine
from multi_adapter_particles_torch.utils.metrics import MetricsRegistry

from test_torch_render import _compare, _positions, _scalars

# The suite runs one xdist worker per core; torch's own thread pool on top
# only oversubscribes them.
torch.set_num_threads(1)

WIDTH, HEIGHT = 128, 64


def _clustered(n, seed, spread=6.0):
    """A tight cluster in front of the camera: a few hot tiles hold most
    entries (many data rows each at a small Q)."""
    pos = _positions(n, seed)
    rng = np.random.default_rng(seed + 100)
    pos[:3, :n] = rng.normal(0.0, spread, size=(3, n)).astype(np.float32)
    return pos


SCENES = {
    # (positions, seg_q, sprite size)
    "clustered": (lambda: _clustered(700, 3), 8, 20.0),
    "sparse": (lambda: _positions(12, 4, spread=150.0), 8, 30.0),
}


def _composite_args(pos, t, n, seg_q, blend):
    """`_render` on the CPU with the composite's arguments recorded."""
    seen = {}

    def record(*args, **kw):
        seen["args"], seen["kw"] = args, kw
        return comp.composite_tiles(*args, **kw)

    out = tr._render(torch.from_numpy(pos), *t, n, width=WIDTH,
                     height=HEIGHT, seg_q=seg_q, dup_y=2, dup_x=2, near=1.0,
                     blend=blend, return_trans=True, composite=record)
    return out, seen["args"], seen["kw"]


@pytest.mark.parametrize("form", ["frame", "trans"])
@pytest.mark.parametrize("blend", ["over", "additive"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_render_matches_jax(scene, blend, form):
    make, seg_q, size = SCENES[scene]
    pos = make()
    n = pos.shape[1]
    cfg, j, t = _scalars(WIDTH, HEIGHT, size, 0.4)
    _, args, _ = _composite_args(pos, t, n, seg_q, blend)
    row_start, row_end = args[9], args[10]
    segs = row_end - row_start
    starts = args[4]
    counts = starts[1:] - starts[:-1]
    if scene == "clustered":
        assert int(segs.max()) >= 9      # a stack three levels deep
    else:
        assert int((counts == 0).sum()) > 0 and int(counts.max()) > 0
    kw = dict(width=WIDTH, height=HEIGHT, seg_q=seg_q, dup_y=2, dup_x=2,
              near=cfg.near, blend=blend, return_trans=form == "trans")
    jout = jr._render(jnp.asarray(pos), *j, jnp.int32(n),
                      use_pallas_composite=False, **kw)
    tout = tr._render(torch.from_numpy(pos), *t, n, **kw)
    _compare(jout, tout)
    assert float(tout.frame.max()) > 0


def _stack_fold(rows, blend):
    """Rows (c0, c1, c2, t) in draw order, folded left to right with a
    binary-counter stack: push each row; while the two top blocks cover
    equal counts, merge them; at the end merge right to left."""
    def merge(e, l):
        if blend == "over":
            return ([e[c] * l[3] + l[c] for c in range(3)]
                    + [e[3] * l[3]])
        return [e[c] + l[c] for c in range(3)] + [e[3]]

    stack = []   # (count, block)
    for row in rows:
        cur, count = row, 1
        while stack and stack[-1][0] == count:
            cur, count = merge(stack.pop()[1], cur), 2 * count
        stack.append((count, cur))
    cur = stack.pop()[1]
    while stack:
        cur = merge(stack.pop()[1], cur)
    return cur


@pytest.mark.parametrize("blend", ["over", "additive"])
def test_stack_fold_is_the_tree_order(blend):
    """Tiles of 1..70 rows side by side: each tile's segment-0 row after
    the eager passes equals the stack fold of its rows, bit for bit."""
    rng = np.random.default_rng(5)
    px = 128
    sizes = list(range(1, 71))
    total = sum(sizes)
    chans = [torch.from_numpy(rng.uniform(0, 1, (total, px))
                              .astype(np.float32)) for _ in range(3)]
    tv = torch.from_numpy(rng.uniform(0, 1, (total, px)).astype(np.float32))
    seg_v = torch.cat([torch.arange(s, dtype=torch.int32) for s in sizes])
    segs_v = torch.cat([torch.full((s,), s, dtype=torch.int32)
                        for s in sizes])
    out_c, out_t = comp.tree_combine(chans, tv, seg_v, segs_v,
                                     max(sizes) + 1, blend)
    first = 0
    for s in sizes:
        rows = [[chans[c][first + i] for c in range(3)] + [tv[first + i]]
                for i in range(s)]
        want = _stack_fold(rows, blend)
        for c in range(3):
            assert torch.equal(out_c[c][first], want[c]), (s, c)
        assert torch.equal(out_t[first], want[3]), s
        first += s


def _near_d(c, base, lo, n, ih):
    """The kernel's `near_d` in numpy float32 scalars, op for op."""
    f = np.float32
    c1 = np.fmin(np.fmax(np.floor(f(c - base)), f(lo)), f(lo + n - 1))
    c0 = np.fmax(f(c1 - f(1.0)), f(lo))
    d1 = f(f(f(base + c1) + f(0.5)) - c) * ih
    d0 = f(f(f(base + c0) + f(0.5)) - c) * ih
    return np.fmin(np.abs(f(d0)), np.abs(f(d1)))


def _reach_mask(cx, cy, ihx, ihy, x0, y0, tile, block):
    """The kernel's `reach_mask`: bit by * blocks_x + bx."""
    (th, tw), (bh, bw) = tile, block
    m = 0
    with np.errstate(over="ignore", invalid="ignore"):
        for by in range(th // bh):
            dv = _near_d(cy, y0, by * bh, bh, ihy)
            for bx in range(tw // bw):
                du = _near_d(cx, x0, bx * bw, bw, ihx)
                if not np.float32(du * du + np.float32(dv * dv)) >= 0.25:
                    m |= 1 << (by * (tw // bw) + bx)
    return m


STAGE = 256   # csrc/composite_tiles.cu's kStage


def _kernels_model(s_cx, s_cy, s_w, s_cgb, starts, tile_v, j_v, lo_k, hi_k,
                   row_start, row_end, inv_sx, inv_sy, intensity, *, q, grid,
                   tile, blend):
    """What csrc/composite_tiles.cu computes, on the host: every live
    virtual row stages its slots [lo_k, hi_k), 256 at a time, read straight
    from the sorted streams, derived per slot, each with the mask of the
    32-pixel blocks its disc reaches; warp b lists the staged slots whose
    mask has bit b, in slot order, and blends them into its block's pixels
    only; every tile folds its rows with the binary-counter stack and
    writes its pixels into the frame. -> (C, T, blends)."""
    gh, gw = grid
    th, tw = tile
    bh, bw = comp.blend_block(tile)
    px = th * tw
    e_total = s_cx.shape[0]
    live_rows = int(row_end[-1])
    sa = intensity.numpy()
    skip = 0.0 <= float(sa) <= 2.0
    every = (1 << (px // 32)) - 1
    # warp b's lanes: pixel (y, x) of block b, blocks row-major
    lanes = torch.arange(32)
    warp_pix = [((b // (tw // bw)) * bh + lanes // bw) * tw
                + (b % (tw // bw)) * bw + lanes % bw for b in range(px // 32)]
    rows, blends = [], 0
    for v in range(live_rows):
        t = min(max(int(tile_v[v]), 0), gh * gw - 1)
        x0 = np.float32((t % gw) * tw)
        y0 = np.float32((t // gw) * th)
        p = torch.arange(px)
        pxc = float((t % gw) * tw) + (p % tw).to(torch.float32) + 0.5
        pyc = float((t // gw) * th) + (p // tw).to(torch.float32) + 0.5
        cr, cg, cb = (torch.zeros(px) for _ in range(3))
        tt = torch.ones(px)
        base = int(j_v[v]) * q
        lo = max(int(lo_k[v]), 0)
        hi = min(int(hi_k[v]), e_total - base)
        for k0 in range(lo, hi, STAGE):
            staged = []
            for k in range(k0, min(k0 + STAGE, hi)):
                e = base + k
                ihx = torch.nan_to_num(s_w[e] * inv_sx, nan=0.0, posinf=0.0,
                                       neginf=0.0)
                ihy = torch.nan_to_num(s_w[e] * inv_sy, nan=0.0, posinf=0.0,
                                       neginf=0.0)
                mask = every if not skip else _reach_mask(
                    s_cx[e].numpy(), s_cy[e].numpy(), ihx.numpy(),
                    ihy.numpy(), x0, y0, tile, (bh, bw))
                staged.append((e, ihx, ihy, mask))
            for b, pix in enumerate(warp_pix):
                mine = [x for x in staged if x[3] >> b & 1]
                blends += len(mine)
                for e, ihx, ihy, _ in mine:
                    g, c = comp.unpack_cgb(s_cgb[e])
                    du = (pxc[pix] - s_cx[e]) * ihx
                    dv = (pyc[pix] - s_cy[e]) * ihy
                    alpha = torch.clamp(0.5 - torch.sqrt(du * du + dv * dv),
                                        0.0, 0.5) * intensity
                    src = [torch.clamp(x * alpha, 0.0, 1.0)
                           for x in (1.0 - c, g, c)]
                    if blend == "over":
                        keep = 1.0 - alpha
                        for acc, y in zip((cr, cg, cb), src):
                            acc[pix] = acc[pix] * keep + y
                        tt[pix] = tt[pix] * keep
                    else:
                        for acc, y in zip((cr, cg, cb), src):
                            acc[pix] = acc[pix] + y
        rows.append([cr, cg, cb, tt])
    color = torch.empty((gh * th, gw * tw, 3))
    trans = torch.empty((gh * th, gw * tw))
    for t in range(gh * gw):
        c0, c1, c2, ct = _stack_fold(rows[int(row_start[t]):int(row_end[t])],
                                     blend)
        ys, xs = (t // gw) * th, (t % gw) * tw
        color[ys:ys + th, xs:xs + tw] = torch.stack(
            [c0, c1, c2], dim=1).reshape(th, tw, 3)
        trans[ys:ys + th, xs:xs + tw] = ct.reshape(th, tw)
    return color, trans, blends


def _scene_args(scene, blend):
    """(args, kw) of the composite call of a `SCENES` or chip_smoke
    `TILE_SCENES` scene, and the `_render` output of a `SCENES` one."""
    if scene in chip_smoke.TILE_SCENES:
        return (None, *chip_smoke.tile_scene(scene, blend=blend))
    make, seg_q, size = SCENES[scene]
    pos = make()
    _, _, t = _scalars(WIDTH, HEIGHT, size, 0.4)
    return _composite_args(pos, t, pos.shape[1], seg_q, blend)


ALL_SCENES = sorted(SCENES) + sorted(chip_smoke.TILE_SCENES)


@pytest.mark.parametrize("blend", ["over", "additive"])
@pytest.mark.parametrize("scene", ALL_SCENES)
def test_kernels_model_is_the_plain_version(scene, blend):
    out, args, kw = _scene_args(scene, blend)
    got = _kernels_model(*args, **kw)
    want = comp.composite_tiles_plain(*args, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[2] == int(want[2])
    if out is not None:
        assert torch.equal(out.frame, want[0])
        assert torch.equal(out.trans, want[1])
        assert torch.equal(out.blends, want[2])


def _brute_reach(args, kw):
    """[Q, V, blocks] bool: some pixel of the block lies at distance < 0.5
    from the slot's centre (in the blend's own float32 ops), and [Q, V] the
    live slots."""
    (s_cx, s_cy, s_w, s_cgb, _, tile_v, j_v, lo_k, hi_k, _, _, inv_sx,
     inv_sy, intensity) = args
    q, th, tw = kw["q"], *kw["tile"]
    bh, bw = comp.blend_block(kw["tile"])
    sp, bases = comp.composite_rows_inputs(
        s_cx, s_cy, s_w, s_cgb, tile_v, j_v, lo_k, hi_k, inv_sx, inv_sy,
        intensity, q=q, grid=kw["grid"], tile=kw["tile"])
    kk = torch.arange(q)[:, None]
    live = ((kk >= lo_k[None, :]) & (kk < hi_k[None, :])
            & (j_v[None, :].long() * q + kk < s_cx.shape[0]))
    pxc, pyc = comp._pixel_centers(bases, th, tw)          # [px, V]
    reached = []
    for b in range(th * tw // 32):
        y = (b // (tw // bw)) * bh + torch.arange(bh)
        x = (b % (tw // bw)) * bw + torch.arange(bw)
        pix = (y[:, None] * tw + x[None, :]).reshape(-1)
        du = (pxc[pix][:, None, :] - sp[0][None]) * sp[2][None]
        dv = (pyc[pix][:, None, :] - sp[1][None]) * sp[3][None]
        dist = torch.sqrt(du * du + dv * dv)                  # [32, Q, V]
        reached.append((dist < 0.5).any(0))
    return torch.stack(reached, dim=-1), live, sp


@pytest.mark.parametrize("scene", ALL_SCENES)
def test_reach_is_the_brute_force(scene):
    """`reach_blocks` keeps exactly the (slot, block) pairs with a pixel at
    distance < 0.5, where alone the alpha can be nonzero: it never skips a
    pixel of nonzero alpha (in the plain version's own blend ops), and the
    plain version's blend count is the brute-force count of those pairs
    (every live slot times every block at a scale past 2)."""
    _, args, kw = _scene_args(scene, "over")
    brute, live, sp = _brute_reach(args, kw)
    bases = comp.composite_rows_inputs(
        *args[:4], *args[5:9], *args[11:], q=kw["q"], grid=kw["grid"],
        tile=kw["tile"])[1]
    reach = comp.reach_blocks(sp[0], sp[1], sp[2], sp[3], bases[0],
                              bases[1], kw["tile"], args[13])
    blends = comp.composite_tiles_plain(*args, **kw)[2]
    blocks = reach.shape[-1]
    if float(args[13]) > 2.0:
        assert bool(reach.all())
        assert int(blends) == int(live.sum()) * blocks
        return
    assert torch.equal(reach & live[..., None], brute & live[..., None])
    assert int(blends) == int((brute & live[..., None]).sum())
    assert 0 < int(blends) < int(live.sum()) * blocks or scene in (
        "zeroed 1/(2h)", "whole tile")


def test_reach_never_skips_an_edge():
    """Single slots at a block's border pixel, swept a few ulps either
    side of distance 0.5 on each axis and on the diagonal, at many scales
    1/(2h): reach_blocks keeps the block exactly when some pixel of it has
    distance below 0.5 in the blend's ops."""
    rng = np.random.default_rng(11)
    tile = (8, 16)
    th, tw = tile
    bh, bw = comp.blend_block(tile)
    f = np.float32
    cx, cy, ih_x, ih_y = [], [], [], []
    for _ in range(400):
        ih = f(rng.choice([0.25, 0.5, 0.125, rng.uniform(0.05, 2.0)]))
        r = f(0.5) / ih                    # the disc's radius in pixels
        bx, by = rng.integers(0, tw // bw), rng.integers(0, th // bh)
        side = rng.choice([-1, 1], 2)
        # the pixel centre on the block's edge, the disc just outside it
        edge_x = f(bx * bw + (bw - 1 if side[0] > 0 else 0) + 0.5)
        edge_y = f(by * bh + (bh - 1 if side[1] > 0 else 0) + 0.5)
        ax = rng.integers(0, 3)            # along x, along y, diagonal
        dx, dy = [(r, 0), (0, r), (r / np.sqrt(2), r / np.sqrt(2))][ax]
        y = f(edge_y + side[1] * f(dy))
        for ulps in range(-3, 4):
            x = f(edge_x + side[0] * f(dx))
            for _ in range(abs(ulps)):
                x = np.nextafter(x, f(np.inf if ulps > 0 else -np.inf))
            cx.append(x)
            cy.append(y)
            ih_x.append(ih)
            ih_y.append(ih)
    cx, cy, ih_x, ih_y = (torch.tensor(np.array(a, np.float32))
                          for a in (cx, cy, ih_x, ih_y))
    zero = torch.zeros(())
    reach = comp.reach_blocks(cx, cy, ih_x, ih_y, zero, zero, tile,
                              torch.tensor(0.5))
    p = torch.arange(th * tw)
    pxc = (p % tw).to(torch.float32) + 0.5
    pyc = (p // tw).to(torch.float32) + 0.5
    du = (pxc[:, None] - cx[None]) * ih_x[None]
    dv = (pyc[:, None] - cy[None]) * ih_y[None]
    near = torch.sqrt(du * du + dv * dv) < 0.5              # [px, slots]
    blk = ((p // tw) // bh) * (tw // bw) + (p % tw) // bw
    brute = torch.stack([near[blk == b].any(0)
                         for b in range(reach.shape[-1])], dim=-1)
    assert torch.equal(reach, brute)
    assert 0 < int(brute.sum()) < brute.numel()


@pytest.mark.parametrize("tile,block", [((8, 16), (8, 4)), ((2, 16), (2, 16)),
                                        ((32, 1), (32, 1)), ((16, 8), (8, 4)),
                                        ((4, 8), (4, 8)), ((1, 96), (1, 32))])
def test_blend_block(tile, block):
    assert comp.blend_block(tile) == block


def test_render_blend_share_gauge():
    """present() reads the frame's blends and gauges them over entries x
    blocks; the count is the brute force's, on the exact binning."""
    metrics = MetricsRegistry()
    eng = RenderEngine(RenderConfig(width=WIDTH, height=HEIGHT), "cpu",
                       metrics)
    pos = torch.from_numpy(_clustered(300, 7, spread=12.0))
    seen = {}

    def record(*args, **kw):
        seen["call"] = (args, kw)
        return comp.composite_tiles(*args, **kw)

    eng.renderer.composite = record
    out = eng.draw(pos, AppConfig(num_particles=300, particle_size=4.0))
    eng.present()
    brute, live, _ = _brute_reach(*seen["call"])
    blends = int((brute & live[..., None]).sum())
    entries = int(out.entries)
    assert int(out.blends) == blends and entries > 0
    assert metrics.gauges["render_blend_share"] == blends / (entries * 4)
    assert 0.0 < metrics.gauges["render_blend_share"] < 1.0


def _small_args():
    pos = _clustered(200, 9)
    _, _, t = _scalars(WIDTH, HEIGHT, 20.0, 0.4)
    return _composite_args(pos, t, pos.shape[1], 8, "over")[1:]


def test_wrapper_on_cpu_is_the_plain_version():
    args, kw = _small_args()
    got = comp.composite_tiles(*args, **kw)
    want = comp.composite_tiles_plain(*args, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[0].shape == (HEIGHT, WIDTH, 3) and got[1].shape == (HEIGHT,
                                                                    WIDTH)


def test_wrapper_refuses_other_devices():
    args, kw = _small_args()
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="cuda or cpu"):
        comp.composite_tiles(*meta, **kw)


@pytest.mark.parametrize("bad", ["s_w dtype", "hi_k shape", "row_end shape",
                                 "scalar shape", "rows", "tile", "blend"])
def test_wrapper_refuses_bad_arguments(bad):
    args, kw = _small_args()
    args = list(args)
    if bad == "s_w dtype":
        args[2] = args[2].to(torch.float64)
    elif bad == "hi_k shape":
        args[8] = args[8][:-1]
    elif bad == "row_end shape":
        args[10] = args[10][1:]
    elif bad == "scalar shape":
        args[13] = args[13].reshape(1)
    elif bad == "rows":
        kw = {**kw, "q": kw["q"] * 2}
    elif bad == "tile":
        kw = {**kw, "tile": (5, 5)}
    else:
        kw = {**kw, "blend": "max"}
    with pytest.raises((ValueError, TypeError)):
        comp.composite_tiles(*args, **kw)
