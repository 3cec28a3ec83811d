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
  from the sorted streams, dead slots skipped; each tile's rows folded by
  the stack) is bitwise `composite_tiles_plain` on real scenes.
- The wrapper: CPU tensors take the plain version and count no launch;
  other devices, shapes and dtypes raise.

The CUDA kernels are held bitwise against the plain version on the card
by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multi_adapter_particles_tpu.render import renderer as jr

from multi_adapter_particles_torch.ops import composite as comp
from multi_adapter_particles_torch.render import renderer as tr

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


def _kernels_model(s_cx, s_cy, s_w, s_cgb, starts, tile_v, j_v, lo_k, hi_k,
                   row_start, row_end, inv_sx, inv_sy, intensity, *, q, grid,
                   tile, blend):
    """What csrc/composite_tiles.cu computes, on the host: every live
    virtual row blends only its slots [lo_k, hi_k), read straight from the
    sorted streams and derived per slot; every tile folds its rows with
    the binary-counter stack and writes its pixels into the frame."""
    gh, gw = grid
    th, tw = tile
    px = th * tw
    e_total = s_cx.shape[0]
    live_rows = int(row_end[-1])
    p = torch.arange(px)
    rows = []
    for v in range(live_rows):
        t = min(max(int(tile_v[v]), 0), gh * gw - 1)
        pxc = float((t % gw) * tw) + (p % tw).to(torch.float32) + 0.5
        pyc = float((t // gw) * th) + (p // tw).to(torch.float32) + 0.5
        cr, cg, cb = (torch.zeros(px) for _ in range(3))
        tt = torch.ones(px)
        base = int(j_v[v]) * q
        for k in range(max(int(lo_k[v]), 0), min(int(hi_k[v]),
                                                 e_total - base)):
            e = base + k
            ihx = torch.nan_to_num(s_w[e] * inv_sx, nan=0.0, posinf=0.0,
                                   neginf=0.0)
            ihy = torch.nan_to_num(s_w[e] * inv_sy, nan=0.0, posinf=0.0,
                                   neginf=0.0)
            g, b = comp.unpack_cgb(s_cgb[e])
            du = (pxc - s_cx[e]) * ihx
            dv = (pyc - s_cy[e]) * ihy
            alpha = torch.clamp(0.5 - torch.sqrt(du * du + dv * dv), 0.0,
                                0.5) * intensity
            src = [torch.clamp(x * alpha, 0.0, 1.0) for x in (1.0 - b, g, b)]
            if blend == "over":
                keep = 1.0 - alpha
                cr, cg, cb = (x * keep + y for x, y in zip((cr, cg, cb), src))
                tt = tt * keep
            else:
                cr, cg, cb = (x + y for x, y in zip((cr, cg, cb), src))
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
    return color, trans


@pytest.mark.parametrize("blend", ["over", "additive"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_kernels_model_is_the_plain_version(scene, blend):
    make, seg_q, size = SCENES[scene]
    pos = make()
    _, _, t = _scalars(WIDTH, HEIGHT, size, 0.4)
    out, args, kw = _composite_args(pos, t, pos.shape[1], seg_q, blend)
    got = _kernels_model(*args, **kw)
    want = comp.composite_tiles_plain(*args, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(out.frame, want[0]) and torch.equal(out.trans, want[1])


def _small_args():
    pos = _clustered(200, 9)
    _, _, t = _scalars(WIDTH, HEIGHT, 20.0, 0.4)
    return _composite_args(pos, t, pos.shape[1], 8, "over")[1:]


def test_wrapper_on_cpu_is_the_plain_version():
    args, kw = _small_args()
    before = comp.composite_tiles.launches
    got = comp.composite_tiles(*args, **kw)
    want = comp.composite_tiles_plain(*args, **kw)
    assert comp.composite_tiles.launches == before   # no kernel on the CPU
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
