"""Segmented sprite composite: CUDA kernels + plain torch twins.

The renderer splits the sorted sprite stream into virtual rows (one
tile slice of one Q-aligned data row each), blends each row's slots in
draw order, and folds each tile's rows in order into the frame.

`composite_tiles` does all of that, from the sort's outputs and the
virtual-row map to the frame planes (`csrc/composite_tiles.cu`: a row
kernel that reads each row's slots straight from the sorted streams, and a
fold kernel that combines each tile's rows and assembles the frame). It
replaces the JAX package's Pallas `ops/composite.py::_kernel` together
with the XLA code around it in that package's renderer. The renderer runs
it once per render (chunk).

- CUDA tensors go to the kernels, or the wrapper raises.
- CPU tensors go to `composite_tiles_plain`: the renderer's eager code
  (one packed row gather, the [8, Q, V] parameter planes,
  `composite_rows_plain`, the tree-combine passes, the assembly).

`composite_rows` is the depth-Q pass alone with the TPU kernel's
interface (`csrc/composite.cu`), off the render path; it stays as that
kernel's counterpart.

Layout of `composite_rows` (the JAX package's public one): sp [8, Q, V]
with channels 0 cx, 1 cy, 2 1/(2hx), 3 1/(2hy), 4 r, 5 g, 6 b, 7 alpha
scale (zero for dead slots); bases [2, V] tile base pixel (x, y); row_hi
[V] int32, the exclusive bound of each row's live slots (slots at or past
it must carry alpha scale 0). Output [4, px, V]: premultiplied r, g, b and
transmittance, px = tile_h * tile_w.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from multi_adapter_particles_torch.ops import _build
from multi_adapter_particles_torch.ops.rowgather import gather_rows_plain

Tensor = torch.Tensor

_BLENDS = {"over": 0, "additive": 1}
# Rounding after every multiply and add, like the twin's separate ops
# (see the note at the top of csrc/composite.cu).
_NVCC_FLAGS = ("-fmad=false",)


def _pixel_centers(bases: Tensor, tile_h: int, tile_w: int):
    """[px, V] pixel-center planes of every row's tile."""
    pix = torch.arange(tile_h * tile_w, device=bases.device)
    x_in = (pix % tile_w).to(torch.float32)[:, None]
    y_in = (pix // tile_w).to(torch.float32)[:, None]
    return bases[0][None, :] + x_in + 0.5, bases[1][None, :] + y_in + 0.5


def composite_rows_plain(
    sp: Tensor,
    bases: Tensor,
    tile_h: int,
    tile_w: int,
    blend: str = "over",
    row_hi: Optional[Tensor] = None,
) -> Tensor:
    """Plain torch twin: -> [4, px, V]. The loop stops at max(row_hi):
    slots past a row's bound blend alpha 0 — an exact identity — so this
    equals the full-Q loop bit for bit."""
    if blend not in _BLENDS:
        raise ValueError(f"unknown blend {blend!r}")
    _, q_len, v = sp.shape
    px = tile_h * tile_w
    pxc, pyc = _pixel_centers(bases, tile_h, tile_w)
    cr = torch.zeros((px, v), dtype=torch.float32, device=sp.device)
    cg = torch.zeros_like(cr)
    cb = torch.zeros_like(cr)
    tt = torch.ones_like(cr)
    trips = q_len if row_hi is None else min(
        max(int(row_hi.max()) if v else 0, 0), q_len
    )
    for q in range(trips):
        scx, scy, ihx, ihy, sr, sg, sb, sa = (sp[c, q][None, :]
                                              for c in range(8))
        du = (pxc - scx) * ihx
        dv = (pyc - scy) * ihy
        dist = torch.sqrt(du * du + dv * dv)
        alpha = torch.clamp(0.5 - dist, 0.0, 0.5) * sa
        if blend == "over":
            keep = 1.0 - alpha
            cr = cr * keep + torch.clamp(sr * alpha, 0.0, 1.0)
            cg = cg * keep + torch.clamp(sg * alpha, 0.0, 1.0)
            cb = cb * keep + torch.clamp(sb * alpha, 0.0, 1.0)
            tt = tt * keep
        else:
            cr = cr + torch.clamp(sr * alpha, 0.0, 1.0)
            cg = cg + torch.clamp(sg * alpha, 0.0, 1.0)
            cb = cb + torch.clamp(sb * alpha, 0.0, 1.0)
    return torch.stack([cr, cg, cb, tt])


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("composite", _NVCC_FLAGS)
    fn = lib.composite_rows
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def composite_rows(
    sp: Tensor,
    bases: Tensor,
    tile_h: int,
    tile_w: int,
    blend: str = "over",
    row_hi: Optional[Tensor] = None,
) -> Tensor:
    """-> [4, px, V] premultiplied rgb + transmittance per virtual row.

    A CPU tensor runs the plain twin; a CUDA tensor launches the kernel.
    `row_hi` None = every row loops the full Q."""
    if sp.device.type == "cpu":
        return composite_rows_plain(sp, bases, tile_h, tile_w, blend, row_hi)
    if sp.device.type != "cuda":
        raise ValueError(f"composite_rows runs on cuda or cpu, got {sp.device}")
    if blend not in _BLENDS:
        raise ValueError(f"unknown blend {blend!r}")
    if sp.dim() != 3 or sp.shape[0] != 8:
        raise ValueError(f"sp must be [8, Q, V], got {tuple(sp.shape)}")
    _, q_len, v = sp.shape
    dev = sp.device
    checks = [(sp, torch.float32, (8, q_len, v), "sp"),
              (bases, torch.float32, (2, v), "bases")]
    if row_hi is not None:
        checks.append((row_hi, torch.int32, (v,), "row_hi"))
    for t, dtype, shape, what in checks:
        _build.check_arg(t, dtype, shape, dev, what)
    px = tile_h * tile_w
    out = torch.empty((4, px, v), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _library().composite_rows(
            sp.data_ptr(), bases.data_ptr(),
            None if row_hi is None else row_hi.data_ptr(),
            out.data_ptr(), q_len, v, tile_h, tile_w, _BLENDS[blend], stream,
        )
    _build.check(rc, "composite_rows")
    return out


# ---- the render composite: sorted streams -> frame planes -------------------

def pack_cgb(cg: Tensor, cb: Tensor) -> Tensor:
    """(cg, cb) f32 -> int32 (f16 bits of cg clamped to [0, 6e4]) << 16 |
    f16 bits of cb: the JAX package's `pack_cgb` lane (`render/renderer.py`
    there). Each half is masked to 16 bits before the shift, so a negative
    f16 cannot sign-extend into the other; cg is clamped below f16-inf (the
    blend clips source terms to [0, 1] anyway, and an inf would NaN-poison
    dead slots through `inf * 0`)."""
    def bits(x):
        return x.to(torch.float16).view(torch.int16).to(torch.int32) & 0xFFFF

    return (bits(torch.clamp(cg, 0.0, 6.0e4)) << 16) | bits(cb)


def unpack_cgb(u: Tensor):
    """int32 `pack_cgb` words -> (cg, cb) f32, each rounded through f16."""
    def half(bits):
        s16 = ((bits & 0xFFFF) ^ 0x8000) - 0x8000    # sign-extend 16 bits
        return s16.to(torch.int16).view(torch.float16).to(torch.float32)

    return half(u >> 16), half(u)


def packed_rows(s_cx: Tensor, s_cy: Tensor, s_w: Tensor, s_cgb: Tensor,
                q: int) -> Tensor:
    """The 4 sorted payloads (as int32 bits) per Q-aligned data row,
    [data_rows, 4Q] with channel-major rows; the tail past the stream is
    zero (beyond every tile's end, never selected)."""
    e_total = s_cx.shape[0]
    data_rows = -(-e_total // q)
    payload = torch.stack([s_cx.view(torch.int32), s_cy.view(torch.int32),
                           s_w.view(torch.int32), s_cgb], dim=1)   # [E, 4]
    e_pad = data_rows * q - e_total
    if e_pad:
        payload = torch.cat([payload, payload.new_zeros((e_pad, 4))])
    return payload.reshape(data_rows, q, 4).transpose(1, 2).reshape(
        data_rows, 4 * q)


def row_tiles(tile_v, starts, row_start, row_end):
    """Each virtual row's tile values (starts_v, ends_v, row_start_v) from
    its tile tile_v; a row past the last (tile_v = T) gets starts_v =
    ends_v = starts[T] and row_start_v = row_end[-1]."""
    num_tiles = row_end.shape[0]
    tv = tile_v.long()
    starts_v = starts[tv]
    ends_v = starts[torch.clamp(tv + 1, max=num_tiles)]
    row_start_v = torch.cat([row_start, row_end[-1:]])[tv]
    return starts_v, ends_v, row_start_v


def composite_rows_inputs(s_cx, s_cy, s_w, s_cgb, tile_v, j_v, lo_k, hi_k,
                          inv_sx, inv_sy, intensity, *, q: int, grid,
                          tile=(8, 16)):
    """(sp [8, Q, V], bases [2, V]): `composite_rows`' inputs for every
    virtual row, as the eager renderer builds them. ONE packed row gather
    reads each virtual row's data row (rows past the stream, dead virtual
    rows only, read the last data row, as XLA's gather clamps); the
    parameters are derived after it (1/(2hx) is linear in w_clip)."""
    _, gw = grid
    tile_h, tile_w = tile
    num_tiles = grid[0] * gw
    num_rows = tile_v.shape[0]
    dev = s_cx.device
    kk = torch.arange(q, dtype=torch.int32, device=dev)
    valid_k = (kk[:, None] >= lo_k[None, :]) & (kk[:, None] < hi_k[None, :])
    t_sa = torch.where(valid_k, intensity, 0.0)  # [Q, V]; dead slots blend 0
    spt = gather_rows_plain(packed_rows(s_cx, s_cy, s_w, s_cgb, q),
                            j_v).reshape(num_rows, 4, q).permute(1, 2, 0)
    t_cx, t_cy, t_w = (spt[c].view(torch.float32) for c in range(3))
    t_cg, t_cb = unpack_cgb(spt[3])
    t_ihx = torch.nan_to_num(t_w * inv_sx, nan=0.0, posinf=0.0, neginf=0.0)
    t_ihy = torch.nan_to_num(t_w * inv_sy, nan=0.0, posinf=0.0, neginf=0.0)
    t_cr = 1.0 - t_cb
    sp = torch.stack([t_cx, t_cy, t_ihx, t_ihy, t_cr, t_cg, t_cb, t_sa])
    tile_vc = torch.clamp(tile_v, 0, num_tiles - 1)
    bases = torch.stack([
        ((tile_vc % gw) * tile_w).to(torch.float32),
        ((tile_vc // gw) * tile_h).to(torch.float32),
    ])                                              # [2, V]
    return sp.contiguous(), bases


def tree_combine(chans, tv, seg_v, segs_v, max_segs: int, blend: str):
    """Combine consecutive segment rows of each tile in O(log rows) static
    passes: at pass p (s = 2^p) row v takes row v + s when seg_v % 2s == 0
    and seg_v + s < segs_v. chans: 3 [V, px] colour planes, tv [V, px];
    returns them with each tile's segment-0 row holding its composite."""
    px_count = tv.shape[1]
    chans = list(chans)
    passes = max(max_segs - 1, 0).bit_length()
    for p in range(passes):
        s = 1 << p
        take = ((seg_v % (2 * s) == 0) & (seg_v + s < segs_v))[:, None]
        part_t = torch.cat([tv[s:], tv.new_ones((s, px_count))])
        for c in range(3):
            part_c = torch.cat([chans[c][s:], tv.new_zeros((s, px_count))])
            if blend == "over":
                # this row = earlier segments, partner = later: later on top
                chans[c] = torch.where(take, chans[c] * part_t + part_c,
                                       chans[c])
            else:
                chans[c] = torch.where(take, chans[c] + part_c, chans[c])
        if blend == "over":
            tv = torch.where(take, tv * part_t, tv)
    return chans, tv


def composite_tiles_plain(s_cx, s_cy, s_w, s_cgb, starts, tile_v, j_v, lo_k,
                          hi_k, row_start, row_end, inv_sx, inv_sy,
                          intensity, *, q: int, grid, tile=(8, 16),
                          blend: str = "over"):
    """Plain torch twin of `composite_tiles` -> (C [H, W, 3], T [H, W]):
    the depth-Q pass over every virtual row (`composite_rows_plain`), then
    consecutive rows of a tile tree-combine in O(log rows) static passes;
    each tile's segment-0 row holds its composite."""
    if blend not in _BLENDS:
        raise ValueError(f"unknown blend {blend!r}")
    gh, gw = grid
    tile_h, tile_w = tile
    num_rows = tile_v.shape[0]
    data_rows = -(-s_cx.shape[0] // q)
    max_segs = data_rows + 1               # one tile could span everything
    sp, bases = composite_rows_inputs(
        s_cx, s_cy, s_w, s_cgb, tile_v, j_v, lo_k, hi_k, inv_sx, inv_sy,
        intensity, q=q, grid=grid, tile=tile)
    out4 = composite_rows_plain(sp, bases, tile_h, tile_w, blend=blend,
                                row_hi=hi_k.contiguous())
    chans = [out4[0].T, out4[1].T, out4[2].T]       # [V, px]
    tv = out4[3].T

    # per-row segment count derived from the row's own starts/ends
    # (invalid rows get 1, which disables partner takes — their contents
    # are never read)
    starts_v, ends_v, row_start_v = row_tiles(tile_v, starts, row_start,
                                              row_end)
    v = torch.arange(num_rows, dtype=torch.int32, device=s_cx.device)
    seg_v = v - row_start_v
    counts_v = ends_v - starts_v
    segs_v = torch.where(
        counts_v > 0, (ends_v - 1) // q - starts_v // q + 1, 1)
    chans, tv = tree_combine(chans, tv, seg_v, segs_v, max_segs, blend)

    # segment-0 row holds each tile's composite
    rs = row_start.long()
    frame_t = torch.stack([c[rs] for c in chans], dim=1)  # [T, 3, px]

    def assemble(t, ch):  # [T, ch, th*tw] -> [H, W, ch] (or [H, W])
        t = t.reshape(gh, gw, ch, tile_h, tile_w)
        t = t.permute(0, 3, 1, 4, 2).reshape(gh * tile_h, gw * tile_w, ch)
        return t[..., 0] if ch == 1 else t

    return assemble(frame_t, 3), assemble(tv[rs][:, None, :], 1)


@functools.cache
def _tiles_library() -> ctypes.CDLL:
    lib = _build.load("composite_tiles", _NVCC_FLAGS)
    fn = lib.composite_tiles
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_void_p] * 6
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
        + [ctypes.c_void_p] * 4)
    fn.restype = ctypes.c_int
    return lib


def composite_tiles(s_cx, s_cy, s_w, s_cgb, starts, tile_v, j_v, lo_k, hi_k,
                    row_start, row_end, inv_sx, inv_sy, intensity, *, q: int,
                    grid, tile=(8, 16), blend: str = "over"):
    """Sorted sprite streams + virtual-row map -> (C [H, W, 3], T [H, W]):
    each tile's unclipped premultiplied colour and transmittance, H =
    grid[0] * tile[0], W = grid[1] * tile[1].

    s_cx, s_cy, s_w float32 and s_cgb int32 (`pack_cgb`) [E], the sort's
    outputs; starts int32 [T + 1], each tile's first entry; tile_v, j_v,
    lo_k, hi_k int32 [V], each virtual row's tile, data row and live slot
    range (hi_k 0 for dead rows); row_start, row_end int32 [T], each tile's
    rows; inv_sx, inv_sy, intensity 0-dim float32 (1/(2hx) = w * inv_sx).
    V = T + ceil(E / q). Arguments are checked on either device; then CPU
    tensors run the plain twin, CUDA tensors launch the two kernels. No
    host read: a CUDA graph can capture the call."""
    dev = s_cx.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"composite_tiles runs on cuda or cpu, got {dev}")
    if blend not in _BLENDS:
        raise ValueError(f"unknown blend {blend!r}")
    gh, gw = grid
    tile_h, tile_w = tile
    num_tiles, px = gh * gw, tile_h * tile_w
    if q < 1 or num_tiles < 1 or px % 32 or not 0 < px <= 1024:
        raise ValueError(f"composite_tiles takes q >= 1, a nonempty grid and "
                         f"tiles of a multiple of 32 pixels up to 1024, got "
                         f"q={q}, grid={grid}, tile={tile}")
    e_total, num_rows = s_cx.shape[0], tile_v.shape[0]
    checks = [(s_cx, torch.float32, (e_total,), "s_cx"),
              (s_cy, torch.float32, (e_total,), "s_cy"),
              (s_w, torch.float32, (e_total,), "s_w"),
              (s_cgb, torch.int32, (e_total,), "s_cgb"),
              (starts, torch.int32, (num_tiles + 1,), "starts"),
              (row_start, torch.int32, (num_tiles,), "row_start"),
              (row_end, torch.int32, (num_tiles,), "row_end")]
    checks += [(t, torch.int32, (num_rows,), what) for t, what in (
        (tile_v, "tile_v"), (j_v, "j_v"), (lo_k, "lo_k"), (hi_k, "hi_k"))]
    checks += [(t, torch.float32, (), what) for t, what in (
        (inv_sx, "inv_sx"), (inv_sy, "inv_sy"), (intensity, "intensity"))]
    for t, dtype, shape, what in checks:
        _build.check_arg(t, dtype, shape, dev, what)
    if num_rows != num_tiles + -(-e_total // q):
        raise ValueError(f"composite_tiles: {num_rows} virtual rows, expected "
                         f"T + ceil(E / q) = {num_tiles + -(-e_total // q)}")
    if dev.type == "cpu":
        return composite_tiles_plain(
            s_cx, s_cy, s_w, s_cgb, starts, tile_v, j_v, lo_k, hi_k,
            row_start, row_end, inv_sx, inv_sy, intensity, q=q, grid=grid,
            tile=tile, blend=blend)
    rows = torch.empty((num_rows, 4, px), dtype=torch.float32, device=dev)
    color = torch.empty((gh * tile_h, gw * tile_w, 3), dtype=torch.float32,
                        device=dev)
    trans = torch.empty((gh * tile_h, gw * tile_w), dtype=torch.float32,
                        device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _tiles_library().composite_tiles(
            s_cx.data_ptr(), s_cy.data_ptr(), s_w.data_ptr(),
            s_cgb.data_ptr(), e_total, tile_v.data_ptr(), j_v.data_ptr(),
            lo_k.data_ptr(), hi_k.data_ptr(), row_start.data_ptr(),
            row_end.data_ptr(), num_rows, gh, gw, inv_sx.data_ptr(),
            inv_sy.data_ptr(), intensity.data_ptr(), q, tile_h, tile_w,
            _BLENDS[blend], rows.data_ptr(), color.data_ptr(),
            trans.data_ptr(), stream)
    _build.check(rc, "composite_tiles")
    return color, trans

