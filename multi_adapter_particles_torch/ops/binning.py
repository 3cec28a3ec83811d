"""Exact sprite binning: CUDA kernels + plain torch twin.

The renderer's sort takes one (tile key, cx, cy, w_clip, cg|cb) entry for
every tile a sprite covers. `bin_sprites` makes them all, with no host read
and no shape that depends on data, so a CUDA graph captures it:

1. project every particle (`project`, `colors`): its pixel rectangle, its
   payloads, and its count of tiles, span_h x span_w when it is drawn
   (p < num_draw, w_clip > near, the rectangle holds a pixel), else 0;
2. an exclusive scan of the counts in particle order gives each sprite
   its offset;
3. the sprite writes its tiles there, row-major; offsets at or past the
   capacity are dropped and counted (`truncated`), and the unused tail
   holds the sentinel key num_tiles.

The stable sort then keeps each tile's entries in particle order, the draw
order of the reference's single DrawInstanced (`Render.cpp:891`): the
sorted live stream is the one a dup window large enough for every sprite
gives (`render/renderer.py`'s window path), whatever the capacity.

- CUDA tensors go to the kernels (`csrc/binning.cu`), or the wrapper
  raises.
- CPU tensors go to `bin_sprites_plain`: the same entries with torch ops
  (each slot finds its sprite by a search over the inclusive scan).

The kernels replace no TPU kernel: the JAX package bins into a fixed
window as XLA ops and drops the tiles outside it.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from multi_adapter_particles_torch import constants as C
from multi_adapter_particles_torch.ops import _build
from multi_adapter_particles_torch.ops.composite import pack_cgb

Tensor = torch.Tensor

# Rounding after every multiply and add, like the twin's separate ops.
_NVCC_FLAGS = ("-fmad=false",)
INT32_MAX = 2**31 - 1


def project(position, wvp, p00, p11, width, height, radius):
    """SoA positions [4, Np] -> screen-space sprite params (all [Np])."""
    x, y, z = position[0], position[1], position[2]
    # row-vector convention: clip = [x y z 1] @ WVP
    cx_clip = x * wvp[0, 0] + y * wvp[1, 0] + z * wvp[2, 0] + wvp[3, 0]
    cy_clip = x * wvp[0, 1] + y * wvp[1, 1] + z * wvp[2, 1] + wvp[3, 1]
    w_clip = x * wvp[0, 3] + y * wvp[1, 3] + z * wvp[2, 3] + wvp[3, 3]
    inv_w = 1.0 / w_clip
    cx = (cx_clip * inv_w + 1.0) * (0.5 * width)
    cy = (1.0 - cy_clip * inv_w) * (0.5 * height)
    hx = radius * p00 * inv_w * (0.5 * width)
    hy = radius * p11 * inv_w * (0.5 * height)
    return cx, cy, hx, hy, w_clip


def colors(position, id_offset=0):
    """VSParticleDraw color rule (`ParticleDraw.hlsl:104-109`), SoA.

    `id_offset` shifts the id-hash channel so a CHUNK of a larger state
    colors exactly as it would in the full draw (chunked renders)."""
    n = position.shape[1]
    ids = torch.arange(n, dtype=torch.int32, device=position.device)
    ids = ids + int(id_offset)
    # Division by a constant as multiplication by its float32 reciprocal:
    # that is what XLA compiles the JAX package's `x / c` to, so colors
    # (and their f16 rounding) match it bit for bit.
    mag = position[3] * (1.0 / C.ACCEL_COLOR_SCALE)
    cold = C.SPRITE_COLOR_COLD
    hot = C.SPRITE_COLOR_HOT
    g = cold[1] + mag * (hot[1] - cold[1])  # unclamped lerp
    b = (ids & C.SPRITE_ID_MASK).to(torch.float32) * (
        1.0 / C.SPRITE_ID_MASK)
    r = 1.0 - b
    return r, g, b


def pixel_bound(edge: Tensor, limit: int) -> Tensor:
    """ceil(edge - 0.5) as int32, clamped to [0, limit] in float first.

    The JAX package clamps only the side that can leave the frame; the
    other clamp changes no nonempty rectangle (a start at or past the
    limit, or an end at or before 0, is empty either way) but keeps huge
    screen coordinates inside int32, where float -> int conversions
    disagree between XLA and torch."""
    return torch.clamp(torch.ceil(edge - 0.5), 0.0, float(limit)).to(
        torch.int32)


def bin_sprites_plain(position, wvp, p00, p11, radius, num_draw,
                      id_offset=0, *, width, height, near, capacity, row=1,
                      tile=(8, 16)):
    """Plain torch twin of `bin_sprites`: the same entries, every tail
    slot's payloads zero."""
    dev = position.device
    n = position.shape[1]
    tile_h, tile_w = tile
    gw = width // tile_w
    num_tiles = (height // tile_h) * gw
    cx, cy, hx, hy, w_clip = project(position, wvp, p00, p11, float(width),
                                     float(height), radius)
    _, cg, cb = colors(position, id_offset)
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    alive = (ids < num_draw) & (w_clip > near)
    px0 = pixel_bound(cx - hx, width)
    px1 = pixel_bound(cx + hx, width)
    py0 = pixel_bound(cy - hy, height)
    py1 = pixel_bound(cy + hy, height)
    drawn = (px0 < px1) & (py0 < py1) & alive
    tx0, ty0 = px0 // tile_w, py0 // tile_h
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    span_w = torch.where(drawn, (px1 - 1) // tile_w - tx0 + 1, zero)
    span_h = torch.where(drawn, (py1 - 1) // tile_h - ty0 + 1, zero)
    count = (span_h * span_w).to(torch.int64)
    ends = torch.cumsum(count, dim=0)             # inclusive scan
    total = ends[-1]

    e = torch.arange(capacity, dtype=torch.int64, device=dev)
    live = e < total
    p = torch.clamp(torch.searchsorted(ends, e, right=True), max=n - 1)
    j = e - (ends[p] - count[p])
    sw = torch.clamp(span_w[p], min=1).to(torch.int64)
    dy = j // sw
    key = (ty0[p] + dy) * gw + tx0[p] + (j - dy * sw)
    key = torch.where(live, key, num_tiles).to(torch.int32)
    cx = torch.nan_to_num(cx, nan=0.0, posinf=0.0, neginf=0.0)
    cy = torch.nan_to_num(cy, nan=0.0, posinf=0.0, neginf=0.0)
    zf = torch.zeros((), dtype=torch.float32, device=dev)
    payloads = [torch.where(live, a[p], zf) for a in (cx, cy, w_clip)]
    payloads.append(torch.where(live, pack_cgb(cg, cb)[p], zero))
    stats = torch.stack([
        torch.clamp(total, max=capacity),
        torch.clamp(total - capacity, 0, INT32_MAX),
        span_h.max(), span_w.max()]).to(torch.int32)
    return (key, *payloads, stats)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("binning", _NVCC_FLAGS)
    fn = lib.bin_sprites
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    fn.argtypes = ([p, ll, ll] + [p] * 5
                   + [ll, ll, i, i, f, f, f, f, i, f, i, i, ll, i] + [p] * 9)
    fn.restype = ctypes.c_int
    lib.bin_tile.restype = ctypes.c_int
    return lib


def _f32(x: float) -> float:
    """x rounded to float32, as torch rounds a Python scalar in an op."""
    return float(np.float32(x))


def bin_sprites(position, wvp, p00, p11, radius, num_draw, id_offset=0, *,
                width: int, height: int, near: float, capacity: int,
                row: int = 1, tile=(8, 16)):
    """Every drawn sprite's tile entries -> (key int32, cx, cy, w_clip f32,
    cgb int32 (`pack_cgb`), each [capacity]; stats int32 [4]: entries
    written, truncated (entries past the capacity, at most 2^31 - 1),
    span_y, span_x (the largest tile rows and columns a drawn sprite
    covers)). position [4, n] f32; wvp [4, 4], p00, p11, radius 0-dim f32;
    num_draw an int or a 0-dim int32 tensor on position's device; position
    may be a column slice of a larger state (its rows' stride). Slots
    past the entries hold key num_tiles; their payloads are zero below the
    next multiple of `row` (the composite's data-row width), and the
    kernels leave later ones unwritten. A CPU tensor runs the plain twin;
    a CUDA tensor launches the two kernels."""
    kw = dict(width=width, height=height, near=near, capacity=capacity,
              row=row, tile=tile)
    dev = position.device
    if dev.type == "cpu":
        return bin_sprites_plain(position, wvp, p00, p11, radius, num_draw,
                                 id_offset, **kw)
    if dev.type != "cuda":
        raise ValueError(f"bin_sprites runs on cuda or cpu, got {dev}")
    n = position.shape[1]
    tile_h, tile_w = tile
    if (n < 1 or not 0 <= capacity <= INT32_MAX or row < 1
            or width % tile_w or height % tile_h):
        raise ValueError(f"bin_sprites takes n >= 1, 0 <= capacity < 2^31, "
                         f"row >= 1 and a frame of whole tiles, got n={n}, "
                         f"capacity={capacity}, row={row}, {width}x{height}, "
                         f"tile {tile}")
    f32 = torch.float32
    if position.stride(1) != 1 or position.stride(0) < n:
        raise ValueError("position must be [4, n] rows of contiguous "
                         "columns (a column slice of a state is)")
    _build.check_arg(position, f32, (4, n), dev, "position",
                     contiguous=False)
    _build.check_arg(wvp, f32, (4, 4), dev, "wvp")
    for t, what in ((p00, "p00"), (p11, "p11"), (radius, "radius")):
        _build.check_arg(t, f32, (), dev, what)
    draw_dev = isinstance(num_draw, Tensor)
    if draw_dev:
        _build.check_arg(num_draw, torch.int32, (), dev, "num_draw")
    lib = _library()
    tiles = -(-n // lib.bin_tile())
    key = torch.empty((capacity,), dtype=torch.int32, device=dev)
    cx, cy, w = (torch.empty((capacity,), dtype=f32, device=dev)
                 for _ in range(3))
    cgb = torch.empty((capacity,), dtype=torch.int32, device=dev)
    stats = torch.empty((4,), dtype=torch.int32, device=dev)
    tile_sum = torch.empty((tiles,), dtype=torch.int64, device=dev)
    tile_span = torch.empty((tiles, 2), dtype=torch.int32, device=dev)
    cold, hot = C.SPRITE_COLOR_COLD[1], C.SPRITE_COLOR_HOT[1]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bin_sprites(
            position.data_ptr(), n, position.stride(0), wvp.data_ptr(),
            p00.data_ptr(), p11.data_ptr(), radius.data_ptr(),
            num_draw.data_ptr() if draw_dev else None,
            0 if draw_dev else int(num_draw), int(id_offset), width, height,
            _f32(near), _f32(1.0 / C.ACCEL_COLOR_SCALE), _f32(cold),
            _f32(hot - cold), C.SPRITE_ID_MASK,
            _f32(1.0 / C.SPRITE_ID_MASK), tile_h, tile_w, capacity, row,
            key.data_ptr(), cx.data_ptr(), cy.data_ptr(), w.data_ptr(),
            cgb.data_ptr(), stats.data_ptr(), tile_sum.data_ptr(),
            tile_span.data_ptr(), stream)
    _build.check(rc, "bin_sprites")
    return key, cx, cy, w, cgb, stats

