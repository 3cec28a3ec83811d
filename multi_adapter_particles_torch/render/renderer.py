"""Tile-binned point-sprite splatter (torch).

The port of the JAX package's `render/renderer.py`, with its semantics and
its numbers, not its TPU workarounds. The reference's draw path is VS -> GS
billboard expand -> PS radial sprite -> alpha blend in ROP hardware
(`ParticleDraw.hlsl`, blend state `Render.cpp:522-532`); here it is a
gather:

1. **Project** all particles. Billboards are eye-space axis-aligned
   squares, so each sprite projects to a screen-axis-aligned rectangle:
   (center, half-extents, rgb, intensity).
2. **Bin** sprites to (TILE_H x TILE_W) pixel tiles: each particle emits
   up to dup_y x dup_x candidate (tile, id) entries, entry e = p*dup + k.
   ONE stable sort of the int32 tile keys carries the entries' four
   payloads (cx, cy, w_clip, and (cg, cb) packed as two f16 halves) and
   orders them by tile, then particle id — the draw order of the
   reference's single DrawInstanced (`Render.cpp:891`): the hand-written
   CUDA kernel `ops/sortkv.py` on CUDA tensors, its plain twin on CPU.
3. **Composite** exactly at any depth: over-composition with a per-sprite
   source clamp is associative on (premultiplied color, transmittance), so
   the sorted stream splits into Q-aligned data rows; each (data row, tile)
   intersection is a virtual row of one depth-Q pass, and consecutive rows
   of a tile combine pairwise in the order of O(log rows) tree passes —
   `ops/composite.composite_tiles`, from the sorted streams and the
   virtual-row map (eager [V] and [T] integers here) to the frame planes:
   two hand-written CUDA kernels on CUDA tensors, the eager twin on CPU.

What changed against the JAX package, and why it is the same result:
- entry expansion: a broadcast-and-reshape of the key planes and payloads
  (the JAX package's MXU permutation matmul was a TPU layout workaround;
  it falls back to the same broadcast where dup does not divide 128);
- tile starts: `torch.searchsorted(..., side="left")`, which the JAX
  package's `_starts_two_level` docstring states it equals;
- virtual-row map: `torch.searchsorted(row_end, v, right=True)` + gathers
  replace the merge sort; the integers are the same;
- keys are int32 tile ids where the JAX package keeps f32 ids (exact
  below 2^24): the same order.

`truncated` counts sprite-tile entries outside the dup_y x dup_x candidate
window. States past `chunk_threshold` render in id-ordered chunks folded
through the associative composite (`_chunked_fold`); `Renderer.render_mesh`
does the same with each chunk a rank's shard on its own device.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from multi_adapter_particles_torch import constants as C
from multi_adapter_particles_torch.config import RenderConfig
from multi_adapter_particles_torch.models.state import PAD_POSITION
from multi_adapter_particles_torch.ops.composite import (  # noqa: F401
    composite_tiles,
    pack_cgb,
    row_tiles,
    unpack_cgb,   # the pair's decoder, public here as in the JAX package
)
from multi_adapter_particles_torch.ops.sortkv import sort_kv_stable
from multi_adapter_particles_torch.render.camera import Camera

Tensor = torch.Tensor

# Tile shape (8, 16) pixels: the JAX package's choice, kept so virtual rows
# and segment counts compare 1:1 (a default sprite covers ~25 px).
TILE_H = 8
TILE_W = 16


class FrameOutput(NamedTuple):
    frame: Tensor         # [H, W, 3] float32 in [0, 1] (uint8 in u8 mode)
    truncated: Tensor     # int32 — tile entries beyond the dup window
    span_y: Tensor        # int32 — max tile rows any live sprite covers
    span_x: Tensor        # int32 — max tile cols any live sprite covers
    trans: Optional[Tensor] = None  # [H, W] transmittance (return_trans
    #                       mode: frame then holds UNclipped premultiplied
    #                       color — the chunked-fold state)


def _project(position, wvp, p00, p11, width, height, radius):
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


def _colors(position, id_offset=0):
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


def _pixel_bound(edge: Tensor, limit: int) -> Tensor:
    """ceil(edge - 0.5) as int32, clamped to [0, limit] in float first.

    The JAX package clamps only the side that can leave the frame; the
    other clamp changes no nonempty rectangle (a start at or past the
    limit, or an end at or before 0, is empty either way) but keeps huge
    screen coordinates inside int32, where float -> int conversions
    disagree between XLA and torch."""
    return torch.clamp(torch.ceil(edge - 0.5), 0.0, float(limit)).to(
        torch.int32)


def _chunk_draw(num_draw, start: int, width: int):
    """A chunk's slice [start, start + width) of the num_draw prefix, for a
    host int or a 0-dim device tensor (the fused engine's)."""
    if isinstance(num_draw, Tensor):
        return torch.clamp(num_draw - start, 0, width)
    return min(max(num_draw - start, 0), width)


def virtual_rows(starts: Tensor, row_end: Tensor, row_start: Tensor,
                 num_rows: int):
    """Virtual row v -> (tile_v, starts_v, ends_v, row_start_v).

    tile_v = the number of tiles whose rows end at or before v
    (searchsorted side="right" over the sorted, distinct row_end); the
    per-row values are the tile's own, and v past the last row maps to
    tile T with starts_v = ends_v = starts[T] and row_start_v =
    row_end[-1] — the integers of the JAX package's merge-sort map."""
    v = torch.arange(num_rows, dtype=torch.int32, device=row_end.device)
    tile_v = torch.searchsorted(row_end, v, right=True).to(torch.int32)
    return (tile_v, *row_tiles(tile_v, starts, row_start, row_end))


def _render(
    position: Tensor,   # [4, Np]
    wvp: Tensor,        # [4, 4] world-view-projection (row-vector), f32
    p00: Tensor,        # proj[0, 0], 0-dim f32
    p11: Tensor,        # proj[1, 1], 0-dim f32
    radius: Tensor,     # particle size (eye units), 0-dim f32
    intensity: Tensor,  # sprite intensity, 0-dim f32
    num_draw,           # draw count (decoupling knob): int, or 0-dim int32
    id_offset: int = 0,  # global id of column 0 (chunked renders)
    *,
    width: int,
    height: int,
    seg_q: int,         # sprites per segment row (perf knob, not coverage)
    dup_y: int,
    dup_x: int,
    near: float,
    blend: str,         # 'over' (exact) | 'additive' (order-free)
    frame_uint8: bool = False,
    return_trans: bool = False,
    composite: Callable = composite_tiles,
    sort: Callable = sort_kv_stable,
) -> FrameOutput:
    """One frame of `position`'s first `num_draw` particles. `composite`
    is the segmented composite (`ops/composite.composite_tiles`), `sort`
    the stable key + payload sort (`ops/sortkv.sort_kv_stable`); a caller
    may hand in their plain twins to compare on the card. No host sync: a
    CUDA graph can capture it (a device `num_draw` keeps the draw count
    out of the graph)."""
    dev = position.device
    n = position.shape[1]
    gh, gw = height // TILE_H, width // TILE_W
    num_tiles = gh * gw
    dup = dup_y * dup_x

    cx, cy, hx, hy, w_clip = _project(
        position, wvp, p00, p11, float(width), float(height), radius
    )
    _, cg, cb = _colors(position, id_offset)

    ids = torch.arange(n, dtype=torch.int32, device=dev)
    alive = (ids < num_draw) & (w_clip > near)

    # Sprite pixel rect [x0, x1) x [y0, y1); pixel centers at +0.5.
    px0 = _pixel_bound(cx - hx, width)
    px1 = _pixel_bound(cx + hx, width)
    py0 = _pixel_bound(cy - hy, height)
    py1 = _pixel_bound(cy + hy, height)
    nonempty = (px0 < px1) & (py0 < py1) & alive

    tx0 = px0 // TILE_W
    tx1 = (px1 - 1) // TILE_W
    ty0 = py0 // TILE_H
    ty1 = (py1 - 1) // TILE_H

    # Candidate tiles (ty0 + dy, tx0 + dx), one key plane per (dy, dx);
    # sprites spanning more tiles lose their far tiles -> `truncated`.
    # Keys are int32 tile ids; num_tiles marks "no tile".
    key_planes = []
    for dy in range(dup_y):
        for dx in range(dup_x):
            typ = ty0 + dy
            txp = tx0 + dx
            okp = nonempty & (typ <= ty1) & (txp <= tx1)
            key_planes.append(torch.where(okp, typ * gw + txp, num_tiles))
    span_h = ty1 - ty0 + 1
    span_w = tx1 - tx0 + 1
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    trunc_p = (torch.clamp(span_h - dup_y, min=0) * span_w
               + torch.clamp(span_w - dup_x, min=0)
               * torch.clamp(span_h, max=dup_y))
    truncated = torch.where(nonempty, trunc_p, zero_i).sum().to(torch.int32)
    span_y = torch.where(nonempty, span_h, zero_i).max().to(torch.int32)
    span_x = torch.where(nonempty, span_w, zero_i).max().to(torch.int32)

    # Degenerate sprites never bin to a tile, but their params still ride
    # the sort as payloads of sentinel entries; NaN/Inf there would poison
    # composite pixels through `x * 0 == NaN`, so sanitize the geometry
    # (the w-derived extents in the composite).
    cx = torch.nan_to_num(cx, nan=0.0, posinf=0.0, neginf=0.0)
    cy = torch.nan_to_num(cy, nan=0.0, posinf=0.0, neginf=0.0)

    def expand(a: Tensor) -> Tensor:  # per-particle [Np] -> per-entry [E]
        return a[:, None].expand(n, dup).reshape(-1)

    # Entry expansion e = p*dup + k, then ONE stable sort by tile key that
    # carries the four payloads the composite needs (the JAX package's
    # minimum: 1/(2h) is linear in w_clip, cr = 1 - cb, (cg, cb) share one
    # word as two f16 halves).
    key = torch.stack(key_planes, dim=1).reshape(-1)
    sorted_key, s_cx, s_cy, s_w, s_cgb = sort(
        key, expand(cx), expand(cy), expand(w_clip), expand(pack_cgb(cg, cb)))

    starts = torch.searchsorted(
        sorted_key,
        torch.arange(num_tiles + 1, dtype=torch.int32, device=dev),
        side="left",
    ).to(torch.int32)
    counts = starts[1:] - starts[:-1]                     # [T]

    # ---- exact segmented composite -----------------------------------------
    q = seg_q
    data_rows = -(-(n * dup) // q)         # ceil: sorted stream, Q-aligned
    num_rows = num_tiles + data_rows       # static bound on virtual rows

    ends = starts[1:]
    j_lo = starts[:-1] // q                              # first data row
    j_hi = torch.where(counts > 0, (ends - 1) // q, j_lo)  # last (incl.)
    segs = torch.where(counts > 0, j_hi - j_lo + 1, 1)     # empty -> 1 dummy
    row_end = torch.cumsum(segs, dim=0).to(torch.int32)  # [T]
    row_start = (row_end - segs).to(torch.int32)

    tile_v, starts_v, ends_v, row_start_v = virtual_rows(
        starts, row_end, row_start, num_rows)
    v = torch.arange(num_rows, dtype=torch.int32, device=dev)
    valid_v = v < row_end[-1]
    counts_v = ends_v - starts_v
    seg_v = v - row_start_v
    j_v = starts_v // q + seg_v                      # data row index [V]
    lo_k = torch.clamp(starts_v - j_v * q, 0, q)
    hi_k = torch.clamp(ends_v - j_v * q, 0, q)
    hi_k = torch.where(valid_v & (counts_v > 0), hi_k, zero_i)

    # 1/(2hx) is linear in w_clip: the composite derives it per slot
    inv_sx = 1.0 / (radius * p00 * float(width))
    inv_sy = 1.0 / (radius * p11 * float(height))
    color, trans = composite(
        s_cx, s_cy, s_w, s_cgb, starts, tile_v, j_v, lo_k, hi_k, row_start,
        row_end, inv_sx, inv_sy, intensity, q=q, grid=(gh, gw),
        tile=(TILE_H, TILE_W), blend=blend)

    if return_trans:
        # chunked-composite mode: UNclipped premultiplied color + the
        # transmittance plane; the caller folds chunks associatively
        return FrameOutput(color, truncated, span_y, span_x, trans)

    frame = torch.clamp(color, 0.0, 1.0)
    if frame_uint8:
        # the reference swap chain's R8G8B8A8_UNORM analog (`Render.cpp:292`)
        frame = (frame * 255.0 + 0.5).to(torch.uint8)
    return FrameOutput(frame, truncated, span_y, span_x)


def _chunk_width(n: int, chunk_size: int):
    """(k, cn): k lane-aligned chunks of width cn covering n particles.

    No exact-divisor requirement; the last chunk carries a parked-padding
    tail."""
    k = -(-n // chunk_size)
    cn = -(-(-(-n // k)) // 128) * 128
    k = -(-n // cn)
    return k, cn


def _chunked_fold(
    position, wvp, p00, p11, size, intensity, num_draw,
    *, width, height, seg_q, dup_y, dup_x, near, blend,
    chunk_size, frame_uint8, composite: Callable = composite_tiles,
    sort: Callable = sort_kv_stable,
) -> FrameOutput:
    """Fold id-ordered particle chunks through the associative composite:
    later ∘ earlier = (C_l + C_e T_l, T_e T_l). Each chunk renders with its
    global id offset (colors) and its slice of the num_draw prefix; equals
    the single-pass frame up to fp reassociation of the per-pixel blend."""
    n = position.shape[1]
    k, cn = _chunk_width(n, chunk_size)
    if k * cn > n:
        pad = torch.full((4, k * cn - n), PAD_POSITION, dtype=position.dtype,
                         device=position.device)
        pad[3].zero_()
        position = torch.cat([position, pad], dim=1)
    nd_global = n if num_draw is None else num_draw

    cf = tf = trunc = sy = sx = None
    for i in range(k):
        chunk = position[:, i * cn:(i + 1) * cn]
        out = _render(
            chunk, wvp, p00, p11, size, intensity,
            _chunk_draw(nd_global, i * cn, cn), i * cn,
            width=width, height=height, seg_q=seg_q,
            dup_y=dup_y, dup_x=dup_x, near=near, blend=blend,
            return_trans=True, composite=composite, sort=sort,
        )
        if cf is None:
            cf, tf = out.frame, out.trans
            trunc, sy, sx = out.truncated, out.span_y, out.span_x
        else:
            cf = out.frame + cf * out.trans[..., None]
            tf = tf * out.trans
            trunc = trunc + out.truncated
            sy = torch.maximum(sy, out.span_y)
            sx = torch.maximum(sx, out.span_x)
    frame = torch.clamp(cf, 0.0, 1.0)
    if frame_uint8:
        frame = (frame * 255.0 + 0.5).to(torch.uint8)
    return FrameOutput(frame, trunc, sy, sx)


class Renderer:
    """Headless splat renderer with reference semantics.

    The composite is exact at any tile depth; `seg_q` is a pure performance
    knob (sprites per segment row). `last_truncated` reports sprites larger
    than the dup_y x dup_x tile window (fix by raising those). The sort
    and composite kernels run on CUDA tensors; CPU tensors take their
    twins.
    """

    def __init__(
        self,
        config: Optional[RenderConfig] = None,
        seg_q: Optional[int] = None,
        dup_y: int = 2,
        dup_x: int = 2,
        blend: str = "over",
        auto_raise_dup: bool = True,
    ):
        """seg_q None = adaptive: ~half the mean entries/tile, clamped to
        [32, 256] (the JAX package's rule)."""
        self.config = config or RenderConfig()
        if self.config.width % TILE_W or self.config.height % TILE_H:
            raise ValueError(
                f"width must be a multiple of {TILE_W} and height of {TILE_H}"
            )
        self.seg_q = seg_q
        self.dup_y = dup_y
        self.dup_x = dup_x
        self.blend = blend
        # When a frame reports truncation (a sprite spans more tiles than
        # the dup window), grow dup_y/dup_x to the frame's measured max
        # span so the NEXT render is lossless; `render()` also re-renders
        # the same frame immediately.
        self.auto_raise_dup = auto_raise_dup
        self.last_truncated = 0
        # Per-frame scalar cache, per device: a static camera and unchanged
        # size/intensity reuse the same device scalars instead of six small
        # host->device copies per frame.
        self._args = {}
        # States above the threshold render in `chunk_size`-particle chunks
        # folded through the associative composite (bounded memory at any
        # N); the JAX package's sizes, so the 4M default renders as 4 x 1M.
        self.chunk_threshold = 3_145_728
        self.chunk_size = 1_048_576
        # Auto-raise budget: dup growth may not push N x dup sort entries
        # past this (see raise_dup_values).
        self.entry_budget = 64 * 1024 * 1024
        # The kernels' wrappers (their plain twins run for CPU tensors);
        # each replaceable by its twin to compare the two on the card.
        self.composite = composite_tiles
        self.sort = sort_kv_stable
        self._last_n = 0
        # particles per sort of the LAST render: == _last_n for single-pass
        # frames, the chunk width for chunked ones (drives the budget)
        self._last_sort_n = 0

    def resolve_seg_q(self, n: int, seg_q: Optional[int] = None) -> int:
        """Adaptive segment size: ~half the mean entries per tile, [32, 256]."""
        q = seg_q or self.seg_q
        if q is not None:
            return q
        cfg = self.config
        tiles = (cfg.width // TILE_W) * (cfg.height // TILE_H)
        density = n * self.dup_y * self.dup_x // max(tiles, 1)
        q = 32
        while q < 256 and q * 2 <= density // 2:
            q *= 2
        return q

    def render_arrays(
        self,
        position: Tensor,
        camera: Camera,
        particle_size: float,
        particle_intensity: float,
        num_draw: Optional[int] = None,
        seg_q: Optional[int] = None,
    ) -> FrameOutput:
        """One render (async launches, no host sync). States larger than
        `chunk_threshold` render in id-ordered chunks (see `_chunked_fold`)."""
        n = position.shape[1]
        nd = int(n if num_draw is None else num_draw)
        args = self._device_args(camera, particle_size, particle_intensity,
                                 position.device)
        return self.render_with(position, args, nd, seg_q)

    def render_with(self, position: Tensor, args, num_draw,
                    seg_q: Optional[int] = None,
                    frame_uint8: Optional[bool] = None) -> FrameOutput:
        """`render_arrays` on device arguments already made: `args` =
        (wvp, p00, p11, size, intensity) as `_device_args` orders them, and
        `num_draw` an int or a 0-dim int32 tensor on position's device. With
        tensors that stay put (the fused engine's), a CUDA graph can
        capture this call and replay it as the arguments change.
        `frame_uint8` defaults to the config's."""
        cfg = self.config
        n = position.shape[1]
        self._last_n = n
        if frame_uint8 is None:
            frame_uint8 = cfg.frame_uint8
        kw = dict(width=cfg.width, height=cfg.height, dup_y=self.dup_y,
                  dup_x=self.dup_x, near=cfg.near, blend=self.blend,
                  frame_uint8=frame_uint8, composite=self.composite,
                  sort=self.sort)
        if n > self.chunk_threshold:
            _, cn = _chunk_width(n, self.chunk_size)
            self._last_sort_n = cn
            return _chunked_fold(
                position, *args, num_draw,
                seg_q=self.resolve_seg_q(cn, seg_q),
                chunk_size=self.chunk_size, **kw,
            )
        self._last_sort_n = n
        return _render(
            position, *args, num_draw,
            seg_q=self.resolve_seg_q(n, seg_q), **kw,
        )

    def frame_args(self, camera, particle_size, particle_intensity):
        """The frame's camera/scalar arguments on the host: (wvp [4, 4]
        float32 array, p00, p11, size, intensity as floats)."""
        cfg = self.config
        proj = camera.projection_matrix(cfg.aspect, cfg.fov_y, cfg.near,
                                        cfg.far)
        wvp = camera.world_view_projection(
            cfg.aspect, fov_y=cfg.fov_y, near=cfg.near, far=cfg.far
        )
        return (np.asarray(wvp, np.float32),
                abs(float(np.float32(proj[0, 0]))),
                abs(float(np.float32(proj[1, 1]))),
                float(particle_size), float(particle_intensity))

    def _device_args(self, camera, particle_size, particle_intensity, device):
        """Camera/scalar device arguments through the per-frame cache."""
        host = self.frame_args(camera, particle_size, particle_intensity)
        akey = (host[0].tobytes(), *host[1:])
        hit = self._args.get(str(device))
        if hit is None or hit[0] != akey:
            hit = (akey, (torch.tensor(host[0], device=device), *(
                torch.tensor(x, dtype=torch.float32, device=device)
                for x in host[1:])))
            self._args[str(device)] = hit
        return hit[1]

    def render_mesh(
        self,
        position,
        camera: Camera,
        particle_size: float,
        particle_intensity: float,
        mesh,
        num_draw: Optional[int] = None,
        seg_q: Optional[int] = None,
        device=None,
    ) -> FrameOutput:
        """Mesh-sharded frame of `position` (a `parallel.mesh.Sharded`
        [4, N] over `mesh`): each rank renders its id-contiguous columns
        on its own device to a premultiplied (color, transmittance) pair
        (`_render(..., return_trans=True)` with its global id offset and
        its slice of the num_draw prefix), and the pairs fold in id order
        on `device` (default: the first rank's) — `_chunked_fold`'s
        association at chunk = N / D, so the frame is bitwise the chunked
        one at that partition. Truncated counts sum and spans take the
        max. Only image pairs cross devices, O(pixels x ranks) whatever N
        (the reference copies every position to its render adapter,
        `Render.cpp:814`)."""
        cfg = self.config
        n = position.shape[1]
        d = mesh.size
        if n % (d * 128):
            raise ValueError(
                f"render_mesh needs the padded particle count ({n}) "
                f"divisible by devices x lanes ({d} x 128); pad the state "
                "(models/state.py pads to 128 lanes — choose a mesh whose "
                "size divides the lane count)")
        cn = n // d
        self._last_n = n
        self._last_sort_n = cn
        nd = int(n if num_draw is None else num_draw)
        device = torch.device(mesh.devices[0] if device is None else device)
        kw = dict(width=cfg.width, height=cfg.height,
                  seg_q=self.resolve_seg_q(cn, seg_q), dup_y=self.dup_y,
                  dup_x=self.dup_x, near=cfg.near, blend=self.blend,
                  return_trans=True, composite=self.composite,
                  sort=self.sort)
        cf = tf = trunc = sy = sx = None
        for r, chunk in enumerate(position.shards):
            args = self._device_args(camera, particle_size,
                                     particle_intensity, chunk.device)
            out = _render(chunk, *args, _chunk_draw(nd, r * cn, cn), r * cn,
                          **kw)
            c, t = out.frame.to(device), out.trans.to(device)
            if cf is None:
                cf, tf = c, t
                trunc, sy, sx = (x.to(device) for x in (
                    out.truncated, out.span_y, out.span_x))
            else:
                cf = c + cf * t[..., None]
                tf = tf * t
                trunc = trunc + out.truncated.to(device)
                sy = torch.maximum(sy, out.span_y.to(device))
                sx = torch.maximum(sx, out.span_x.to(device))
        frame = torch.clamp(cf, 0.0, 1.0)
        if cfg.frame_uint8:
            frame = (frame * 255.0 + 0.5).to(torch.uint8)
        return FrameOutput(frame, trunc, sy, sx)

    def raise_dup_for(self, out: FrameOutput) -> bool:
        """Grow the dup window to a frame's measured max sprite span (three
        host reads; `RenderEngine.present` packs them into one)."""
        return self.raise_dup_values(
            int(out.truncated), int(out.span_y), int(out.span_x)
        )

    def raise_dup_values(self, truncated: int, span_y: int,
                         span_x: int) -> bool:
        """`raise_dup_for` on already-pulled host scalars. Returns True if
        the window grew. The growth is bounded by `entry_budget` (sort
        entries = N x dup); beyond it the frame stays truncated and
        counted."""
        if truncated == 0:
            return False
        gh = self.config.height // TILE_H
        gw = self.config.width // TILE_W
        new_y = max(self.dup_y, min(int(span_y), gh))
        new_x = max(self.dup_x, min(int(span_x), gw))
        n = self._last_sort_n or self._last_n or 0
        if n:
            max_dup = max(4, self.entry_budget // n)
            while new_y * new_x > max_dup:
                # shrink the larger axis first; never below the current
                if new_y >= new_x and new_y > self.dup_y:
                    new_y -= 1
                elif new_x > self.dup_x:
                    new_x -= 1
                else:
                    break
        if (new_y, new_x) == (self.dup_y, self.dup_x):
            return False
        self.dup_y, self.dup_x = new_y, new_x
        return True

    def render(self, position, camera, particle_size, particle_intensity,
               num_draw=None) -> Tensor:
        """One frame (exact at any depth), tracking the truncation metric;
        a truncating frame raises the dup window and re-renders."""
        out = self.render_arrays(
            position, camera, particle_size, particle_intensity, num_draw
        )
        if self.auto_raise_dup and self.raise_dup_for(out):
            out = self.render_arrays(
                position, camera, particle_size, particle_intensity, num_draw
            )
        self.last_truncated = int(out.truncated)
        return out.frame
