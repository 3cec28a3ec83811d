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
   A stable sort by tile key orders entries by tile, then particle id —
   the draw order of the reference's single DrawInstanced
   (`Render.cpp:891`) — and the payloads follow by index gather.
3. **Composite** exactly at any depth: over-composition with a per-sprite
   source clamp is associative on (premultiplied color, transmittance), so
   the sorted stream splits into Q-aligned data rows; each (data row, tile)
   intersection is a virtual row of one depth-Q pass — the hand-written
   CUDA kernel `ops/composite.py` on CUDA tensors, its plain twin on CPU —
   and consecutive rows of a tile tree-combine in O(log rows) passes.

What changed against the JAX package, and why it is the same result:
- entry expansion: a broadcast-and-reshape of the key planes (the JAX
  package's MXU permutation matmul was a TPU layout workaround); payloads
  gather through `perm // dup` from the per-particle arrays;
- sort: `torch.sort(key, stable=True)` + index gathers replace the
  5-operand stable `lax.sort` (same permutation: stable, same keys);
- tile starts: `torch.searchsorted(..., side="left")`, which the JAX
  package's `_starts_two_level` docstring states it equals;
- virtual-row map: `torch.searchsorted(row_end, v, right=True)` + gathers
  replace the merge sort; the integers are the same;
- (cg, cb) keep the JAX package's f16 rounding (it packed them as two
  f16 halves of one lane) — without it frames only match at golden
  tolerance.

`truncated` counts sprite-tile entries outside the dup_y x dup_x candidate
window.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from multi_adapter_particles_torch import constants as C
from multi_adapter_particles_torch.config import RenderConfig
from multi_adapter_particles_torch.models.state import PAD_POSITION
from multi_adapter_particles_torch.ops.composite import composite_rows
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


def virtual_rows(starts: Tensor, row_end: Tensor, row_start: Tensor,
                 num_rows: int):
    """Virtual row v -> (tile_v, starts_v, ends_v, row_start_v).

    tile_v = the number of tiles whose rows end at or before v
    (searchsorted side="right" over the sorted, distinct row_end); the
    per-row values are the tile's own, and v past the last row maps to
    tile T with starts_v = ends_v = starts[T] and row_start_v =
    row_end[-1] — the integers of the JAX package's merge-sort map."""
    num_tiles = row_end.shape[0]
    v = torch.arange(num_rows, dtype=torch.int32, device=row_end.device)
    tile_v = torch.searchsorted(row_end, v, right=True).to(torch.int32)
    tv = tile_v.long()
    starts_v = starts[tv]
    ends_v = starts[torch.clamp(tv + 1, max=num_tiles)]
    row_start_v = torch.cat([row_start, row_end[-1:]])[tv]
    return tile_v, starts_v, ends_v, row_start_v


def _render(
    position: Tensor,   # [4, Np]
    wvp: Tensor,        # [4, 4] world-view-projection (row-vector), f32
    p00: Tensor,        # proj[0, 0], 0-dim f32
    p11: Tensor,        # proj[1, 1], 0-dim f32
    radius: Tensor,     # particle size (eye units), 0-dim f32
    intensity: Tensor,  # sprite intensity, 0-dim f32
    num_draw: int,      # draw count (decoupling knob)
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
    composite: Callable = composite_rows,
) -> FrameOutput:
    """One frame of `position`'s first `num_draw` particles. `composite`
    is the depth-Q pass (`ops/composite.composite_rows`; a caller may hand
    in its plain twin to compare the two on the card)."""
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
    alive = (ids < int(num_draw)) & (w_clip > near)

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
    # Keys are f32 tile ids (exact below 2^24); num_tiles marks "no tile".
    key_planes = []
    for dy in range(dup_y):
        for dx in range(dup_x):
            typ = ty0 + dy
            txp = tx0 + dx
            okp = nonempty & (typ <= ty1) & (txp <= tx1)
            key_planes.append(torch.where(
                okp, (typ * gw + txp).to(torch.float32),
                torch.tensor(float(num_tiles), device=dev)))
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
    # along as payloads of sentinel entries; NaN/Inf there would poison
    # composite pixels through `x * 0 == NaN`, so sanitize the geometry.
    cx = torch.nan_to_num(cx, nan=0.0, posinf=0.0, neginf=0.0)
    cy = torch.nan_to_num(cy, nan=0.0, posinf=0.0, neginf=0.0)
    # (cg, cb) rounded through f16, as the JAX package carries them; cg
    # clamped below f16-inf (the blend clips source terms to [0, 1] anyway)
    cg16 = torch.clamp(cg, 0.0, 6.0e4).to(torch.float16).to(torch.float32)
    cb16 = cb.to(torch.float16).to(torch.float32)

    # Entry expansion e = p*dup + k, then ONE stable sort by tile key.
    key = torch.stack(key_planes, dim=1).reshape(-1)
    sorted_key, perm = torch.sort(key, stable=True)
    pidx = perm // dup  # the particle of each sorted entry

    starts = torch.searchsorted(
        sorted_key,
        torch.arange(num_tiles + 1, dtype=torch.float32, device=dev),
        side="left",
    ).to(torch.int32)
    counts = starts[1:] - starts[:-1]                     # [T]

    # ---- exact segmented composite -----------------------------------------
    px_count = TILE_H * TILE_W
    e_total = n * dup
    q = seg_q
    data_rows = -(-e_total // q)           # ceil: sorted stream, Q-aligned
    e_pad = data_rows * q - e_total        # tail padding (beyond all ends)
    max_segs = data_rows + 1               # one tile could span everything
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
    tile_vc = torch.clamp(tile_v, 0, num_tiles - 1)
    counts_v = ends_v - starts_v
    seg_v = v - row_start_v
    j_v = starts_v // q + seg_v                      # data row index [V]
    lo_k = torch.clamp(starts_v - j_v * q, 0, q)
    hi_k = torch.clamp(ends_v - j_v * q, 0, q)
    hi_k = torch.where(valid_v & (counts_v > 0), hi_k, zero_i)

    kk = torch.arange(q, dtype=torch.int32, device=dev)
    valid_k = (kk[:, None] >= lo_k[None, :]) & (kk[:, None] < hi_k[None, :])
    t_sa = torch.where(valid_k, intensity, 0.0)  # [Q, V]; dead slots blend 0

    # Payloads per sorted entry, Q-aligned rows gathered per virtual row.
    # Rows past the stream (dead virtual rows only) clamp to the last data
    # row, as the JAX gather does; their slots are dead either way.
    j_g = torch.clamp(j_v, max=data_rows - 1).long()

    def rows(a: Tensor) -> Tensor:  # per-particle [Np] -> [Q, V]
        s = a[pidx]
        if e_pad:
            s = torch.cat([s, s.new_zeros(e_pad)])
        return s.reshape(data_rows, q)[j_g].T

    t_cx, t_cy, t_w = rows(cx), rows(cy), rows(w_clip)
    t_cg, t_cb = rows(cg16), rows(cb16)
    # post-gather derivations: 1/(2hx) is linear in w_clip
    inv_sx = 1.0 / (radius * p00 * float(width))
    inv_sy = 1.0 / (radius * p11 * float(height))
    t_ihx = torch.nan_to_num(t_w * inv_sx, nan=0.0, posinf=0.0, neginf=0.0)
    t_ihy = torch.nan_to_num(t_w * inv_sy, nan=0.0, posinf=0.0, neginf=0.0)
    t_cr = 1.0 - t_cb
    sp = torch.stack([t_cx, t_cy, t_ihx, t_ihy, t_cr, t_cg, t_cb, t_sa])

    bases = torch.stack([
        ((tile_vc % gw) * TILE_W).to(torch.float32),
        ((tile_vc // gw) * TILE_H).to(torch.float32),
    ])                                              # [2, V]
    out4 = composite(sp.contiguous(), bases, TILE_H, TILE_W,
                     blend=blend, row_hi=hi_k.contiguous())
    chans = [out4[0].T, out4[1].T, out4[2].T]       # [V, px]
    tv = out4[3].T

    # tree-combine segment rows (consecutive rows share a tile); per-row
    # segment count derived from the row's own starts/ends (invalid rows
    # get 1, which disables partner takes — their contents are never read)
    segs_v = torch.where(
        counts_v > 0, (ends_v - 1) // q - starts_v // q + 1, 1)
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

    # segment-0 row holds each tile's composite
    rs = row_start.long()
    frame_t = torch.stack([c[rs] for c in chans], dim=1)  # [T, 3, px]

    def assemble(t, ch):  # [T, ch, th*tw] -> [H, W, ch] (or [H, W])
        t = t.reshape(gh, gw, ch, TILE_H, TILE_W)
        t = t.permute(0, 3, 1, 4, 2).reshape(height, width, ch)
        return t[..., 0] if ch == 1 else t

    if return_trans:
        # chunked-composite mode: UNclipped premultiplied color + the
        # transmittance plane; the caller folds chunks associatively
        return FrameOutput(
            assemble(frame_t, 3), truncated, span_y, span_x,
            assemble(tv[rs][:, None, :], 1),
        )

    frame = assemble(torch.clamp(frame_t, 0.0, 1.0), 3)
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
    chunk_size, frame_uint8, composite: Callable = composite_rows,
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
    nd_global = n if num_draw is None else int(num_draw)

    cf = tf = trunc = sy = sx = None
    for i in range(k):
        chunk = position[:, i * cn:(i + 1) * cn]
        nd = min(max(nd_global - i * cn, 0), cn)
        out = _render(
            chunk, wvp, p00, p11, size, intensity, nd, i * cn,
            width=width, height=height, seg_q=seg_q,
            dup_y=dup_y, dup_x=dup_x, near=near, blend=blend,
            return_trans=True, composite=composite,
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
    than the dup_y x dup_x tile window (fix by raising those). The composite
    kernel runs for every Q on CUDA tensors; CPU tensors take its twin.
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
        # Per-frame scalar cache: a static camera and unchanged
        # size/intensity reuse the same device scalars instead of six small
        # host->device copies per frame.
        self._arg_key = None
        self._arg_dev = None
        # States above the threshold render in `chunk_size`-particle chunks
        # folded through the associative composite (bounded memory at any
        # N); the JAX package's sizes, so the 4M default renders as 4 x 1M.
        self.chunk_threshold = 3_145_728
        self.chunk_size = 1_048_576
        # Auto-raise budget: dup growth may not push N x dup sort entries
        # past this (see raise_dup_values).
        self.entry_budget = 64 * 1024 * 1024
        # The depth-Q composite pass: the CUDA kernel's wrapper (its plain
        # twin runs for CPU tensors); replaceable to compare the two.
        self.composite = composite_rows
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
        cfg = self.config
        n = position.shape[1]
        self._last_n = n
        nd = int(n if num_draw is None else num_draw)
        wvp, p00, p11, size, intensity = self._device_args(
            camera, particle_size, particle_intensity, position.device
        )
        kw = dict(width=cfg.width, height=cfg.height, dup_y=self.dup_y,
                  dup_x=self.dup_x, near=cfg.near, blend=self.blend,
                  frame_uint8=cfg.frame_uint8, composite=self.composite)
        if n > self.chunk_threshold:
            _, cn = _chunk_width(n, self.chunk_size)
            self._last_sort_n = cn
            return _chunked_fold(
                position, wvp, p00, p11, size, intensity, nd,
                seg_q=self.resolve_seg_q(cn, seg_q),
                chunk_size=self.chunk_size, **kw,
            )
        self._last_sort_n = n
        return _render(
            position, wvp, p00, p11, size, intensity, nd,
            seg_q=self.resolve_seg_q(n, seg_q), **kw,
        )

    def _device_args(self, camera, particle_size, particle_intensity, device):
        """Camera/scalar device arguments through the per-frame cache."""
        cfg = self.config
        proj = camera.projection_matrix(cfg.aspect, cfg.fov_y, cfg.near,
                                        cfg.far)
        wvp = camera.world_view_projection(
            cfg.aspect, fov_y=cfg.fov_y, near=cfg.near, far=cfg.far
        )
        akey = (
            wvp.tobytes(), float(proj[0, 0]), float(proj[1, 1]),
            float(particle_size), float(particle_intensity), str(device),
        )
        if akey != self._arg_key:
            def f32(x):
                return torch.tensor(x, dtype=torch.float32, device=device)

            self._arg_dev = (
                torch.tensor(np.asarray(wvp, np.float32), device=device),
                f32(abs(float(np.float32(proj[0, 0])))),
                f32(abs(float(np.float32(proj[1, 1])))),
                f32(float(particle_size)),
                f32(float(particle_intensity)),
            )
            self._arg_key = akey
        return self._arg_dev

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
