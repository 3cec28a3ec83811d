"""Tile-binned point-sprite splatter (torch).

The port of the JAX package's `render/renderer.py`, with its semantics and
its numbers, not its TPU workarounds. The reference's draw path is VS -> GS
billboard expand -> PS radial sprite -> alpha blend in ROP hardware
(`ParticleDraw.hlsl`, blend state `Render.cpp:522-532`); here it is a
gather:

1. **Project** all particles. Billboards are eye-space axis-aligned
   squares, so each sprite projects to a screen-axis-aligned rectangle:
   (center, half-extents, rgb, intensity).
2. **Bin** sprites to (TILE_H x TILE_W) pixel tiles. By default every
   drawn sprite emits exactly the tiles its rectangle covers
   (`ops/binning.bin_sprites`: hand-written CUDA kernels, a plain twin on
   CPU), at offsets from a scan of the counts in particle order, into
   `entry_factor` x N entries of fixed capacity; the tail holds the
   sentinel key. Given a dup window, each particle emits dup_y x dup_x
   candidate (tile, id) entries instead, entry e = p*dup + k (the JAX
   package's binning, `_bin_window`). ONE stable sort of the int32 tile
   keys carries the entries' four payloads (cx, cy, w_clip, and (cg, cb)
   packed as two f16 halves) and orders them by tile, then particle id —
   the draw order of the reference's single DrawInstanced
   (`Render.cpp:891`): the hand-written CUDA kernel `ops/sortkv.py` on
   CUDA tensors, its plain twin on CPU. Both binnings give the same sorted
   live stream when the window holds every sprite. The exact binning's
   sort stops at its entry count (`live=`), read on the device: the
   sentinel tail is already where the sort would put it.
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

- the exact binning draws every sprite whole, where the JAX package drops
  the tiles outside its window until a host read grows it (`PARITY.md`).

`truncated` counts the tile entries a frame dropped: past the exact
binning's capacity, or outside the dup_y x dup_x window. States past
`chunk_threshold` render in id-ordered chunks folded through the
associative composite (`_chunked_fold`); `Renderer.render_mesh` does the
same with each chunk a rank's shard on its own device.

Every operation of a render runs inside one of four spans
(`runtime/trace.py`): `render.bin` (the exact binning),
`render.project` (the device arguments; on the window path the
projection, colours, tile keys and the entry expansion; a chunk's slice
and padding), `render.sort` (the sort, the tile starts and the
virtual-row map) and `render.composite` (the composite, the chunk and
rank folds, the clamp and the uint8 pack); `render_mesh`'s gather of the
ranks' image pairs runs inside `render.copy`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from multi_adapter_particles_torch.config import RenderConfig
from multi_adapter_particles_torch.models.state import PAD_POSITION
from multi_adapter_particles_torch.ops.binning import (
    bin_sprites,
    colors as _colors,
    pixel_bound as _pixel_bound,
    project as _project,
)
from multi_adapter_particles_torch.ops.composite import (  # noqa: F401
    composite_tiles,
    pack_cgb,
    row_tiles,
    unpack_cgb,   # the pair's decoder, public here as in the JAX package
)
from multi_adapter_particles_torch.ops.sortkv import sort_kv_stable
from multi_adapter_particles_torch.render.camera import Camera
from multi_adapter_particles_torch.runtime import trace

Tensor = torch.Tensor

# Tile shape (8, 16) pixels: the JAX package's choice, kept so virtual rows
# and segment counts compare 1:1 (a default sprite covers ~25 px).
TILE_H = 8
TILE_W = 16


class FrameOutput(NamedTuple):
    frame: Tensor         # [H, W, 3] float32 in [0, 1] (uint8 in u8 mode)
    truncated: Tensor     # int32 — tile entries the frame dropped: past
    #                       the exact binning's capacity, or outside the
    #                       dup window
    span_y: Tensor        # int32 — max tile rows any live sprite covers
    span_x: Tensor        # int32 — max tile cols any live sprite covers
    trans: Optional[Tensor] = None  # [H, W] transmittance (return_trans
    #                       mode: frame then holds UNclipped premultiplied
    #                       color — the chunked-fold state)
    entries: Optional[Tensor] = None  # int32 — tile entries the exact
    #                       binning wrote (None on the window path)
    blends: Optional[Tensor] = None  # int64 — (entry, 32-pixel block)
    #                       pairs the composite blended (`composite_tiles`)


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


def _bin_window(position, wvp, p00, p11, radius, num_draw, id_offset, *,
                width, height, dup_y, dup_x, near):
    """The dup-window binning: each particle emits dup_y x dup_x candidate
    (tile, id) entries, entry e = p*dup + k; sprites spanning more tiles
    lose their far tiles -> `truncated`. -> (key, payloads, truncated,
    span_y, span_x). The path held bitwise against the JAX package."""
    dev = position.device
    n = position.shape[1]
    gw = width // TILE_W
    num_tiles = (height // TILE_H) * gw
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

    def expand(a: Tensor) -> Tensor:  # per-particle [Np] -> [E]
        return a[:, None].expand(n, dup).reshape(-1)

    # Entry expansion e = p*dup + k, for ONE stable sort by tile key that
    # carries the four payloads the composite needs (the JAX package's
    # minimum: 1/(2h) is linear in w_clip, cr = 1 - cb, (cg, cb) share one
    # word as two f16 halves).
    key = torch.stack(key_planes, dim=1).reshape(-1)
    payloads = (expand(cx), expand(cy), expand(w_clip),
                expand(pack_cgb(cg, cb)))
    return key, payloads, truncated, span_y, span_x


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
    near: float,
    blend: str,         # 'over' (exact) | 'additive' (order-free)
    dup_y: Optional[int] = None,  # a dup window (both or neither): the
    dup_x: Optional[int] = None,  # window path; None: the exact binning
    entry_factor: int = 4,  # exact binning: sort entries per particle
    frame_uint8: bool = False,
    return_trans: bool = False,
    composite: Callable = composite_tiles,
    sort: Callable = sort_kv_stable,
    bin: Callable = bin_sprites,
) -> FrameOutput:
    """One frame of `position`'s first `num_draw` particles. `bin` is the
    exact binning (`ops/binning.bin_sprites`), `sort` the stable key +
    payload sort (`ops/sortkv.sort_kv_stable`; on the exact path given
    `live=` the binning's entry count), `composite` the segmented
    composite (`ops/composite.composite_tiles`); a caller may hand in
    their plain twins to compare on the card. No host sync: a CUDA graph
    can capture it (a device `num_draw` keeps the draw count out of the
    graph).

    With no window the binning is exact: `entry_factor * Np` entries of
    fixed capacity, every drawn sprite's tiles at offsets in particle
    order, `truncated` the entries past the capacity. With a window
    (`dup_y`, `dup_x`) it is the JAX package's dup-window binning."""
    dev = position.device
    n = position.shape[1]
    gh, gw = height // TILE_H, width // TILE_W
    num_tiles = gh * gw
    q = seg_q
    entries = None

    if (dup_y is None) != (dup_x is None):
        raise ValueError("give both dup_y and dup_x, or neither")
    if dup_y is None:
        e_total = entry_factor * n
        with trace.span("render.bin"):
            key, *payloads, stats = bin(
                position, wvp, p00, p11, radius, num_draw, id_offset,
                width=width, height=height, near=near, capacity=e_total,
                row=q, tile=(TILE_H, TILE_W))
            entries, truncated, span_y, span_x = stats.unbind()
    else:
        e_total = n * dup_y * dup_x
        with trace.span("render.project"):
            key, payloads, truncated, span_y, span_x = _bin_window(
                position, wvp, p00, p11, radius, num_draw, id_offset,
                width=width, height=height, dup_y=dup_y, dup_x=dup_x,
                near=near)

    with trace.span("render.sort"):
        # the exact binning's sentinel tail is already in its sorted
        # place: only its entries are sorted, in the binning's arrays
        # (nothing reads them unsorted again); the window path's sentinels
        # lie among its entries, so it sorts them all
        live = {} if entries is None else {"live": entries}
        sorted_key, s_cx, s_cy, s_w, s_cgb = sort(key, *payloads, **live)

        starts = torch.searchsorted(
            sorted_key,
            torch.arange(num_tiles + 1, dtype=torch.int32, device=dev),
            side="left",
        ).to(torch.int32)
        counts = starts[1:] - starts[:-1]                     # [T]

        # ---- the virtual-row map of the exact segmented composite --------
        data_rows = -(-e_total // q)        # ceil: sorted stream, Q-aligned
        num_rows = num_tiles + data_rows    # static bound on virtual rows

        ends = starts[1:]
        j_lo = starts[:-1] // q                              # first data row
        j_hi = torch.where(counts > 0, (ends - 1) // q, j_lo)  # last (incl.)
        segs = torch.where(counts > 0, j_hi - j_lo + 1, 1)  # empty -> 1 dummy
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
        hi_k = torch.where(valid_v & (counts_v > 0), hi_k, 0)

    with trace.span("render.composite"):
        # 1/(2hx) is linear in w_clip: the composite derives it per slot
        inv_sx = 1.0 / (radius * p00 * float(width))
        inv_sy = 1.0 / (radius * p11 * float(height))
        color, trans, blends = composite(
            s_cx, s_cy, s_w, s_cgb, starts, tile_v, j_v, lo_k, hi_k,
            row_start, row_end, inv_sx, inv_sy, intensity, q=q,
            grid=(gh, gw), tile=(TILE_H, TILE_W), blend=blend)

        if return_trans:
            # chunked-composite mode: UNclipped premultiplied color + the
            # transmittance plane; the caller folds chunks associatively
            return FrameOutput(color, truncated, span_y, span_x, trans,
                               entries, blends)

        frame = torch.clamp(color, 0.0, 1.0)
        if frame_uint8:
            # the reference swap chain's R8G8B8A8_UNORM analog
            # (`Render.cpp:292`)
            frame = (frame * 255.0 + 0.5).to(torch.uint8)
    return FrameOutput(frame, truncated, span_y, span_x, entries=entries,
                       blends=blends)


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
    *, width, height, seg_q, near, blend, chunk_size, frame_uint8,
    dup_y=None, dup_x=None, entry_factor=4,
    composite: Callable = composite_tiles,
    sort: Callable = sort_kv_stable, bin: Callable = bin_sprites,
) -> FrameOutput:
    """Fold id-ordered particle chunks through the associative composite:
    later ∘ earlier = (C_l + C_e T_l, T_e T_l). Each chunk renders with its
    global id offset (colors) and its slice of the num_draw prefix; equals
    the single-pass frame up to fp reassociation of the per-pixel blend."""
    n = position.shape[1]
    k, cn = _chunk_width(n, chunk_size)
    if k * cn > n:
        with trace.span("render.project"):
            pad = torch.full((4, k * cn - n), PAD_POSITION,
                             dtype=position.dtype, device=position.device)
            pad[3].zero_()
            position = torch.cat([position, pad], dim=1)
    nd_global = n if num_draw is None else num_draw

    acc = None
    for i in range(k):
        with trace.span("render.project"):
            chunk = position[:, i * cn:(i + 1) * cn]
            chunk_draw = _chunk_draw(nd_global, i * cn, cn)
        out = _render(
            chunk, wvp, p00, p11, size, intensity, chunk_draw, i * cn,
            width=width, height=height, seg_q=seg_q, near=near,
            blend=blend, dup_y=dup_y, dup_x=dup_x, entry_factor=entry_factor,
            return_trans=True, composite=composite, sort=sort, bin=bin,
        )
        if acc is None:
            acc = out
        else:
            with trace.span("render.composite"):
                acc = _fold(acc, out)
    with trace.span("render.composite"):
        return _finish(acc, frame_uint8)


def _fold(earlier: FrameOutput, later: FrameOutput) -> FrameOutput:
    """Two premultiplied (C, T) renders in id order as one: later over
    earlier; truncated, entries and blends add, spans take the max."""
    return FrameOutput(
        later.frame + earlier.frame * later.trans[..., None],
        earlier.truncated + later.truncated,
        torch.maximum(earlier.span_y, later.span_y),
        torch.maximum(earlier.span_x, later.span_x),
        earlier.trans * later.trans,
        None if later.entries is None else earlier.entries + later.entries,
        None if later.blends is None else earlier.blends + later.blends)


def _finish(acc: FrameOutput, frame_uint8: bool) -> FrameOutput:
    """A folded (C, T) render's frame: C clamped to [0, 1] (uint8 in u8
    mode), without the transmittance."""
    frame = torch.clamp(acc.frame, 0.0, 1.0)
    if frame_uint8:
        frame = (frame * 255.0 + 0.5).to(torch.uint8)
    return acc._replace(frame=frame, trans=None)


class Renderer:
    """Headless splat renderer with reference semantics.

    The composite is exact at any tile depth; `seg_q` is a pure performance
    knob (sprites per segment row). By default every drawn sprite is drawn
    whole: the exact binning (`ops/binning.py`) writes each sprite's tiles
    into `entry_factor` x N sort entries, and `last_truncated` counts the
    entries past that capacity. Given a dup window (`dup_y`, `dup_x`), it
    bins into that window as the JAX package does, and `last_truncated`
    counts the tiles outside it. A truncating frame grows the capacity or
    the window for later frames (`raise_dup_values`). The binning, sort
    and composite kernels run on CUDA tensors; CPU tensors take their
    twins.
    """

    def __init__(
        self,
        config: Optional[RenderConfig] = None,
        seg_q: Optional[int] = None,
        dup_y: Optional[int] = None,
        dup_x: Optional[int] = None,
        blend: str = "over",
        auto_raise_dup: bool = True,
        entry_factor: int = 4,
    ):
        """seg_q None = adaptive: ~half the mean entries/tile, clamped to
        [32, 256] (the JAX package's rule). dup_y and dup_x: both (the
        window path) or neither (the exact binning, `entry_factor` sort
        entries a particle: 4 is the 2 x 2 window's sort length)."""
        if (dup_y is None) != (dup_x is None):
            raise ValueError("give both dup_y and dup_x, or neither")
        self.config = config or RenderConfig()
        if self.config.width % TILE_W or self.config.height % TILE_H:
            raise ValueError(
                f"width must be a multiple of {TILE_W} and height of {TILE_H}"
            )
        self.seg_q = seg_q
        self.dup_y = dup_y
        self.dup_x = dup_x
        self.entry_factor = entry_factor
        self.blend = blend
        # When a frame reports truncation (entries past the capacity, or a
        # sprite spanning more tiles than the dup window), grow the
        # capacity to the frame's entries, or dup_y/dup_x to its measured
        # max span, so the NEXT render is lossless; `render()` also
        # re-renders the same frame immediately.
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
        # Auto-raise budget: growth may not push a sort's entries (N x the
        # entry factor, or N x dup) past this (see raise_dup_values).
        self.entry_budget = 64 * 1024 * 1024
        # The kernels' wrappers (their plain twins run for CPU tensors);
        # each replaceable by its twin to compare the two on the card.
        self.composite = composite_tiles
        self.sort = sort_kv_stable
        self.bin = bin_sprites
        self._last_n = 0
        # particles per sort of the LAST render: == _last_n for single-pass
        # frames, the chunk width for chunked ones (drives the budget)
        self._last_sort_n = 0
        # the LAST render's sort entries over all its sorts (capacity x
        # chunks or ranks): what `render_sort_skipped` counts down from
        self.last_sort_slots = 0

    @property
    def window(self) -> bool:
        """True when a dup window bins the sprites (the JAX package's
        path), False for the exact binning."""
        return self.dup_y is not None

    @property
    def entries_per_particle(self) -> int:
        """Sort entries a particle: dup_y x dup_x, or the entry factor."""
        return self.dup_y * self.dup_x if self.window else self.entry_factor

    def _render_kw(self) -> dict:
        """The binning and kernel settings every `_render` call takes."""
        cfg = self.config
        return dict(width=cfg.width, height=cfg.height, near=cfg.near,
                    blend=self.blend, dup_y=self.dup_y, dup_x=self.dup_x,
                    entry_factor=self.entry_factor, composite=self.composite,
                    sort=self.sort, bin=self.bin)

    def resolve_seg_q(self, n: int, seg_q: Optional[int] = None) -> int:
        """Adaptive segment size: ~half the mean entries per tile, [32, 256]."""
        q = seg_q or self.seg_q
        if q is not None:
            return q
        cfg = self.config
        tiles = (cfg.width // TILE_W) * (cfg.height // TILE_H)
        density = n * self.entries_per_particle // max(tiles, 1)
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
        kw = dict(self._render_kw(), frame_uint8=frame_uint8)
        if n > self.chunk_threshold:
            k, cn = _chunk_width(n, self.chunk_size)
            self._sorted(cn, k)
            return _chunked_fold(
                position, *args, num_draw,
                seg_q=self.resolve_seg_q(cn, seg_q),
                chunk_size=self.chunk_size, **kw,
            )
        self._sorted(n, 1)
        return _render(
            position, *args, num_draw,
            seg_q=self.resolve_seg_q(n, seg_q), **kw,
        )

    def _sorted(self, width: int, sorts: int) -> None:
        """Record the render's sorts: `sorts` of `width` particles each."""
        self._last_sort_n = width
        self.last_sort_slots = self.entries_per_particle * width * sorts

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
            with trace.span("render.project"):
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
        on `device` (default: this process's first rank's) —
        `_chunked_fold`'s association at chunk = N / D, so the frame is
        bitwise the chunked one at that partition. Truncated, entry and
        blend counts sum and spans take the max. Only image pairs cross
        devices, O(pixels x ranks) whatever N (the reference copies every
        position to its render adapter, `Render.cpp:814`). Over a process
        group each process renders its own ranks, the pairs are
        all-gathered, and every process folds the same frame (every
        process calls it)."""
        from multi_adapter_particles_torch.parallel.mesh import gather_ranks

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
        self._sorted(cn, d)
        nd = int(n if num_draw is None else num_draw)
        device = torch.device(mesh.local_devices[0] if device is None
                              else device)
        kw = dict(self._render_kw(), seg_q=self.resolve_seg_q(cn, seg_q),
                  return_trans=True)
        outs = []
        for r, chunk in zip(mesh.local_ranks, position.shards):
            args = self._device_args(camera, particle_size,
                                     particle_intensity, chunk.device)
            outs.append(_render(chunk, *args, _chunk_draw(nd, r * cn, cn),
                                r * cn, **kw))
        fields = [f for f in FrameOutput._fields
                  if getattr(outs[0], f) is not None]
        with trace.span("render.copy"):
            ranks = [FrameOutput(**dict(zip(fields, vals))) for vals in zip(
                *([x.to(device) for x in gather_ranks(
                    mesh, [getattr(o, f) for o in outs])] for f in fields))]
        with trace.span("render.composite"):
            acc = ranks[0]
            for later in ranks[1:]:
                acc = _fold(acc, later)
            return _finish(acc, cfg.frame_uint8)

    def raise_dup_for(self, out: FrameOutput) -> bool:
        """Grow the capacity, or the dup window, for a truncating frame
        (three host reads; `RenderEngine.present` packs them into one)."""
        return self.raise_dup_values(
            int(out.truncated), int(out.span_y), int(out.span_x)
        )

    def raise_dup_values(self, truncated: int, span_y: int,
                         span_x: int) -> bool:
        """`raise_dup_for` on already-pulled host scalars. Returns True if
        the capacity or the window grew. Exact binning: the entry factor
        grows to hold the frame's entries, the capacity of each sort plus
        every entry dropped. Window: dup_y/dup_x grow to the frame's
        measured max span. The growth is bounded by `entry_budget` (sort
        entries = N x the factor, or N x dup); beyond it the frame stays
        truncated and counted."""
        if truncated == 0:
            return False
        n = self._last_sort_n or self._last_n or 0
        if not self.window:
            if not n:
                return False
            need = -(-(self.entry_factor * n + int(truncated)) // n)
            new = min(need, max(4, self.entry_budget // n))
            if new <= self.entry_factor:
                return False
            self.entry_factor = new
            return True
        gh = self.config.height // TILE_H
        gw = self.config.width // TILE_W
        new_y = max(self.dup_y, min(int(span_y), gh))
        new_x = max(self.dup_x, min(int(span_x), gw))
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
        a truncating frame grows the capacity (or the dup window) and
        re-renders."""
        out = self.render_arrays(
            position, camera, particle_size, particle_intensity, num_draw
        )
        if self.auto_raise_dup and self.raise_dup_for(out):
            out = self.render_arrays(
                position, camera, particle_size, particle_intensity, num_draw
            )
        self.last_truncated = int(out.truncated)
        return out.frame
