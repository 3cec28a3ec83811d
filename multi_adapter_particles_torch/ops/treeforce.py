"""Block-sparse exact near field: the tree-structured P³M near mode.

The port of the JAX package's `ops/treeforce.py`, force and potential
traces:

1. One stable Morton sort of the particles. Blocks of B consecutive
   Morton-sorted particles are compact spatial nodes.
2. Per-block float AABBs over the live (in-box) particles.
3. The dual-tree walk, flattened: an [nb, nb] AABB gap² <= r_c² test,
   compacted into an i-major block-pair list under a budget (pairs past
   it are counted in `dropped`, never lost silently).
4. The sweep over the listed pairs (`near_sweep`, or `near_sweep_n3` over
   the halved list j >= i), un-sorted back to particle order, × g_const.

The diagnostics gauge's potential variants (`with_potential`,
`potential_only`, `half_pairs`, `total_only`) run the directed kernel with
a fourth output row, the short-range pair potential u_short
(`short_potential_cheb`). Its self pair is not 0: the live entries lose
the constant the sweep picks up from it (`potential_self`), the others are
zeroed, in sorted order.

Blocks wider than the sweep's 512 are split for the sweep only: each
listed block pair expands to split² sub-block pairs, pruned by sub-block
AABBs (exact, since the factor is 0 past r_c) and optionally truncated to
a probed `sub_pair_budget`.

The kernels are in `csrc/treeforce.cu`. Each wrapper takes a CUDA tensor
to its kernel (or raises) and a CPU tensor to its `*_plain` twin: the same
pair math as torch ops over the same list, summed per target block in list
order. The kernels sweep balanced work items (`sweep_items`: each target
block's segment cut into items of at most `ITEM_LEN` listed source
blocks, one CTA each, their sums folded in list order), built on the
device from the list's static length, so no host sync.

Against the JAX package:

- The Newton-3rd gate keeps its semantic conditions (`half_force`, no
  sub-block expansion, one device) and drops the TPU memory ones (the
  VMEM band cap, the SMEM slice cap): the pair set is the same, only the
  order of the sums differs. At 1,048,576 particles (B = 512, eight VMEM
  bands) the JAX package falls back to the directed sweep; the port runs
  the halved one.
- The Morton sort is stable (the JAX device walk's is not; its host probe
  is). Ties at a block boundary can change which particles share a block,
  which moves AABBs and the pair count but not the force.
- Cells are computed as XLA compiles `x / hn + gn/2`: one fused
  multiply-add with the float32 reciprocal (`pm.scaled_cells`).
- The budget `p_max` keeps its rounding down to a multiple of `pair_chunk`
  (the JAX fallback's chunk): it is budget semantics, though the port's
  sweeps do not chunk.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import os
from typing import Optional

import numpy as np
import torch

from multi_adapter_particles_torch.ops import _build, pm
from multi_adapter_particles_torch.ops.p3m import _SIGMA_PER_CUTOFF

Tensor = torch.Tensor

_PARK = 1.0e9

# -- Polynomial short-range factor -------------------------------------------
# s_short(r) = s_exact - g_long; G(t) = g_long * r³ (t = r/σ) is universal, so
# H(v) = G(t)/t³ (v = t²) is fit once by a degree-12 polynomial in
# x = 2v/VMAX - 1 and evaluated by Horner. Past the cutoff t_c = 4.5 the
# factor is set to 0.
_TC = 4.5                      # cutoff in t = r/sigma units (= r_c/sigma)
_VMAX = _TC * _TC
_POLY_DEG = 12


def _fit_h_poly():
    """Degree-12 monomial fit of H(v) on [0, VMAX] (float64), in the mapped
    variable x = 2v/VMAX - 1 (the JAX package's fit, to the bit)."""
    v = np.linspace(0.0, _VMAX, 8001)
    t = np.sqrt(v)
    # series for small t: H(v) = sqrt(2/pi) * sum_n (-v/2)^n / (n! (2n+3))
    hs = np.zeros_like(v)
    term = np.ones_like(v)
    for n in range(0, 40):
        hs += term / (2 * n + 3)
        term = term * (-v / 2) / (n + 1)
    hs *= math.sqrt(2.0 / math.pi)
    # exact formula for large t (no cancellation there)
    erf_v = np.vectorize(math.erf)
    with np.errstate(divide="ignore", invalid="ignore"):
        he = (
            erf_v(t / math.sqrt(2.0))
            - math.sqrt(2.0 / math.pi) * t * np.exp(-v / 2.0)
        ) / np.maximum(t, 1e-30) ** 3
    h = np.where(v <= 4.0, hs, he)
    x = 2.0 * v / _VMAX - 1.0
    return np.polynomial.polynomial.polyfit(x, h, _POLY_DEG).astype(
        np.float32)


_H_POLY = tuple(float(c) for c in _fit_h_poly())


def _fit_e_poly():
    """Degree-12 monomial fit of E(v) = erf(t/sqrt(2))/t (t = r/σ, v = t²)
    on [0, VMAX], in the same mapped variable: the long-range pair
    potential's numerator (u_long = -E/σ). The JAX package's fit, to the
    bit."""
    v = np.linspace(0.0, _VMAX, 8001)
    t = np.sqrt(v)
    # series: E(v) = sqrt(2/pi) * sum_n (-v/2)^n / (n! (2n+1))
    es = np.zeros_like(v)
    term = np.ones_like(v)
    for n in range(0, 40):
        es += term / (2 * n + 1)
        term = term * (-v / 2) / (n + 1)
    es *= math.sqrt(2.0 / math.pi)
    erf_v = np.vectorize(math.erf)
    with np.errstate(divide="ignore", invalid="ignore"):
        ee = erf_v(t / math.sqrt(2.0)) / np.maximum(t, 1e-30)
    e = np.where(v <= 4.0, es, ee)
    x = 2.0 * v / _VMAX - 1.0
    return np.polynomial.polynomial.polyfit(x, e, _POLY_DEG).astype(
        np.float32)


_E_POLY = tuple(float(c) for c in _fit_e_poly())


def _factor_consts(eps2: float, sigma: float):
    """The float32 constants of `short_factor_cheb`: (eps2, 1/σ², 2/VMAX,
    1/σ³, VMAX)."""
    return tuple(pm._f32(c) for c in (eps2, 1.0 / (sigma * sigma),
                                      2.0 / _VMAX, 1.0 / sigma**3, _VMAX))


def short_factor_cheb(d2: Tensor, eps2: float, sigma: float) -> Tensor:
    """Polynomial s_short: ~1e-5 of the exact force inside the cutoff,
    exactly 0 beyond it (rsqrt + multiply-adds only)."""
    e2, inv_s2, c2v, inv_s3, vmax = _factor_consts(eps2, sigma)
    inv = torch.rsqrt(d2 + e2)
    s_exact = inv * inv * inv
    v = d2 * inv_s2
    x = torch.clamp(v * c2v - 1.0, -1.0, 1.0)
    h = torch.full_like(x, _H_POLY[-1])
    for c in _H_POLY[-2::-1]:
        h = h * x + c
    s = s_exact - h * inv_s3
    return torch.where(v <= vmax, s, 0.0)


def short_potential_cheb(d2: Tensor, eps2: float, sigma: float) -> Tensor:
    """Polynomial short-range pair potential u_short = u_exact - u_long,
    u_exact = -(d² + eps²)^(-1/2), u_long = -erf(r/(√2σ))/r: the potential
    whose gradient is `short_factor_cheb`'s force, exactly 0 beyond the
    cutoff. At d2 = 0 it is sqrt(2/π)/σ - 1/eps, not 0: callers remove the
    self pair (`potential_self`)."""
    e2, inv_s2, c2v, _, vmax = _factor_consts(eps2, sigma)
    u_exact = -torch.rsqrt(d2 + e2)
    v = d2 * inv_s2
    x = torch.clamp(v * c2v - 1.0, -1.0, 1.0)
    e = torch.full_like(x, _E_POLY[-1])
    for c in _E_POLY[-2::-1]:
        e = e * x + c
    u = u_exact + e * pm._f32(1.0 / sigma)
    return torch.where(v <= vmax, u, 0.0)


def short_potential_self(eps2: float, sigma: float) -> float:
    """u_short(0) through the same float32 Horner steps as the twins (x =
    -1 at v = 0): the self-pair constant of a CPU sweep, bitwise the JAX
    package's."""
    e = np.float32(_E_POLY[-1])
    for c in _E_POLY[-2::-1]:
        e = e * np.float32(-1.0) + np.float32(c)     # x(v=0) = -1
    u_exact0 = -np.float32(1.0) / np.float32(np.sqrt(np.float32(eps2)))
    return float(u_exact0 + e * np.float32(1.0 / sigma))


# Widest block the sweeps take; wider tree blocks are split for the sweep.
_SWEEP_MAX_BLOCK = 512

# elements of one [A, B, B] pair plane in the twins (bounds their memory)
_PLANE_ELEMS = 1 << 24


# -- the sweeps: plain twins ---------------------------------------------------
def _blocks(spos: Tensor, block: int):
    """[4, nb*B] -> three [nb, B] planes."""
    nb = spos.shape[1] // block
    return [spos[c].reshape(nb, block) for c in range(3)]


def _pair_d(planes, ti: Tensor, tj: Tensor):
    """Target blocks ti and source blocks tj ([A] each) -> the [A, B, B]
    separations (dx, dy, dz) and d2 (targets on dim 1, sources on dim
    2)."""
    d = [p[tj][:, None, :] - p[ti][:, :, None] for p in planes]
    return d, d[0] * d[0] + d[1] * d[1] + d[2] * d[2]


def _pair_planes(planes, ti: Tensor, tj: Tensor, eps2: float, sigma: float):
    """The [A, B, B] force pair terms (tx, ty, tz) of `_pair_d`'s pairs."""
    d, d2 = _pair_d(planes, ti, tj)
    f = short_factor_cheb(d2, eps2, sigma)
    return [dc * f for dc in d]


def _rounds(bounds: Tensor):
    """The list positions of each block's r-th entry, round by round:
    yields (blocks with an r-th entry, their positions). Summing a block's
    entries round by round adds them in list order, with no two writers of
    one block in a round."""
    counts = bounds[1:] - bounds[:-1]
    lmax = int(counts.max()) if counts.numel() else 0
    for r in range(lmax):
        act = torch.nonzero(counts > r).squeeze(1)
        yield act, bounds[act] + r


def _chunks(n: int, block: int):
    step = max(1, _PLANE_ELEMS // (block * block))
    return range(0, n, step), step


# The directed sweep's variants: (with_potential, potential_only,
# half_pairs) -> the kernel's variant index.
_VARIANTS = {(False, False, False): 0, (True, False, False): 1,
             (True, True, False): 2, (True, True, True): 3}


def _variant(with_potential: bool, potential_only: bool,
             half_pairs: bool) -> int:
    """The directed sweep's variant index; raises on the combinations the
    JAX package refuses."""
    if potential_only and not with_potential:
        raise ValueError("potential_only requires with_potential=True")
    if half_pairs and not potential_only:
        raise ValueError("half_pairs requires potential_only=True")
    return _VARIANTS[(bool(with_potential), bool(potential_only),
                      bool(half_pairs))]


def near_sweep_plain(spos: Tensor, bounds: Tensor, j_idx: Tensor, *,
                     block: int, eps2: float, sigma: float,
                     with_potential: bool = False,
                     potential_only: bool = False,
                     half_pairs: bool = False) -> Tensor:
    """Plain twin of the directed sweep: spos [4, nb*B], bounds [nb+1] over
    the i-major list j_idx -> [4, nb*B] (ax, ay, az, u), unscaled. Rows
    0-2 are 0 under `potential_only`, row 3 unless `with_potential`: the
    list-order sum of `short_potential_cheb`, a diagonal pair (source block
    = target block) weighted 1/2 under `half_pairs`."""
    _variant(with_potential, potential_only, half_pairs)
    planes = _blocks(spos, block)
    nb = planes[0].shape[0]
    acc = torch.zeros((4, nb, block), dtype=torch.float32,
                      device=spos.device)
    bounds = bounds.long()
    for act, pos in _rounds(bounds):
        js = j_idx[pos].long()
        starts, step = _chunks(act.numel(), block)
        for a0 in starts:
            ti, tj = act[a0:a0 + step], js[a0:a0 + step]
            d, d2 = _pair_d(planes, ti, tj)
            if not potential_only:
                f = short_factor_cheb(d2, eps2, sigma)
                acc[:3, ti] += torch.stack([(dc * f).sum(2) for dc in d])
            if with_potential:
                us = short_potential_cheb(d2, eps2, sigma).sum(2)
                if half_pairs:
                    us = torch.where((ti == tj)[:, None], us * 0.5, us)
                acc[3, ti] += us
    return acc.reshape(4, -1)


def _n3_lists(sweep_i: Tensor, sweep_j: Tensor, nb: int):
    """The halved list's per-target bounds [nb+1] and its fold index: the
    off-diagonal list positions stably sorted by source block (jorder),
    with per-source bounds (jbounds [nb+1])."""
    bounds = pm._segment_bounds(sweep_i.long(), nb)
    off = torch.nonzero(sweep_j > sweep_i).squeeze(1)
    keys, order = torch.sort(sweep_j[off].long(), stable=True)
    jorder = off[order]
    jbounds = pm._segment_bounds(keys, nb)
    return bounds, jorder, jbounds


def near_sweep_n3_plain(spos: Tensor, sweep_i: Tensor, sweep_j: Tensor, *,
                        nb: int, block: int, eps2: float,
                        sigma: float) -> Tensor:
    """Plain twin of the halved sweep: the halved i-major list (sweep_i,
    sweep_j), j >= i -> [4, nb*B]. Each pair's plane once: row sums to the
    target, negated column sums (j > i) to a row per list position, folded
    per source block in j-major order, then the target side added."""
    planes = _blocks(spos, block)
    bounds, jorder, jbounds = _n3_lists(sweep_i, sweep_j, nb)
    dev = spos.device
    iside = torch.zeros((3, nb, block), dtype=torch.float32, device=dev)
    rows = torch.zeros((sweep_j.shape[0], 3, block), dtype=torch.float32,
                       device=dev)
    for act, pos in _rounds(bounds):
        js = sweep_j[pos].long()
        starts, step = _chunks(act.numel(), block)
        for a0 in starts:
            ti, tj = act[a0:a0 + step], js[a0:a0 + step]
            terms = _pair_planes(planes, ti, tj, eps2, sigma)
            iside[:, ti] += torch.stack([t.sum(2) for t in terms])
            rows[pos[a0:a0 + step]] = -torch.stack([t.sum(1) for t in terms],
                                                   dim=1)
    fold = torch.zeros((nb, 3, block), dtype=torch.float32, device=dev)
    for act, pos in _rounds(jbounds):
        fold[act] += rows[jorder[pos]]
    out = torch.zeros((4, nb * block), dtype=torch.float32, device=dev)
    out[:3] = (fold.permute(1, 0, 2) + iside).reshape(3, -1)
    return out


# -- the sweeps: the kernels' work items --------------------------------------
# Listed source blocks a work item of the kernels takes at most (L); the
# kernels' `kItemLen`.
ITEM_LEN = 16
# Bytes of item slots a launch of the sweep kernels may fill: more items
# than fit run in chunks, each folded before the next.
SWEEP_SCRATCH_BYTES = 1 << 30


@dataclasses.dataclass
class SweepItems:
    """The kernels' work items over an i-major list (`sweep_items`).

    table [4, K] int32: each item's target block (nb on the padding past
    the live items), its list range [q0, q1), and the launch order (the
    table index CTA b of the chunk takes); istart [nb+1] int32: the first
    table index of each target block's items (istart[nb], the live count);
    chunk: table entries a launch takes."""

    table: Tensor
    istart: Tensor
    chunk: int

    @property
    def target(self) -> Tensor:
        return self.table[0]

    @property
    def q0(self) -> Tensor:
        return self.table[1]

    @property
    def q1(self) -> Tensor:
        return self.table[2]

    @property
    def order(self) -> Tensor:
        return self.table[3]


def items_len(nb: int, list_len: int) -> int:
    """The item table's static size: nb + ceil(list_len / ITEM_LEN) bounds
    the live items of any segmentation of a list `list_len` long over nb
    target blocks (a segment of s entries takes ceil(s / L) < 1 + s / L)."""
    return nb + -(-int(list_len) // ITEM_LEN)


def sweep_items(bounds: Tensor, list_len: int,
                chunk: Optional[int] = None) -> SweepItems:
    """The work items of a sweep over an i-major list `list_len` long whose
    target block i lists entries bounds[i]..bounds[i+1]: each segment cut
    into items of at most ITEM_LEN consecutive entries, in list order.
    Device ops only (the table's size is static: `items_len`), so building
    it never waits for the device. Within each `chunk` of table entries
    (default: all), launch longest items first: scheduling only, since each
    item writes its own slot and the fold adds them in table order."""
    nb = bounds.numel() - 1
    kall = items_len(nb, list_len)
    chunk = kall if chunk is None else max(1, min(int(chunk), kall))
    b = bounds.long()
    count = (b[1:] - b[:-1] + (ITEM_LEN - 1)) // ITEM_LEN
    iend = torch.cumsum(count, 0)
    istart = torch.cat([iend.new_zeros(1), iend])
    k = torch.arange(kall, device=bounds.device)
    target = torch.searchsorted(iend, k, right=True)  # nb on padding
    live = target < nb
    ti = target.clamp(max=nb - 1)
    q0 = torch.where(live, b[ti] + (k - istart[ti]) * ITEM_LEN, 0)
    q1 = torch.where(live, torch.minimum(q0 + ITEM_LEN, b[ti + 1]), 0)
    key = (k // chunk) * (ITEM_LEN + 1) + (ITEM_LEN - (q1 - q0))
    order = torch.argsort(key, stable=True)
    table = torch.stack([target, q0, q1, order]).to(torch.int32)
    return SweepItems(table, istart.to(torch.int32), chunk)


def _sweep_chunk(kall: int, item_bytes: int) -> int:
    """Table entries a launch takes: as many as SWEEP_SCRATCH_BYTES of
    slots hold (at least one)."""
    return max(1, min(kall, SWEEP_SCRATCH_BYTES // item_bytes))


# -- the sweeps: kernels -------------------------------------------------------
@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("treeforce")
    f, i, p = ctypes.c_float, ctypes.c_int, ctypes.c_void_p
    ll = ctypes.c_longlong
    coef = ctypes.POINTER(ctypes.c_float)
    lib.tree_sweep.argtypes = [p, i, i, p, p, ll, p, ll, p, p, coef, coef,
                               f, f, f, f, f, f, i, p]
    lib.tree_sweep.restype = ctypes.c_int
    lib.tree_potential_at.argtypes = [p, p, coef, f, f, f, f, f, p]
    lib.tree_potential_at.restype = ctypes.c_int
    lib.tree_sweep_n3.argtypes = [p, i, i, p, p, ll, p, ll, p, p, p, p, p,
                                  coef, f, f, f, f, f, p]
    lib.tree_sweep_n3.restype = ctypes.c_int
    intp = ctypes.POINTER(ctypes.c_int)
    lib.tree_sweep_occupancy.argtypes = [i, i, intp, intp]
    lib.tree_sweep_occupancy.restype = ctypes.c_int
    for name in ("tree_sweep_max_block", "tree_sweep_poly_terms",
                 "tree_sweep_item_len"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    if lib.tree_sweep_max_block() != _SWEEP_MAX_BLOCK:
        raise RuntimeError("csrc/treeforce.cu's widest block is not "
                           "_SWEEP_MAX_BLOCK")
    if not lib.tree_sweep_poly_terms() == len(_H_POLY) == len(_E_POLY):
        raise RuntimeError("csrc/treeforce.cu takes another number of "
                           "Horner coefficients than _H_POLY or _E_POLY has")
    if lib.tree_sweep_item_len() != ITEM_LEN:
        raise RuntimeError("csrc/treeforce.cu's item length is not ITEM_LEN")
    return lib


_POLY_C = (ctypes.c_float * len(_H_POLY))(*_H_POLY)
_E_POLY_C = (ctypes.c_float * len(_E_POLY))(*_E_POLY)


def _sweep_consts(eps2: float, sigma: float):
    """The kernels' float32 constants: `_factor_consts` and 1/σ."""
    return (*_factor_consts(eps2, sigma), pm._f32(1.0 / sigma))


def _check_sweep_args(spos: Tensor, block: int, what: str) -> int:
    if spos.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, got {spos.device}")
    if block < 32 or block > _SWEEP_MAX_BLOCK or block % 32:
        raise ValueError(f"{what}: block {block} is not a multiple of 32 "
                         f"up to {_SWEEP_MAX_BLOCK}")
    nbb = spos.shape[-1]
    if nbb % block:
        raise ValueError(f"{what}: {nbb} columns are not whole blocks of "
                         f"{block}")
    _build.check_arg(spos, torch.float32, (4, nbb), spos.device, "spos")
    return nbb // block


def _check_list(what: str, spos: Tensor, nb: int, j_idx: Tensor,
                bounds: Optional[Tensor] = None,
                i_idx: Optional[Tensor] = None) -> None:
    """Raise unless a block-pair list is fit for the kernels to index with
    (one host sync): 1-D on spos's device, source blocks in [0, nb); the
    directed list's `bounds` within it; the halved list's targets in
    [0, nb) with j >= i."""
    for t in (j_idx, bounds, i_idx):
        if t is not None and (t.device != spos.device or t.dim() != 1):
            raise ValueError(f"{what}: the pair list must be 1-D tensors on "
                             f"{spos.device}")
    bad = ((j_idx < 0) | (j_idx >= nb)).any()
    if bounds is not None:
        bad = bad | (bounds.min() < 0) | (bounds[-1] > j_idx.numel())
    if i_idx is not None:
        if i_idx.shape != j_idx.shape:
            raise ValueError(f"{what}: sweep_i and sweep_j differ in length")
        bad = bad | ((i_idx < 0) | (i_idx >= nb) | (j_idx < i_idx)).any()
    if bool(bad):
        raise ValueError(f"{what}: the pair list indexes outside its {nb} "
                         "blocks (or, halved, lists j < i)")


def _i32(t: Tensor) -> Tensor:
    return t.to(torch.int32).contiguous()


def near_sweep(spos: Tensor, bounds: Tensor, j_idx: Tensor, *, block: int,
               eps2: float, sigma: float, with_potential: bool = False,
               potential_only: bool = False,
               half_pairs: bool = False) -> Tensor:
    """Directed sweep: spos [4, nb*B] (sorted, parked), bounds [nb+1] over
    the i-major source-block list j_idx -> [4, nb*B] (ax, ay, az, u),
    unscaled; the variants as `near_sweep_plain` has them. A CPU tensor
    runs the plain twin; a CUDA tensor launches the kernels."""
    variant = _variant(with_potential, potential_only, half_pairs)
    if spos.device.type == "cpu":
        return near_sweep_plain(spos, bounds, j_idx, block=block, eps2=eps2,
                                sigma=sigma, with_potential=with_potential,
                                potential_only=potential_only,
                                half_pairs=half_pairs)
    nb = _check_sweep_args(spos, block, "near_sweep")
    bounds, j_idx = _i32(bounds), _i32(j_idx)
    _build.check_arg(bounds, torch.int32, (nb + 1,), spos.device, "bounds")
    _check_list("near_sweep", spos, nb, j_idx, bounds=bounds)
    return _launch_sweep(spos, nb, block, bounds, j_idx, eps2, sigma,
                         variant)


# slot rows of each directed variant's items: force, force + potential,
# potential only (twice)
_SLOT_ROWS = (3, 4, 1, 1)


def _launch_sweep(spos: Tensor, nb: int, block: int, bounds: Tensor,
                  j_idx: Tensor, eps2: float, sigma: float,
                  variant: int = 0, chunk: Optional[int] = None) -> Tensor:
    """The directed kernel's `variant` (`_VARIANTS`) on lists `near_sweep`
    has checked (int32): the item table, then the item kernel and its fold
    a chunk of `chunk` table entries (default: as SWEEP_SCRATCH_BYTES
    allows)."""
    out = torch.empty_like(spos)
    rows = _SLOT_ROWS[variant]
    kall = items_len(nb, j_idx.numel())
    if chunk is None:
        chunk = _sweep_chunk(kall, rows * block * 4)
    items = sweep_items(bounds, j_idx.numel(), chunk)
    slot = torch.empty((items.chunk, rows, block), dtype=torch.float32,
                       device=spos.device)
    with torch.cuda.device(spos.device):
        stream = torch.cuda.current_stream(spos.device).cuda_stream
        rc = _library().tree_sweep(
            spos.data_ptr(), nb, block, j_idx.data_ptr(),
            items.table.data_ptr(), kall, items.istart.data_ptr(),
            items.chunk, slot.data_ptr(), out.data_ptr(), _POLY_C,
            _E_POLY_C, *_sweep_consts(eps2, sigma), variant, stream)
    _build.check(rc, "tree_sweep")
    return out


@functools.lru_cache(maxsize=16)
def _kernel_potential_self(eps2: float, sigma: float,
                           device: torch.device) -> float:
    """u_short(0) by the kernels' own device function on `device` (one
    launch and one host sync per (eps², σ, device))."""
    d2 = torch.zeros(1, dtype=torch.float32, device=device)
    out = torch.empty(1, dtype=torch.float32, device=device)
    e2, inv_s2, c2v, _, vmax, inv_s = _sweep_consts(eps2, sigma)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _library().tree_potential_at(d2.data_ptr(), out.data_ptr(),
                                          _E_POLY_C, e2, inv_s2, c2v, vmax,
                                          inv_s, stream)
    _build.check(rc, "tree_potential_at")
    return float(out[0])


def potential_self(eps2: float, sigma: float, device) -> float:
    """The constant a potential sweep on `device` adds to each live target
    from its own self pair: the CUDA kernels' evaluation of u_short(0) on a
    card (rsqrtf and the kernel's fused multiply-adds round otherwise than
    torch's CPU ops), `short_potential_self` on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return _kernel_potential_self(float(eps2), float(sigma), device)
    if device.type == "cpu":
        return short_potential_self(eps2, sigma)
    raise ValueError(f"potential sweeps run on cuda or cpu, got {device}")


def near_sweep_n3(spos: Tensor, sweep_i: Tensor, sweep_j: Tensor, *,
                  nb: int, block: int, eps2: float, sigma: float) -> Tensor:
    """Newton-3rd halved sweep over the halved i-major list (sweep_i,
    sweep_j), j >= i, live entries only -> [4, nb*B], unscaled. A CPU
    tensor runs the plain twin; a CUDA tensor launches the kernels."""
    if spos.device.type == "cpu":
        return near_sweep_n3_plain(spos, sweep_i, sweep_j, nb=nb,
                                   block=block, eps2=eps2, sigma=sigma)
    return _launch_sweep_n3(spos, *_n3_prepare(spos, sweep_i, sweep_j, nb,
                                                block), eps2, sigma)


def _n3_prepare(spos: Tensor, sweep_i: Tensor, sweep_j: Tensor, nb: int,
                block: int):
    """Check the halved list and build what the kernels index with: (nb,
    block, bounds, j_idx, jorder, jbounds) as int32."""
    if _check_sweep_args(spos, block, "near_sweep_n3") != nb:
        raise ValueError(f"near_sweep_n3: spos is not {nb} blocks")
    if block & (block - 1):
        raise ValueError(f"near_sweep_n3: block {block} is not a power of 2")
    _check_list("near_sweep_n3", spos, nb, sweep_j, i_idx=sweep_i)
    bounds, jorder, jbounds = (_i32(t) for t in _n3_lists(sweep_i, sweep_j,
                                                           nb))
    return nb, block, bounds, _i32(sweep_j), jorder, jbounds


def _launch_sweep_n3(spos: Tensor, nb: int, block: int, bounds: Tensor,
                     j_idx: Tensor, jorder: Tensor, jbounds: Tensor,
                     eps2: float, sigma: float,
                     chunk: Optional[int] = None) -> Tensor:
    """The halved sweep's kernels on lists `_n3_prepare` built: the item
    table, then the item kernel and its i-side fold a chunk of `chunk`
    table entries (default: as SWEEP_SCRATCH_BYTES allows), then the
    j-fold."""
    out = torch.empty_like(spos)
    list_len = j_idx.shape[0]
    kall = items_len(nb, list_len)
    if chunk is None:
        chunk = _sweep_chunk(kall, 3 * block * 4)
    items = sweep_items(bounds, list_len, chunk)
    islot = torch.empty((items.chunk, 3, block), dtype=torch.float32,
                        device=spos.device)
    rows = torch.empty((max(list_len, 1), 3, block), dtype=torch.float32,
                       device=spos.device)
    with torch.cuda.device(spos.device):
        stream = torch.cuda.current_stream(spos.device).cuda_stream
        rc = _library().tree_sweep_n3(
            spos.data_ptr(), nb, block, j_idx.data_ptr(),
            items.table.data_ptr(), kall, items.istart.data_ptr(),
            items.chunk, islot.data_ptr(), rows.data_ptr(),
            jorder.data_ptr(), jbounds.data_ptr(), out.data_ptr(), _POLY_C,
            *_factor_consts(eps2, sigma), stream)
    _build.check(rc, "tree_sweep_n3")
    return out


# -- the tree walk -------------------------------------------------------------
def _morton(ib: Tensor, bits: int) -> Tensor:
    """[3, N] int cell coords in [0, 2^bits) -> interleaved Morton code."""
    code = torch.zeros_like(ib[0])
    for b in range(bits):
        for c in range(3):
            code = code | (((ib[c] >> b) & 1) << (3 * b + c))
    return code


def morton_codes(position: Tensor, hn: float, gn: int):
    """(Morton codes [N] with out-of-box particles at the sentinel
    1 << 3*bits, sentinel) on the near grid of gn cells of width hn."""
    bits = max((gn - 1).bit_length(), 1)
    if 3 * bits + 1 > 31:
        raise ValueError(f"near grid {gn} overflows the int32 Morton code")
    u = pm.scaled_cells(position[:3], hn, gn / 2)
    ib = torch.floor(torch.clamp(u, -1.0, float(gn))).long()
    inbox = torch.all((ib >= 0) & (ib <= gn - 1), dim=0)
    code = _morton(torch.clamp(ib, 0, gn - 1), bits)
    sentinel = 1 << (3 * bits)
    return torch.where(inbox, code, sentinel), sentinel


def default_pair_budget(num_blocks: int) -> int:
    """Static block-pair budget when none is probed: at least the full
    matrix for tiny inputs."""
    return int(min(num_blocks * num_blocks, max(4096, 64 * num_blocks)))


def default_block(n: int) -> int:
    """Block size keeping the [nb, nb] adjacency bounded: nb <= ~2048."""
    b = 256
    while -(-n // b) > 2048:
        b *= 2
    return b


def _aabbs(sx, sy, sz, live, nblocks: int, width: int):
    """Per-block (min [3][nb], max [3][nb]) over live lanes."""
    lv = live.reshape(nblocks, width)
    fmin, fmax = [], []
    for s in (sx, sy, sz):
        sb = s.reshape(nblocks, width)
        fmin.append(torch.where(lv, sb, 4e9).amin(dim=1))
        fmax.append(torch.where(lv, sb, -4e9).amax(dim=1))
    return fmin, fmax


def _gap2(fmin, fmax, a, b):
    """Squared AABB gap of blocks a and b (broadcasting index tensors, or
    slices)."""
    gap2 = None
    for c in range(3):
        g = torch.clamp(torch.maximum(fmin[c][a] - fmax[c][b],
                                      fmin[c][b] - fmax[c][a]), min=0.0)
        gap2 = g * g if gap2 is None else gap2 + g * g
    return gap2


@dataclasses.dataclass
class TreeLists:
    """The sweep's inputs from one tree walk (`tree_lists`).

    spos [4, nb*block] sorted, parked positions; spid [nb*block] the
    particle of each sorted column (padding n..); live [nb*block] the
    in-box columns; `n3` says which sweep takes the list: the Newton-3rd
    force sweep over (sweep_i, sweep_j) at `block`, or the directed one
    over (bounds, sweep_j) at `sweep_block` (`sweep_nb` blocks, > nb after
    sub-block expansion); `half_pairs` that the directed list is the
    potential gauge's halved one (j >= i at sweep granularity, diagonal
    pairs weighted 1/2 in the sweep); `pairs` counts the listed (live)
    block pairs at sweep granularity; `dropped` the pairs past the
    budgets."""

    spos: Tensor
    spid: Tensor
    live: Tensor
    n: int
    nb: int
    block: int
    n3: bool
    half_pairs: bool
    sweep_block: int
    sweep_nb: int
    sweep_i: Tensor
    sweep_j: Tensor
    bounds: Optional[Tensor]
    pairs: int
    dropped: int


def tree_lists(position: Tensor, box: float, r_c: float, near_grid: int,
               block: Optional[int] = None, pair_budget: Optional[int] = None,
               pair_chunk: Optional[int] = None,
               sub_pair_budget: Optional[int] = None,
               half_force: bool = False,
               half_pairs: bool = False,
               block_owner_fn=None) -> TreeLists:
    """The tree walk of `near_field_tree`: Morton sort and parking, block
    AABBs, the [nb, nb] adjacency, its compaction under the budget (halved
    where the Newton-3rd gate holds, or for the potential gauge's
    `half_pairs`), the pairs whose target block `block_owner_fn` does not
    own taken out (after the budget, so `dropped` is the global count)
    and, for blocks wider than the sweep, the sub-block expansion (halved
    again inside parent diagonals under `half_pairs`)."""
    if half_force and half_pairs:
        raise ValueError("half_force (the force sweep) and half_pairs (the "
                         "potential gauge) halve different sweeps")
    dev = position.device
    n = position.shape[1]
    if block is None:
        block = default_block(n)
    if pair_chunk is None:
        pair_chunk = max(8, 64 * (256 * 256) // (block * block))
    gn = near_grid

    code, sentinel = morton_codes(position, box / gn, gn)
    scode, order = torch.sort(code, stable=True)
    nb = -(-n // block)
    npad = nb * block - n
    spid = order
    if npad:
        scode = torch.cat([scode, scode.new_full((npad,), sentinel)])
        spid = torch.cat([order, torch.arange(n, n + npad, device=dev)])
    # park out-of-box particles (and the block padding): they neither feel
    # nor exert short-range force
    live_flat = scode < sentinel
    sxyz = []
    for c in range(3):
        s = position[c][order]
        if npad:
            s = torch.cat([s, s.new_full((npad,), _PARK)])
        sxyz.append(torch.where(live_flat, s, _PARK))
    sx, sy, sz = sxyz

    # -- dual-tree walk, flattened: AABB gap -> compacted pair list ----------
    fmin, fmax = _aabbs(sx, sy, sz, live_flat, nb, block)
    any_live = live_flat.reshape(nb, block).any(dim=1)
    col = torch.arange(nb, device=dev)
    rc2 = pm._f32(np.float32(r_c) * np.float32(r_c))
    m = (any_live[:, None] & any_live[None, :]
         & (_gap2(fmin, fmax, col[:, None], col[None, :]) <= rc2))

    # Newton-3rd gate: the halved list and its sweep, or the directed one.
    # half_force is the caller's (SimConfig.tree_half_force, as in the JAX
    # package); PERF.md §7 has the two sweeps' measured times. The
    # potential gauge's half_pairs halves the list too, but its directed
    # sweep weights the diagonal pairs instead. An owner function turns
    # the halved force sweep off: its j-side crosses target ownership.
    n3 = (bool(half_force) and block <= _SWEEP_MAX_BLOCK
          and block_owner_fn is None)
    halved = n3 or bool(half_pairs)
    if halved:
        m = m & (col[None, :] >= col[:, None])
    listed = torch.nonzero(m.reshape(-1)).squeeze(1)   # i-major
    total = int(listed.numel())
    p_max = int(min(pair_budget or default_pair_budget(nb), nb * nb))
    if halved:
        # budgets are probed on the full directed list; the halved list
        # holds (F + D)/2 <= (F + nb)/2 live pairs (D live diagonal pairs)
        p_max = min((p_max + nb) // 2 + 1, nb * nb)
    pc = int(min(pair_chunk, p_max))
    p_max = max(pc, (p_max // pc) * pc)
    dropped = max(total - p_max, 0)
    listed = listed[:p_max]
    sweep_i, sweep_j = listed // nb, listed % nb
    spos = torch.stack([sx, sy, sz, torch.zeros_like(sx)])
    sweep_block, sweep_nb, bounds = block, nb, None
    wide = not n3 and block > _SWEEP_MAX_BLOCK
    if block_owner_fn is not None and not wide:
        owned = block_owner_fn(sweep_i)
        sweep_i, sweep_j = sweep_i[owned], sweep_j[owned]
    pairs = int(sweep_i.numel())
    if not n3:
        if wide:
            sweep_i, sweep_j, sweep_nb, pairs, shortfall = _expand(
                sweep_i, sweep_j, nb, block, sx, sy, sz, live_flat, rc2,
                sub_pair_budget, half_pairs, block_owner_fn)
            sweep_block = _SWEEP_MAX_BLOCK
            dropped += shortfall
        bounds = pm._segment_bounds(sweep_i, sweep_nb)
    return TreeLists(spos, spid, live_flat, n, nb, block, n3,
                     bool(half_pairs), sweep_block, sweep_nb, sweep_i,
                     sweep_j, bounds, pairs, dropped)


def tree_sweep(lists: TreeLists, eps2: float, r_c: float,
               with_potential: bool = False,
               potential_only: bool = False) -> Tensor:
    """The sweep `lists` asks for -> [4, nb*block] unscaled near sums in
    sorted order (row 3 the pair potential under `with_potential`)."""
    sigma = r_c * _SIGMA_PER_CUTOFF
    if lists.n3:
        if with_potential:
            raise ValueError("the Newton-3rd force sweep has no potential "
                             "row")
        return near_sweep_n3(lists.spos, lists.sweep_i, lists.sweep_j,
                             nb=lists.nb, block=lists.block, eps2=eps2,
                             sigma=sigma)
    return near_sweep(lists.spos, lists.bounds, lists.sweep_j,
                      block=lists.sweep_block, eps2=eps2, sigma=sigma,
                      with_potential=with_potential,
                      potential_only=potential_only,
                      half_pairs=lists.half_pairs)


def near_field_tree(
    position: Tensor,   # [4, N]
    box: float,
    g_const: float,
    eps2: float,
    r_c: float,
    near_grid: int,
    block: Optional[int] = None,
    pair_budget: Optional[int] = None,
    pair_chunk: Optional[int] = None,
    sub_pair_budget: Optional[int] = None,
    half_force: bool = False,
    block_owner_fn=None,
    with_potential: bool = False,
    potential_only: bool = False,
    half_pairs: bool = False,
    total_only: bool = False,
):
    """Short-range pairwise correction -> (accel [3, N], dropped_pairs).

    accel = g_const * Σ s_short(r) r_vec over the near pairs; `near_grid`
    cells must be >= r_c wide. `dropped_pairs` (an int) counts block pairs
    past `pair_budget` (and live sub-pairs past `sub_pair_budget`); 0 =
    nothing truncated. `block` None = adaptive (nb capped near 2048).
    `half_force`: the Newton-3rd halved sweep where its gate holds (no
    sub-block expansion); the same pair set, another summation order.

    The diagnostics variants, as in the JAX package:
    `with_potential` also returns u [N] = g_const * Σ_j u_short(r_ij), self
    pair removed, out-of-box particles 0 -> (accel, u, dropped);
    `potential_only` (requires `with_potential`) skips the force -> (u,
    dropped), u bitwise the fused variant's; `half_pairs` (requires
    `potential_only`) sweeps each unordered pair once (j >= i at sweep
    granularity, diagonal pairs weighted 1/2) and returns 2u, whose sum is
    the directed one's to float32 rounding but whose entries are no longer
    per-particle; `total_only` (requires `potential_only`) returns the
    scalar Σu (a 0-d tensor: the block-order sum, no un-sort). Budgets keep
    their directed-count meaning under `half_pairs`.

    `block_owner_fn` (mesh runs): maps target block ids (an int tensor) to
    "this rank owns these targets"; pairs of blocks it does not own are
    not swept, so the result is a PARTIAL near field (its other targets 0,
    and so u) that sums over the mesh to the whole one, each block owned
    once. It selects the directed force sweep. `dropped` stays the global
    count, the same on every rank."""
    _variant(with_potential, potential_only, half_pairs)
    if total_only and not potential_only:
        raise ValueError("total_only requires potential_only=True")
    if half_force and with_potential:
        raise ValueError("half_force is a force-trace option "
                         "(with_potential computes its own channels)")
    lists = tree_lists(position, box, r_c, near_grid, block=block,
                       pair_budget=pair_budget, pair_chunk=pair_chunk,
                       sub_pair_budget=sub_pair_budget, half_force=half_force,
                       half_pairs=half_pairs, block_owner_fn=block_owner_fn)
    acc = tree_sweep(lists, eps2, r_c, with_potential=with_potential,
                     potential_only=potential_only)
    if not with_potential:
        return unsort(lists, acc, g_const), lists.dropped
    # Every live particle picked up u_short(0) from its own self pair once
    # (half of it under half_pairs, whose diagonal pairs weigh 1/2), and
    # co-parked dead lanes from each other: subtract the one, zero the
    # others (and, on a mesh, the blocks of other ranks), in sorted order.
    u_self = potential_self(eps2, r_c * _SIGMA_PER_CUTOFF, acc.device)
    if half_pairs:
        u_self *= 0.5
    gate = lists.live
    if block_owner_fn is not None:
        ids = torch.arange(lists.nb, device=acc.device)
        gate = gate & block_owner_fn(ids).repeat_interleave(lists.block)
    acc_u = torch.where(gate, acc[3] - u_self, 0.0)
    scale = pm._f32(g_const)
    if potential_only:
        u_scale = scale * 2.0 if half_pairs else scale
        if total_only:
            return acc_u.sum() * u_scale, lists.dropped
        return _unsort_row(lists, acc_u) * u_scale, lists.dropped
    return (unsort(lists, acc, g_const), _unsort_row(lists, acc_u) * scale,
            lists.dropped)


def _unsort_row(lists: TreeLists, row: Tensor) -> Tensor:
    """A sorted row [nb*block] -> [n] in particle order."""
    out = torch.empty_like(row)
    out[lists.spid] = row
    return out[:lists.n]


def unsort(lists: TreeLists, acc: Tensor, g_const: float) -> Tensor:
    """Sorted near sums [4, nb*block] -> accel [3, n] in particle order
    (each column written once), × g_const."""
    out = torch.empty((3, acc.shape[1]), dtype=torch.float32,
                      device=acc.device)
    out[:, lists.spid] = acc[:3]
    return out[:, :lists.n] * pm._f32(g_const)


def _expand(i_idx, j_idx, nb, block, sx, sy, sz, live_flat, rc2,
            sub_pair_budget, half_pairs=False, owner=None):
    """Split each listed wide block pair into split² sub-block pairs at the
    sweep width, drop those whose sub-AABBs are farther apart than r_c
    (and, under `half_pairs`, the sub-pairs j < i that a parent diagonal
    pair expands to, and those whose parent target block `owner` does not
    own), sort i-major (stable) and truncate to `sub_pair_budget` (a
    directed count, halved here under `half_pairs`). -> (sweep_i with dead
    entries at sweep_nb, sweep_j, sweep_nb, live sub-pairs kept, live
    sub-pairs past the budget). The shortfall counts the sub-pairs of
    every owner (the global count, the same on every rank)."""
    split = block // _SWEEP_MAX_BLOCK
    sweep_nb = nb * split
    a_off = torch.arange(split, device=i_idx.device)
    p = i_idx.shape[0]
    i_e = (i_idx[:, None] * split + a_off)[:, :, None].expand(
        p, split, split).reshape(-1)
    j_e = (j_idx[:, None] * split + a_off)[:, None, :].expand(
        p, split, split).reshape(-1)
    smin, smax = _aabbs(sx, sy, sz, live_flat, sweep_nb, _SWEEP_MAX_BLOCK)
    near_e = _gap2(smin, smax, i_e, j_e) <= rc2
    if half_pairs:
        # parent i < j pairs always give j_e > i_e: this prunes only
        # inside parent diagonals
        near_e = near_e & (j_e >= i_e)
    live_e = int(near_e.sum())
    if owner is not None:
        near_e = near_e & owner(i_e // split)
    kept = int(near_e.sum()) if owner is not None else live_e
    i_e = torch.where(near_e, i_e, sweep_nb)
    sweep_i, order = torch.sort(i_e, stable=True)
    sweep_j = j_e[order]
    shortfall = 0
    if sub_pair_budget is not None:
        keep = max(2, sub_pair_budget)
        if half_pairs:
            # the probe counts directed sub-pairs; the halved survivors
            # are (S + D_sub)/2 <= (S + sweep_nb)/2 (halve, then clamp)
            keep = (keep + sweep_nb) // 2 + 2
        keep = int(min(i_e.shape[0], keep))
        shortfall = max(live_e - keep, 0)
        kept = min(kept, keep)
        sweep_i, sweep_j = sweep_i[:keep], sweep_j[:keep]
    return sweep_i, sweep_j, sweep_nb, kept, shortfall


# -- host probes (numpy copies of the device walk's pruning rule) -------------
# budget headroom over the probed initial-state counts: scenes evolve, and a
# breached budget only costs counted (never silent) dropped pairs
PAIR_HEADROOM = 1.25


def host_pair_budget(position, box: float, r_c: float, near_grid: int,
                     block: Optional[int] = None,
                     headroom: float = PAIR_HEADROOM) -> int:
    """The block-pair count of the scene × headroom, for `pair_budget`."""
    if block is None:
        count, _, _ = host_tree_counts(position, box, r_c, near_grid)
    else:
        count, _ = host_block_pairs(position, box, r_c, near_grid, block)
    return int(count * headroom) + 1


def host_tree_counts(position, box: float, r_c: float, near_grid: int,
                     block: Optional[int] = None):
    """One Morton sort -> (coarse_count, sub_count_or_None, block): the
    host copy of the device walk's pruning rule (Morton interleave,
    live-masked float AABBs, banded gap² <= r_c² test), coarse block pairs
    first, then sub-block tests inside the survivors."""
    pos = np.asarray(position)
    n = pos.shape[1]
    if block is None:
        block = default_block(n)
    split = max(1, block // _SWEEP_MAX_BLOCK)
    sub_block = block // split

    gn = near_grid
    hn = box / gn
    p3 = pos[:3]
    ib = np.floor(p3 / hn + gn / 2).astype(np.int64)
    inbox = ((ib >= 0) & (ib <= gn - 1)).all(axis=0)
    bits = max(int(gn - 1).bit_length(), 1)
    ibc = np.clip(ib, 0, gn - 1)
    code = np.zeros(n, np.int64)
    for b in range(bits):
        for c in range(3):
            code |= ((ibc[c] >> b) & 1) << (3 * b + c)
    code[~inbox] = 1 << (3 * bits)
    order = np.argsort(code, kind="stable")
    spos = p3[:, order].astype(np.float32)
    live = inbox[order]
    nb = -(-n // block)
    pad = nb * block - n
    if pad:
        spos = np.concatenate([spos, np.zeros((3, pad), np.float32)], axis=1)
        live = np.concatenate([live, np.zeros(pad, bool)])
    nbs = nb * split
    sspos = spos.reshape(3, nbs, sub_block)
    slive = live.reshape(nbs, sub_block)
    smin = np.where(slive[None], sspos, 4e9).min(axis=2)    # [3, nbs]
    smax = np.where(slive[None], sspos, -4e9).max(axis=2)
    # coarse AABBs fold the sub ones
    cmin = smin.reshape(3, nb, split).min(axis=2)           # [3, nb]
    cmax = smax.reshape(3, nb, split).max(axis=2)
    c_any = slive.reshape(nb, block).any(axis=1)
    rc2 = np.float32(r_c) ** 2

    def _pairs(fmin, fmax, alive, band=4096):
        nn = fmin.shape[1]
        out = []
        for lo in range(0, nn, band):
            hi = min(lo + band, nn)
            m = alive[lo:hi, None] & alive[None, :]
            gap2 = np.zeros((hi - lo, nn), np.float32)
            for c in range(3):
                g = np.maximum(
                    np.maximum(
                        fmin[c][lo:hi, None] - fmax[c][None, :],
                        fmin[c][None, :] - fmax[c][lo:hi, None],
                    ),
                    0.0,
                )
                gap2 += g * g
            ii, jj = (m & (gap2 <= rc2)).nonzero()
            out.append((ii + lo, jj))
        return (
            np.concatenate([o[0] for o in out]),
            np.concatenate([o[1] for o in out]),
        )

    ci, cj = _pairs(cmin, cmax, c_any)
    coarse = len(ci)
    if split == 1:
        return coarse, None, block
    # sub tests only inside surviving coarse pairs: [P, split, split]
    a = np.arange(split)
    isub = (ci[:, None] * split + a[None, :])[:, :, None]   # [P, split, 1]
    jsub = (cj[:, None] * split + a[None, :])[:, None, :]   # [P, 1, split]
    gap2 = np.zeros((len(ci), split, split), np.float32)
    for c in range(3):
        g = np.maximum(
            np.maximum(
                smin[c][isub] - smax[c][jsub],
                smin[c][jsub] - smax[c][isub],
            ),
            0.0,
        )
        gap2 += g * g
    return coarse, int((gap2 <= rc2).sum()), block


def host_sub_pair_budget(position, box: float, r_c: float, near_grid: int,
                         headroom: float = PAIR_HEADROOM) -> Optional[int]:
    """Survivor count of the sub-block prune × headroom, for
    `sub_pair_budget`; None when no expansion happens."""
    _, sub, _ = host_tree_counts(position, box, r_c, near_grid)
    if sub is None:
        return None
    return int(sub * headroom) + 2


def host_block_pairs(position, box: float, r_c: float, near_grid: int,
                     block: Optional[int] = None):
    """Host block-pair count under the device walk's rule -> (count,
    block)."""
    coarse, _sub, blk = host_tree_counts(position, box, r_c, near_grid,
                                         block=block)
    return coarse, blk


def counts_cache_key(gn: int, r_c: float):
    """Canonical key of one (near grid, cutoff) probe in a counts cache."""
    return (int(gn), f"{float(r_c):.9g}")


# -- grid choice ---------------------------------------------------------------
# The JAX package's ranking model of the tree-P3M accel time, kept so the
# port picks the grid the JAX package picks for the same scene:
#   cost = _COST_PER_PAIR * pair_interactions + _COST_FAR * G³ log2 G
#          + _COST_PER_N * N
# Only the ranking is used; among candidates within _COST_BAND of the
# cheapest, the largest grid wins.
_COST_PER_PAIR = 1.374e-8
_COST_FAR = 3.911e-6
_COST_PER_N = 4.316e-5
_COST_BAND = 1.2

AUTO_GRID_LADDER = (64, 96, 128, 192, 256, 384, 512)

# Device bytes per grid cell (G³) held at the peak of one long-range solve
# (`p3m._accel_long`), counted from the buffers it allocates; a complex64
# element is 8 B and the doubled grid's half spectrum [2G, 2G, G+1] about
# 32 B per cell. The peak is the first inverse's axis-1 transform:
#    4  rho
#   96  the three cached kernel spectra
#   32  the forward spectrum (alive through all three inverses)
#   32  spectrum * kernel (alive through the inverse it feeds)
#   32  the axis-0 inverse [2G, 2G, G+1] (its [:G] slice keeps all of it)
#   16  the axis-1 inverse [G, 2G, G+1]
#    8  two finished acceleration grids (the third is not yet made)
#   32  cuFFT's work area, at most one transform's size
# The kernel tabulation (`p3m._long_grad_kernels_rfft`, the first solve of
# a grid) holds less: the spectra made so far, one [2G]³ real grid and its
# spectrum. chip_smoke holds the count against
# `torch.cuda.max_memory_allocated` over a cold and a warm solve at G=192
# and G=256.
SOLVE_BYTES_PER_CELL = 4 + 96 + 32 + 32 + 32 + 16 + 8 + 32

# share of the compute device's memory the long-range solve may hold; the
# rest is kept for the particle state, the tree lists and the render
SOLVE_MEMORY_SHARE = 0.5


def solve_budget(device) -> int:
    """Bytes the long-range solve may hold on `device`: SOLVE_MEMORY_SHARE
    of its memory (a CUDA card's total memory, the host's RAM for the
    CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
    elif device.type == "cpu":
        total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    else:
        raise ValueError(f"no memory budget for device {device}")
    return int(total * SOLVE_MEMORY_SHARE)


def feasible_grid(g: int, budget: int) -> bool:
    """Whether grid g's long-range solve fits `budget` bytes."""
    return g ** 3 * SOLVE_BYTES_PER_CELL <= budget


def auto_grid(position, box: float, cutoff_cells: float, budget: int,
              candidates=AUTO_GRID_LADDER, counts_cache: Optional[dict] = None,
              num_particles: Optional[int] = None) -> int:
    """Pick the mesh size minimizing the JAX package's modeled tree-P3M
    accel time on the actual scene, among the grids whose solve fits
    `budget` bytes (`solve_budget(device)`). `position` may be a zero-arg
    callable (materialized on a counts-cache miss); `counts_cache` maps
    `counts_cache_key` -> `host_tree_counts` triples."""
    if callable(position):
        pos_fn, _pos = position, None

        def get_pos():
            nonlocal _pos
            if _pos is None:
                _pos = np.asarray(pos_fn())
            return _pos
    else:
        def get_pos():
            return position

    n = num_particles
    if n is None:
        n = np.asarray(get_pos()).shape[1]
    is_default = candidates is AUTO_GRID_LADDER
    candidates = tuple(g for g in candidates if feasible_grid(g, budget))
    if not candidates:
        raise ValueError(
            f"no auto_grid candidate fits the solve budget ({budget} B); "
            "largest feasible grid is "
            f"{int((budget / SOLVE_BYTES_PER_CELL) ** (1 / 3))}")
    if is_default:
        # small grids are strictly dominated at scale: trim them
        if n > 8_000_000:
            candidates = tuple(g for g in candidates if g >= 256)
        elif n > 2_000_000:
            candidates = tuple(g for g in candidates if g >= 192)
    costs = {}
    for g in candidates:
        r_c = cutoff_cells * box / g
        gn = max(int(box // r_c), 1)
        ck = counts_cache_key(gn, r_c)
        if counts_cache is not None and ck in counts_cache:
            coarse, sub, block = counts_cache[ck]
        else:
            coarse, sub, block = host_tree_counts(get_pos(), box, r_c, gn)
            if counts_cache is not None:
                counts_cache[ck] = (coarse, sub, block)
        if sub is not None:
            # wide blocks are swept at sub-block granularity
            count, block = sub, _SWEEP_MAX_BLOCK
        else:
            count = coarse
        pairs = float(count) * block * block
        costs[g] = (_COST_PER_PAIR * pairs + _COST_FAR * g ** 3 * np.log2(g)
                    + _COST_PER_N * n)
    cmin = min(costs.values())
    return int(max(g for g, c in costs.items() if c <= _COST_BAND * cmin))
