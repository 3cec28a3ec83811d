"""Rectangle-schedule all-pairs variants: CUDA kernels + plain torch twins.

The port of the JAX package's `experiments/allpairs_*.py` A/B variants of
the directed rectangle (`ops/allpairs.py::all_pairs_accel`, "v0"): one
function per JAX launcher, under the JAX names, keyword names and
defaults. The harness that times them against v0 is
`multi_adapter_particles_torch/tools/allpairs_variants.py`.

- `attr_accel` (`allpairs_v2.py:87`): v0 with op groups removed (`mode`),
  no mass applied; [N, 4].
- `v1b_accel` (`allpairs_v2.py:166`): d² = (w_j·v_i) + r_i², F = (p_j, 1)ᵀ·S.
- `unroll_accel` (`allpairs_unroll.py:85`): v0 in two chains over
  alternating j-tiles.
- `v1_accel` (`allpairs_variants.py:101`): d² = r_i² + (r_j² − 2 p_i·p_j),
  F = S·(p_j, 1).
- `v3_accel` (`allpairs_v3.py:144`): the centred expansion, bf16 hi/lo
  split, `force_path`.
- `hybrid_accel` (`allpairs_hybrid.py:131`): per 3 j-tiles, two
  elementwise and one HIGHEST expansion.
- `v4_accel` (`allpairs_planeacc.py:84`): v0 summed per (target, j-lane),
  one lane reduction; [N, 4].

Each result is (ax, ay, az, |a|) with `PARTICLE_MASS` applied once (attr:
no mass), softening `SOFTENING_SQUARED`, no interaction scale, and the
layout of the JAX function's output ([N, 4] where the JAX kernel writes
rows). N must be a multiple of 128 (the kernels' tile; the port's state
pads to 128).

Where `ti`/`tj` only set the order of a sum (attr, unroll, v1, v1b, v4)
the kernels pick their own tiles and the twins their own blocks; unroll
keeps the JAX rule that `N // tj` is even. Where they change the result
they are semantics: v3 centres each (ti-block, tj-tile) pair on the mean of
its two centroids, and hybrid sends the third tj-tile of every group of
three through the expansion (`ValueError` unless `N // tj` divides by 3).

Matrix-unit precision is what the TPU computes. `"default"` is one bf16
pass: operands rounded to bf16, products summed in float32 (the kernels:
BF16 `mma` with FP32 accumulation; the twins: bf16-rounded operands in
float32 arithmetic). `"highest"` is float32-accurate: the twins compute in
float32, the kernels split each operand into three bf16 pieces and take
the six products TPU HIGHEST takes (hi·hi, hi·mid, mid·hi, hi·lo, lo·hi,
mid·mid). v1's dot names no precision in JAX, so it runs at `"default"`;
v3's bf16 splits are explicit casts on both sides. The expansion forms
cancel in d² (|p|² ~ 1e5 against d² ~ eps2), so the twins keep the JAX
op order; the bf16 forms are wrong by design on a ±400 scene (JAX's own
finding, `allpairs_v3.py:3-6`).

- CUDA tensors go to the kernels in `csrc/allpairs_variants.cu`, or the
  wrappers raise.
- CPU tensors go to the `*_plain` twins.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from multi_adapter_particles_torch import constants as C
from multi_adapter_particles_torch.ops import _build

Tensor = torch.Tensor

TILE = 128                 # N must be a multiple (the kernels' tile)
ATTR_MODES = ("full", "norsqrt", "noaccum")
PRECISIONS = ("highest", "default")
FORCE_PATHS = ("vpu", "mm_split", "mm_bf16")
HYBRID_GROUP = 3           # j-tiles a group: 2 elementwise + 1 expansion

# elements of one [Ni, tj] pair plane in the twins (bounds their memory)
_PLANE_ELEMS = 1 << 24

MASS = C.PARTICLE_MASS
EPS2 = C.SOFTENING_SQUARED


def _check(position: Tensor, what: str) -> int:
    if position.dim() != 2 or position.shape[0] != 4:
        raise ValueError(f"{what} takes position [4, N], got "
                         f"{list(position.shape)}")
    n = position.shape[1]
    if n == 0 or n % TILE:
        raise ValueError(f"{what} takes N a positive multiple of {TILE}, "
                         f"got {n}")
    return n


def _check_choice(value: str, allowed, what: str) -> None:
    if value not in allowed:
        raise ValueError(f"{what} must be one of {allowed}, got {value!r}")


def _bf16(x: Tensor) -> Tensor:
    """x rounded to bf16 (nearest even), back in x's dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def _split(q: Tensor):
    """The JAX `_split`: q ~ hi + lo, both bf16 values (in q's dtype)."""
    hi = _bf16(q)
    return hi, _bf16(q - hi)


def _scalar(v: float, like: Tensor) -> Tensor:
    return torch.tensor(v, dtype=like.dtype)


def _step(rows: int) -> int:
    """Sources a twin takes at once against `rows` targets."""
    return max(TILE, _PLANE_ELEMS // max(rows, 1) // TILE * TILE)


def _inv3(d2: Tensor) -> Tensor:
    inv = torch.rsqrt(d2)
    return inv * inv * inv


def _r2(p: Tensor) -> Tensor:
    """x² + y² + z² over dim 0, in the JAX reduction order."""
    return (p[0] * p[0] + p[1] * p[1]) + p[2] * p[2]


def _amag(a3: Tensor) -> Tensor:
    return torch.sqrt(a3[0] * a3[0] + a3[1] * a3[1] + a3[2] * a3[2])


def _out(a3: Tensor, rows: bool) -> Tensor:
    """[3, N] -> [4, N] with |a|; `rows`: the JAX [N, 4] layout."""
    out = torch.cat([a3, _amag(a3)[None]], dim=0)
    return out.T.contiguous() if rows else out


def _pair_planes(position: Tensor, src: Tensor):
    """dx, dy, dz and d² [Ni, tj] of every target against sources src."""
    xi, yi, zi = (position[k][:, None] for k in range(3))
    dx = src[0][None, :] - xi
    dy = src[1][None, :] - yi
    dz = src[2][None, :] - zi
    return dx, dy, dz, dx * dx + dy * dy + dz * dz + EPS2


def _direct_sums(position: Tensor, j0: int, j1: int) -> Tensor:
    """[3, N]: sum over sources j0..j1 of d·s (v0's pair terms)."""
    n = position.shape[1]
    acc = torch.zeros((3, n), dtype=position.dtype, device=position.device)
    step = _step(n)
    for a in range(j0, j1, step):
        dx, dy, dz, d2 = _pair_planes(position, position[:3, a:min(a + step,
                                                                    j1)])
        s = _inv3(d2)
        acc += torch.stack([(dx * s).sum(1), (dy * s).sum(1),
                            (dz * s).sum(1)])
    return acc


# -- 9a: attribution ----------------------------------------------------------

def attr_accel_plain(position: Tensor, mode: str = "full", ti: int = 512,
                     tj: int = 1024) -> Tensor:
    """Twin of `_attr_kernel` (`allpairs_v2.py:37`): v0's pair terms with
    `mode` "norsqrt" (s = d² · 1e-9, no rsqrt) or "noaccum" (ax = Σ s, no
    force products); "full" keeps all. No mass is applied. [N, 4]."""
    n = _check(position, "attr_accel")
    _check_choice(mode, ATTR_MODES, "mode")
    acc = torch.zeros((3, n), dtype=position.dtype, device=position.device)
    step = _step(n)
    for j0 in range(0, n, step):
        dx, dy, dz, d2 = _pair_planes(position, position[:3, j0:j0 + step])
        s = d2 * _scalar(1e-9, d2) if mode == "norsqrt" else _inv3(d2)
        if mode == "noaccum":
            acc[0] += s.sum(1)
        else:
            acc += torch.stack([(dx * s).sum(1), (dy * s).sum(1),
                                (dz * s).sum(1)])
    return _out(acc, rows=True)


# -- 9c: two accumulator chains -----------------------------------------------

def unroll_fits(n: int, tj: int = 2048) -> bool:
    """unroll's JAX shape rule: N // tj even (and tj dividing N)."""
    return n % tj == 0 and (n // tj) % 2 == 0


def _unroll_rule(n: int, tj: int) -> None:
    if not unroll_fits(n, tj):
        raise ValueError(f"unroll_accel needs N // tj even (N={n}, tj={tj})")


def unroll_accel_plain(position: Tensor, ti: int = 256,
                       tj: int = 2048) -> Tensor:
    """Twin of `allpairs_unroll.py:29`: tj-tile t's sums go to chain t % 2,
    a = (a₀ + a₁) · m. [4, N]."""
    n = _check(position, "unroll_accel")
    _unroll_rule(n, tj)
    chains = [torch.zeros((3, n), dtype=position.dtype,
                          device=position.device) for _ in range(2)]
    for t, j0 in enumerate(range(0, n, tj)):
        chains[t % 2] += _direct_sums(position, j0, j0 + tj)
    return _out((chains[0] + chains[1]) * _scalar(MASS, position), False)


# -- 9h: plane accumulation ---------------------------------------------------

LANES = 32   # the kernel's j-lanes (one warp)


def v4_accel_plain(position: Tensor, ti: int = 256, tj: int = 1024) -> Tensor:
    """Twin of `_v4_kernel` (`allpairs_planeacc.py:35`): d·s summed per
    (target, j mod 32) over all sources, then one sum across the 32 lanes,
    times m. [N, 4]."""
    n = _check(position, "v4_accel")
    planes = torch.zeros((3, n, LANES), dtype=position.dtype,
                         device=position.device)
    step = _step(n)
    for j0 in range(0, n, step):
        dx, dy, dz, d2 = _pair_planes(position, position[:3, j0:j0 + step])
        s = _inv3(d2)
        for k, d in enumerate((dx, dy, dz)):
            planes[k] += (d * s).view(n, -1, LANES).sum(1)
    return _out(planes.sum(2) * _scalar(MASS, position), rows=True)


# -- 9b, 9d: the expansion forms ----------------------------------------------

def _outer(a, b) -> Tensor:
    """Σ_k a[k][:, None] · b[k][None, :] in k order ([M, K]ᵀ·[K, N] of a
    small K, as float32 sums, with no matmul precision to set)."""
    out = a[0][:, None] * b[0][None, :]
    for k in range(1, len(a)):
        out = out + a[k][:, None] * b[k][None, :]
    return out


def _rows_dot(rows, s: Tensor, dim: int) -> Tensor:
    """[len(rows), ·]: Σ over `dim` of rows[r] (broadcast) · s."""
    return torch.stack([(r * s).sum(dim) for r in rows])


def _v1b_tile(p: Tensor, ri2: Tensor, pj: Tensor, precision: str) -> Tensor:
    """v1b's [4, N] sums over sources pj [3, c] (`allpairs_v2.py:135-155`):
    d²[j, i] = (w_j·v_i) + ri2_i, F = (p_j, 1)ᵀ·S."""
    rd = _bf16 if precision == "default" else (lambda x: x)
    one_i = torch.ones_like(p[0])
    rj2 = _r2(pj)
    wj = [rd(-2.0 * pj[0]), rd(-2.0 * pj[1]), rd(-2.0 * pj[2]), rd(rj2)]
    vi = [rd(p[0]), rd(p[1]), rd(p[2]), one_i]
    d2 = _outer(wj, vi) + ri2[None, :]                      # [c, N]
    s = rd(_inv3(d2))
    tile1 = [rd(pj[0])[:, None], rd(pj[1])[:, None], rd(pj[2])[:, None]]
    f = _rows_dot(tile1, s, 0)
    return torch.cat([f, s.sum(0)[None]])


def v1b_accel_plain(position: Tensor, ti: int = 512, tj: int = 512,
                    precision: str = "highest") -> Tensor:
    """Twin of `_v1b_kernel` (`allpairs_v2.py:112`): planes [TJ, TI],
    d² = (w_j·v_i) + r_i² with w_j = (−2x, −2y, −2z, r_j²) and
    v_i = (x, y, z, 1), F = (p_j, 1)ᵀ·S, a = m(F₀..₂ − p_i F₃). [4, N]."""
    n = _check(position, "v1b_accel")
    _check_choice(precision, PRECISIONS, "precision")
    p = position[:3]
    ri2 = _r2(p) + EPS2
    acc = torch.zeros((4, n), dtype=position.dtype, device=position.device)
    step = _step(n)
    for j0 in range(0, n, step):
        acc += _v1b_tile(p, ri2, p[:, j0:j0 + step], precision)
    return _out(_scalar(MASS, p) * (acc[:3] - p * acc[3:4]), rows=False)


def v1_accel_plain(position: Tensor, ti: int = 256, tj: int = 512,
                   precision: str = "default") -> Tensor:
    """Twin of `_v1_kernel` (`allpairs_variants.py:35`): planes [TI, TJ],
    d² = r_i² + (r_j² − 2 p_i·p_j), F = S·(p_j, 1), a = m(F₀..₂ − p_i F₃).
    The JAX dots name no precision: DEFAULT. [4, N]."""
    n = _check(position, "v1_accel")
    _check_choice(precision, PRECISIONS, "precision")
    rd = _bf16 if precision == "default" else (lambda x: x)
    p = position[:3]
    ri2 = _r2(p) + EPS2
    pr = [rd(p[k]) for k in range(3)]
    acc = torch.zeros((4, n), dtype=position.dtype, device=position.device)
    step = _step(n)
    for j0 in range(0, n, step):
        pj = p[:, j0:j0 + step]
        rj2 = _r2(pj)
        dot = _outer(pr, [rd(pj[k]) for k in range(3)])    # [N, c]
        d2 = ri2[:, None] + (rj2[None, :] - 2.0 * dot)
        s = rd(_inv3(d2))
        f = _rows_dot([rd(pj[k])[None, :] for k in range(3)], s, 1)
        acc += torch.cat([f, s.sum(1)[None]])
    return _out(_scalar(MASS, p) * (acc[:3] - p * acc[3:4]), rows=False)


# v1 / v1b's kernel shape and shared-memory layout (csrc/allpairs_variants.cu's
# `expand_kernel`, whose exports `_library` checks these against when it
# loads)
EXPAND_MT = 2            # m16 row tiles a warp (32 targets)
EXPAND_WARPS = 8         # warps a CTA
EXPAND_SM_WARPS = 16     # warps an SM its launch bounds ask for
EXPAND_TARGETS = 16 * EXPAND_MT * EXPAND_WARPS
EXPAND_STAGE = 512       # sources a staged buffer (fewer when N % 512)
# the first-mma record of a source: the K words (each two bf16 K slots) in
# record order; "highest" reads words t and t + 4 as one 64-bit load at 2 t
# (K words 8-11 repeat 0-3, 12-15 are zero), "default" word t & 1 (group 0;
# its K words 2-3 meet a zero A)
EXPAND_REC = {"highest": (0, 4, 1, 5, 2, 6, 3, 7), "default": (0, 1)}
# a chunk's column table: [hi x y z | 1 | mid x y z | 0 | lo x y z]
# ("highest"), [hi x y z | 1 | 0] ("default"), 8 source-pair words a
# column; the second mma's B operands ("which"): 0 [hi | mid] ("highest"
# only), 1 [hi | 0], 2 [lo | 0] ("highest" only)
EXPAND_COLS = {"highest": 11, "default": 5}
EXPAND_ZERO_COL = {"highest": 7, "default": 4}
EXPAND_WHICH = {"highest": (0, 1, 2), "default": (1,)}


def expand_stage(n: int) -> int:
    """Sources an expansion stage: the largest of EXPAND_STAGE, a half and
    a quarter of it that divides N (N a multiple of TILE)."""
    return next(s for s in (EXPAND_STAGE, EXPAND_STAGE // 2,
                            EXPAND_STAGE // 4) if n % s == 0)


def expand_smem_bytes(v1b: bool, precision: str) -> int:
    """Dynamic shared memory of an expansion CTA: two stage buffers of
    EXPAND_STAGE sources, each a record (8 words "highest", 2 "default"), a
    column table (8 words a column) and, for v1, r_j² (twice at
    "highest"; v1b: a 16-byte pad)."""
    rj2 = 4 if v1b else EXPAND_STAGE * (2 if precision == "highest" else 1)
    words = (EXPAND_STAGE * len(EXPAND_REC[precision])
             + EXPAND_STAGE // 16 * EXPAND_COLS[precision] * 8 + rj2)
    return 2 * 4 * words


def expand_rec_words(precision: str, lane: int, chunk: int,
                     half: int) -> tuple:
    """The words lane (g, t) = (lane // 4, lane % 4) reads of a stage
    buffer's records for the first mma of one (chunk, half): source
    chunk·16 + half·8 + g's words 2 t and 2 t + 1 (one 64-bit load,
    "highest") or word t & 1 ("default")."""
    g, t = lane >> 2, lane & 3
    rec = len(EXPAND_REC[precision])
    base = (chunk * 16 + half * 8 + g) * rec
    return (base + 2 * t, base + 2 * t + 1) if precision == "highest" \
        else (base + (t & 1),)


def expand_col(precision: str, which: int, g: int) -> int:
    """The column lane group g reads for second-mma operand `which`."""
    zero = EXPAND_ZERO_COL[precision]
    if which == 0:
        return g
    if which == 1:
        return g if g < 4 else zero
    return 8 + g if g < 3 else zero


def expand_tcol_words(precision: str, which: int, lane: int,
                      chunk: int) -> tuple:
    """The two words (one 64-bit load) lane (g, t) reads of chunk's column
    table for second-mma operand `which`: its column's slots 2 t, 2 t + 1,
    which hold source-pair words t and t + 4 (`v3_tcol_slot`'s order)."""
    g, t = lane >> 2, lane & 3
    w = (chunk * EXPAND_COLS[precision] + expand_col(precision, which, g)) \
        * 8 + 2 * t
    return (w, w + 1)


def expand_rj2_words(precision: str, lane: int, chunk: int,
                     half: int) -> tuple:
    """v1: the words lane (g, t) reads of r_j², those of its accumulator
    columns' source pair m = chunk·8 + half·4 + t: "highest" stores each
    pair as (r_2m, r_2m+1, r_2m, r_2m+1), its first-mma C quad (one
    128-bit load); "default" r_j² once a source (one 64-bit load)."""
    m = chunk * 8 + half * 4 + (lane & 3)
    if precision == "highest":
        return tuple(range(4 * m, 4 * m + 4))
    return (2 * m, 2 * m + 1)


def _check_expand_layout(lib) -> None:
    """Raise unless the .cu's expansion CTA shape, shared memory, stages
    and fragment loads are this module's mirror of them."""
    if (lib.apv_expand_warps(0), lib.apv_expand_warps(1),
            lib.apv_expand_warps(2)) != (EXPAND_WARPS, EXPAND_SM_WARPS,
                                         EXPAND_MT) or any(
            lib.apv_expand_smem(int(v1b), int(prec == "highest"))
            != expand_smem_bytes(v1b, prec)
            for v1b in (True, False) for prec in PRECISIONS):
        raise RuntimeError("csrc/allpairs_variants.cu's expansion warps, row "
                           "tiles or shared memory are not EXPAND_WARPS, "
                           "EXPAND_SM_WARPS, EXPAND_MT and expand_smem_bytes")
    for n in [TILE * k for k in range(1, 65)] + [TILE * 769]:
        if lib.apv_expand_stage(n) != expand_stage(n):
            raise RuntimeError(f"csrc/allpairs_variants.cu's expansion stage "
                               f"at N={n} is not expand_stage's")
    for prec in PRECISIONS:
        hi = int(prec == "highest")
        for c in (0, 1, EXPAND_STAGE // 16 - 1):
            for lane in range(32):
                bad = any(
                    lib.apv_expand_rec_word(hi, c, h, lane)
                    != expand_rec_words(prec, lane, c, h)[0]
                    or lib.apv_expand_rj2_word(hi, c, h, lane)
                    != expand_rj2_words(prec, lane, c, h)[0]
                    for h in (0, 1)) or any(
                    lib.apv_expand_tcol_word(hi, which, c, lane)
                    != expand_tcol_words(prec, which, lane, c)[0]
                    for which in EXPAND_WHICH[prec])
                if bad:
                    raise RuntimeError(
                        "csrc/allpairs_variants.cu's expansion fragment loads "
                        f"are not the mirror's ({prec}, chunk {c}, lane "
                        f"{lane})")


# -- 9e: centred bf16 expansion -----------------------------------------------

def v3_fits(n: int, ti: int = 512, tj: int = 512) -> bool:
    """ti and tj multiples of TILE that divide N (v3's tiles are
    semantics)."""
    return ti % TILE == 0 and tj % TILE == 0 and n % ti == 0 and n % tj == 0


def _v3_rule(n: int, ti: int, tj: int) -> None:
    if not v3_fits(n, ti, tj):
        raise ValueError(f"v3_accel needs ti, tj multiples of {TILE} that "
                         f"divide N (N={n}, ti={ti}, tj={tj})")


# v3's kernel shape and shared-memory layout (csrc/allpairs_variants.cu's
# `v3_kernel`, whose exports `_library` checks these against when it loads)
V3_STAGE = 512         # sources a staged buffer (fewer when tj % 512)
V3_WARPS = 4           # warps a CTA (32 targets each)
V3_SM_WARPS = 20       # warps an SM its launch bounds ask for


def v3_stage(tj: int) -> int:
    """Sources a v3 stage: the largest of V3_STAGE, a half and a quarter of
    it that divides tj, so that no stage straddles two j-tiles."""
    return next(s for s in (V3_STAGE, V3_STAGE // 2, V3_STAGE // 4)
                if tj % s == 0)


def v3_smem_bytes(force_path: str) -> int:
    """Static shared memory of a v3 CTA: two stage buffers (double
    buffering) of V3_STAGE sources — 16 B of first-mma record and, for
    "vpu", 16 B of (q, r_j²), for the mm paths 16 B of column table and 4 B
    of r_j² — and the stage's centre (16 B), then the CTA's targets (16 B
    each). The same at every tj."""
    per_source = 32 if force_path == "vpu" else 36
    return 2 * (V3_STAGE * per_source + 16) + 32 * V3_WARPS * 16


def v3_rec_words(lane: int, chunk: int, half: int) -> tuple:
    """The two 32-bit words (one 64-bit load) lane (g, t) = (lane // 4,
    lane % 4) reads of a stage buffer's first-mma records in one (chunk,
    half): words 2 (t & 1) and 2 (t & 1) + 1 of source g's 4-word record."""
    g, t = lane >> 2, lane & 3
    w = (chunk * 16 + half * 8 + g) * 4 + 2 * (t & 1)
    return (w, w + 1)


def v3_tcol_slot(pair: int) -> int:
    """The slot of source-pair word `pair` (0-7) in a column of a chunk's
    column table (8 columns of 8 words): w0 w4 w1 w5 w2 w6 w3 w7."""
    return 2 * (pair & 3) + (pair >> 2)


def v3_tcol_words(lane: int, chunk: int, low: bool) -> tuple:
    """The two words (one 64-bit load) lane (g, t) reads of chunk's column
    table for the second mma's B: column g (mm_split's B_l with `low`:
    column g & 3), the slots of source-pair words t and t + 4."""
    g, t = lane >> 2, lane & 3
    base = chunk * 64 + (g & 3 if low else g) * 8
    return (base + v3_tcol_slot(t), base + v3_tcol_slot(t + 4))


def v3_q_sources(lane: int, chunk: int, half: int) -> tuple:
    """vpu: the two sources whose (q, r_j²) float4 lane (g, t) loads for
    one (chunk, half): those of its accumulator columns 2 t and 2 t + 1."""
    src = chunk * 16 + half * 8 + 2 * (lane & 3)
    return (src, src + 1)


def _check_v3_layout(lib) -> None:
    """Raise unless the .cu's v3 CTA width, shared memory, stages and
    fragment loads are this module's mirror of them."""
    if (lib.apv_v3_warps(0), lib.apv_v3_warps(1)) != (
            V3_WARPS, V3_SM_WARPS) or any(
            lib.apv_v3_smem(_FORCE_PATH[fp]) != v3_smem_bytes(fp)
            for fp in FORCE_PATHS):
        raise RuntimeError("csrc/allpairs_variants.cu's v3 warps or shared "
                           "memory are not V3_WARPS, V3_SM_WARPS and "
                           "v3_smem_bytes")
    for tj in range(TILE, 4096 + 1, TILE):
        if lib.apv_v3_stage(tj) != v3_stage(tj):
            raise RuntimeError(f"csrc/allpairs_variants.cu's v3 stage at "
                               f"tj={tj} is not v3_stage's")
    for c in (0, 1, V3_STAGE // 16 - 1):
        for lane in range(32):
            for h in (0, 1):
                if (lib.apv_v3_rec_word(c, h, lane)
                        != v3_rec_words(lane, c, h)[0]
                        or (lib.apv_v3_q_source(c, h, lane, 0),
                            lib.apv_v3_q_source(c, h, lane, 1))
                        != v3_q_sources(lane, c, h)
                        or lib.apv_v3_tcol_word(c, h, lane)
                        != v3_tcol_words(lane, c, bool(h))[0]):
                    raise RuntimeError(
                        "csrc/allpairs_variants.cu's v3 fragment loads are "
                        f"not the mirror's (chunk {c}, lane {lane})")
    if [lib.apv_v3_tcol_slot(m) for m in range(8)] != [
            v3_tcol_slot(m) for m in range(8)]:
        raise RuntimeError("csrc/allpairs_variants.cu's v3 column slots are "
                           "not v3_tcol_slot's")


def v3_centroids(position: Tensor, ti: int, tj: int):
    """The tile centroids [3, N/ti] and [3, N/tj] (`allpairs_v3.py:58,77`)."""
    p = position[:3]
    n = p.shape[1]
    return (p.reshape(3, n // ti, ti).mean(2),
            p.reshape(3, n // tj, tj).mean(2))


def v3_accel_plain(position: Tensor, ti: int = 512, tj: int = 512,
                   force_path: str = "vpu") -> Tensor:
    """Twin of `_v3_kernel` (`allpairs_v3.py:53`): each (ti-block, tj-tile)
    pair centred on c = (c_i + c_j)/2; q = hi + lo in bf16; d² = (r_i² −
    2 dot) + r_j² with dot the four split products (one K=12 matmul);
    force by `force_path`: "vpu" (float32 sums), "mm_split" (s split hi/lo,
    two bf16 matmuls), "mm_bf16" (s in bf16, one matmul). [4, N]."""
    n = _check(position, "v3_accel")
    _check_choice(force_path, FORCE_PATHS, "force_path")
    _v3_rule(n, ti, tj)
    p = position[:3]
    ci, cj = v3_centroids(position, ti, tj)
    acc3 = torch.zeros((3, n), dtype=position.dtype, device=position.device)
    per = max(1, _PLANE_ELEMS // (ti * tj))    # j-tiles at once
    half = _scalar(0.5, p)
    for a in range(n // ti):
        pi = p[:, a * ti:(a + 1) * ti]
        for b0 in range(0, n // tj, per):
            b1 = min(b0 + per, n // tj)
            c = half * (ci[:, a:a + 1] + cj[:, b0:b1])            # [3, nb]
            qi = pi[:, None, :] - c[:, :, None]           # [3, nb, ti]
            qj = (p[:, b0 * tj:b1 * tj].reshape(3, b1 - b0, tj)
                  - c[:, :, None])                        # [3, nb, tj]
            hi_i, lo_i = _split(qi)
            hi_j, lo_j = _split(qj)
            ri2 = _r2(qi) + EPS2                                   # [nb, ti]
            rj2 = _r2(qj)                                          # [nb, tj]
            # the K=12 products in slot order: hi_j·hi_i, hi_j·lo_i,
            # lo_j·hi_i, lo_j·lo_i (each exact in float32)
            dot = None
            for wj, vi in ((hi_j, hi_i), (hi_j, lo_i), (lo_j, hi_i),
                           (lo_j, lo_i)):
                for k in range(3):
                    t = wj[k][:, :, None] * vi[k][:, None, :]      # [nb,tj,ti]
                    dot = t if dot is None else dot + t
            d2 = (ri2[:, None, :] - 2.0 * dot) + rj2[:, :, None]
            s = _inv3(d2)
            col = lambda r: r[:, :, None]                          # noqa: E731
            if force_path == "vpu":
                f3 = _rows_dot([col(qj[k]) for k in range(3)], s, 1)
                fs = s.sum(1)
            elif force_path == "mm_split":
                sh, sl = _split(s)
                rows_h = [col(hi_j[k]) for k in range(3)] + \
                    [col(lo_j[k]) for k in range(3)]
                f_h = _rows_dot(rows_h, sh, 1)
                f_l = _rows_dot([col(hi_j[k]) for k in range(3)], sl, 1)
                f3 = (f_h[0:3] + f_h[3:6]) + f_l
                fs = sh.sum(1) + sl.sum(1)
            else:
                sh = _bf16(s)
                rows_h = [col(hi_j[k]) for k in range(3)] + \
                    [col(lo_j[k]) for k in range(3)]
                f = _rows_dot(rows_h, sh, 1)
                f3 = f[0:3] + f[3:6]
                fs = sh.sum(1)
            acc3[:, a * ti:(a + 1) * ti] += (f3 - qi * fs[None]).sum(1)
    return _out(_scalar(MASS, p) * acc3, rows=False)


# -- 9f: hybrid ---------------------------------------------------------------

def hybrid_fits(n: int, tj: int = 512) -> bool:
    """hybrid's JAX shape rule: N // tj a multiple of the tile group."""
    return tj % TILE == 0 and n % tj == 0 and (n // tj) % HYBRID_GROUP == 0


def _hybrid_rule(n: int, tj: int) -> None:
    if not hybrid_fits(n, tj):
        raise ValueError(f"hybrid_accel: num_j must divide by the tile group "
                         f"(N={n}, tj={tj}, group {HYBRID_GROUP})")


# hybrid's kernel shape and shared-memory layout (csrc/allpairs_variants.cu's
# `hybrid_kernel`, whose exports `_library` checks these against when it
# loads): the expansion's CTA (EXPAND_WARPS warps of two m16 row tiles,
# EXPAND_SM_WARPS an SM); a stage holds S expansion sources of a group's
# tile 2 and the 2 S elementwise sources of its tiles 0-1 beside them, and
# a loop body takes one 16-source chunk of the first and HYBRID_ELEM of the
# second
HYBRID_STAGE = 512       # expansion sources a stage (fewer when tj % 512)
HYBRID_ELEM = 32         # elementwise sources a loop body


def hybrid_stage(tj: int) -> int:
    """Expansion sources a hybrid stage: the largest of HYBRID_STAGE, a
    half and a quarter of it that divides tj (tj a multiple of TILE)."""
    return next(s for s in (HYBRID_STAGE, HYBRID_STAGE // 2,
                            HYBRID_STAGE // 4) if tj % s == 0)


def hybrid_source(tj: int, stage: int, j: int) -> int:
    """The source index of stage `stage`'s source j (of 3 S, S =
    hybrid_stage(tj)): j < 2 S its group's tiles 0-1, the stage's 2 S of
    them in order; then S of its tile 2. A group takes tj / S stages."""
    size = hybrid_stage(tj)
    group, k = divmod(stage, tj // size)
    if j < 2 * size:
        return group * 3 * tj + k * 2 * size + j
    return group * 3 * tj + 2 * tj + k * size + (j - 2 * size)


def hybrid_elem_words(chunk: int, u: int) -> tuple:
    """The four words (one 16-byte load, the same on every lane) loop body
    `chunk` reads as its u-th float4 of each elementwise plane: sources
    chunk·HYBRID_ELEM + 4 u to + 3 of the stage."""
    w = chunk * HYBRID_ELEM + 4 * u
    return tuple(range(w, w + 4))


def hybrid_smem_bytes() -> int:
    """Dynamic shared memory of a hybrid CTA: two stage buffers, each v1b
    "highest"'s (records and column table of HYBRID_STAGE sources) and
    the x, y and z planes of 2 HYBRID_STAGE elementwise sources."""
    return expand_smem_bytes(True, "highest") + 2 * 3 * 2 * HYBRID_STAGE * 4


def _check_hybrid_layout(lib) -> None:
    """Raise unless the .cu's hybrid CTA shape, shared memory, stages,
    source order and elementwise loads are this module's mirror of
    them."""
    if tuple(lib.apv_hybrid_warps(k) for k in range(3)) != (
            EXPAND_WARPS, EXPAND_SM_WARPS, EXPAND_MT) or \
            lib.apv_hybrid_smem() != hybrid_smem_bytes():
        raise RuntimeError("csrc/allpairs_variants.cu's hybrid warps, row "
                           "tiles or shared memory are not EXPAND_WARPS, "
                           "EXPAND_SM_WARPS, EXPAND_MT and hybrid_smem_bytes")
    for tj in range(TILE, 4096 + 1, TILE):
        size = hybrid_stage(tj)
        if lib.apv_hybrid_stage(tj) != size:
            raise RuntimeError(f"csrc/allpairs_variants.cu's hybrid stage at "
                               f"tj={tj} is not hybrid_stage's")
        for stage in range(3 * tj // size + 1):
            for j in (0, 1, 2 * size - 1, 2 * size, 3 * size - 1):
                if lib.apv_hybrid_source(tj, stage, j) != hybrid_source(
                        tj, stage, j):
                    raise RuntimeError(
                        "csrc/allpairs_variants.cu's hybrid source order is "
                        f"not hybrid_source's (tj={tj}, stage {stage}, j={j})")
    for c in range(HYBRID_STAGE // 16):
        for u in range(HYBRID_ELEM // 4):
            if lib.apv_hybrid_elem_word(c, u) != hybrid_elem_words(c, u)[0]:
                raise RuntimeError("csrc/allpairs_variants.cu's hybrid "
                                   "elementwise loads are not the mirror's "
                                   f"(body {c}, float4 {u})")


def hybrid_accel_plain(position: Tensor, ti: int = 256,
                       tj: int = 512) -> Tensor:
    """Twin of `_hybrid_kernel` (`allpairs_hybrid.py:42`): of every group
    of three tj-tiles, tiles 0-1 summed elementwise (v0's terms) and tile 2
    through v1b's HIGHEST expansion; a = m((e + F₀..₂) − p_i F₃). [4, N]."""
    n = _check(position, "hybrid_accel")
    _hybrid_rule(n, tj)
    p = position[:3]
    ri2 = _r2(p) + EPS2
    elem = torch.zeros((3, n), dtype=position.dtype, device=position.device)
    mat = torch.zeros((4, n), dtype=position.dtype, device=position.device)
    step = min(tj, _step(n))
    for t, j0 in enumerate(range(0, n, tj)):
        if t % HYBRID_GROUP < HYBRID_GROUP - 1:
            elem += _direct_sums(position, j0, j0 + tj)
            continue
        for a in range(j0, j0 + tj, step):
            mat += _v1b_tile(p, ri2, p[:, a:min(a + step, j0 + tj)],
                             "highest")
    return _out(_scalar(MASS, p) * ((elem + mat[:3]) - p * mat[3:4]),
                rows=False)


# -- the kernels --------------------------------------------------------------

# elementwise kernel modes (csrc/allpairs_variants.cu `ElemMode`)
_ELEM_MODE = {"full": 0, "norsqrt": 1, "noaccum": 2, "unroll": 3}
_FORCE_PATH = {"vpu": 0, "mm_split": 1, "mm_bf16": 2}


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("allpairs_variants")
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    for name, args in (
            ("apv_elem", [p, ll, p, i, f, f, p]),
            ("apv_plane", [p, ll, p, f, f, p]),
            ("apv_expand", [p, ll, p, i, i, f, f, p]),
            ("apv_hybrid", [p, ll, i, p, f, f, p]),
            ("apv_v3", [p, ll, p, i, p, i, p, i, f, f, p]),
            ("apv_tile", []), ("apv_expand_warps", [i]),
            ("apv_expand_smem", [i, i]), ("apv_expand_stage", [ll]),
            ("apv_expand_rec_word", [i, i, i, i]),
            ("apv_expand_tcol_word", [i, i, i, i]),
            ("apv_expand_rj2_word", [i, i, i, i]), ("apv_v3_warps", [i]),
            ("apv_v3_smem", [i]), ("apv_v3_stage", [i]),
            ("apv_v3_rec_word", [i, i, i]), ("apv_v3_tcol_word", [i, i, i]),
            ("apv_v3_tcol_slot", [i]), ("apv_v3_q_source", [i, i, i, i]),
            ("apv_hybrid_warps", [i]), ("apv_hybrid_smem", []),
            ("apv_hybrid_stage", [i]), ("apv_hybrid_source", [i, ll, i]),
            ("apv_hybrid_elem_word", [i, i])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ll if name == "apv_hybrid_source" else ctypes.c_int
    if lib.apv_tile() != TILE:
        raise RuntimeError("csrc/allpairs_variants.cu's tile is not TILE")
    _check_expand_layout(lib)
    _check_v3_layout(lib)
    _check_hybrid_layout(lib)
    return lib


def _launch(position: Tensor, what: str, out_shape, call) -> Tensor:
    """Check position, allocate out, run `call(lib, out, stream)` on the
    current stream and raise on a launch error."""
    if position.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, got {position.device}")
    dev = position.device
    _build.check_arg(position, torch.float32, (4, position.shape[1]), dev,
                     "position")
    out = torch.empty(out_shape, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = call(_library(), out, stream)
    _build.check(rc, what)
    return out


def attr_accel(position: Tensor, mode: str = "full", ti: int = 512,
               tj: int = 1024) -> Tensor:
    """`experiments/allpairs_v2.py:87`: v0 with `mode`'s op groups removed,
    unscaled, [N, 4]. Wrong by design except "full"; timed, and held
    against its twin."""
    n = _check(position, "attr_accel")
    _check_choice(mode, ATTR_MODES, "mode")
    if position.device.type == "cpu":
        return attr_accel_plain(position, mode, ti, tj)
    return _launch(position, "attr_accel", (n, 4), lambda lib, o, st:
                   lib.apv_elem(position.data_ptr(), n, o.data_ptr(),
                                _ELEM_MODE[mode], 1.0, EPS2, st))


def unroll_accel(position: Tensor, ti: int = 256, tj: int = 2048) -> Tensor:
    """`experiments/allpairs_unroll.py:85`: v0 in two accumulator chains
    over alternating j-tiles (the kernel's own 128-wide tiles). [4, N]."""
    n = _check(position, "unroll_accel")
    _unroll_rule(n, tj)
    if position.device.type == "cpu":
        return unroll_accel_plain(position, ti, tj)
    return _launch(position, "unroll_accel", (4, n), lambda lib, o, st:
                   lib.apv_elem(position.data_ptr(), n, o.data_ptr(),
                                _ELEM_MODE["unroll"], MASS, EPS2, st))


def v4_accel(position: Tensor, ti: int = 256, tj: int = 1024) -> Tensor:
    """`experiments/allpairs_planeacc.py:84`: per-(target, j-lane) sums,
    one lane reduction at the end. [N, 4]."""
    n = _check(position, "v4_accel")
    if position.device.type == "cpu":
        return v4_accel_plain(position, ti, tj)
    return _launch(position, "v4_accel", (n, 4), lambda lib, o, st:
                   lib.apv_plane(position.data_ptr(), n, o.data_ptr(), MASS,
                                 EPS2, st))


def _expand(position: Tensor, what: str, v1b: bool, precision: str) -> Tensor:
    n = position.shape[1]
    return _launch(position, what, (4, n), lambda lib, o, st:
                   lib.apv_expand(position.data_ptr(), n, o.data_ptr(),
                                  int(v1b), int(precision == "highest"),
                                  MASS, EPS2, st))


def v1b_accel(position: Tensor, ti: int = 512, tj: int = 512,
              precision: str = "highest") -> Tensor:
    """`experiments/allpairs_v2.py:166`: the K=4 expansion with r_j² inside
    the product; tensor-core `mma` at `precision`. [4, N]."""
    _check(position, "v1b_accel")
    _check_choice(precision, PRECISIONS, "precision")
    if position.device.type == "cpu":
        return v1b_accel_plain(position, ti, tj, precision)
    return _expand(position, "v1b_accel", True, precision)


def v1_accel(position: Tensor, ti: int = 256, tj: int = 512,
             precision: str = "default") -> Tensor:
    """`experiments/allpairs_variants.py:101`: the K=3 expansion with r_j²
    as a float32 add; tensor-core `mma` at `precision`. [4, N]."""
    _check(position, "v1_accel")
    _check_choice(precision, PRECISIONS, "precision")
    if position.device.type == "cpu":
        return v1_accel_plain(position, ti, tj, precision)
    return _expand(position, "v1_accel", False, precision)


def v3_accel(position: Tensor, ti: int = 512, tj: int = 512,
             force_path: str = "vpu") -> Tensor:
    """`experiments/allpairs_v3.py:144`: the centred bf16 hi/lo expansion
    (one K=16 BF16 `mma` a tile pair), force by `force_path`. The tile
    centroids are a torch pre-pass. [4, N]."""
    n = _check(position, "v3_accel")
    _check_choice(force_path, FORCE_PATHS, "force_path")
    _v3_rule(n, ti, tj)
    if position.device.type == "cpu":
        return v3_accel_plain(position, ti, tj, force_path)
    ci, cj = (c.contiguous() for c in v3_centroids(position, ti, tj))
    return _launch(position, "v3_accel", (4, n), lambda lib, o, st:
                   lib.apv_v3(position.data_ptr(), n, ci.data_ptr(), ti,
                              cj.data_ptr(), tj, o.data_ptr(),
                              _FORCE_PATH[force_path], MASS, EPS2, st))


def hybrid_accel(position: Tensor, ti: int = 256, tj: int = 512) -> Tensor:
    """`experiments/allpairs_hybrid.py:131`: per group of three tj-tiles,
    two elementwise (FP32 pipe) and one HIGHEST expansion (tensor cores).
    [4, N]."""
    n = _check(position, "hybrid_accel")
    _hybrid_rule(n, tj)
    if position.device.type == "cpu":
        return hybrid_accel_plain(position, ti, tj)
    if position.data_ptr() % 16:   # the kernel stages by 16-byte copies
        position = position.clone()
    return _launch(position, "hybrid_accel", (4, n), lambda lib, o, st:
                   lib.apv_hybrid(position.data_ptr(), n, tj, o.data_ptr(),
                                  MASS, EPS2, st))


VARIANTS = (attr_accel, v1b_accel, unroll_accel, v1_accel, v3_accel,
            hybrid_accel, v4_accel)
