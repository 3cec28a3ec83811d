"""Newton-3rd half-pair generations: CUDA kernels + plain torch twins.

The port of the JAX package's `experiments/allpairs_halfpair.py` (queue 2
#9g): one function per JAX launcher, under the JAX names, keyword names and
defaults. The harness that times them against the rectangle ("v0") is
`multi_adapter_particles_torch/tools/allpairs_halfpair.py`.

- `v5_accel` (`allpairs_halfpair.py:228`): tile triangle j >= i, i-side
  row sums, j-side column sums into a persistent accumulator; `mode`.
- `v5s_accel` (`:188`): v5 "full" with a static j-loop over all tiles and
  a predicated body.
- `v6_accel` (`:323`): one (i, j) tile pair per grid step, from an
  i-major pair table.
- `v7_accel` (`:532`): banded v5s, one call per band of kb j-tiles, the
  i-partials added across bands.

Each returns [4, N] (ax, ay, az, |a|) with `PARTICLE_MASS` applied once
after the sum, as the JAX functions do: a = (i-side + j-side) * m (v7:
both added band by band, then * m). Softening is `SOFTENING_SQUARED`;
nothing is scaled by the interaction scale.

The full forms (v5 "full", v5s, v6, v7) all compute the sum of
`ops/allpairs.py::all_pairs_accel_halfpair` (#4): each tile pair (i, j >=
i) once, the i-side taking row sums (the diagonal tile whole), the j-side
the negated column sums for j > i. Their `t` and `kb` only set the order of
that sum; the kernels still walk the JAX tile schedule, because that
schedule is what the A/B measures. v5's other modes are wrong by design
(attribution): "tri_only" takes the i-side only, "reduce_only" takes the
i-side and subtracts colsum(tx) + colsum(ty) + colsum(tz) of every pair
j >= i (diagonal included) into the x row of the first tile (`:100-104`).
There `t` is semantics: it sets the triangle and where the sums land.

Shape rules (the JAX launchers check none and return NaN or zero tails):
N a positive multiple of t, t a positive multiple of 128 (on CUDA at most
`MAX_KERNEL_T`), kb >= 1, mode one of `V5_MODES`; otherwise `ValueError`.

- CUDA tensors go to the kernels in `csrc/allpairs_halfpair.cu`, which says
  how the j-side stays deterministic without float atomics, or the wrappers
  raise.
- CPU tensors go to the `*_plain` twins, in the JAX op order, blocked over
  j-tiles to bound memory.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from multi_adapter_particles_torch import constants as C
from multi_adapter_particles_torch.ops import _build
from multi_adapter_particles_torch.ops.allpairs import _pair_terms

Tensor = torch.Tensor

V5_MODES = ("full", "reduce_only", "tri_only")
TILE = 128            # t must be a multiple (the kernels' warp of targets)
MAX_KERNEL_T = 1024   # the kernels' widest tile (shared memory)
V5_CHUNK = 128        # i-tiles a v5 / v5s launch (j-side scratch [C, 3, N])
V6_ENTRIES = 65_536   # pair-table entries a v6 launch (scratch [E, 6, t])
SMEM_LIMIT = 232_448  # shared memory a CTA may take on sm_90 (227 KB)
MAX_TEAMS = 8         # teams a tri_kernel CTA (named barriers 1 .. 8)

# elements of one [t, k*t] pair plane in the twins (bounds their memory)
_PLANE_ELEMS = 1 << 24

MASS = C.PARTICLE_MASS
EPS2 = C.SOFTENING_SQUARED


def _check(position: Tensor, t: int, what: str) -> int:
    if position.dim() != 2 or position.shape[0] != 4:
        raise ValueError(f"{what} takes position [4, N], got "
                         f"{list(position.shape)}")
    n = position.shape[1]
    if t <= 0 or t % TILE:
        raise ValueError(f"{what} takes t a positive multiple of {TILE}, "
                         f"got {t}")
    if n == 0 or n % t:
        raise ValueError(f"{what} takes N a positive multiple of t "
                         f"(N={n}, t={t})")
    return n


def _check_mode(mode: str) -> None:
    if mode not in V5_MODES:
        raise ValueError(f"mode must be one of {V5_MODES}, got {mode!r}")


def _check_kb(kb: int) -> None:
    if kb < 1:
        raise ValueError(f"kb must be >= 1, got {kb}")


# -- the kernels' launch geometry (host) --------------------------------------

def team_smem_bytes(t: int) -> int:
    """Shared memory of one team of the kernels at tile width t, which is
    what a v6 `pair_kernel` CTA asks for: its staged j-tile (each 32-source
    chunk twice, 16 B a source) and its t / 128 warps' column sums [3, t]
    float32."""
    return 2 * t * 16 + (t // TILE) * 3 * t * 4


def teams_for(t: int) -> int:
    """Teams a v5 / v5s / v7 CTA (`tri_kernel`) runs at tile width t: up
    to 512 threads of t / 4 a team and `MAX_TEAMS`, within `SMEM_LIMIT`."""
    fit = SMEM_LIMIT // team_smem_bytes(t)
    return max(1, min(2048 // t, MAX_TEAMS, fit))


def tri_smem_bytes(t: int, teams: int | None = None) -> int:
    """Shared memory a `tri_kernel` CTA of `teams` teams (default
    `teams_for(t)`) asks for; its end-of-CTA i-side sums [teams, 3, t]
    reuse it."""
    return (teams_for(t) if teams is None else teams) * team_smem_bytes(t)


def v7_bands(n: int, t: int, kb: int) -> list[tuple[int, int, int]]:
    """v7's launches over nt = n // t tiles: (j0, kbb, off) a band of kbb
    j-tiles from j0 with its off-diagonal tile pairs (i < j; tile j meets
    i-tiles 0 .. j) beside its kbb diagonal ones; i-tiles 0 .. j0 + kbb - 1
    meet it."""
    nt = n // t
    return [(j0, min(kb, nt - j0), sum(range(j0, min(j0 + kb, nt))))
            for j0 in range(0, nt, kb)]


def v7_fold_bytes(n: int, t: int, kb: int) -> int:
    """Bytes v7's band folds must move: each j-side slot (3 floats a
    column of every tile pair i < j) read once, and the j-side sum and
    compensation planes of the band's 3 kbb t columns read and written
    once a band."""
    slots = sum(off for _, _, off in v7_bands(n, t, kb)) * 12 * t
    planes = sum(kbb for _, kbb, _ in v7_bands(n, t, kb)) * t * 3 * 4 * 4
    return slots + planes


# -- the twins ----------------------------------------------------------------

def _tri_sums(position: Tensor, t: int, mode: str = "full", j0: int = 0,
              j1=None):
    """(i-side, j-side) [3, N] unscaled sums of the JAX triangle over the
    j-tiles [j0, j1) (default: all): i-tile i < j1 against tiles
    max(i, j0) .. j1-1, row sums into tile i; `mode` "full": negated column
    sums into tile j > i; "reduce_only": colsum(tx) + colsum(ty) + colsum(tz)
    of every tile pair subtracted, pair by pair, from the x row of tile 0;
    "tri_only": no j-side."""
    n = position.shape[1]
    nt = n // t
    j1 = nt if j1 is None else j1
    iacc = torch.zeros((3, n), dtype=position.dtype, device=position.device)
    jacc = torch.zeros_like(iacc)
    step = max(1, _PLANE_ELEMS // (t * t))       # j-tiles at once
    for i in range(min(nt, j1)):
        i0 = i * t
        xi, yi, zi = (position[k, i0:i0 + t][:, None] for k in range(3))
        for b0 in range(max(i, j0), j1, step):
            b1 = min(b0 + step, j1)
            tx, ty, tz = _pair_terms(xi, yi, zi, position[:3, b0 * t:b1 * t],
                                     EPS2)
            iacc[:, i0:i0 + t] += torch.stack([tx.sum(1), ty.sum(1),
                                               tz.sum(1)])
            if mode == "full":
                skip = (max(b0, i + 1) - b0) * t    # the diagonal tile
                if skip < tx.shape[1]:
                    jacc[:, b0 * t + skip:b1 * t] -= torch.stack([
                        tx[:, skip:].sum(0), ty[:, skip:].sum(0),
                        tz[:, skip:].sum(0)])
            elif mode == "reduce_only":
                for q in range(0, b1 - b0):
                    sl = slice(q * t, (q + 1) * t)
                    jacc[0, :t] -= (tx[:, sl].sum(0) + ty[:, sl].sum(0)
                                    + tz[:, sl].sum(0))
    return iacc, jacc


def _finish(a3: Tensor) -> Tensor:
    """[3, N] sums -> [4, N] (a * m, |a|)."""
    a3 = a3 * torch.tensor(MASS, dtype=a3.dtype)
    amag = torch.sqrt(a3[0] * a3[0] + a3[1] * a3[1] + a3[2] * a3[2])
    return torch.cat([a3, amag[None]], dim=0)


def v5_accel_plain(position: Tensor, t: int = 512,
                   mode: str = "full") -> Tensor:
    """Twin of `_v5_kernel` (`allpairs_halfpair.py:45`): a = (i-side +
    j-side) * m over the tile triangle, by `mode`. [4, N]."""
    _check(position, t, "v5_accel")
    _check_mode(mode)
    iacc, jacc = _tri_sums(position, t, mode)
    return _finish(iacc + jacc)


def v5s_accel_plain(position: Tensor, t: int = 512) -> Tensor:
    """Twin of `_v5s_kernel` (`allpairs_halfpair.py:120`): v5 "full" (the
    static loop only skips j < i). [4, N]."""
    _check(position, t, "v5s_accel")
    iacc, jacc = _tri_sums(position, t)
    return _finish(iacc + jacc)


def v6_accel_plain(position: Tensor, t: int = 512) -> Tensor:
    """Twin of `_v6_kernel` (`allpairs_halfpair.py:268`): the same tile
    pairs in the pair table's i-major order. [4, N]."""
    _check(position, t, "v6_accel")
    iacc, jacc = _tri_sums(position, t)
    return _finish(iacc + jacc)


def v7_accel_plain(position: Tensor, t: int = 512, kb: int = 128) -> Tensor:
    """Twin of `v7_accel` (`allpairs_halfpair.py:532`, `_v7_kernel` :459):
    per band of kb j-tiles, the triangle's i-partials over i-tiles 0 ..
    band end and the band's j-side, added band by band. [4, N]."""
    n = _check(position, t, "v7_accel")
    _check_kb(kb)
    nt = n // t
    acc = torch.zeros((3, n), dtype=position.dtype, device=position.device)
    for j0 in range(0, nt, kb):
        j1 = min(j0 + kb, nt)
        iacc, jacc = _tri_sums(position, t, "full", j0, j1)
        acc[:, :j1 * t] += iacc[:, :j1 * t]
        acc[:, j0 * t:j1 * t] += jacc[:, j0 * t:j1 * t]
    return _finish(acc)


# -- the kernels --------------------------------------------------------------

_MODE = {"full": 0, "reduce_only": 1, "tri_only": 2}


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("allpairs_halfpair")
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    for name, args in (
            ("aph_v5", [p, ll, i, i, i, i, p, p, p, f, f, p]),
            ("aph_v6", [p, ll, i, p, p, ll, ll, p, p, p, p, f, f, p]),
            ("aph_v7", [p, ll, i, i, p, p, p, f, f, p])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    for name, args in (("aph_tile", []), ("aph_max_tile", []),
                       ("aph_teams", [i]), ("aph_smem", [i, i])):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = ctypes.c_int
    if lib.aph_tile() != TILE or lib.aph_max_tile() != MAX_KERNEL_T:
        raise RuntimeError("csrc/allpairs_halfpair.cu's tiles are not "
                           "TILE / MAX_KERNEL_T")
    for t in range(TILE, MAX_KERNEL_T + 1, TILE):
        if (lib.aph_teams(t), lib.aph_smem(0, t), lib.aph_smem(1, t)) != (
                teams_for(t), tri_smem_bytes(t), team_smem_bytes(t)):
            raise RuntimeError("csrc/allpairs_halfpair.cu's teams or shared "
                               f"memory at t={t} are not teams_for / "
                               "tri_smem_bytes / team_smem_bytes")
    return lib


def _require_kernel(position: Tensor, t: int, what: str) -> None:
    """Raise unless the kernels take position (on cuda, float32 [4, N],
    contiguous) and t."""
    if position.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, got {position.device}")
    if t > MAX_KERNEL_T:
        raise ValueError(f"{what}: the kernels take t <= {MAX_KERNEL_T}, "
                         f"got {t}")
    _build.check_arg(position, torch.float32, (4, position.shape[1]),
                     position.device, "position")


def _launch(position: Tensor, what: str, call) -> Tensor:
    """Allocate out [4, N] and the accumulator planes [4, 3, N], run
    `call(lib, out, planes, stream)` on the current stream and raise on a
    launch error."""
    dev = position.device
    n = position.shape[1]
    out = torch.empty((4, n), dtype=torch.float32, device=dev)
    planes = torch.empty((4, 3, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = call(_library(), out, planes, stream)
    _build.check(rc, what)
    return out


def _v5_launch(position: Tensor, t: int, mode: str, static: bool,
               what: str) -> Tensor:
    _require_kernel(position, t, what)
    n = position.shape[1]
    chunk = min(V5_CHUNK, n // t)
    # the j-side slots: a [3, N] row per i-tile of a chunk (full), one
    # [t] row (reduce_only), none (tri_only)
    width = {"full": 3 * n, "reduce_only": t, "tri_only": 0}[mode]
    slot = torch.empty((chunk, width), dtype=torch.float32,
                       device=position.device)
    return _launch(position, what, lambda lib, o, pl, st: lib.aph_v5(
        position.data_ptr(), n, t, _MODE[mode], int(static), chunk,
        pl.data_ptr(), slot.data_ptr(), o.data_ptr(), MASS, EPS2, st))


def v5_accel(position: Tensor, t: int = 512, mode: str = "full") -> Tensor:
    """`experiments/allpairs_halfpair.py:228`: one CTA per i-tile walking
    j = i .. nt-1, launched in chunks of `V5_CHUNK` i-tiles. [4, N]."""
    _check(position, t, "v5_accel")
    _check_mode(mode)
    if position.device.type == "cpu":
        return v5_accel_plain(position, t, mode)
    return _v5_launch(position, t, mode, False, "v5_accel")


def v5s_accel(position: Tensor, t: int = 512) -> Tensor:
    """`experiments/allpairs_halfpair.py:188`: v5's CTA with a static loop
    over all j-tiles, skipping j < i. [4, N]."""
    _check(position, t, "v5s_accel")
    if position.device.type == "cpu":
        return v5s_accel_plain(position, t)
    return _v5_launch(position, t, "full", True, "v5s_accel")


@functools.lru_cache(maxsize=8)
def pair_table(n: int, t: int, device) -> Tensor:
    """v6's pair table [2, K] int32 on `device`: the JAX (i, j >= i) tile
    pairs in i-major order (`allpairs_halfpair.py:327`)."""
    nt = n // t
    return torch.triu_indices(nt, nt, device=device).to(
        torch.int32).contiguous()


def v6_accel(position: Tensor, t: int = 512) -> Tensor:
    """`experiments/allpairs_halfpair.py:323`: one tile pair per CTA from
    the pair table, in launches of `V6_ENTRIES` entries. [4, N]."""
    n = _check(position, t, "v6_accel")
    if position.device.type == "cpu":
        return v6_accel_plain(position, t)
    _require_kernel(position, t, "v6_accel")
    table = pair_table(n, t, position.device)
    k = table.shape[1]
    e = min(V6_ENTRIES, k)
    slot = torch.empty((2, e, 3, t), dtype=torch.float32,
                       device=position.device)
    return _launch(position, "v6_accel", lambda lib, o, pl, st: lib.aph_v6(
        position.data_ptr(), n, t, table[0].data_ptr(), table[1].data_ptr(),
        k, e, pl.data_ptr(), slot[0].data_ptr(), slot[1].data_ptr(),
        o.data_ptr(), MASS, EPS2, st))


def v7_accel(position: Tensor, t: int = 512, kb: int = 128) -> Tensor:
    """`experiments/allpairs_halfpair.py:532`: one launch per band of kb
    j-tiles over i-tiles 0 .. band end, the static predicated loop. [4, N]."""
    n = _check(position, t, "v7_accel")
    _check_kb(kb)
    if position.device.type == "cpu":
        return v7_accel_plain(position, t, kb)
    _require_kernel(position, t, "v7_accel")
    nt = n // t
    kbb = min(kb, nt)
    slot = torch.empty((nt, 3, kbb * t), dtype=torch.float32,
                       device=position.device)
    return _launch(position, "v7_accel", lambda lib, o, pl, st: lib.aph_v7(
        position.data_ptr(), n, t, kbb, pl.data_ptr(), slot.data_ptr(),
        o.data_ptr(), MASS, EPS2, st))


GENERATIONS = (v5_accel, v5s_accel, v6_accel, v7_accel)
