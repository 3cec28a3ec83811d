"""All-pairs softened gravity: CUDA kernels + plain torch twins.

The O(N^2) `bodyBodyInteraction` sum (`nBodyGravityCS.hlsl:44-57`) in the
JAX package's two schedules (`multi_adapter_particles_tpu/ops/allpairs.py`):

- `all_pairs_accel`: the directed rectangle, every target i against every
  source j (`_allpairs_kernel`); `sources=` gives the split form of the
  multi-device ring.
- `all_pairs_accel_halfpair`: the Newton-3rd schedule (`_halfpair_kernel`):
  each pair of 512-wide tiles once, the i-side taking row sums and the
  j-side negated column sums, diagonal tiles the i-side only. It falls back
  to the rectangle when N does not tile (`n % 512 or n // 512 < 2`), as the
  JAX function does.

Both return [4, Ni] (ax, ay, az, |a|) with mass * interaction_scale applied
once after the sum. Both kernels are in `csrc/allpairs.cu`, which says how
the half-pair's j-side stays deterministic without atomics. The half-pair
kernel walks super-tiles of `HALF_G` tiles: its work items are the pairs
(A, B >= A) of `half_items`, launched `half_chunk` items at a time, each
launch followed by a fold of their slots in table order.

- CUDA tensors go to the kernels, or the wrappers raise.
- CPU tensors go to the `*_plain` twins: the kernels' arithmetic as torch
  ops, blocked over sources to bound memory. Like the kernels (and the
  Pallas ones) they take no padding mask: padding parked at 1e9 adds
  ~1e-18 to a real particle's sum and pad-pad pairs add exactly 0. The
  masked XLA form is `models/integrator.py::all_pairs_accel`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional

import torch

from multi_adapter_particles_torch.ops import _build

Tensor = torch.Tensor

# Tile width of the half-pair schedule: which tile pairs exist, and the
# fallback rule, are the JAX function's semantics (`_HALF_T`).
HALF_T = 512
# The half-pair kernel's work item is a pair of super-tiles of HALF_G tiles
# (the last one short when the tile count is not a multiple of HALF_G).
HALF_G = 4
HALF_SUPER = HALF_T * HALF_G
# Bytes of one item's slots: i-side and j-side sums, [2, 3, HALF_SUPER].
HALF_ITEM_BYTES = 2 * 3 * HALF_SUPER * 4
# Most bytes of item slots a call allocates; items beyond it run in
# further launches, each followed by its fold.
HALF_SCRATCH_BYTES = 1 << 30

# elements of one [Ni, tj] pair plane in the twins (bounds their memory)
_PLANE_ELEMS = 1 << 24
# source tile of the rectangle's twin
_PLAIN_TJ = 2048


def _pair_terms(xi, yi, zi, src, eps2):
    """The [Ni, tj] planes dx*s, dy*s, dz*s of targets (xi, yi, zi) [Ni, 1]
    against sources src [3+, tj], in the kernels' op order."""
    dx = src[0][None, :] - xi
    dy = src[1][None, :] - yi
    dz = src[2][None, :] - zi
    d2 = dx * dx + dy * dy + dz * dz + eps2
    inv = torch.rsqrt(d2)
    s = inv * inv * inv
    return dx * s, dy * s, dz * s


def _finish(acc: Tensor, mass_scale: float) -> Tensor:
    """[3, N] unscaled sums -> [4, N] (a * mass_scale, |a|)."""
    a3 = acc * torch.tensor(mass_scale, dtype=acc.dtype)
    amag = torch.sqrt(a3[0] * a3[0] + a3[1] * a3[1] + a3[2] * a3[2])
    return torch.cat([a3, amag[None]], dim=0)


def all_pairs_accel_plain(
    position: Tensor,
    *,
    mass: float,
    softening_squared: float,
    interaction_scale: float = 1.0,
    sources: Optional[Tensor] = None,
) -> Tensor:
    """Plain twin of the rectangle kernel: position [4, Ni] (sources
    [4, Nj], default position) -> [4, Ni], in position's dtype."""
    src = position if sources is None else sources
    ni, nj = position.shape[1], src.shape[1]
    acc = torch.zeros((3, ni), dtype=position.dtype, device=position.device)
    # fixed source tiles: a target's sum does not depend on how many
    # targets share the call (the mesh's bit-stable step runs 1/D of them)
    ti = _PLANE_ELEMS // _PLAIN_TJ
    for i0 in range(0, ni, ti):
        xi, yi, zi = (position[k, i0:i0 + ti][:, None] for k in range(3))
        for j0 in range(0, nj, _PLAIN_TJ):
            tx, ty, tz = _pair_terms(xi, yi, zi, src[:3, j0:j0 + _PLAIN_TJ],
                                     softening_squared)
            acc[:, i0:i0 + ti] += torch.stack([tx.sum(1), ty.sum(1),
                                               tz.sum(1)])
    return _finish(acc, float(mass) * float(interaction_scale))


def _half_tiles(n: int) -> bool:
    """True when n tiles into the half-pair schedule (else the rectangle)."""
    return n % HALF_T == 0 and n // HALF_T >= 2


def all_pairs_accel_halfpair_plain(
    position: Tensor,
    *,
    mass: float,
    softening_squared: float,
    interaction_scale: float = 1.0,
) -> Tensor:
    """Plain twin of the half-pair kernel: the same tile pairs (b >= a,
    i-side row sums into tile a, negated column sums into tile b > a) as
    row bands of [T, tj] planes. position [4, N] -> [4, N]."""
    n = position.shape[1]
    if not _half_tiles(n):
        return all_pairs_accel_plain(
            position, mass=mass, softening_squared=softening_squared,
            interaction_scale=interaction_scale)
    t = HALF_T
    acc = torch.zeros((3, n), dtype=position.dtype, device=position.device)
    tj = max(t, _PLANE_ELEMS // t // t * t)
    for a in range(n // t):
        i0 = a * t
        xi, yi, zi = (position[k, i0:i0 + t][:, None] for k in range(3))
        for j0 in range(i0, n, tj):
            tx, ty, tz = _pair_terms(xi, yi, zi, position[:3, j0:j0 + tj],
                                     softening_squared)
            acc[:, i0:i0 + t] += torch.stack([tx.sum(1), ty.sum(1),
                                              tz.sum(1)])
            # j-side: columns past the diagonal tile
            skip = max(0, i0 + t - j0)
            if skip < tx.shape[1]:
                acc[:, j0 + skip:j0 + tx.shape[1]] -= torch.stack([
                    tx[:, skip:].sum(0), ty[:, skip:].sum(0),
                    tz[:, skip:].sum(0)])
    return _finish(acc, float(mass) * float(interaction_scale))


@functools.lru_cache(maxsize=8)
def half_items(n: int, device) -> Tensor:
    """The half-pair kernel's item table [2, K] int32 on `device`: the
    super-tile pairs (A, B >= A) of n particles in i-major order, K = ns
    (ns + 1) / 2 with ns = ceil(n / 512 / HALF_G). Built once per (n,
    device), on the first (eager) call, so a captured frame does no host
    work."""
    ns = -(-(n // HALF_T) // HALF_G)
    return torch.triu_indices(ns, ns, device=device).to(
        torch.int32).contiguous()


def half_chunk(items: int, wave: int) -> int:
    """Items a launch of the half-pair kernel takes: whole waves of `wave`
    CTAs, as many as HALF_SCRATCH_BYTES of slots hold (at least one wave),
    and no more than there are."""
    waves = max(1, HALF_SCRATCH_BYTES // HALF_ITEM_BYTES // wave)
    return min(items, waves * wave)


@functools.cache
def _half_wave(index: int) -> int:
    """CTAs of the half-pair item kernel that device `index` runs at
    once."""
    wave = ctypes.c_int(0)
    with torch.cuda.device(index):
        _build.check(_library().allpairs_half_wave(ctypes.byref(wave)),
                     "allpairs_half_wave")
    if wave.value < 1:
        raise RuntimeError("the half-pair item kernel does not fit an SM")
    return wave.value


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("allpairs")
    lib.allpairs_rect.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p,
    ]
    lib.allpairs_rect.restype = ctypes.c_int
    lib.allpairs_half.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p,
    ]
    lib.allpairs_half.restype = ctypes.c_int
    lib.allpairs_half_wave.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.allpairs_half_wave.restype = ctypes.c_int
    for fn in (lib.allpairs_half_tile, lib.allpairs_half_super):
        fn.argtypes = []
        fn.restype = ctypes.c_int
    if (lib.allpairs_half_tile(), lib.allpairs_half_super()) != (
            HALF_T, HALF_SUPER):
        raise RuntimeError("csrc/allpairs.cu's tile widths are not HALF_T "
                           "and HALF_SUPER")
    return lib


def _require_cuda(position: Tensor, what: str) -> None:
    if position.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, got {position.device}")


def all_pairs_accel(
    position: Tensor,
    *,
    mass: float,
    softening_squared: float,
    interaction_scale: float = 1.0,
    sources: Optional[Tensor] = None,
) -> Tensor:
    """Directed all-pairs acceleration: position [4, Ni] (sources [4, Nj],
    default position) -> [4, Ni] (ax, ay, az, |a|). A CPU tensor runs the
    plain twin; a CUDA tensor launches the rectangle kernel."""
    kw = dict(mass=mass, softening_squared=softening_squared,
              interaction_scale=interaction_scale)
    if position.device.type == "cpu":
        return all_pairs_accel_plain(position, sources=sources, **kw)
    _require_cuda(position, "all_pairs_accel")
    src = position if sources is None else sources
    ni, nj = position.shape[-1], src.shape[-1]
    dev = position.device
    _build.check_arg(position, torch.float32, (4, ni), dev, "position")
    _build.check_arg(src, torch.float32, (4, nj), dev, "sources")
    out = torch.empty((4, ni), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _library().allpairs_rect(
            position.data_ptr(), ni, src.data_ptr(), nj, out.data_ptr(),
            float(mass) * float(interaction_scale), float(softening_squared),
            stream,
        )
    _build.check(rc, "allpairs_rect")
    return out


def all_pairs_accel_halfpair(
    position: Tensor,
    *,
    mass: float,
    softening_squared: float,
    interaction_scale: float = 1.0,
) -> Tensor:
    """Half-pair (Newton-3rd) acceleration: position [4, N] -> [4, N].
    Falls back to `all_pairs_accel` when N does not tile into 512-wide
    tiles (at least two). A CPU tensor runs the plain twin; a CUDA tensor
    launches the half-pair kernels (2 ceil(K / half_chunk) of them for the
    K items of `half_items`)."""
    kw = dict(mass=mass, softening_squared=softening_squared,
              interaction_scale=interaction_scale)
    n = position.shape[-1]
    if not _half_tiles(n):
        return all_pairs_accel(position, **kw)
    if position.device.type == "cpu":
        return all_pairs_accel_halfpair_plain(position, **kw)
    _require_cuda(position, "all_pairs_accel_halfpair")
    dev = position.device
    _build.check_arg(position, torch.float32, (4, n), dev, "position")
    table = half_items(n, dev)
    items = table.shape[1]
    chunk = half_chunk(items, _half_wave(dev.index))
    out = torch.empty((4, n), dtype=torch.float32, device=dev)
    # scratch: the item slots of a launch, the fold's Kahan compensation
    slot = torch.empty((chunk, 2, 3, HALF_SUPER), dtype=torch.float32,
                       device=dev)
    comp = torch.empty((3, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _library().allpairs_half(
            position.data_ptr(), n, table[0].data_ptr(), table[1].data_ptr(),
            items, chunk, slot.data_ptr(), out.data_ptr(), comp.data_ptr(),
            float(mass) * float(interaction_scale), float(softening_squared),
            stream,
        )
    _build.check(rc, "allpairs_half")
    return out


def make_accel_fn(
    mass: float,
    softening_squared: float,
    interaction_scale: float = 1.0,
    half: bool = False,
) -> Callable[[Tensor], Tensor]:
    """The integrator's accel function (position [4, Np] -> accel [3, Np])
    through the rectangle or, with `half`, the half-pair schedule."""
    fn = all_pairs_accel_halfpair if half else all_pairs_accel

    def accel_fn(position: Tensor) -> Tensor:
        return fn(position, mass=mass, softening_squared=softening_squared,
                  interaction_scale=interaction_scale)[:3]

    return accel_fn
