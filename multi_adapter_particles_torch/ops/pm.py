"""Particle-mesh (PM) self-gravity: FFT convolution, isolated boundaries.

The port of the JAX package's `ops/pm.py` (no Pallas kernel there, none
here): deposit unit masses on a [G, G, G] grid ([z, y, x]) by
cloud-in-cell, convolve with the softened pair potential through
zero-padded FFTs (free space, not periodic), take central differences,
and interpolate the three acceleration grids back to the particles.

- **Deposit** (`deposit_cic`): one stable sort of the base cell ids
  carrying the three CIC fractions, and the per-cell segment bounds of the
  sorted ids (`searchsorted`). On CUDA two kernels (`csrc/cic_deposit.cu`)
  sum each cell's run of sorted particles in a fixed order, tiles of
  2,048 particles whatever the crowding, and add the 8 corner histograms
  into the grid in the twin's corner order. On the CPU the plain twin
  (`deposit_sorted_plain`, the JAX package's arithmetic) takes one cumsum
  over the 8 corner weights, differences it at the bounds into 8
  histograms and adds them to the grid as 8 shifted slices. Neither uses
  `index_add_`/`scatter_add_`: their float atomics on CUDA would break
  the port's promise that a step is the same from run to run.
- **Solve**: axis-pruned rfft/fft on the doubled grid (both ends of every
  axis pruned) times a cached kernel spectrum, in complex64.
- **Interpolate**: the 8 corner values of each acceleration grid (or of
  the diagnostics' potential grid, `_interp_scalar`) are read by plain
  indexing and summed in (dz, dy, dx) order. The JAX package's lane-packed
  corner rows (`_pack_corner_rows`, `_pack_scalar_corner_rows`, TPU tiling
  workarounds) have no counterpart.
- **Spans and count** (`pm_accel_counted`, `make_accel_fn`): the
  three phases run inside the spans `pm.deposit`, `pm.solve` and
  `pm.interp` (`runtime/trace.py`; under a CUDA graph's replay they
  launch nothing, the replay is one launch inside `step`), and the
  integrator's force function keeps, on the device, the count of
  particles outside the mesh's 1-cell margin, whose mesh force is 0
  (`accel_fn.outside`, the `pm_outside` gauge), from the deposit's own
  count of those inside (its last segment bound).

Cell geometry follows what the JAX package's compiled code computes: XLA
turns `x / h + c` into one fused multiply-add with the float32 reciprocal
of h, so `_cic_cells` evaluates that in float64 (exact product, one
rounding to float32) and lands every particle in the same base cell.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from multi_adapter_particles_torch.ops import _build
from multi_adapter_particles_torch.runtime import trace

Tensor = torch.Tensor


def _f32(x) -> float:
    """x rounded to float32, as a Python float."""
    return float(np.float32(x))


def _fma_scale_shift(x: Tensor, scale: float, shift: float) -> Tensor:
    """float32 round(x * scale + shift) with one rounding, as XLA's fused
    multiply-add computes it (scale and shift are float32 values)."""
    return (x.double() * scale + shift).float()


def scaled_cells(pos3: Tensor, h: float, shift: float) -> Tensor:
    """[3, N] float32 u = pos / h + shift as the JAX package's compiled
    code evaluates it (fma with the float32 reciprocal of h)."""
    recip = _f32(np.float32(1.0) / np.float32(h))
    return _fma_scale_shift(pos3, recip, _f32(shift))


def _cic_cells(position: Tensor, grid: int, box: float):
    """Common CIC geometry: (base cell [3, N] int64, fractions [3, N],
    in-box mask [N])."""
    g = grid
    # grid node i sits at x = (i + 0.5 - g/2) * h; CIC base = floor
    u = scaled_cells(position[:3], box / g, g / 2 - 0.5)
    # clamping first keeps the float -> int conversion defined for parked
    # particles; it changes no in-box cell and no clipped index below
    i0f = torch.floor(torch.clamp(u, -1.0, float(g)))
    frac = u - torch.floor(u)
    i0 = i0f.long()
    # keep a 1-cell margin so CIC corners and the FD stencil stay in-bounds
    inside = torch.all((i0 >= 1) & (i0 <= g - 3), dim=0)
    return i0, frac, inside


_CORNERS = tuple((dz, dy, dx) for dz in (0, 1) for dy in (0, 1)
                 for dx in (0, 1))


def _corner_weights(frac: Tensor):
    """8 trilinear weights [N] in (dz, dy, dx) binary order."""
    ws = []
    for dz, dy, dx in _CORNERS:
        ws.append((frac[0] if dx else 1.0 - frac[0])
                  * (frac[1] if dy else 1.0 - frac[1])
                  * (frac[2] if dz else 1.0 - frac[2]))
    return ws


def _segment_bounds(sbase: Tensor, ncell: int) -> Tensor:
    """bounds[c] = #{i : sbase[i] < c} for c in 0..ncell (int64) over
    ascending keys: the `searchsorted(side='left')` that the JAX package's
    merge-by-sort reproduces bit for bit."""
    queries = torch.arange(ncell + 1, dtype=sbase.dtype, device=sbase.device)
    return torch.searchsorted(sbase, queries, side="left")


def _sort_by_cell(position: Tensor, grid: int, box: float):
    """(sorted base cell ids, out-of-box parked at G³; sorted fractions)."""
    g = grid
    i0, frac, inside = _cic_cells(position, grid, box)
    ncell = g * g * g
    base = i0[2] * g * g + i0[1] * g + i0[0]
    base = torch.where(inside, base, torch.full_like(base, ncell))
    sbase, order = torch.sort(base, stable=True)
    return sbase, frac[:, order]


def deposit_sorted_plain(sbase: Tensor, sfrac: Tensor, bounds: Tensor,
                         grid: int) -> Tensor:
    """Sorted cell ids [N], fractions [3, N] and segment bounds [G³+1] ->
    CIC count grid [G, G, G] in sfrac's dtype: a cumsum of the 8 corner
    weights differenced at the bounds, added as 8 shifted slices."""
    g = grid
    ncell = g * g * g
    live = sbase < ncell
    # corners on dim 0, particles on the contiguous dim 1: CUDA's cumsum
    # scans a contiguous dim in parallel, but walks a strided one with one
    # thread per column (8 threads over N, ~270 ms at 1M on an H100)
    sw8 = torch.stack([torch.where(live, w, 0.0)
                       for w in _corner_weights(sfrac)])          # [8, N]
    csum = torch.cat([sw8.new_zeros((8, 1)), torch.cumsum(sw8, dim=1)],
                     dim=1)
    at_bounds = csum[:, bounds]                                  # [8, G³+1]
    hist8 = at_bounds[:, 1:] - at_bounds[:, :-1]
    rho = torch.zeros((g, g, g), dtype=sfrac.dtype, device=sbase.device)
    for c, (dz, dy, dx) in enumerate(_CORNERS):
        hist = hist8[c].reshape(g, g, g)
        # corner cell = base + (dx, dy, dz): the histogram shifted
        rho[dz:, dy:, dx:] += hist[:g - dz, :g - dy, :g - dx]
    return rho


# Rounding after every multiply, like the twin's separate ops: each corner
# weight is bitwise the twin's.
_NVCC_FLAGS = ("-fmad=false",)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("cic_deposit", _NVCC_FLAGS)
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.cic_deposit.argtypes = [p, p, ll, ctypes.c_int] + [p] * 6
    lib.cic_deposit.restype = ctypes.c_int
    lib.cic_tile.restype = ctypes.c_int
    return lib


def deposit_sorted_cuda(sbase: Tensor, sfrac: Tensor, bounds: Tensor,
                        grid: int) -> Tensor:
    """`deposit_sorted_plain` by the two kernels of `csrc/cic_deposit.cu`:
    float32 only, each cell's run summed in a fixed order (not the twin's
    cumsum, so not bitwise the twin), the same from run to run."""
    g = grid
    ncell = g * g * g
    if not 0 < ncell < 2**31:
        raise ValueError(f"deposit_sorted_cuda takes 0 < G³ < 2^31, got G={g}")
    dev = sbase.device
    if dev.type != "cuda":
        raise ValueError(f"deposit_sorted_cuda runs on cuda, got {dev}")
    n = sbase.shape[0]
    _build.check_arg(sbase, torch.int64, (n,), dev, "sbase")
    _build.check_arg(sfrac, torch.float32, (3, n), dev, "sfrac")
    _build.check_arg(bounds, torch.int64, (ncell + 1,), dev, "bounds")
    lib = _library()
    tiles = -(-n // lib.cic_tile())
    f32 = torch.float32
    hist = torch.empty((8, ncell), dtype=f32, device=dev)
    head = torch.empty((8, tiles), dtype=f32, device=dev)
    tail = torch.empty((8, tiles), dtype=f32, device=dev)
    rho = torch.empty((g, g, g), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.cic_deposit(sbase.data_ptr(), sfrac.data_ptr(), n, g,
                             bounds.data_ptr(), hist.data_ptr(),
                             head.data_ptr(), tail.data_ptr(),
                             rho.data_ptr(), stream)
    _build.check(rc, "cic_deposit")
    return rho


def _deposit_sorted(sbase: Tensor, sfrac: Tensor, grid: int):
    """Sorted cell ids + fractions -> (CIC count grid [G, G, G], the
    number of ids inside the mesh: the last segment bound, a 0-d int64).
    CUDA tensors go to the kernels, CPU tensors to the plain twin."""
    ncell = grid * grid * grid
    bounds = _segment_bounds(sbase, ncell)
    if sbase.device.type == "cpu":
        rho = deposit_sorted_plain(sbase, sfrac, bounds, grid)
    else:
        rho = deposit_sorted_cuda(sbase, sfrac, bounds, grid)
    # a copy: a view would keep all G³+1 bounds alive through the solve
    return rho, bounds[ncell].clone()


def deposit_cic(position: Tensor, grid: int, box: float) -> Tensor:
    """[4, N] positions -> CIC count grid [G, G, G] ([z, y, x], unit mass).
    Out-of-box particles (and the 1e9 padding) deposit nothing."""
    return _deposit_sorted(*_sort_by_cell(position, grid, box), grid)[0]


def doubled_offsets(grid: int, box: float, device) -> Tensor:
    """[2G] float32 min-image offsets (-G..G-1) * h of the doubled grid."""
    g2 = 2 * grid
    m = torch.arange(g2, device=device)
    return (((m + grid) % g2) - grid).to(torch.float32) * _f32(box / grid)


@functools.lru_cache(maxsize=8)
def _potential_kernel_rfft(grid: int, box: float, eps2: float,
                           device: torch.device) -> Tensor:
    """rfft of phi(r) = -(|r|²+eps²)^{-1/2} on the doubled grid, cached per
    (G, box, eps², device)."""
    off = doubled_offsets(grid, box, device)
    rz, ry, rx = off[:, None, None], off[None, :, None], off[None, None, :]
    d2 = rx * rx + ry * ry + rz * rz + _f32(eps2)
    return torch.fft.rfftn(-torch.rsqrt(d2))


def _rfft_pruned(rho: Tensor, g: int) -> Tensor:
    """Forward half of the axis-pruned free-space transform:
    [G, G, G] real -> [2G, 2G, G+1] complex64 spectrum."""
    g2 = 2 * g
    f = torch.fft.rfft(rho, n=g2, dim=2)           # [G, G, G+1]
    f = torch.fft.fft(f, n=g2, dim=1)              # [G, 2G, G+1]
    return torch.fft.fft(f, n=g2, dim=0)           # [2G, 2G, G+1]


def _irfft_pruned(f: Tensor, g: int) -> Tensor:
    """Inverse half: [2G, 2G, G+1] spectrum -> [G, G, G] real, slicing the
    padded half of each axis away as soon as it is inverse-done."""
    g2 = 2 * g
    f = torch.fft.ifft(f, dim=0)[:g]               # [G, 2G, G+1]
    f = torch.fft.ifft(f, dim=1)[:, :g]            # [G, G, G+1]
    return torch.fft.irfft(f, n=g2, dim=2)[:, :, :g].contiguous()


def _grad(phi: Tensor, grid: int, box: float) -> Tuple[Tensor, Tensor, Tensor]:
    """Scaled potential [G, G, G] -> accel = -grad phi by 2nd-order central
    differences, three [G, G, G] grids (zero on the boundary planes)."""
    inv2h = _f32(1.0 / (2.0 * (box / grid)))
    ax = torch.zeros_like(phi)
    ay = torch.zeros_like(phi)
    az = torch.zeros_like(phi)
    ax[:, :, 1:-1] = (phi[:, :, :-2] - phi[:, :, 2:]) * inv2h
    ay[:, 1:-1, :] = (phi[:, :-2, :] - phi[:, 2:, :]) * inv2h
    az[1:-1, :, :] = (phi[:-2, :, :] - phi[2:, :, :]) * inv2h
    return ax, ay, az


def _accel_grids(rho: Tensor, grid: int, box: float, g_const: float,
                 softening_squared: float):
    """Field solve + gradient -> (ax, ay, az) grids [G, G, G]."""
    k = _potential_kernel_rfft(grid, box, float(softening_squared),
                               rho.device)
    phi = _irfft_pruned(_rfft_pruned(rho, grid) * k, grid) * _f32(g_const)
    return _grad(phi, grid, box)


def _interp(grids, position: Tensor, grid: int, box: float) -> Tensor:
    """Trilinear gather-back in particle order -> accel [3, N]: the 8
    corners of each grid in (dz, dy, dx) order, weighted and summed; 0 for
    particles outside the 1-cell margin."""
    g = grid
    i0, frac, inside = _cic_cells(position, g, box)
    i0c = torch.clamp(i0, 0, g - 2)
    cid = i0c[2] * g * g + i0c[1] * g + i0c[0]
    flat = [a.reshape(-1) for a in grids]
    acc = [None, None, None]
    for (dz, dy, dx), w in zip(_CORNERS, _corner_weights(frac)):
        idx = cid + (dz * g * g + dy * g + dx)
        for c in range(3):
            term = flat[c][idx] * w
            acc[c] = term if acc[c] is None else acc[c] + term
    out = torch.stack(acc)
    return torch.where(inside[None, :], out, 0.0)


def _interp_scalar(phi: Tensor, position: Tensor, grid: int, box: float):
    """Trilinear gather-back of a scalar grid [G, G, G] -> (values [N],
    inside [N]): `_interp`'s corners and weights, 0 outside the 1-cell
    margin; `inside` lets callers gate per-particle corrections."""
    g = grid
    i0, frac, inside = _cic_cells(position, g, box)
    i0c = torch.clamp(i0, 0, g - 2)
    cid = i0c[2] * g * g + i0c[1] * g + i0c[0]
    flat = phi.reshape(-1)
    val = None
    for (dz, dy, dx), w in zip(_CORNERS, _corner_weights(frac)):
        term = flat[cid + (dz * g * g + dy * g + dx)] * w
        val = term if val is None else val + term
    return torch.where(inside, val, 0.0), inside


def solve_and_gather(rho: Tensor, position: Tensor, grid: int, box: float,
                     g_const: float, softening_squared: float) -> Tensor:
    """Field solve + gradient + trilinear gather-back -> accel [3, N]."""
    grids = _accel_grids(rho, grid, box, g_const, softening_squared)
    return _interp(grids, position, grid, box)


def pm_accel_counted(position: Tensor, grid: int = 64,
                     box: float = 2048.0, g_const: float = 1.0,
                     softening_squared: float = 25.0):
    """-> (accel [3, N], the number of the N columns inside the mesh's
    1-cell margin, which the deposit counts: a 0-d int64 device tensor);
    the others get no mesh force. The three phases run inside the spans
    `pm.deposit`, `pm.solve` and `pm.interp` (`runtime/trace.py`)."""
    with trace.span("pm.deposit"):
        rho, inside = _deposit_sorted(*_sort_by_cell(position, grid, box),
                                      grid)
    with trace.span("pm.solve"):
        grids = _accel_grids(rho, grid, box, g_const, softening_squared)
    with trace.span("pm.interp"):
        return _interp(grids, position, grid, box), inside


def pm_accel(position: Tensor, grid: int = 64, box: float = 2048.0,
             g_const: float = 1.0, softening_squared: float = 25.0) -> Tensor:
    """-> accel [3, N]: isolated-boundary FFT-PM with the all-pairs pair law
    (g_const = mass * interaction_scale, the same softening)."""
    return pm_accel_counted(position, grid, box, g_const,
                            softening_squared)[0]


def make_accel_fn(mass: float, softening_squared: float = 25.0,
                  grid: int = 64, box: float = 2048.0,
                  num_particles: Optional[int] = None
                  ) -> Callable[[Tensor], Tensor]:
    """Adapter matching the integrator's accel_fn signature. Each call
    copies into `accel_fn.outside` the number of the first
    `num_particles` columns (None: every column) that lie outside the
    mesh's 1-cell margin and so got no mesh force: those columns less the
    ones the deposit counted inside, exact because the state's padding
    past them, parked at 1e9 (`models/state.py`), lies outside any mesh
    of a box under 2e9. A 0-d int64 tensor on the state's device made at
    the first call (a copy, so a captured step updates it at every
    replay, with no host read)."""

    def accel_fn(position: Tensor) -> Tensor:
        acc, inside = pm_accel_counted(
            position, grid=grid, box=box, g_const=mass,
            softening_squared=softening_squared)
        if accel_fn.outside is None:
            accel_fn.outside = torch.zeros((), dtype=torch.int64,
                                           device=position.device)
        n = position.shape[1] if num_particles is None else num_particles
        accel_fn.outside.copy_(n - inside)
        return acc

    accel_fn.outside = None
    return accel_fn
