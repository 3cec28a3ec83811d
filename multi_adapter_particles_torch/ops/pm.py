"""Particle-mesh (PM) self-gravity: FFT convolution, isolated boundaries.

The port of the JAX package's `ops/pm.py` (no Pallas kernel there, none
here): deposit unit masses on a [G, G, G] grid ([z, y, x]) by
cloud-in-cell, convolve with the softened pair potential through
zero-padded FFTs (free space, not periodic), take central differences,
and interpolate the three acceleration grids back to the particles.

- **Deposit** (`deposit_cic`): one stable sort of the base cell ids
  carrying the three CIC fractions, then one cumsum over the 8 corner
  weights and a gather at the per-cell segment bounds gives 8 histograms,
  added to the grid as 8 shifted slices. No `index_add_`/`scatter_add_`:
  their float atomics on CUDA would break the port's promise that a step
  is the same from run to run.
- **Solve**: axis-pruned rfft/fft on the doubled grid (both ends of every
  axis pruned) times a cached kernel spectrum, in complex64.
- **Interpolate**: the 8 corner values of each acceleration grid (or of
  the diagnostics' potential grid, `_interp_scalar`) are read by plain
  indexing and summed in (dz, dy, dx) order. The JAX package's lane-packed
  corner rows (`_pack_corner_rows`, `_pack_scalar_corner_rows`, TPU tiling
  workarounds) have no counterpart.

Cell geometry follows what the JAX package's compiled code computes: XLA
turns `x / h + c` into one fused multiply-add with the float32 reciprocal
of h, so `_cic_cells` evaluates that in float64 (exact product, one
rounding to float32) and lands every particle in the same base cell.
"""

from __future__ import annotations

import functools
from typing import Callable, Tuple

import numpy as np
import torch

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


def _deposit_sorted(sbase: Tensor, sfrac: Tensor, grid: int) -> Tensor:
    """Sorted cell ids + fractions -> CIC count grid [G, G, G]."""
    g = grid
    ncell = g * g * g
    live = sbase < ncell
    # corners on dim 0, particles on the contiguous dim 1: CUDA's cumsum
    # scans a contiguous dim in parallel, but walks a strided one with one
    # thread per column (8 threads over N, ~270 ms at 1M on an H100)
    sw8 = torch.stack([torch.where(live, w, 0.0)
                       for w in _corner_weights(sfrac)])          # [8, N]
    bounds = _segment_bounds(sbase, ncell)
    csum = torch.cat([sw8.new_zeros((8, 1)), torch.cumsum(sw8, dim=1)],
                     dim=1)
    at_bounds = csum[:, bounds]                                  # [8, G³+1]
    hist8 = at_bounds[:, 1:] - at_bounds[:, :-1]
    rho = torch.zeros((g, g, g), dtype=torch.float32, device=sbase.device)
    for c, (dz, dy, dx) in enumerate(_CORNERS):
        hist = hist8[c].reshape(g, g, g)
        # corner cell = base + (dx, dy, dz): the histogram shifted
        rho[dz:, dy:, dx:] += hist[:g - dz, :g - dy, :g - dx]
    return rho


def deposit_cic(position: Tensor, grid: int, box: float) -> Tensor:
    """[4, N] positions -> CIC count grid [G, G, G] ([z, y, x], unit mass).
    Out-of-box particles (and the 1e9 padding) deposit nothing."""
    sbase, sfrac = _sort_by_cell(position, grid, box)
    return _deposit_sorted(sbase, sfrac, grid)


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


def pm_accel(position: Tensor, grid: int = 64, box: float = 2048.0,
             g_const: float = 1.0, softening_squared: float = 25.0) -> Tensor:
    """-> accel [3, N]: isolated-boundary FFT-PM with the all-pairs pair law
    (g_const = mass * interaction_scale, the same softening)."""
    rho = deposit_cic(position, grid, box)
    return solve_and_gather(rho, position, grid, box, g_const,
                            softening_squared)


def make_accel_fn(mass: float, softening_squared: float = 25.0,
                  grid: int = 64, box: float = 2048.0
                  ) -> Callable[[Tensor], Tensor]:
    """Adapter matching the integrator's accel_fn signature."""

    def accel_fn(position: Tensor) -> Tensor:
        return pm_accel(position, grid=grid, box=box, g_const=mass,
                        softening_squared=softening_squared)

    return accel_fn
