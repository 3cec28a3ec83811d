"""One step of particle-mesh (PM) self-gravity: the demo lineage's
softened pair law (`nBodyGravityCS.hlsl:44-57`), phi(r) = -(|r|^2 +
eps^2)^(-1/2) per unit mass, summed by the textbook particle-mesh method
(Hockney & Eastwood, *Computer Simulation Using Particles*, 1988, ch. 5-6)
on a G^3 mesh over a cube of side `box`, then the demo's Euler tail.

- **Mesh.** h = box / G; node i of an axis sits at (i + 0.5 - G/2) h;
  the grid is [z, y, x].
- **Deposit.** Cloud-in-cell: each of the n particles adds unit mass to
  the 8 nodes around it, with trilinear weights, by scatter-add
  (`index_add_`) in `dtype`. A particle whose base cell is not in
  [1, G - 3] on every axis (outside the 1-cell margin that keeps the
  corners and the difference stencil on the mesh) deposits nothing; the
  state's padding, past n, is not read.
- **Solve.** The free-space (isolated) convolution of the density with
  phi: the density zero-padded to the doubled grid (2G per axis), phi
  sampled there at the minimum-image offsets (-G..G-1) h, both through
  full complex FFTs (`fftn` / `ifftn`), the product taken back and the
  first G^3 nodes kept, times mass x scale (scale = 1 / n).
- **Gradient.** a = -grad phi by second-order central differences, zero
  on the boundary planes.
- **Interpolation.** The same trilinear weights read a back at each
  particle, in `dtype`; 0 for a particle outside the margin.
- **Euler tail.** v' = (v + a dt) damping, p' = p + v' dt, w' = |a|.

G and box come from the configuration's `physics` (`pm_grid_size`,
`pm_box`); mass, eps^2, dt and damping as for the other force models.

Where this departs from the method as written:

- **Cell coordinate.** u = x * fl32(1/h) + fl32(G/2 - 0.5), formed in
  float64 from the float32 position and rounded once to float32, as the
  configuration's mesh states it; base cell floor(u), fractions u -
  floor(u) (exact in float64). A particle within one float32 rounding of
  a margin face would otherwise be inside one mesh and outside the other,
  and get its whole force in one and none in the other.
- **FFT precision.** A `dtype` that `torch.fft` does not take (bfloat16,
  the control's) transforms in float32: the density and the sampled phi
  are rounded to `dtype` before the transform and the potential after
  it.
- it steps only the `rows` it is asked for (None: the first n); every
  one of the n particles deposits.
"""

from __future__ import annotations

import torch

FFT_DTYPES = (torch.float32, torch.float64)
CORNERS = tuple((dz, dy, dx) for dz in (0, 1) for dy in (0, 1)
                for dx in (0, 1))


def cells(x, grid: int, box: float):
    """(base cell [3, R] int64, fractions [3, R] float64, inside [R]) of
    float32 positions x [3, R]."""
    f32 = torch.float32
    recip = float(torch.tensor(1.0, dtype=f32)
                  / torch.tensor(box / grid, dtype=f32))
    shift = float(torch.tensor(grid / 2 - 0.5, dtype=f32))
    u = (x.to(torch.float64) * recip + shift).to(f32).to(torch.float64)
    base = torch.floor(u)
    i0 = base.long()
    inside = ((i0 >= 1) & (i0 <= grid - 3)).all(dim=0)
    return i0, u - base, inside


def weights(frac, dtype):
    """The 8 trilinear weights [R] of the `CORNERS`, in `dtype`."""
    f = frac.to(dtype)
    return [(f[0] if dx else 1 - f[0]) * (f[1] if dy else 1 - f[1])
            * (f[2] if dz else 1 - f[2]) for dz, dy, dx in CORNERS]


def corner_index(i0, grid: int, corner):
    dz, dy, dx = corner
    g = grid
    return (i0[2] + dz) * g * g + (i0[1] + dy) * g + (i0[0] + dx)


def deposit(x, grid: int, box: float, dtype):
    """[G, G, G] counts of unit masses at positions x [3, n]."""
    i0, frac, inside = cells(x, grid, box)
    i0, frac = i0[:, inside], frac[:, inside]
    rho = torch.zeros(grid ** 3, dtype=dtype, device=x.device)
    for corner, w in zip(CORNERS, weights(frac, dtype)):
        rho.index_add_(0, corner_index(i0, grid, corner), w)
    return rho.reshape(grid, grid, grid)


def potential(rho, grid: int, box: float, eps2: float, dtype):
    """[G, G, G] sum over the mesh of rho(j) phi(node - node_j)."""
    g2 = 2 * grid
    fft_dtype = dtype if dtype in FFT_DTYPES else torch.float32
    m = torch.arange(g2, device=rho.device)
    off = (((m + grid) % g2) - grid).to(dtype) * (box / grid)
    d2 = (off[:, None, None] ** 2 + off[None, :, None] ** 2
          + off[None, None, :] ** 2 + eps2)
    phi = -torch.rsqrt(d2)
    padded = torch.zeros((g2, g2, g2), dtype=dtype, device=rho.device)
    padded[:grid, :grid, :grid] = rho
    conv = torch.fft.ifftn(torch.fft.fftn(padded.to(fft_dtype))
                           * torch.fft.fftn(phi.to(fft_dtype)))
    return conv.real[:grid, :grid, :grid].to(dtype)


def gradient(phi, grid: int, box: float):
    """(ax, ay, az) = -grad phi, central differences, 0 on the boundary
    planes."""
    two_h = 2 * (box / grid)
    ax, ay, az = (torch.zeros_like(phi) for _ in range(3))
    ax[:, :, 1:-1] = (phi[:, :, :-2] - phi[:, :, 2:]) / two_h
    ay[:, 1:-1, :] = (phi[:, :-2, :] - phi[:, 2:, :]) / two_h
    az[1:-1, :, :] = (phi[:-2, :, :] - phi[2:, :, :]) / two_h
    return ax, ay, az


def interpolate(grids, x, grid: int, box: float, dtype):
    """[3, R] trilinear reads of the three grids at positions x [3, R]."""
    i0, frac, inside = cells(x, grid, box)
    i0 = torch.where(inside[None, :], i0, torch.ones_like(i0))
    flat = [a.reshape(-1) for a in grids]
    acc = torch.zeros((3, x.shape[1]), dtype=dtype, device=x.device)
    for corner, w in zip(CORNERS, weights(frac, dtype)):
        idx = corner_index(i0, grid, corner)
        for c in range(3):
            acc[c] += flat[c][idx] * w
    return torch.where(inside[None, :], acc, torch.zeros_like(acc))


def accel(position, physics: dict, n: int, rows, dtype=torch.float64):
    """[3, R] mesh accelerations of the `rows` (None: every body) from the
    n bodies."""
    grid, box = int(physics["pm_grid_size"]), float(physics["pm_box"])
    rho = deposit(position[:3, :n], grid, box, dtype)
    phi = potential(rho, grid, box, physics["softening_squared"], dtype)
    phi = phi * (physics["mass"] / n)
    x = position[:3, :n] if rows is None else position[:3, rows]
    return interpolate(gradient(phi, grid, box), x, grid, box, dtype)


def step(position, velocity, physics: dict, n: int, rows,
         dtype=torch.float64):
    """(position [4, R], velocity [3, R]) of the `rows` (None: every body)
    after one step."""
    if rows is None:
        rows = slice(0, n)
    a = accel(position, physics, n, rows, dtype)
    v = (velocity[:, rows].to(dtype) + a * physics["dt"]) * physics["damping"]
    p = position[:3, rows].to(dtype) + v * physics["dt"]
    amag = torch.sqrt((a * a).sum(dim=0))
    return torch.cat([p, amag[None]]), v
