"""Distributed free-space FFT convolution: the slab decomposition.

The port of the JAX package's `parallel/dist_fft.py`: the PM field solve
split over the mesh's inner axis (its D ranks), each stage a torch FFT op
on 1/D of the pencils, the data moved by the collectives of
`parallel/mesh.py` (between processes too, over a process group):

    partial deposits --reduce_scatter--> z-slabs [G/D, G, G]
    rfft(x) + fft(y)                     [G/D, 2G, G+1]
    all_to_all (y split, z concat)       [G, 2G/D, G+1]      (transpose)
    fft(z, padded) x kernel slab         [2G, 2G/D, G+1]
    ifft(z) + slice                      [G, 2G/D, G+1]
    all_to_all (z split, y concat)       [G/D, 2G, G+1]      (transpose back)
    ifft(y) + irfft(x) + slice           [G/D, G, G]
    all_gather                           [G, G, G] phi on every rank

Each rank holds 1/D of the kernel spectrum (`make_kernel_slabs`, its
y-columns, tabulated on the host once per grid as the JAX package does).
The forward axes pad lazily and the inverse axes slice as soon as they
are done, as `ops/pm._rfft_pruned` / `_irfft_pruned` do.

Numerics: the per-axis transforms act on independent pencils, so the
result matches the one-device solve up to the order of the deposit's
reduction (a tolerance, not bitwise, as in the JAX package).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from multi_adapter_particles_torch.parallel import mesh as M

Tensor = torch.Tensor


def supports(grid: int, n_inner: int) -> bool:
    """The slab decomposition needs G and 2G to split evenly over the
    inner axis (and more than one rank to be worth anything)."""
    return n_inner > 1 and grid % n_inner == 0 and (2 * grid) % n_inner == 0


def make_kernel_slabs(mesh: M.Mesh, grid: int, box: float,
                      softening_squared: float) -> List[Tensor]:
    """The kernel spectrum of `ops/pm._potential_kernel_rfft` (phi(r) =
    -(|r|²+eps²)^(-1/2) on the doubled grid, min-image offsets), built in
    numpy once; each of this process's ranks gets the y-columns [2G, 2G/D,
    G+1] of its inner index, on its device."""
    g2 = 2 * grid
    h = box / grid
    m = np.arange(g2)
    off = (((m + grid) % g2) - grid).astype(np.float32) * np.float32(h)
    rz = off[:, None, None]
    ry = off[None, :, None]
    rx = off[None, None, :]
    d2 = rx * rx + ry * ry + rz * rz + np.float32(softening_squared)
    kernel = np.fft.rfftn(-1.0 / np.sqrt(d2)).astype(np.complex64)
    n_inner = mesh.shape[M.AXIS]
    w = g2 // n_inner
    return [torch.from_numpy(np.ascontiguousarray(
                kernel[:, (r % n_inner) * w:(r % n_inner + 1) * w])).to(
                    mesh.devices[r])
            for r in mesh.local_ranks]


def convolve_mesh(rho_parts: Sequence[Tensor],
                  kernel_slabs: Sequence[Tensor], grid: int,
                  mesh: M.Mesh) -> List[Tensor]:
    """This process's ranks' partial deposits [G, G, G] -> the convolved
    phi [G, G, G] for each (see the module docstring), the pipeline run in
    each inner-axis group of the mesh (each slice of a 2-D mesh solves its
    own copy)."""
    g, g2 = grid, 2 * grid

    def over(fn, xs, **kw):
        return M.over_groups(mesh, M.AXIS, fn, xs, **kw)

    slab = over(M.reduce_scatter, rho_parts, dim=0)            # [G/D, G, G]
    f = [torch.fft.fft(torch.fft.rfft(s, n=g2, dim=2), n=g2, dim=1)
         for s in slab]                                        # [G/D, 2G, G+1]
    f = over(M.all_to_all, f, split_dim=1, concat_dim=0)       # [G, 2G/D, G+1]
    f = [torch.fft.ifft(torch.fft.fft(x, n=g2, dim=0) * k, dim=0)[:g]
         for x, k in zip(f, kernel_slabs)]                     # [G, 2G/D, G+1]
    f = over(M.all_to_all, f, split_dim=0, concat_dim=1)       # [G/D, 2G, G+1]
    phi = [torch.fft.irfft(torch.fft.ifft(x, dim=1)[:, :g], n=g2,
                           dim=2)[:, :, :g] for x in f]        # [G/D, G, G]
    return [p.contiguous() for p in over(M.all_gather, phi, dim=0)]
