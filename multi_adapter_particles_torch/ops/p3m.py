"""P³M (particle-particle particle-mesh): exact-at-all-separations gravity.

The port of the JAX package's `ops/p3m.py` in its tree near-field mode:
an Ewald split of the softened pair factor s(r) = (r²+eps²)^(-3/2) into

    s_long  = g_l(r; σ_eff)   the field of a Gaussian-smoothed source,
                              solved on the mesh (this module)
    s_short = s - s_long      summed pairwise over the block-pair list of
                              `ops/treeforce.py` (exactly 0 past r_c)

with σ_eff = r_c / 4.5. The mesh convolves the analytic long-range
acceleration kernels tabulated at σ_tab = sqrt(σ_eff² - h²/3), so the
variance the CIC deposit and interpolation add composes to exactly σ_eff.

Not here yet: the static-K slot near field (`near_mode="slots"`, and
`"auto"`, which resolves to slots without the CLI's startup probe), ROADMAP
queue 1 item 10; the `p3m_potential_*` functions, which belong to the
diagnostics path (item 12).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional

import numpy as np
import torch

from multi_adapter_particles_torch.ops import pm

Tensor = torch.Tensor

_SIGMA_PER_CUTOFF = 1.0 / 4.5   # sigma_eff = r_c/4.5: tail there ≈ 1.4e-4
_CIC2_VARIANCE_CELLS = 1.0 / 3.0  # variance added by deposit+interp CIC, h²

# σ_tab² = σ_eff² - h²/3 must stay positive: the CIC windows alone may not
# contribute more variance than the whole effective Gaussian. In cutoff
# units that is (cutoff_cells/4.5)² > 1/3.
MIN_CUTOFF_CELLS = _CIC2_VARIANCE_CELLS**0.5 / _SIGMA_PER_CUTOFF  # ≈ 2.598


def validate_cutoff_cells(cutoff_cells: float) -> None:
    """Reject cutoffs whose σ_tab² = σ_eff² - h²/3 would go non-positive."""
    if (cutoff_cells * _SIGMA_PER_CUTOFF) ** 2 <= _CIC2_VARIANCE_CELLS:
        raise ValueError(
            f"p3m cutoff_cells={cutoff_cells} is below the minimum usable "
            f"cutoff (~{MIN_CUTOFF_CELLS:.3f} cells): the CIC deposit+interp "
            "variance h²/3 would exceed σ_eff² and the tabulated kernel "
            "width σ_tab would be imaginary. Raise -p3mcutoff."
        )


def near_grid_for(grid: int, box: float, cutoff_cells: float):
    """(r_c, near grid gn): cells box/gn >= r_c wide, at least one."""
    r_c = cutoff_cells * box / grid
    return r_c, max(int(box // r_c), 1)


def _g_long(d2: Tensor, sigma: float) -> Tensor:
    """Ewald long-range pair factor of a Gaussian-smoothed unit source,

        g_l(r) = [erf(r/√2σ) - √(2/π)(r/σ) e^(-r²/2σ²)] / r³

    (accel = g_l * r_vec), with the r³ division guarded so r = 0 gives 0.
    The float32 constants are formed as the JAX function forms them."""
    s32 = np.float32(sigma)
    c_u = np.float32(1.0) / (np.sqrt(np.float32(2.0)) * s32)
    c_exp = np.sqrt(np.float32(2.0 / math.pi)) / s32
    r = torch.sqrt(d2)
    u = r * float(c_u)
    num = torch.special.erf(u) - float(c_exp) * r * torch.exp(
        d2 * pm._f32(-0.5 / sigma**2))
    return num / torch.clamp(d2 * r, min=1e-30)


# z-planes of the doubled grid per step of the kernel tabulation: bounds
# _g_long's temporaries to a slab while the [2G]³ real grid is filled
_KERNEL_SLAB_CELLS = 1 << 22


@functools.lru_cache(maxsize=8)
def _long_grad_kernels_rfft(grid: int, box: float, r_c: float,
                            device: torch.device):
    """rffts of the analytic acceleration kernels K_axis(v) =
    -g_l(|v|; σ_tab) v_axis on the doubled grid, cached per
    (G, box, r_c, device). K(0) = 0: no self-peak. Each axis's real grid
    is tabulated slab by slab and transformed before the next is built, so
    the build holds at most one real grid and its spectrum beside the
    spectra already made."""
    h = box / grid
    sigma_eff = r_c * _SIGMA_PER_CUTOFF
    sigma_tab = float((sigma_eff**2 - _CIC2_VARIANCE_CELLS * h * h) ** 0.5)
    off = pm.doubled_offsets(grid, box, device)
    g2 = 2 * grid
    ry, rx = off[:, None], off[None, :]
    dz = max(1, _KERNEL_SLAB_CELLS // (g2 * g2))
    spectra = []
    for axis in range(3):
        real = torch.empty((g2, g2, g2), dtype=torch.float32, device=device)
        for z0 in range(0, g2, dz):
            rz = off[z0:z0 + dz, None, None]
            s_long = _g_long(rx * rx + ry * ry + rz * rz, sigma_tab)
            real[z0:z0 + dz] = -s_long * (rx, ry, rz)[axis]
        spectra.append(torch.fft.rfftn(real))
        del real
    return tuple(spectra)


def _accel_long(rho: Tensor, grid: int, box: float, g_const: float,
                r_c: float):
    """Long-range field solve -> (ax, ay, az) grids [G, G, G]: one shared
    forward transform, three pruned inverses. Softening is absent here; it
    lives only in the short-range factor's s_exact."""
    kernels = _long_grad_kernels_rfft(grid, box, r_c, rho.device)
    fr = pm._rfft_pruned(rho, grid)
    scale = pm._f32(g_const)
    return tuple(pm._irfft_pruned(fr * k, grid) * scale for k in kernels)


def _require_tree(near_mode: str) -> None:
    """Raise unless `near_mode` is the ported tree near field."""
    if near_mode == "slots":
        raise NotImplementedError(
            "the p3m slot near field is not ported to "
            "multi_adapter_particles_torch yet (ROADMAP queue 1 item 10)")
    if near_mode != "tree":
        raise ValueError(f"unknown near_mode {near_mode!r}")


def p3m_accel_with_overflow(
    position: Tensor,
    grid: int = 64,
    box: float = 2048.0,
    g_const: float = 1.0,
    softening_squared: float = 25.0,
    cutoff_cells: float = 6.75,
    capacity: int = 64,
    near_mode: str = "slots",
    pair_budget: Optional[int] = None,
    sub_pair_budget: Optional[int] = None,
    with_potential: bool = False,
    half_force: bool = False,
):
    """-> (accel [3, N], dropped block pairs): mesh long range + the tree
    near field (`near_mode="tree"`). `capacity` belongs to the slot near
    field, which is not ported; `with_potential` belongs to diagnostics."""
    validate_cutoff_cells(cutoff_cells)
    _require_tree(near_mode)
    if with_potential:
        raise NotImplementedError(
            "the p3m potential belongs to the diagnostics path, not ported "
            "yet (ROADMAP queue 1 item 12)")
    from multi_adapter_particles_torch.ops.treeforce import near_field_tree

    r_c, gn = near_grid_for(grid, box, cutoff_cells)
    rho = pm.deposit_cic(position, grid, box)
    a_far = pm._interp(_accel_long(rho, grid, box, g_const, r_c), position,
                       grid, box)
    del rho
    a_near, dropped = near_field_tree(
        position, box, g_const, softening_squared, r_c, gn,
        pair_budget=pair_budget, sub_pair_budget=sub_pair_budget,
        half_force=half_force,
    )
    return a_far + a_near, dropped


def p3m_accel(position: Tensor, **kw) -> Tensor:
    """-> accel [3, N] (the dropped-pair count dropped)."""
    acc, _ = p3m_accel_with_overflow(position, **kw)
    return acc


def host_overflow_count(position, grid: int, box: float,
                        cutoff_cells: float, capacity: int) -> int:
    """NumPy replica of the slot binning's overflow diagnostic, run once at
    startup so the CLI can pick the near field for the scene."""
    r_c = cutoff_cells * box / grid
    gn = max(int(box // r_c), 1)
    hn = box / gn
    pos = np.asarray(position)[:3]
    ib = np.floor(pos / hn + gn / 2).astype(np.int64)
    inbox = ((ib >= 0) & (ib <= gn - 1)).all(axis=0)
    cid = ib[2] * gn * gn + ib[1] * gn + ib[0]
    counts = np.bincount(cid[inbox], minlength=gn**3)
    return int(np.maximum(counts - capacity, 0).sum())


def make_accel_fn(
    mass: float,
    softening_squared: float = 25.0,
    grid: int = 64,
    box: float = 2048.0,
    cutoff_cells: float = 6.75,
    capacity: int = 64,
    near_mode: str = "slots",
    pair_budget: Optional[int] = None,
    sub_pair_budget: Optional[int] = None,
    half_force: bool = False,
) -> Callable[[Tensor], Tensor]:
    """Adapter matching the integrator's accel_fn signature. "auto" means
    slots here, as in the JAX package (the CLI's startup probe resolves it
    to tree where slots would overflow); slots raise."""
    if near_mode == "auto":
        near_mode = "slots"
    _require_tree(near_mode)

    def accel_fn(position: Tensor) -> Tensor:
        return p3m_accel(
            position, grid=grid, box=box, g_const=mass,
            softening_squared=softening_squared, cutoff_cells=cutoff_cells,
            capacity=capacity, near_mode=near_mode, pair_budget=pair_budget,
            sub_pair_budget=sub_pair_budget, half_force=half_force,
        )

    return accel_fn
