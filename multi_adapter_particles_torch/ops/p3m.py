"""P³M (particle-particle particle-mesh): exact-at-all-separations gravity.

The port of the JAX package's `ops/p3m.py`: an Ewald split of the softened
pair factor s(r) = (r²+eps²)^(-3/2) into

    s_long  = g_l(r; σ_eff)   the field of a Gaussian-smoothed source,
                              solved on the mesh (this module)
    s_short = s - s_long      summed pairwise by one of two near fields

with σ_eff = r_c / 4.5. The mesh convolves the analytic long-range
acceleration kernels tabulated at σ_tab = sqrt(σ_eff² - h²/3), so the
variance the CIC deposit and interpolation add composes to exactly σ_eff.

The near fields (`near_mode`):

- **tree**: the block-pair list of `ops/treeforce.py` (exact on any
  density contrast; its sweeps are CUDA kernels);
- **slots**: the static-K 27-cell sweep (`near_field_correction`), torch
  ops as the JAX package's are XLA. Particles are binned by a stable sort
  on their near-cell id into a [Gn³, K] slot table, empty slots parked at
  1e9 (where s_short underflows to 0, so the sweep needs no masks); the
  27 neighbour cells are shifted slices of the slot planes padded by one
  parked cell; the sweep runs over slabs of z-planes so that no
  temporary exceeds `_SWEEP_TEMP_BYTES`; slot forces go back to particle
  order by a permutation scatter (each index written once). A particle
  out of the box, or past the capacity K of its cell, gets no
  correction (it keeps the smooth mesh force); the overflow count,
  sum over cells of max(count - K, 0), is returned as a 0-d tensor. The
  binning sort is stable, where the JAX package's is not, so which
  particles of an overflowing cell lose their slot is defined by their
  order; with no overflow the slot sets are the same. Nothing on this
  path reads the device from the host, so a CUDA graph captures it.

The diagnostics gauge's potential splits the same way: the mesh convolves
the analytic potential kernel -erf(r/(√2σ_tab))/r, and the tree sweeps the
short remainder (`treeforce.short_potential_cheb`). `with_potential` adds
it to the force; `p3m_potential_with_overflow` and
`p3m_potential_total_with_overflow` compute it without the force work
(tree mode only: the slot sweep has no potential channel).
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


def _sigma_tab(grid: int, box: float, r_c: float) -> float:
    """σ_tab = sqrt(σ_eff² - h²/3): the width the mesh kernels are
    tabulated at."""
    h = box / grid
    return float(((r_c * _SIGMA_PER_CUTOFF) ** 2
                  - _CIC2_VARIANCE_CELLS * h * h) ** 0.5)


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
    sigma_tab = _sigma_tab(grid, box, r_c)
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


@functools.lru_cache(maxsize=8)
def _long_potential_kernel_rfft(grid: int, box: float, r_c: float,
                                device: torch.device) -> Tensor:
    """rfft of the analytic long-range potential kernel K_phi(v) =
    -erf(|v|/(√2 σ_tab))/|v| (-√(2/π)/σ_tab at 0) on the doubled grid,
    cached per (G, box, r_c, device) and tabulated slab by slab like
    `_long_grad_kernels_rfft`: its negative gradient is their
    acceleration. The float32 constants are formed as the JAX function
    forms them."""
    s_tab = _sigma_tab(grid, box, r_c)
    c_u = float(np.float32(1.0) / (np.sqrt(np.float32(2.0))
                                   * np.float32(s_tab)))
    limit0 = pm._f32(-((2.0 / math.pi) ** 0.5) / s_tab)
    off = pm.doubled_offsets(grid, box, device)
    g2 = 2 * grid
    ry, rx = off[:, None], off[None, :]
    dz = max(1, _KERNEL_SLAB_CELLS // (g2 * g2))
    real = torch.empty((g2, g2, g2), dtype=torch.float32, device=device)
    for z0 in range(0, g2, dz):
        rz = off[z0:z0 + dz, None, None]
        d2 = rx * rx + ry * ry + rz * rz
        r = torch.sqrt(d2)
        real[z0:z0 + dz] = torch.where(
            d2 > 0.0, -torch.special.erf(r * c_u) / torch.clamp(r, min=1e-30),
            limit0)
    return torch.fft.rfftn(real)


def _potential_long(rho: Tensor, grid: int, box: float, r_c: float) -> Tensor:
    """Long-range potential solve -> phi [G, G, G] per unit coupling (one
    forward transform, one pruned inverse)."""
    kp = _long_potential_kernel_rfft(grid, box, r_c, rho.device)
    return pm._irfft_pruned(pm._rfft_pruned(rho, grid) * kp, grid)


def _self_long(r_c: float, g_const: float = 1.0) -> float:
    """g √(2/π)/σ_eff: the mesh's delivered self response u_long(0; σ_eff)
    at coupling g, with the sign that removes it (float32, formed as the
    JAX package forms it)."""
    return pm._f32(g_const * float((2.0 / math.pi) ** 0.5)
                   / (r_c * _SIGMA_PER_CUTOFF))


def _gathered_potential(rho: Tensor, position: Tensor, grid: int,
                        box: float, g_const: float, r_c: float) -> Tensor:
    """The mesh's long-range potential at each particle, its own smoothed
    blob removed (in-box particles), 0 out of the box -> [N]."""
    phi = _potential_long(rho, grid, box, r_c) * pm._f32(g_const)
    u_long, inside = pm._interp_scalar(phi, position, grid, box)
    return u_long + torch.where(inside, _self_long(r_c, g_const), 0.0)


def _accel_long(rho: Tensor, grid: int, box: float, g_const: float,
                r_c: float):
    """Long-range field solve -> (ax, ay, az) grids [G, G, G]: one shared
    forward transform, three pruned inverses. Softening is absent here; it
    lives only in the short-range factor's s_exact."""
    kernels = _long_grad_kernels_rfft(grid, box, r_c, rho.device)
    fr = pm._rfft_pruned(rho, grid)
    scale = pm._f32(g_const)
    return tuple(pm._irfft_pruned(fr * k, grid) * scale for k in kernels)


def _short_factor(d2: Tensor, eps2: float, sigma_eff: float) -> Tensor:
    """s_short(r) = s_exact - g_l(r; σ_eff): accel = g s_short r_vec for
    the pair correction (the JAX package's `_short_factor`). Past r_c =
    4.5 σ_eff it has decayed to a few 1e-4 of s_exact; against a parked
    1e9 slot it underflows to a vanishing force."""
    inv = torch.rsqrt(d2 + pm._f32(eps2))
    return inv * inv * inv - _g_long(d2, sigma_eff)


_PARK = 1.0e9
# bytes of one [cells, K, K] pair temporary of the slot sweep; a slab of
# z-planes is sized to stay under it (about a dozen such temporaries are
# alive at once, so a slab peaks near 1 GiB)
_SWEEP_TEMP_BYTES = 1 << 26


def _bin_particles(position: Tensor, gn: int, hn: float, capacity: int):
    """Stable sort by near cell -> the slot table.

    Returns (slots [3, Gn³, K] with empty slots parked at 1e9, the sorted
    cell ids (out-of-box particles at Gn³), the sort permutation, the cell
    bounds [Gn³ + 1], the overflow count as a 0-d int64 tensor)."""
    n = position.shape[1]
    ncell = gn * gn * gn
    # the cell coordinate as the JAX package's compiled x / hn + gn / 2
    # rounds it (one fma with the float32 reciprocal of hn)
    ib = torch.floor(torch.clamp(pm.scaled_cells(position[:3], hn, gn / 2),
                                 -1.0, float(gn))).long()
    inbox = torch.all((ib >= 0) & (ib <= gn - 1), dim=0)
    cid = ib[2] * gn * gn + ib[1] * gn + ib[0]
    cid = torch.where(inbox, cid, torch.full_like(cid, ncell))
    scid, order = torch.sort(cid, stable=True)
    bounds = pm._segment_bounds(scid, ncell)
    counts = bounds[1:] - bounds[:-1]
    overflow = torch.clamp(counts - capacity, min=0).sum()
    k = torch.arange(capacity, device=position.device)[None, :]
    slot_idx = torch.where(k < counts[:, None], bounds[:-1, None] + k, n)
    spos = torch.cat([position[:3, order],
                      position.new_full((3, 1), _PARK)], dim=1)
    slots = spos[:, slot_idx.reshape(-1)].reshape(3, ncell, capacity)
    return slots, scid, order, bounds, overflow


def _near_sweep(slots: Tensor, gn: int, capacity: int, g_const: float,
                eps2: float, r_c: float) -> Tensor:
    """27-offset shifted-slice pair sweep -> slot forces [3, Gn³, K].

    Each neighbour cell is a shifted slice of the slot planes padded by one
    parked cell on every side; sources run along the last axis and are
    summed there. The cells are swept a slab of z-planes at a time."""
    k = capacity
    sigma = r_c * _SIGMA_PER_CUTOFF
    comp = slots.reshape(3, gn, gn, gn, k)
    pads = slots.new_full((3, gn + 2, gn + 2, gn + 2, k), _PARK)
    pads[:, 1:-1, 1:-1, 1:-1] = comp
    out = torch.empty_like(comp)
    plane = gn * gn * k * k * 4
    dz_slab = max(1, min(gn, _SWEEP_TEMP_BYTES // max(plane, 1)))
    for z0 in range(0, gn, dz_slab):
        z1 = min(gn, z0 + dz_slab)
        own = [comp[c, z0:z1][..., :, None] for c in range(3)]
        acc = [None, None, None]
        for dz in (0, 1, 2):
            for dy in (0, 1, 2):
                for dx in (0, 1, 2):
                    nb = [pads[c, z0 + dz:z1 + dz, dy:dy + gn, dx:dx + gn]
                          [..., None, :] for c in range(3)]
                    dv = [nb[c] - own[c] for c in range(3)]
                    d2 = dv[0] * dv[0] + dv[1] * dv[1] + dv[2] * dv[2]
                    s = _short_factor(d2, eps2, sigma)
                    for c in range(3):
                        part = torch.sum(s * dv[c], dim=-1)
                        acc[c] = part if acc[c] is None else acc[c] + part
        for c in range(3):
            out[c, z0:z1] = acc[c]
    return out.reshape(3, gn * gn * gn, k) * pm._f32(g_const)


def near_field_correction(position: Tensor, box: float, g_const: float,
                          eps2: float, r_c: float, near_grid: int,
                          capacity: int):
    """Short-range pairwise correction -> (accel [3, N], overflow count as
    a 0-d int64 tensor). `near_grid` must satisfy box / near_grid >= r_c,
    so the 27-cell neighbourhood covers the cutoff (`near_grid_for`)."""
    n = position.shape[1]
    gn = near_grid
    ncell = gn * gn * gn
    slots, scid, order, bounds, overflow = _bin_particles(
        position, gn, box / gn, capacity)
    slot_force = _near_sweep(slots, gn, capacity, g_const, eps2, r_c)
    # sorted particle i sits in slot (scid[i], i - bounds[scid[i]]); past
    # the capacity, or out of the box, it gets no correction
    live = scid < ncell
    cell = torch.where(live, scid, torch.zeros_like(scid))
    krank = torch.arange(n, device=position.device) - bounds[cell]
    ok = live & (krank < capacity)
    row = torch.where(ok, cell * capacity + krank, torch.zeros_like(krank))
    f_sorted = torch.where(ok[None, :],
                           slot_force.reshape(3, ncell * capacity)[:, row],
                           0.0)
    accel = torch.empty_like(f_sorted).index_copy_(1, order, f_sorted)
    return accel, overflow


def _check_near_mode(near_mode: str) -> None:
    if near_mode not in ("tree", "slots"):
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
    """-> (accel [3, N], overflow): mesh long range + a near field.
    `near_mode="tree"`: the tree sweep, overflow = dropped block pairs (an
    int). `"slots"`: the static-K sweep over cells of capacity
    `capacity`, overflow = particles past it (a 0-d int64 tensor, no host
    read). `with_potential` (the diagnostics gauge, tree only) also
    returns the per-particle softened pair potential u_i = g Σ_{j≠i}
    -1/sqrt(r_ij² + eps²), split the same Ewald way -> (accel, u [N],
    dropped); the total potential energy is 0.5 Σu. `half_force` is
    dropped there: the fused sweep is the directed one."""
    validate_cutoff_cells(cutoff_cells)
    _check_near_mode(near_mode)
    if with_potential and near_mode != "tree":
        raise ValueError(
            "with_potential requires near_mode='tree' (the slot sweep has "
            "no potential channel)")
    from multi_adapter_particles_torch.ops.treeforce import near_field_tree

    r_c, gn = near_grid_for(grid, box, cutoff_cells)
    rho = pm.deposit_cic(position, grid, box)
    a_far = pm._interp(_accel_long(rho, grid, box, g_const, r_c), position,
                       grid, box)
    if near_mode == "slots":
        a_near, overflow = near_field_correction(
            position, box, g_const, softening_squared, r_c, gn, capacity)
        return a_far + a_near, overflow
    near = near_field_tree(
        position, box, g_const, softening_squared, r_c, gn,
        pair_budget=pair_budget, sub_pair_budget=sub_pair_budget,
        with_potential=with_potential,
        half_force=half_force and not with_potential,
    )
    if not with_potential:
        a_near, dropped = near
        return a_far + a_near, dropped
    a_near, u_near, dropped = near
    u_long = _gathered_potential(rho, position, grid, box, g_const, r_c)
    return a_far + a_near, u_long + u_near, dropped


def p3m_accel(position: Tensor, **kw) -> Tensor:
    """-> accel [3, N] (the overflow count dropped)."""
    acc, _ = p3m_accel_with_overflow(position, **kw)
    return acc


def p3m_potential_with_overflow(
    position: Tensor,
    grid: int = 64,
    box: float = 2048.0,
    g_const: float = 1.0,
    softening_squared: float = 25.0,
    cutoff_cells: float = 6.75,
    pair_budget: Optional[int] = None,
    sub_pair_budget: Optional[int] = None,
    half_pairs: bool = False,
):
    """-> (u [N], dropped): the potential of `p3m_accel_with_overflow(...,
    with_potential=True)` with none of its force work (no gradient solves,
    the potential-only sweep), u bitwise the fused variant's on the same
    sweep. `half_pairs`: the halved near sweep; 0.5 Σu is unchanged to
    float32 rounding, but entries are no longer per-particle."""
    validate_cutoff_cells(cutoff_cells)
    from multi_adapter_particles_torch.ops.treeforce import near_field_tree

    r_c, gn = near_grid_for(grid, box, cutoff_cells)
    rho = pm.deposit_cic(position, grid, box)
    u_near, dropped = near_field_tree(
        position, box, g_const, softening_squared, r_c, gn,
        pair_budget=pair_budget, sub_pair_budget=sub_pair_budget,
        with_potential=True, potential_only=True, half_pairs=half_pairs,
    )
    u_long = _gathered_potential(rho, position, grid, box, g_const, r_c)
    return u_long + u_near, dropped


def p3m_potential_total_with_overflow(
    position: Tensor,
    grid: int = 64,
    box: float = 2048.0,
    g_const: float = 1.0,
    softening_squared: float = 25.0,
    cutoff_cells: float = 6.75,
    pair_budget: Optional[int] = None,
    sub_pair_budget: Optional[int] = None,
    half_pairs: bool = True,
):
    """-> (Σu, a 0-d tensor; dropped): `p3m_potential_with_overflow`'s
    total without per-particle values. The long part by the CIC adjoint
    identity (the gather-back weights are the deposit's, and both drop
    out-of-box particles): Σ_i phi(x_i) = Σ_c phi(c) rho(c) and Σ_i
    inside_i = Σ_c rho(c), so it is g (Σ phi·rho + self_long Σ rho); the
    near part is the sweep's block-order sum (`total_only`). Every sum is
    a `torch.sum` over a fixed shape: the same run to run."""
    validate_cutoff_cells(cutoff_cells)
    from multi_adapter_particles_torch.ops.treeforce import near_field_tree

    r_c, gn = near_grid_for(grid, box, cutoff_cells)
    rho = pm.deposit_cic(position, grid, box)
    u_near_total, dropped = near_field_tree(
        position, box, g_const, softening_squared, r_c, gn,
        pair_budget=pair_budget, sub_pair_budget=sub_pair_budget,
        with_potential=True, potential_only=True, half_pairs=half_pairs,
        total_only=True,
    )
    phi = _potential_long(rho, grid, box, r_c)
    u_long_total = pm._f32(g_const) * (
        torch.sum(phi * rho) + _self_long(r_c) * torch.sum(rho))
    return u_long_total + u_near_total, dropped


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
    to tree where slots would overflow). With slots, each call copies its
    overflow count into `accel_fn.overflow`, a 0-d int64 tensor on the
    state's device made at the first call (a copy, so a captured step
    updates it at every replay); it stays None for the tree."""
    if near_mode == "auto":
        near_mode = "slots"
    _check_near_mode(near_mode)

    def accel_fn(position: Tensor) -> Tensor:
        acc, overflow = p3m_accel_with_overflow(
            position, grid=grid, box=box, g_const=mass,
            softening_squared=softening_squared, cutoff_cells=cutoff_cells,
            capacity=capacity, near_mode=near_mode, pair_budget=pair_budget,
            sub_pair_budget=sub_pair_budget, half_force=half_force,
        )
        if near_mode == "slots":
            if accel_fn.overflow is None:
                accel_fn.overflow = torch.zeros(
                    (), dtype=torch.int64, device=position.device)
            accel_fn.overflow.copy_(overflow)
        return acc

    accel_fn.overflow = None
    return accel_fn
