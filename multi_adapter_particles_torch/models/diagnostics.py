"""Conservation diagnostics: energy, momentum and angular-momentum gauges.

The port of the JAX package's `models/diagnostics.py`: a handful of scalar
reductions over the state, published as metrics gauges every K frames
(`-diagnostics K`). The physics is the JAX module's:

- The semi-implicit Euler step is kick-drift leapfrog with velocities at
  the half step; `sync=True` (default) half-kicks them to the position's
  time, v + a(p) dt/2, which removes the O(dt) sawtooth of the raw energy.
- Self-gravity potential energy is the exact softened (Plummer) pair sum,
  whatever approximation made the run's forces, so the energy gauge also
  probes the force model. Up to `_EXACT_MAX_N` particles it is the O(N²)
  sum (`pairwise_potential_and_accel`, plain torch ops); above, the P³M
  split of the same potential (`mesh_potential_and_accel`,
  `mesh_potential_only`), whose tree sweep runs the CUDA kernels'
  potential variants on a card (`ops/treeforce.py`).
- central_well: U_i = -M / sqrt(|r_i|² + eps²) per unit mass.
- Particles are equal unit masses; padding (parked at 1e9) is masked out
  of every sum.

Every gauge is a 0-d tensor on the state's device until `DiagnosticsProbe`
pulls it with `float()` (one host sync a sample).
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, Optional

import torch

from multi_adapter_particles_torch.config import SimConfig
from multi_adapter_particles_torch.models import integrator
from multi_adapter_particles_torch.models.state import ParticleState
from multi_adapter_particles_torch.ops import p3m, pm, treeforce
from multi_adapter_particles_torch.runtime import trace

Tensor = torch.Tensor

_SELF_GRAVITY = ("all_pairs", "pm_grid", "p3m")

# targets per chunk of the exact sum: [chunk, j_tile] float32 temporaries
# of 256 MB at the default tile
_EXACT_I_CHUNK = 65_536


def pairwise_potential_and_accel(position: Tensor, mask: Tensor,
                                 g_scale: float, softening_squared: float,
                                 j_tile: int = 1024):
    """Exact softened pairwise (potential, accel [3, Np]) in one blocked
    pass:

        potential = -0.5 g Σ_{i≠j} m_i m_j / sqrt(d_ij² + eps²)
        accel_i   =       g Σ_j (p_j - p_i) m_j / (d_ij² + eps²)^{3/2}

    The JAX package's j-tile scan (each row summed tile by tile in j
    order), chunked over targets as well so no temporary passes ~256 MB.
    The i == j term adds no force and a known 1/eps self energy, which is
    subtracted."""
    p = position[:3]
    n = p.shape[1]
    if n % j_tile != 0:
        j_tile = n
    eps2 = pm._f32(softening_squared)
    g = pm._f32(g_scale)
    inv_sum = torch.zeros_like(p[0])
    acc = torch.zeros_like(p)
    for i0 in range(0, n, _EXACT_I_CHUNK):
        pi = p[:, i0:i0 + _EXACT_I_CHUNK]
        for j0 in range(0, n, j_tile):
            pj, mj = p[:, j0:j0 + j_tile], mask[j0:j0 + j_tile]
            dx = pj[0][None, :] - pi[0][:, None]
            dy = pj[1][None, :] - pi[1][:, None]
            dz = pj[2][None, :] - pi[2][:, None]
            d2 = dx * dx + dy * dy + dz * dz + eps2
            inv = torch.rsqrt(d2) * mj[None, :]
            s = inv / d2   # = m_j / (d² + eps²)^{3/2}
            inv_sum[i0:i0 + _EXACT_I_CHUNK] += inv.sum(1)
            acc[:, i0:i0 + _EXACT_I_CHUNK] += torch.stack(
                [(dx * s).sum(1), (dy * s).sum(1), (dz * s).sum(1)])
    self_inv = mask * pm._f32(1.0 / math.sqrt(eps2))
    potential = -0.5 * g * torch.sum(mask * (inv_sum - self_inv))
    return potential, acc * g


# auto mode: the exact O(N²) potential up to here, the P³M-split mesh
# potential above
_EXACT_MAX_N = 262_144


def _gauge_grid(n: int, config_grid: int) -> int:
    """Mesh size of the potential gauge, independent of the force model's
    mesh: the JAX package's table (its tree-P³M grid optima at 1M and 4M);
    small N keeps the config's mesh."""
    if n <= _EXACT_MAX_N:
        return config_grid
    if n <= 2_097_152:
        return max(config_grid, 192)
    return max(config_grid, 256)


def mesh_potential_and_accel(position: Tensor, g_scale: float,
                             softening_squared: float, grid: int, box: float,
                             cutoff_cells: float = 6.75,
                             pair_budget: Optional[int] = None,
                             sub_pair_budget: Optional[int] = None):
    """P³M-split (potential, accel, dropped_pairs): the mesh's erf/r long
    part + the tree-swept short remainder of the exact sum's potential
    (`p3m_accel_with_overflow(with_potential=True)`, the fused directed
    sweep); the accel is the tree-P³M force, for the half-kick."""
    accel, u, dropped = p3m.p3m_accel_with_overflow(
        position, grid=grid, box=box, g_const=g_scale,
        softening_squared=softening_squared, cutoff_cells=cutoff_cells,
        near_mode="tree", pair_budget=pair_budget,
        sub_pair_budget=sub_pair_budget, with_potential=True,
    )
    return 0.5 * torch.sum(u), accel, dropped


def mesh_potential_only(position: Tensor, g_scale: float,
                        softening_squared: float, grid: int, box: float,
                        cutoff_cells: float = 6.75,
                        pair_budget: Optional[int] = None,
                        sub_pair_budget: Optional[int] = None,
                        half_pairs: bool = True, total_only: bool = True):
    """P³M-split (potential, dropped_pairs) without the force work: the
    potential-only sweep, by default over the Newton-3rd halved list and
    summed without per-particle values (`p3m_potential_total_with_
    overflow`); `half_pairs=False` keeps the fused gauge's directed
    enumeration, `total_only=False` the per-particle path."""
    kw = dict(grid=grid, box=box, g_const=g_scale,
              softening_squared=softening_squared, cutoff_cells=cutoff_cells,
              pair_budget=pair_budget, sub_pair_budget=sub_pair_budget,
              half_pairs=half_pairs)
    if total_only:
        u_total, dropped = p3m.p3m_potential_total_with_overflow(position,
                                                                 **kw)
        return 0.5 * u_total, dropped
    u, dropped = p3m.p3m_potential_with_overflow(position, **kw)
    return 0.5 * torch.sum(u), dropped


def _check_mode(potential_mode: str) -> None:
    if potential_mode not in ("auto", "exact", "mesh"):
        raise ValueError(f"unknown potential_mode {potential_mode!r} "
                         "(auto | exact | mesh)")


def _uses_mesh(config: SimConfig, potential_mode: str) -> bool:
    return config.force_model in _SELF_GRAVITY and (
        potential_mode == "mesh"
        or (potential_mode == "auto" and config.num_particles > _EXACT_MAX_N))


def make_diagnostics(config: SimConfig, sync: bool = True,
                     j_tile: int = 1024, potential_mode: str = "auto",
                     pair_budget: Optional[int] = None,
                     external_accel: bool = False,
                     sub_pair_budget: Optional[int] = None
                     ) -> Callable[..., Dict[str, Tensor]]:
    """The `state -> {gauge: 0-d tensor}` function: kinetic, potential,
    energy, momentum_x/y/z, momentum_mag, angular_momentum_mag, and
    diag_dropped_pairs where the mesh gauge runs.

    `potential_mode` (self-gravity): "exact" the O(N²) sum, "mesh" the
    P³M-split gauge, "auto" exact up to 262,144 particles and mesh above.
    `pair_budget` / `sub_pair_budget` size the gauge's tree lists
    (`sub_pair_budget` None = the config's). `external_accel`: the function
    takes `(state, accel)` and half-kicks with the supplied accel (the
    run's own force), so the mesh gauge skips its force work
    (`mesh_potential_only`)."""
    _check_mode(potential_mode)
    n = config.num_particles
    half_dt = pm._f32(0.5 * pm._f32(config.dt))
    model = config.force_model
    g_scale = (config.mass * config.interaction_scale
               if model in _SELF_GRAVITY else None)
    use_mesh = _uses_mesh(config, potential_mode)
    if sub_pair_budget is None:
        sub_pair_budget = config.p3m_sub_pair_budget
    mesh_kw = dict(grid=_gauge_grid(n, config.pm_grid_size),
                   box=config.pm_box, cutoff_cells=config.p3m_cutoff_cells,
                   pair_budget=pair_budget, sub_pair_budget=sub_pair_budget)

    def central_potential(pos: Tensor, mask: Tensor) -> Tensor:
        r = pos[:3]
        d2 = torch.sum(r * r, dim=0) + pm._f32(config.softening_squared)
        return torch.sum(mask * -pm._f32(config.mass) * torch.rsqrt(d2))

    def reduce(state: ParticleState, mask: Tensor, potential: Tensor,
               accel: Optional[Tensor], extra: Dict[str, Tensor]):
        v = state.velocity + half_dt * accel if sync else state.velocity
        vm = v * mask[None, :]
        momentum = torch.sum(vm, dim=1)
        ang = torch.sum(torch.linalg.cross(state.position[:3] * mask[None, :],
                                           vm, dim=0), dim=1)
        kinetic = 0.5 * torch.sum(vm * vm)
        out = {
            "kinetic": kinetic,
            "potential": potential,
            "energy": kinetic + potential,
            "momentum_x": momentum[0],
            "momentum_y": momentum[1],
            "momentum_z": momentum[2],
            "momentum_mag": torch.sqrt(torch.sum(momentum * momentum)),
            "angular_momentum_mag": torch.sqrt(torch.sum(ang * ang)),
        }
        out.update(extra)
        return out

    def diagnostics(state: ParticleState,
                    accel: Optional[Tensor] = None) -> Dict[str, Tensor]:
        mask = state.make_mask(n)
        pos = state.position
        extra: Dict[str, Tensor] = {}
        if use_mesh:
            if external_accel or not sync:
                potential, dropped = mesh_potential_only(
                    pos, g_scale, config.softening_squared, **mesh_kw)
                if accel is None:   # no half-kick, no force
                    accel = torch.zeros_like(pos[:3])
            else:
                potential, accel, dropped = mesh_potential_and_accel(
                    pos, g_scale, config.softening_squared, **mesh_kw)
            extra["diag_dropped_pairs"] = torch.tensor(float(dropped))
        elif model in _SELF_GRAVITY:
            potential, own = pairwise_potential_and_accel(
                pos, mask, g_scale, config.softening_squared, j_tile)
            if accel is None:
                accel = own
        else:
            potential = central_potential(pos, mask)
            if accel is None:
                accel = integrator.central_well_accel(
                    pos, config.mass, config.softening_squared)
        return reduce(state, mask, potential, accel, extra)

    if external_accel:
        def diagnostics_ext(state: ParticleState,
                            accel: Tensor) -> Dict[str, Tensor]:
            return diagnostics(state, accel)

        return diagnostics_ext
    return diagnostics


class DiagnosticsProbe:
    """Cadenced publisher: the gauges every `every` frames, written into a
    `MetricsRegistry` with `energy_drift` (relative to the first sample)
    and `diag_sample_ms` (the host wall time of every sample so far, its
    one host sync included; the first holds the budget probe).

    Where the mesh gauge runs and the config carries no probed
    `p3m_pair_budget`, the first sample sizes the gauge's pair and sub-pair
    budgets from that state (`treeforce.host_tree_counts` at the gauge
    grid, one host Morton sort), once for both gauge variants. A sample
    runs inside the `diagnostics` span (`runtime/trace.py`).

    `use_run_accel` (None = auto: on exactly for a pm_grid run with the
    mesh gauge) half-kicks with the run's own force
    (`integrator.make_accel_fn_for`), so the gauge runs the potential-only
    halved sweep; p3m runs keep the fused sweep, whose force is the run's.
    A caller holding the step's accel may pass `maybe_publish(accel=...)`."""

    def __init__(self, config: SimConfig, every: int, sync: bool = True,
                 potential_mode: str = "auto",
                 use_run_accel: Optional[bool] = None):
        _check_mode(potential_mode)
        self.every = max(1, int(every))
        self._config = config
        self._sync = sync
        self._mode = potential_mode
        self._fn = None
        self._fn_ext = None
        self._run_accel = None
        self._probed_budget: Optional[int] = None
        self._probed_sub: Optional[int] = None
        self._e0: Optional[float] = None
        self.sample_ms: list = []
        if use_run_accel is None:
            use_run_accel = (config.force_model == "pm_grid"
                             and _uses_mesh(config, potential_mode))
        self.use_run_accel = bool(use_run_accel) and sync

    def _budget(self, state: ParticleState):
        """-> (pair_budget, sub_pair_budget) of the gauge's tree lists."""
        cfg = self._config
        budget, sub = cfg.p3m_pair_budget, cfg.p3m_sub_pair_budget
        if _uses_mesh(cfg, self._mode) and budget is None:
            if self._probed_budget is None:
                gg = _gauge_grid(cfg.num_particles, cfg.pm_grid_size)
                r_c, gn = p3m.near_grid_for(gg, cfg.pm_box,
                                            cfg.p3m_cutoff_cells)
                coarse, subc, _ = treeforce.host_tree_counts(
                    state.position.cpu().numpy(), cfg.pm_box, r_c, gn)
                head = treeforce.PAIR_HEADROOM
                self._probed_budget = int(coarse * head) + 1
                self._probed_sub = (None if subc is None
                                    else int(subc * head) + 2)
            budget = self._probed_budget
            if sub is None:
                sub = self._probed_sub
        return budget, sub

    def _build(self, state: ParticleState, external_accel: bool):
        budget, sub = self._budget(state)
        return make_diagnostics(self._config, sync=self._sync,
                                potential_mode=self._mode,
                                pair_budget=budget,
                                external_accel=external_accel,
                                sub_pair_budget=sub)

    def maybe_publish(self, frame_count: int, state: ParticleState, metrics,
                      accel: Optional[Tensor] = None) -> bool:
        if frame_count % self.every:
            return False
        with trace.span("diagnostics"):
            return self._publish(state, metrics, accel)

    def _publish(self, state: ParticleState, metrics,
                 accel: Optional[Tensor]) -> bool:
        t0 = time.perf_counter()
        if accel is None and self.use_run_accel:
            if self._run_accel is None:
                self._run_accel = integrator.make_accel_fn_for(self._config)
            accel = self._run_accel(state.position)
        if accel is not None:
            if self._fn_ext is None:
                self._fn_ext = self._build(state, external_accel=True)
            gauges = self._fn_ext(state, accel)
        else:
            if self._fn is None:
                self._fn = self._build(state, external_accel=False)
            gauges = self._fn(state)
        vals = {k: float(v) for k, v in gauges.items()}
        if self._e0 is None:
            self._e0 = vals["energy"]
        vals["energy_drift"] = (vals["energy"] - self._e0) / (
            abs(self._e0) or 1.0)
        self.sample_ms.append((time.perf_counter() - t0) * 1e3)
        for k, v in vals.items():
            metrics.gauge(k, v)
        metrics.gauge("diag_sample_ms", list(self.sample_ms))
        return True


__all__ = ["DiagnosticsProbe", "make_diagnostics", "mesh_potential_and_accel",
           "mesh_potential_only", "pairwise_potential_and_accel"]
