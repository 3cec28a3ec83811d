"""Particle-mesh (pm_grid) parity of the torch port against the JAX package.

Seeded numpy inputs go through `multi_adapter_particles_tpu.ops.pm` (jitted,
as its callers run it) and `multi_adapter_particles_torch.ops.pm`. The cell
geometry is bitwise: XLA compiles `x / h + c` into one fused multiply-add
with the float32 reciprocal, and the port evaluates exactly that. Segment
bounds are bitwise (both are `searchsorted(side='left')`). The deposit
agrees to 1e-4 counts: both take a float32 cumsum of the corner weights,
whose rounding at this size is ~1.5e-5 per cell and whose order differs.
Kernel spectra and accelerations agree to 1e-5 of their largest value:
two FFT libraries, and XLA's fused multiply-adds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multi_adapter_particles_tpu.config import SimConfig as JSimConfig
from multi_adapter_particles_tpu.models import integrator as jintegrator
from multi_adapter_particles_tpu.ops import pm as JPM

from multi_adapter_particles_torch.config import SimConfig
from multi_adapter_particles_torch.models import integrator
from multi_adapter_particles_torch.ops import pm

# The suite runs one xdist worker per core; torch's own thread pool on top
# only oversubscribes them.
torch.set_num_threads(1)

MASS = 70000.0
EPS2 = 25.0
BOX = 2048.0


def _scene(n, seed, spread=600.0):
    """[4, n] positions: a Gaussian blob plus a uniform spray, a few
    particles out of the box and the 1e9 parking of the state's padding."""
    rng = np.random.default_rng(seed)
    p = np.zeros((4, n), np.float32)
    p[:3, : n // 2] = rng.normal(100, spread / 4, (3, n // 2))
    p[:3, n // 2:] = rng.uniform(-spread, spread, (3, n - n // 2))
    p[:3, -4:-2] = 1500.0
    p[:3, -2:] = 1e9
    return p


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def test_segment_bounds_bitwise():
    rng = np.random.default_rng(7)
    ncell = 64
    keys = np.sort(rng.integers(0, ncell + 1, 500)).astype(np.int32)
    want = np.asarray(JPM._segment_bounds(jnp.asarray(keys), ncell))
    got = pm._segment_bounds(torch.from_numpy(keys).long(), ncell)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("g,box", [(32, 2048.0), (96, 2048.0), (192, 2048.0),
                                   (64, 4096.0)])
def test_cic_cells_bitwise(g, box):
    """Base cells, fractions and the in-box mask of the JAX function as it
    runs compiled, including particles one ulp either side of a cell edge
    (where a true division would floor differently at some h)."""
    rng = np.random.default_rng(g)
    p = rng.uniform(-1100, 1100, (4, 20000)).astype(np.float32)
    h = box / g
    k = rng.integers(1, g, 256)
    edge = ((k - g / 2 + 0.5) * h).astype(np.float32)
    p[0, :256] = np.nextafter(edge, np.float32(-np.inf))
    p[1, :256] = np.nextafter(edge, np.float32(np.inf))
    p[:3, -1] = 1e9
    wi0, wfrac, winside = (np.asarray(a) for a in jax.jit(
        lambda x: JPM._cic_cells(x, g, box))(p))
    i0, frac, inside = (t.numpy() for t in pm._cic_cells(
        torch.from_numpy(p), g, box))
    np.testing.assert_array_equal(inside, winside)
    # base cells and fractions wherever they address the grid (the port
    # clamps parked particles before converting to int; both mask them)
    on_grid = np.all((wi0 >= -1) & (wi0 <= g), axis=0)
    assert on_grid.sum() > 14000
    np.testing.assert_array_equal(i0[:, on_grid], wi0[:, on_grid])
    np.testing.assert_array_equal(frac[:, on_grid], wfrac[:, on_grid])


@pytest.mark.parametrize("g", [16, 32])
def test_deposit_matches_jax(g):
    p = _scene(1500, seed=g)
    want = np.asarray(JPM.deposit_cic(jnp.asarray(p), g, BOX))
    got = pm.deposit_cic(torch.from_numpy(p), g, BOX).numpy()
    assert got.shape == (g, g, g)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # mass of the particles inside the margin, and none of the rest
    inside = pm._cic_cells(torch.from_numpy(p), g, BOX)[2]
    assert got.sum() == pytest.approx(float(inside.sum()), rel=1e-5)


def test_deposit_single_particle_at_node():
    g = 32
    h = BOX / g
    p = np.zeros((4, 1), np.float32)
    p[:3, 0] = (np.array([5, 7, 9]) + 0.5 - g / 2) * h
    rho = pm.deposit_cic(torch.from_numpy(p), g, BOX).numpy()
    assert rho[9, 7, 5] == pytest.approx(1.0, rel=1e-6)   # [z, y, x]
    assert rho.sum() == pytest.approx(1.0, rel=1e-6)


def test_potential_kernel_spectrum_matches_jax():
    g = 16
    want = np.asarray(JPM._potential_kernel_rfft(g, BOX, EPS2))
    got = pm._potential_kernel_rfft(g, BOX, EPS2, torch.device("cpu"))
    assert got.dtype == torch.complex64 and got.shape == want.shape
    assert _rel(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("g", [16, 32])
def test_pm_accel_matches_jax(g):
    p = _scene(1536, seed=3 + g)
    want = np.asarray(JPM.pm_accel(jnp.asarray(p), grid=g, box=BOX,
                                   g_const=MASS, softening_squared=EPS2))
    got = pm.pm_accel(torch.from_numpy(p), grid=g, box=BOX, g_const=MASS,
                      softening_squared=EPS2).numpy()
    assert got.shape == (3, 1536)
    assert _rel(got, want) < 1e-5
    # outside the 1-cell margin: no PM force
    assert np.all(got[:, -4:] == 0.0)


def test_make_accel_fn_for_pm_grid_matches_jax():
    """The run's own force: g_const = mass * interaction_scale."""
    n = 1024
    p = _scene(n, seed=1)
    kw = dict(num_particles=n, force_model="pm_grid", pm_grid_size=32)
    want = np.asarray(jintegrator.make_accel_fn_for(JSimConfig(**kw))(
        jnp.asarray(p)))
    got = integrator.make_accel_fn_for(SimConfig(**kw))(
        torch.from_numpy(p)).numpy()
    assert _rel(got, want) < 1e-5


def test_pm_step_matches_jax():
    """Three steps of the pm_grid integrator from the same state."""
    n = 1024
    p = _scene(n, seed=2)
    v = np.random.default_rng(2).normal(0, 1, (3, n)).astype(np.float32)
    kw = dict(num_particles=n, force_model="pm_grid", pm_grid_size=16)
    from multi_adapter_particles_tpu.models.state import ParticleState as JS

    from multi_adapter_particles_torch.models.state import ParticleState

    jstep = jintegrator.make_step(JSimConfig(**kw), donate=False)
    tstep = integrator.make_step(SimConfig(**kw))
    js = JS(jnp.asarray(p), jnp.asarray(v))
    ts = ParticleState.from_numpy(p, v)
    for _ in range(3):
        js, ts = jstep(js), tstep(ts)
    tpos, tvel = ts.to_numpy()
    np.testing.assert_allclose(tpos, np.asarray(js.position), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(tvel, np.asarray(js.velocity), rtol=2e-5,
                               atol=2e-5)
