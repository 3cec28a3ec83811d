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


# -- the mesh's spans and its count of particles outside it -------------------

def _pm_sim(n, g=32):
    return SimConfig(num_particles=n, force_model="pm_grid", pm_grid_size=g,
                     pm_box=BOX)


def _planted(n, seed=5):
    """(state of n particles, the state's padding past n parked at 1e9, the
    number planted outside the margin of a G = 32 mesh over BOX (interior
    [-928, 928) on every axis): one past each face, one far away; one
    exactly on the lower face is inside)."""
    from multi_adapter_particles_torch.models.init import (
        initialize_particles_device,
    )

    state = initialize_particles_device(
        n, generator=torch.Generator().manual_seed(seed))
    p = state.position
    p[0, 0] = 950.0       # base cell 30 > G - 3
    p[1, 1] = -930.0      # base cell 0 < 1
    p[2, 2] = 1.0e5
    p[0, 3] = -928.0      # base cell 1: inside
    return state, 3


@pytest.mark.parametrize("n", [1000, 1024])
def test_pm_outside_counts_the_particles_off_the_mesh(n):
    from multi_adapter_particles_torch.models.state import ParticleState

    state, planted = _planted(n)
    assert state.padded_count == 1024     # 24 columns of padding at n=1000
    step = integrator.make_step(_pm_sim(n))
    step(state)
    inside = pm._cic_cells(state.position, 32, BOX)[2]
    assert int(step.accel_fn.outside) == planted == int((~inside[:n]).sum())
    # a step of a state all inside counts 0 again
    p = state.position.clone()
    p[:3, :4] = 0.0
    step(ParticleState(p, state.velocity))
    assert int(step.accel_fn.outside) == 0


def test_pm_outside_stays_a_device_tensor(monkeypatch):
    """One 0-d int64 tensor on the state's device, refilled in place by
    every step (a captured step keeps it), and no host read in the step."""
    state, planted = _planted(1000)
    step = integrator.make_step(_pm_sim(1000))
    step(state)
    kept = step.accel_fn.outside

    def refuse(*args, **kwargs):
        raise AssertionError("a host read in the step")

    for name in ("item", "tolist", "__int__", "__float__", "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    step(state)
    step(state)
    monkeypatch.undo()
    assert step.accel_fn.outside is kept
    assert kept.dim() == 0 and kept.dtype == torch.int64
    assert kept.device == state.position.device and int(kept) == planted


def _pm_app(fused, n=1000):
    from multi_adapter_particles_torch.config import AppConfig, RenderConfig
    from multi_adapter_particles_torch.runtime import devices
    from multi_adapter_particles_torch.runtime.orchestrator import ParticlesApp

    return ParticlesApp(
        AppConfig(num_particles=n, vsync=True, gui=False),
        _pm_sim(n), RenderConfig(width=64, height=64),
        compute_adapter=devices.cpu_adapter_index(), fused=fused)


@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused"])
def test_pm_spans_nest_in_the_step(fused):
    """An eager pm_grid step opens `pm.deposit`, `pm.solve` and
    `pm.interp`, once each and in that order, directly inside `step`."""
    from multi_adapter_particles_torch.runtime import trace

    app = _pm_app(fused)
    app.draw()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        app.draw()
    app.shutdown()
    ranges = [(ev.name()[len(trace.PREFIX):], ev.start_ns(),
               ev.start_ns() + ev.duration_ns())
              for ev in prof.profiler.kineto_results.events()
              if ev.is_user_annotation()
              and ev.name().startswith(trace.PREFIX)]
    phases = [r for r in ranges if r[0].startswith("pm.")]
    assert [r[0] for r in sorted(phases, key=lambda r: r[1])] == [
        "pm.deposit", "pm.solve", "pm.interp"]
    for r in phases:
        around = [o for o in ranges if o is not r
                  and o[1] <= r[1] and r[2] <= o[2]]
        assert min(around, key=lambda o: o[2] - o[1])[0] == "step"


@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused"])
def test_pm_outside_gauge(fused):
    """`shutdown()` publishes the last step's count; fused frames also
    carry it in `present()`'s one read."""
    app = _pm_app(fused)
    app.compute.restore(_planted(1000)[0])
    app.draw()
    if fused:
        assert app.metrics.gauges["pm_outside"] == 3
    app.draw()
    app.shutdown()
    # a second step moves each by v dt (|v| = 15, dt = 0.1): still outside
    assert app.metrics.gauges["pm_outside"] == 3


def test_pm_scan_ms_reads_the_deposit_scan():
    """The benchmark's reader: nothing where the breakdown holds no float
    scan, else that scan's device ms a frame (an integer scan, as the
    render's, is not read)."""
    from benchmark import harness

    read = harness.metric("pm_scan_ms").read
    ops = [["tile_rows_kernel", 0.004],
           ["void at::native::tensor_kernel_scan_innermost_dim<long, "
            "std::plus<long> >(long*, long const*)", 0.002]]
    assert read({"trace": {"frames": 4, "device_ops": ops}}) is None
    ops.append(["void at::native::tensor_kernel_scan_innermost_dim<float, "
                "std::plus<float> >(float*, float const*, unsigned int)",
                0.028])
    assert read({"trace": {"frames": 0, "device_ops": ops}}) is None
    assert read({"trace": {"frames": 4, "device_ops": ops}}) == (
        pytest.approx(7.0))
