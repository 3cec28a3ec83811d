"""Kernel parity of the torch port: each kernel's plain torch twin against
the JAX package's Pallas kernel (interpret mode on the CPU, as
tests/test_ops.py and tests/test_render.py run it). The CUDA kernels
themselves are held against their twins on the card by chip_smoke.py.

Inputs are made with seeded numpy and handed to both packages."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multi_adapter_particles_tpu import constants as JC
from multi_adapter_particles_tpu.config import SimConfig as JSimConfig
from multi_adapter_particles_tpu.models import integrator as jintegrator
from multi_adapter_particles_tpu.models import oracle
from multi_adapter_particles_tpu.models.state import ParticleState as JState
from multi_adapter_particles_tpu.ops.central_well import central_well_step_pallas
from multi_adapter_particles_tpu.ops.composite import composite_rows_pallas

from multi_adapter_particles_torch import constants as C
from multi_adapter_particles_torch.config import SimConfig
from multi_adapter_particles_torch.models import integrator
from multi_adapter_particles_torch.models.state import ParticleState
from multi_adapter_particles_torch.ops.central_well import (
    central_well_step,
    central_well_step_plain,
)
from multi_adapter_particles_torch.ops.composite import (
    composite_rows,
    composite_rows_plain,
)

# The suite runs one xdist worker per core; torch's own thread pool on top
# only oversubscribes them.
torch.set_num_threads(1)

PHYS =dict(dt=C.TIMESTEP, damping=C.DAMPING, mass=C.PARTICLE_MASS,
            softening_squared=C.SOFTENING_SQUARED)


def _oracle_planes(n, seed):
    pos, vel = oracle.initialize_particles(n, variant="scalar", seed=seed)
    st = JState.from_aos(pos, vel)
    return np.array(st.position), np.array(st.velocity)


def _composite_inputs(seed=0, q=32, v=1100):
    """test_render.py's row_hi shapes: random live windows and a dead tail;
    slots past each row's bound carry alpha scale 0."""
    rng = np.random.default_rng(seed)
    sp = rng.uniform(-3, 3, size=(8, q, v)).astype(np.float32)
    hi = rng.integers(0, q + 1, size=v).astype(np.int32)
    hi[900:] = 0
    kk = np.arange(q)[:, None]
    sp[7] = np.where(kk < hi[None, :], np.abs(sp[7]), 0.0)
    bases = rng.uniform(0, 64, size=(2, v)).astype(np.float32)
    return sp, bases, hi


class TestCentralWellTwin:
    @pytest.mark.parametrize("n,seed", [(2048, 0), (1000, 1)])
    def test_plain_matches_pallas(self, n, seed):
        """N = 2048, and a count that is not a multiple of 128 (padded
        columns ride along parked)."""
        pos, vel = _oracle_planes(n, seed)
        jp, jv = central_well_step_pallas(
            jnp.asarray(pos), jnp.asarray(vel), JC.TIMESTEP, JC.DAMPING,
            JC.PARTICLE_MASS, JC.SOFTENING_SQUARED,
        )
        tp, tv = central_well_step_plain(
            torch.from_numpy(pos), torch.from_numpy(vel), **PHYS
        )
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv),
                                   rtol=2e-5, atol=2e-5)

    def test_wrapper_on_cpu_is_the_twin(self):
        pos, vel = _oracle_planes(300, 2)
        before = central_well_step.launches
        a = central_well_step(torch.from_numpy(pos), torch.from_numpy(vel),
                              **PHYS)
        b = central_well_step_plain(torch.from_numpy(pos),
                                    torch.from_numpy(vel), **PHYS)
        assert central_well_step.launches == before  # no kernel launch
        for x, y in zip(a, b):
            assert torch.equal(x, y)

    @pytest.mark.parametrize("num_sim", [1, 64, 65, 1000, 1999])
    def test_num_sim_freeze_bitwise(self, num_sim):
        """The freeze (num_sim rounded up to 64, the rest copied through)
        is bitwise equal to the JAX package's `_apply_num_sim_mask`, in the
        kernel's twin and in the plain integrator step."""
        n = 2048
        pos, vel = _oracle_planes(n, 3)
        jnew = jintegrator.make_step(
            JSimConfig(num_particles=n), donate=False,
        )(JState(jnp.asarray(pos), jnp.asarray(vel)), num_sim)
        live = integrator.live_count(num_sim, pos.shape[1])
        assert live == min(-(-num_sim // 64) * 64, pos.shape[1])
        tp, tv = central_well_step_plain(
            torch.from_numpy(pos), torch.from_numpy(vel), num_live=live,
            **PHYS,
        )
        jp, jv = np.asarray(jnew.position), np.asarray(jnew.velocity)
        # the frozen tail is the input, bit for bit, in both packages
        np.testing.assert_array_equal(tp.numpy()[:, live:], pos[:, live:])
        np.testing.assert_array_equal(tv.numpy()[:, live:], vel[:, live:])
        np.testing.assert_array_equal(jp[:, live:], tp.numpy()[:, live:])
        np.testing.assert_array_equal(jv[:, live:], tv.numpy()[:, live:])
        np.testing.assert_allclose(tp.numpy()[:, :live], jp[:, :live],
                                   rtol=2e-5, atol=2e-5)
        # the plain integrator step's freeze into a preallocated buffer
        st = ParticleState.from_numpy(pos, vel)
        out = st.empty_like()
        res = integrator.make_step(SimConfig(num_particles=n))(
            st, num_sim, out=out)
        assert res is out
        np.testing.assert_array_equal(out.position.numpy()[:, live:],
                                      pos[:, live:])
        np.testing.assert_array_equal(out.velocity.numpy()[:, live:],
                                      vel[:, live:])

    def test_integrator_matches_jax_integrator(self):
        """The plain step (the compute engine's CPU path) tracks the JAX
        package's integrator over 20 steps."""
        n = 1024
        pos, vel = _oracle_planes(n, 4)
        jstep = jintegrator.make_step(
            JSimConfig(num_particles=n), donate=False)
        tstep = integrator.make_step(SimConfig(num_particles=n))
        js = JState(jnp.asarray(pos), jnp.asarray(vel))
        ts = ParticleState.from_numpy(pos, vel)
        for _ in range(20):
            js = jstep(js)
            ts = tstep(ts)
        np.testing.assert_allclose(ts.position.numpy(), np.asarray(js.position),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(ts.velocity.numpy(), np.asarray(js.velocity),
                                   rtol=2e-5, atol=2e-5)

    def test_force_models_not_ported_raise(self):
        for model in ("all_pairs", "pm_grid", "p3m"):
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                integrator.make_step(SimConfig(num_particles=256,
                                               force_model=model))


class TestCompositeTwin:
    @pytest.mark.parametrize("blend", ["over", "additive"])
    def test_plain_matches_pallas(self, blend):
        sp, bases, hi = _composite_inputs()
        want = np.asarray(composite_rows_pallas(
            jnp.asarray(sp), jnp.asarray(bases), 8, 16, blend=blend,
            row_hi=jnp.asarray(hi),
        ))
        got = composite_rows_plain(
            torch.from_numpy(sp), torch.from_numpy(bases), 8, 16,
            blend=blend, row_hi=torch.from_numpy(hi),
        ).numpy()
        assert got.shape == want.shape == (4, 128, 1100)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("blend", ["over", "additive"])
    def test_row_hi_trip_bound_bitwise(self, blend):
        """Stopping at the rows' live bound equals the full-Q loop bit for
        bit (zero-alpha slots are an exact identity)."""
        sp, bases, hi = _composite_inputs(seed=1)
        args = (torch.from_numpy(sp), torch.from_numpy(bases), 8, 16)
        full = composite_rows_plain(*args, blend=blend)
        trip = composite_rows_plain(*args, blend=blend,
                                    row_hi=torch.from_numpy(hi))
        assert torch.equal(full, trip)

    def test_wrapper_on_cpu_is_the_twin(self):
        sp, bases, hi = _composite_inputs(seed=2, q=8, v=300)
        args = (torch.from_numpy(sp), torch.from_numpy(bases), 8, 16)
        before = composite_rows.launches
        a = composite_rows(*args, row_hi=torch.from_numpy(hi))
        b = composite_rows_plain(*args, row_hi=torch.from_numpy(hi))
        assert composite_rows.launches == before
        assert torch.equal(a, b)

    def test_unknown_blend_raises(self):
        sp, bases, _ = _composite_inputs(seed=3, q=8, v=16)
        with pytest.raises(ValueError, match="blend"):
            composite_rows(torch.from_numpy(sp), torch.from_numpy(bases),
                           8, 16, blend="max")
