"""The port's main path against the JAX package's, end to end on the CPU.

Both `ParticlesApp`s run the split frame loop (draw the stale-by-one state,
step, present) with -novsync semantics from the SAME initial state: the
JAX app's device init, handed across with `ParticleState.from_numpy`.
Final state: rtol/atol 2e-5; last frame: 2e-3 (the golden tolerance,
tests/test_render.py). The decoupled counts' frozen sim tail and stale
copy tail are bitwise."""

import numpy as np
import pytest
import torch

from multi_adapter_particles_tpu.config import (
    AppConfig as JAppConfig,
    RenderConfig as JRenderConfig,
    SimConfig as JSimConfig,
)
from multi_adapter_particles_tpu.runtime import ParticlesApp as JApp

from multi_adapter_particles_torch.config import (
    AppConfig,
    RenderConfig,
    SimConfig,
)
from multi_adapter_particles_torch.models.state import ParticleState
from multi_adapter_particles_torch.runtime.devices import cpu_adapter_index
from multi_adapter_particles_torch.runtime.orchestrator import ParticlesApp

# The suite runs one xdist worker per core; torch's own thread pool on top
# only oversubscribes them.
torch.set_num_threads(1)

N = 2048
FRAMES = 8
# both roles on the CPU adapter, named: the port runs nowhere unasked
CPU = dict(compute_adapter=cpu_adapter_index(),
           render_adapter=cpu_adapter_index())


def _app_kw(**counts):
    return dict(num_particles=N, particle_size=40.0, vsync=False, gui=False,
                **counts)


def _pair(**counts):
    japp = JApp(JAppConfig(**_app_kw(**counts)), JSimConfig(num_particles=N),
                JRenderConfig(width=64, height=64), async_timers=False)
    tapp = ParticlesApp(AppConfig(**_app_kw(**counts)),
                        SimConfig(num_particles=N),
                        RenderConfig(width=64, height=64), **CPU)
    pos0 = np.array(japp.compute.state.position)
    vel0 = np.array(japp.compute.state.velocity)
    tapp.compute.restore(ParticleState.from_numpy(pos0, vel0))
    tapp.share_handles()
    return japp, tapp, pos0, vel0


def _run(app):
    for _ in range(FRAMES):
        app.draw()
    app.shutdown()


def test_split_frame_loop_matches_jax():
    japp, tapp, _, _ = _pair()
    assert tapp.async_mode  # one device: the zero-copy async-compute mode
    _run(japp)
    _run(tapp)
    assert tapp.compute.get_fence_value() == japp.compute.get_fence_value()
    tpos, tvel = tapp.compute.state.to_numpy()
    np.testing.assert_allclose(tpos, np.asarray(japp.compute.state.position),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(tvel, np.asarray(japp.compute.state.velocity),
                               rtol=2e-5, atol=2e-5)
    jframe = np.asarray(japp.render.last_frame)
    tframe = tapp.render.last_frame.numpy()
    assert tframe.max() > 0
    np.testing.assert_allclose(tframe, jframe, rtol=0, atol=2e-3)
    out = tapp.render.last_output
    assert int(out.truncated) == int(japp.render._frame.truncated) == 0
    assert tapp.metrics.counters["frames"] == FRAMES


def test_decoupled_counts_match_jax():
    """num_sim / num_copy / num_draw below N: the frozen sim tail and the
    stale copy tail are bitwise equal to the JAX app's."""
    counts = dict(linked=False, num_sim=1000, num_copy=1500, num_draw=1200)
    japp, tapp, pos0, vel0 = _pair(**counts)
    _run(japp)
    _run(tapp)
    live = -(-1000 // 64) * 64
    tpos, tvel = tapp.compute.state.to_numpy()
    jpos = np.asarray(japp.compute.state.position)
    jvel = np.asarray(japp.compute.state.velocity)
    np.testing.assert_array_equal(tpos[:, live:], pos0[:, live:])
    np.testing.assert_array_equal(tvel[:, live:], vel0[:, live:])
    np.testing.assert_array_equal(tpos[:, live:], jpos[:, live:])
    np.testing.assert_array_equal(tvel[:, live:], jvel[:, live:])
    np.testing.assert_allclose(tpos[:, :live], jpos[:, :live],
                               rtol=2e-5, atol=2e-5)
    # the render engine's local buffer: copied head, stale (parked) tail
    nc = -(-1500 // 128) * 128
    tloc = tapp.render._local.numpy()
    jloc = np.asarray(japp.render._local)
    np.testing.assert_array_equal(tloc[:, nc:], jloc[:, nc:])
    np.testing.assert_allclose(tloc[:, :nc], jloc[:, :nc],
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(tapp.render.last_frame.numpy(),
                               np.asarray(japp.render.last_frame),
                               rtol=0, atol=2e-3)
    assert tapp.metrics.counters["transfer_bytes"] == FRAMES * nc * 16.0


def test_live_reassignment_keeps_trajectory():
    """A compute-adapter change (drain + CopyState) continues the same
    trajectory as an undisturbed run."""
    a = ParticlesApp(AppConfig(**_app_kw()), SimConfig(num_particles=N),
                     RenderConfig(width=64, height=64), **CPU)
    b = ParticlesApp(AppConfig(**_app_kw()), SimConfig(num_particles=N),
                     RenderConfig(width=64, height=64), **CPU)
    for i in range(4):
        a.draw()
        b.draw()
        if i == 1:  # re-assign to the same (only) adapter: forces a rebuild
            b._prev_compute_index = -1
            b._prev_render_index = -1
    a.shutdown()
    b.shutdown()
    assert torch.equal(a.compute.state.position, b.compute.state.position)
    assert b.compute.get_fence_value() == 4


@pytest.mark.parametrize("kw", [dict(fused=True, mesh_devices=2),
                                dict(mesh_devices=2),
                                dict(shard_render=True),
                                dict(debug=True, shard_render=True)])
def test_later_slices_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ParticlesApp(AppConfig(num_particles=256), **kw)
