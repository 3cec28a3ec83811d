"""The port's host init tiers against the JAX package's.

Mirrors tests/test_oracle.py, tests/test_native.py and
tests/test_init.py::test_host_init_roundtrip: the port's own NumPy oracle
(`models/oracle.py`) and its native engine (`native/fastinit.cpp`, built
with g++ at first use) are held bitwise against the JAX package's oracle
for several seeds (n <= 512: the oracle is per-particle Python); native
'orig' is deterministic and on the radius-400 shell; chunked runs are
deterministic; `initialize_particles_host(device="cpu")` is bitwise the
JAX `initialize_particles_host`; one central-well step of the port's plain
twin on that state matches the JAX step at tests/test_torch_ops.py's
tolerance (rtol = atol = 2e-5). A native build that fails raises with the
compiler's output. No wall-clock gate: speed is measured on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multi_adapter_particles_tpu.config import SimConfig as JSimConfig
from multi_adapter_particles_tpu.models import init as jinit
from multi_adapter_particles_tpu.models import integrator as jintegrator
from multi_adapter_particles_tpu.models import oracle as joracle
from multi_adapter_particles_tpu.models.state import ParticleState as JState

from multi_adapter_particles_torch import constants as C
from multi_adapter_particles_torch.models import init as pinit
from multi_adapter_particles_torch.models import oracle
from multi_adapter_particles_torch.native import fastinit
from multi_adapter_particles_torch.ops import _build
from multi_adapter_particles_torch.ops.central_well import (
    central_well_step_plain,
)

torch.set_num_threads(1)

N = 512
SEEDS = (0, 7, 12345)
PHYS = dict(dt=C.TIMESTEP, damping=C.DAMPING, mass=C.PARTICLE_MASS,
            softening_squared=C.SOFTENING_SQUARED)


def _equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


class TestRngTiers:
    @pytest.mark.parametrize("seed", SEEDS)
    def test_fast_rand_stream_is_the_jax_oracles(self, seed):
        a, b = oracle.FastRand(seed), joracle.FastRand(seed)
        assert [a.next() for _ in range(200)] == [b.next()
                                                  for _ in range(200)]
        np.testing.assert_array_equal(a.uniform3(), b.uniform3())

    @pytest.mark.parametrize("seed", SEEDS)
    def test_rand_sse_stream_is_the_jax_oracles(self, seed):
        a, b = oracle.RandSse(seed), joracle.RandSse(seed)
        for _ in range(50):
            np.testing.assert_array_equal(a.next4(), b.next4())
        np.testing.assert_array_equal(a.uniform4(), b.uniform4())

    def test_fast_rand_sequence(self):
        r = oracle.FastRand(0)
        state, outs = 0, []
        for _ in range(5):
            state = (214013 * state + 2531011) & 0xFFFFFFFF
            outs.append((state >> 16) & 0x7FFF)
        assert [r.next() for _ in range(5)] == outs


@pytest.mark.parametrize("variant", ["orig", "scalar", "simd"])
class TestOracle:
    @pytest.mark.parametrize("seed", SEEDS)
    def test_bitwise_jax_oracle(self, variant, seed):
        _equal(oracle.initialize_particles(N, variant=variant, seed=seed),
               joracle.initialize_particles(N, variant=variant, seed=seed))

    def test_cluster_geometry(self, variant):
        center = (C.CLUSTER_CENTER_X, 0.0, 0.0)
        pos, vel = oracle.load_particles(200, center, variant=variant,
                                         seed=5)
        assert pos.dtype == np.float32 and vel.dtype == np.float32
        radii = np.linalg.norm(pos[:, :3] - np.float32(center), axis=1)
        np.testing.assert_allclose(radii, C.PARTICLE_SPREAD, rtol=1e-5)
        assert np.all(pos[:, 3] == 0.0)


@pytest.mark.parametrize("variant", ["scalar", "simd"])
@pytest.mark.parametrize("seed", SEEDS)
def test_native_bitwise_jax_oracle(variant, seed):
    """The -ffp-contract=off contract: chunks=1 is the oracle's stream and
    roundings, bit for bit."""
    _equal(fastinit.initialize_particles(N, variant=variant, seed=seed),
           joracle.initialize_particles(N, variant=variant, seed=seed))


def test_native_orig_deterministic_and_on_shell():
    p1, v1 = fastinit.initialize_particles(N, variant="orig", seed=3)
    p2, v2 = fastinit.initialize_particles(N, variant="orig", seed=3)
    _equal((p1, v1), (p2, v2))
    half = N // 2
    for sl, cx in ((slice(0, half), 300.0), (slice(half, N), -300.0)):
        d = p1[sl, :3] - np.array([cx, 0, 0], dtype=np.float32)
        np.testing.assert_allclose(np.linalg.norm(d, axis=1), 400.0,
                                   rtol=1e-5)
    speeds = np.linalg.norm(v1, axis=1)
    assert np.all(speeds <= 15.0 + 1e-3) and speeds.mean() > 5.0
    dirs = p1[:, :3] / np.linalg.norm(p1[:, :3], axis=1, keepdims=True)
    assert np.abs(np.sum(dirs * v1, axis=1)).max() < 1e-3


@pytest.mark.parametrize("variant", ["scalar", "simd", "orig"])
def test_native_chunks_deterministic(variant):
    a = fastinit.initialize_particles(N, variant=variant, seed=1, chunks=4)
    b = fastinit.initialize_particles(N, variant=variant, seed=1, chunks=4)
    _equal(a, b)
    # per-chunk seeds: another stream than the sequential one, same shell
    assert not np.array_equal(
        a[0], fastinit.initialize_particles(N, variant=variant, seed=1)[0])
    d = a[0][:N // 2, :3] - np.array([300.0, 0, 0], dtype=np.float32)
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 400.0, rtol=1e-5)


def test_native_rejects_unknown_variant():
    with pytest.raises(ValueError, match="native init failed"):
        fastinit.initialize_particles(64, variant="sse4")


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A source g++ cannot compile raises with the compiler's output, and
    leaves no library behind."""
    monkeypatch.setattr(_build, "_build_dir", tmp_path)
    bad = tmp_path / "broken.cpp"
    bad.write_text("int f( { return 0; }\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for broken.cpp"):
        _build.build_host(bad)
    assert not list(tmp_path.glob("*.so"))


def test_native_without_compiler_raises(tmp_path, monkeypatch):
    """No g++: the first use raises; nothing falls through to the oracle."""
    monkeypatch.setattr(_build, "_build_dir", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    fastinit._lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            pinit.initialize_particles_host(64, variant="scalar",
                                            device="cpu")
    finally:
        fastinit._lib.cache_clear()


def test_native_library_is_keyed_by_source_and_flags(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "_build_dir", tmp_path)
    lib = _build.build_host(fastinit.SOURCE)
    assert lib.parent == tmp_path and lib.name.startswith("fastinit-")
    assert _build.build_host(fastinit.SOURCE) == lib  # built once
    copy = tmp_path / "fastinit.cpp"
    copy.write_text(fastinit.SOURCE.read_text() + "\n// edited\n")
    assert _build.build_host(copy) != lib


class TestInitializeParticlesHost:
    @pytest.mark.parametrize("variant,use_native", [
        ("orig", None), ("scalar", None), ("simd", None),
        ("scalar", False), ("simd", False),
    ])
    def test_bitwise_jax_host_init(self, variant, use_native):
        n = 300
        got = pinit.initialize_particles_host(n, variant=variant, seed=4,
                                              use_native=use_native,
                                              device="cpu")
        want = jinit.initialize_particles_host(n, variant=variant, seed=4,
                                               use_native=use_native)
        np.testing.assert_array_equal(got.position.numpy(),
                                      np.asarray(want.position))
        np.testing.assert_array_equal(got.velocity.numpy(),
                                      np.asarray(want.velocity))
        assert got.position.device.type == "cpu"

    def test_roundtrip_to_oracle(self):
        n = 200
        st = pinit.initialize_particles_host(n, variant="scalar", seed=4,
                                             use_native=False, device="cpu")
        _equal(st.to_aos(n), oracle.initialize_particles(n, "scalar", 4))

    def test_native_orig_when_forced(self):
        st = pinit.initialize_particles_host(N, variant="orig", seed=3,
                                             use_native=True, device="cpu")
        _equal(st.to_aos(N), fastinit.initialize_particles(N, "orig", 3))

    def test_never_the_cpu_unasked(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pinit.initialize_particles_host(64, variant="scalar")

    @pytest.mark.parametrize("variant", ["scalar", "simd"])
    def test_central_well_step_matches_jax(self, variant):
        """The first init the two packages share bit for bit, stepped once
        by each."""
        n = 1000
        st = pinit.initialize_particles_host(n, variant=variant, seed=9,
                                             device="cpu")
        js = jinit.initialize_particles_host(n, variant=variant, seed=9)
        jnew = jintegrator.make_step(JSimConfig(num_particles=n),
                                     donate=False)(
            JState(jnp.asarray(js.position), jnp.asarray(js.velocity)))
        tp, tv = central_well_step_plain(st.position, st.velocity, **PHYS)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jnew.position),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jnew.velocity),
                                   rtol=2e-5, atol=2e-5)
