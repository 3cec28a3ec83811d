"""The all-pairs A/B variants of the torch port against the JAX package's
`experiments/allpairs_*.py`.

The CUDA kernels (`csrc/allpairs_variants.cu`) are held against their plain
twins on the card by chip_smoke.py; here each twin is held against its JAX
variant in Pallas interpret mode (the experiments modules are loaded by
their path in the repository), at the JAX harnesses' sizes: n = 4,096 for
unroll (tj = 2048 needs an even tile count), 1,536 for hybrid (three tiles
of 512), 2,048 for the rest.

Tolerances, as max |twin - JAX| over (ax, ay, az, |a|) in units of
max |a|:

- 1e-5 on the demo scene (uniform in ±400) for the elementwise forms
  (attr, unroll, v4: the same terms summed in another order, measured
  ~3e-7, the bound tests/test_torch_allpairs.py holds v0 to);
- 1e-5 (mm_bf16: 2e-5) for the expansion forms on a compact copy of that
  scene (|p| <= 4), where d² cannot cancel (measured <= 7e-7; 6e-6 for
  mm_bf16, whose s rounds to bf16 and can land on the other side of a
  rounding boundary);
- 1e-2 for the expansion forms on the demo scene: there d² = r_i² + r_j² -
  2 p_i·p_j cancels ~1e5 down to ~eps2 = 25, which multiplies any
  difference in the order of the float32 sums (measured 3e-4 to 2.7e-3;
  the variants differ from v0 by up to 8e-4 on the TPU's own harness).

The CPU interpreter computes a matmul in float32 whatever its `precision`,
so the twins' "highest" forms are held against the JAX functions, and
their "default" (one bf16 pass) forms against bf16 casts made on the JAX
side. Inputs are seeded numpy, handed to both packages.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multi_adapter_particles_torch import constants as C
from multi_adapter_particles_torch.ops import allpairs_variants as V
from multi_adapter_particles_torch.tools import allpairs_variants as harness

# The suite runs one xdist worker per core; torch's own thread pool on top
# only oversubscribes them.
torch.set_num_threads(1)

EXPERIMENTS = Path(__file__).resolve().parents[1] / "experiments"


def _load(name):
    """An experiments module by its path (its own sys.path line names a
    fixed checkout, so it is not relied on)."""
    spec = importlib.util.spec_from_file_location(
        f"_experiments_{name}", EXPERIMENTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def exp():
    return {n: _load(f"allpairs_{n}") for n in
            ("v2", "unroll", "variants", "v3", "hybrid", "planeacc")}


def _pos(n, scale=1.0, seed=0):
    """[4, n] uniform in ±400 (the JAX harnesses' scene), w = 0, times
    `scale`."""
    p = np.random.default_rng(seed).uniform(
        -400.0, 400.0, size=(4, n)).astype(np.float32)
    p[3] = 0.0
    p[:3] *= np.float32(scale)
    return p


def _assert_rel(got, want, rel):
    """max |got - want| <= rel * max |a| (rows or columns of 4)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    a = want[:3] if want.shape[0] == 4 else want[:, :3]
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(a).max(), err / np.abs(a).max()


def _twin(fn, p, **kw):
    return fn(torch.from_numpy(p), **kw).numpy()


COMPACT = 0.01   # |p| <= 4: no cancellation in d²


class TestElementwiseTwins:
    @pytest.mark.parametrize("mode", V.ATTR_MODES)
    def test_attr(self, exp, mode):
        p = _pos(2048)
        want = exp["v2"].attr_accel(jnp.asarray(p), mode)
        got = _twin(V.attr_accel_plain, p, mode=mode)
        assert got.shape == (2048, 4)
        _assert_rel(got, want, 1e-5)

    def test_unroll(self, exp):
        p = _pos(4096)
        _assert_rel(_twin(V.unroll_accel_plain, p),
                    exp["unroll"].unroll_accel(jnp.asarray(p)), 1e-5)

    def test_v4(self, exp):
        p = _pos(2048)
        got = _twin(V.v4_accel_plain, p)
        assert got.shape == (2048, 4)
        _assert_rel(got, exp["planeacc"].v4_accel(jnp.asarray(p)), 1e-5)


class TestExpansionTwins:
    @pytest.mark.parametrize("precision", V.PRECISIONS)
    def test_v1b(self, exp, precision):
        """The JAX function at either precision (float32 on the CPU)
        against the twin's float32 ("highest") form."""
        for scale, rel in ((COMPACT, 1e-5), (1.0, 1e-2)):
            p = _pos(2048, scale)
            want = exp["v2"].v1b_accel(jnp.asarray(p), precision=precision)
            _assert_rel(_twin(V.v1b_accel_plain, p, precision="highest"),
                        want, rel)

    def test_v1(self, exp):
        for scale, rel in ((COMPACT, 1e-5), (1.0, 1e-2)):
            p = _pos(2048, scale)
            _assert_rel(_twin(V.v1_accel_plain, p, precision="highest"),
                        exp["variants"].v1_accel(jnp.asarray(p)), rel)

    @pytest.mark.parametrize("force_path", V.FORCE_PATHS)
    def test_v3(self, exp, force_path):
        """bf16 splits are explicit casts on both sides."""
        tight = 2e-5 if force_path == "mm_bf16" else 1e-5
        for scale, rel in ((COMPACT, tight), (1.0, 1e-2)):
            p = _pos(2048, scale)
            want = exp["v3"].v3_accel(jnp.asarray(p), force_path=force_path)
            _assert_rel(_twin(V.v3_accel_plain, p, force_path=force_path),
                        want, rel)

    @pytest.mark.parametrize("force_path", V.FORCE_PATHS)
    def test_v3_tj1024(self, exp, force_path):
        """The JAX harness's other j-tile (`allpairs_v3.py:203`), at
        test_v3's tolerances."""
        tight = 2e-5 if force_path == "mm_bf16" else 1e-5
        for scale, rel in ((COMPACT, tight), (1.0, 1e-2)):
            p = _pos(2048, scale)
            want = exp["v3"].v3_accel(jnp.asarray(p), tj=1024,
                                      force_path=force_path)
            _assert_rel(_twin(V.v3_accel_plain, p, tj=1024,
                              force_path=force_path), want, rel)

    def test_hybrid(self, exp):
        for scale, rel in ((COMPACT, 1e-5), (1.0, 1e-2)):
            p = _pos(1536, scale)
            _assert_rel(_twin(V.hybrid_accel_plain, p),
                        exp["hybrid"].hybrid_accel(jnp.asarray(p)), rel)


def _jax_bf16_v1b(p):
    """v1b's body at one bf16 pass (TPU DEFAULT), written with explicit
    jnp.bfloat16 casts: all targets against all sources at once."""
    bf, f32 = jnp.bfloat16, jnp.float32
    pi3 = p[:3]
    ones = jnp.ones((1, p.shape[1]), f32)
    r2 = jnp.sum(pi3 * pi3, axis=0, keepdims=True)
    vi = jnp.concatenate([pi3, ones]).astype(bf)
    wj = jnp.concatenate([-2.0 * pi3, r2]).astype(bf)
    d2 = jax.lax.dot_general(wj, vi, (((0,), (0,)), ((), ())),
                             preferred_element_type=f32)
    d2 = d2 + (r2 + C.SOFTENING_SQUARED)
    inv = jax.lax.rsqrt(d2)
    s = (inv * inv * inv).astype(bf)
    f = jax.lax.dot_general(jnp.concatenate([pi3, ones]).astype(bf), s,
                            (((1,), (0,)), ((), ())),
                            preferred_element_type=f32)
    a3 = f32(C.PARTICLE_MASS) * (f[:3] - pi3 * f[3:4])
    return jnp.concatenate([a3, jnp.sqrt(jnp.sum(a3 * a3, axis=0,
                                                 keepdims=True))])


def _jax_bf16_v1(p):
    """v1's body at one bf16 pass, with explicit jnp.bfloat16 casts."""
    bf, f32 = jnp.bfloat16, jnp.float32
    pt = p[:3].T                                            # [N, 3]
    r2 = jnp.sum(pt * pt, axis=1)
    dot = jax.lax.dot_general(pt.astype(bf), pt.astype(bf),
                              (((1,), (1,)), ((), ())),
                              preferred_element_type=f32)   # [N, N]
    d2 = (r2 + C.SOFTENING_SQUARED)[:, None] + (r2[None, :] - 2.0 * dot)
    inv = jax.lax.rsqrt(d2)
    s = (inv * inv * inv).astype(bf)
    pj1 = jnp.concatenate([pt, jnp.ones((pt.shape[0], 1), f32)], axis=1)
    f = jax.lax.dot_general(s, pj1.astype(bf), (((1,), (0,)), ((), ())),
                            preferred_element_type=f32)     # [N, 4]
    a3 = f32(C.PARTICLE_MASS) * (f[:, :3] - pt * f[:, 3:4])
    return jnp.concatenate([a3, jnp.sqrt(jnp.sum(a3 * a3, axis=1,
                                                 keepdims=True))], axis=1).T


@pytest.mark.parametrize("name", ["v1b", "v1"])
def test_default_forms_are_one_bf16_pass(name):
    """The twins' "default" forms against bf16 casts on the JAX side, on
    the compact scene (the demo scene NaNs in bf16 by design). Products of
    bf16 values are exact in float32, so the two differ by the order of
    the float32 sums and by s landing on the other side of a bf16
    rounding boundary: 1e-4 of max |a| (measured below 1e-5)."""
    p = _pos(2048, COMPACT)
    fn, jfn = {"v1b": (V.v1b_accel_plain, _jax_bf16_v1b),
               "v1": (V.v1_accel_plain, _jax_bf16_v1)}[name]
    want = np.asarray(jfn(jnp.asarray(p)))
    got = _twin(fn, p, precision="default")
    _assert_rel(got, want, 1e-4)
    # and one bf16 pass is not float32: the forms differ measurably
    assert np.abs(got - _twin(fn, p, precision="highest")).max() > 0


class TestShapeRules:
    def test_unroll_needs_even_tile_count(self, exp):
        p = _pos(3 * 2048)   # n // tj == 3
        with pytest.raises(AssertionError):
            exp["unroll"].unroll_accel(jnp.asarray(p))
        with pytest.raises(ValueError, match="even"):
            V.unroll_accel(torch.from_numpy(p))
        V.unroll_accel(torch.from_numpy(p), tj=1024)   # 6 tiles: fine

    def test_hybrid_needs_groups_of_three(self, exp):
        p = _pos(2048)       # n // 512 == 4
        with pytest.raises(ValueError, match="tile group"):
            exp["hybrid"].hybrid_accel(jnp.asarray(p))
        with pytest.raises(ValueError, match="tile group"):
            V.hybrid_accel(torch.from_numpy(p))

    def test_n_must_tile(self):
        p = torch.from_numpy(_pos(384 + 64))
        for fn in V.VARIANTS:
            with pytest.raises(ValueError, match="multiple of 128"):
                fn(p)
        with pytest.raises(ValueError, match="divide N"):
            V.v3_accel(torch.from_numpy(_pos(768)))      # 768 % 512


_WRAPPER_CASES = [
    (V.attr_accel, V.attr_accel_plain, dict(mode="noaccum")),
    (V.v1b_accel, V.v1b_accel_plain, dict(precision="default")),
    (V.unroll_accel, V.unroll_accel_plain, dict(tj=128)),
    (V.v1_accel, V.v1_accel_plain, {}),
    (V.v3_accel, V.v3_accel_plain, dict(ti=256, tj=128,
                                        force_path="mm_split")),
    (V.hybrid_accel, V.hybrid_accel_plain, dict(tj=128)),
    (V.v4_accel, V.v4_accel_plain, {}),
]


@pytest.mark.parametrize("fn,plain,kw", _WRAPPER_CASES,
                         ids=[c[0].__name__ for c in _WRAPPER_CASES])
def test_cpu_wrapper_is_its_twin(fn, plain, kw):
    """A CPU tensor runs the twin (bit for bit); any device but cuda or
    cpu raises."""
    p = torch.from_numpy(_pos(768, COMPACT))
    assert torch.equal(fn(p, **kw), plain(p, **kw))
    with pytest.raises(ValueError, match="cuda or cpu"):
        fn(torch.empty((4, 768), device="meta"), **kw)


def test_harness_runs_every_v3_tile():
    """The harness's v3 cases are its JAX harness's: every force path at
    tj = 512 and 1024 (`allpairs_v3.py:202-203`)."""
    v3 = [kw for _, fn, kw, _ in harness.CASES if fn is V.v3_accel]
    want = [(fp, tj) for fp in ("vpu", "mm_split", "mm_bf16")
            for tj in (512, 1024)]
    assert sorted((kw["force_path"], kw["tj"]) for kw in v3) == sorted(want)


def test_harness_only_keeps_the_prefix():
    """`--only v3` runs v3's six cases (and v0), at their own tiles; each
    has its error against v0 (large on this scene, where d² cancels) and no
    NaN."""
    rows = harness.run(2048, "cpu", reps=1, log=lambda s: None, only=["v3"])
    assert [r["label"] for r in rows] == [
        c[0] for c in harness.CASES if c[0].startswith("v3")]
    for row in rows:
        assert row["rel_err"] < 1 and row["nan_share"] == 0
