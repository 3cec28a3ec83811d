"""The half-pair generations of the torch port against the JAX package's
`experiments/allpairs_halfpair.py`.

The CUDA kernels (`csrc/allpairs_halfpair.cu`) are held against their plain
twins on the card by chip_smoke.py; here each twin is held against its JAX
launcher in Pallas interpret mode (the experiments module is loaded by its
path in the repository), at n = 2,048 with t = 256 and 512 and at n =
1,536 with t = 512 (an odd tile count); v6 also at t = 1024, v7 at kb = 2
(several bands) and 128. Inputs are seeded numpy (the JAX harness's scene:
uniform in ±400, w = 0), handed to both packages.

Tolerances, as max |twin - JAX| over (ax, ay, az, |a|): 1e-5 of max |a|
(the same tile sums in another order, measured ~4e-7); the attribution
modes (reduce_only, tri_only), wrong by design, 1e-5 of the JAX output's
own max. The full forms are also held against #4's twin,
`all_pairs_accel_halfpair_plain`, at 1e-5.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multi_adapter_particles_torch import constants as C
from multi_adapter_particles_torch.ops import allpairs_halfpair as H
from multi_adapter_particles_torch.ops.allpairs import (
    all_pairs_accel_halfpair_plain,
)
from multi_adapter_particles_torch.tools import allpairs_halfpair as tool

# The suite runs one xdist worker per core; torch's own thread pool on top
# only oversubscribes them.
torch.set_num_threads(1)

EXPERIMENTS = Path(__file__).resolve().parents[1] / "experiments"


@pytest.fixture(scope="module")
def exp():
    """experiments/allpairs_halfpair.py by its path (its own sys.path line
    names a fixed checkout, so it is not relied on)."""
    spec = importlib.util.spec_from_file_location(
        "_experiments_allpairs_halfpair", EXPERIMENTS / "allpairs_halfpair.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pos(n, seed=0):
    p = np.random.default_rng(seed).uniform(
        -400.0, 400.0, size=(4, n)).astype(np.float32)
    p[3] = 0.0
    return p


def _assert_rel(got, want, rel, own=False):
    """max |got - want| <= rel * max |want[:3]| (own: max |want|)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    scale = np.abs(want).max() if own else np.abs(want[:3]).max()
    err = np.abs(got - want).max()
    assert err <= rel * scale, err / scale


SIZES = [(2048, 256), (2048, 512), (1536, 512)]
# (JAX launcher and twin name, keywords, wrong by design)
FORMS = ([("v5", dict(mode=m), m != "full") for m in H.V5_MODES]
         + [("v5s", {}, False), ("v6", {}, False)]
         + [("v7", dict(kb=kb), False) for kb in (2, 128)])
CASES = [(name, {**kw, "t": t}, n, wrong) for name, kw, wrong in FORMS
         for n, t in SIZES] + [("v6", dict(t=1024), 2048, False)]


@pytest.mark.parametrize(
    "name,kw,n,wrong", CASES,
    ids=[f"{c[0]}-{'-'.join(f'{k}{v}' for k, v in c[1].items())}-n{c[2]}"
         for c in CASES])
def test_twin_matches_jax(exp, name, kw, n, wrong):
    p = _pos(n)
    want = getattr(exp, f"{name}_accel")(jnp.asarray(p), **kw)
    got = getattr(H, f"{name}_accel_plain")(torch.from_numpy(p), **kw)
    assert got.shape == (4, n)
    _assert_rel(got.numpy(), want, 1e-5, own=wrong)


@pytest.mark.parametrize("t", [256, 512])
@pytest.mark.parametrize("name", ["v5", "v5s", "v6", "v7"])
def test_full_forms_are_halfpair_sum(name, t):
    """Every full form computes #4's sum; t (and kb) only set its order."""
    p = torch.from_numpy(_pos(2048, seed=1))
    want = all_pairs_accel_halfpair_plain(
        p, mass=C.PARTICLE_MASS, softening_squared=C.SOFTENING_SQUARED)
    got = getattr(H, f"{name}_accel_plain")(p, t=t)
    _assert_rel(got.numpy(), want.numpy(), 1e-5)


def test_attribution_modes_differ_from_full():
    """tri_only drops the j-side, reduce_only moves it onto tile 0: both
    leave the i-side of every target, so tiles past 0 differ from full by
    the j-side alone (tri_only and reduce_only agree there)."""
    p = torch.from_numpy(_pos(1024))
    full, red, tri = (H.v5_accel_plain(p, t=256, mode=m) for m in H.V5_MODES)
    assert torch.equal(red[:3, 256:], tri[:3, 256:])
    assert not torch.equal(red[0, :256], tri[0, :256])
    assert torch.equal(red[1:3, :256], tri[1:3, :256])
    assert (full[:3] - tri[:3]).abs().max() > 0


_FNS = [H.v5_accel, H.v5s_accel, H.v6_accel, H.v7_accel]


@pytest.mark.parametrize("fn", _FNS, ids=[f.__name__ for f in _FNS])
def test_shape_rules(fn):
    """N a multiple of t, t a multiple of 128: ValueError (the JAX
    launchers return NaN or zero tails there)."""
    with pytest.raises(ValueError, match="multiple of t"):
        fn(torch.from_numpy(_pos(2176)), t=512)
    with pytest.raises(ValueError, match="multiple of 128"):
        fn(torch.from_numpy(_pos(1920)), t=192)
    with pytest.raises(ValueError, match=r"\[4, N\]"):
        fn(torch.zeros((3, 512)), t=256)


def test_mode_and_kb_rules():
    p = torch.from_numpy(_pos(512))
    with pytest.raises(ValueError, match="mode must be one of"):
        H.v5_accel(p, t=256, mode="partial")
    with pytest.raises(ValueError, match="kb must be"):
        H.v7_accel(p, t=256, kb=0)


_WRAPPER_CASES = [(H.v5_accel, dict(t=256, mode="reduce_only")),
                  (H.v5s_accel, dict(t=256)),
                  (H.v6_accel, dict(t=256)),
                  (H.v7_accel, dict(t=256, kb=2))]


@pytest.mark.parametrize("fn,kw", _WRAPPER_CASES,
                         ids=[c[0].__name__ for c in _WRAPPER_CASES])
def test_cpu_wrapper_is_its_twin(fn, kw):
    """A CPU tensor runs the twin (bit for bit); any device but cuda or
    cpu raises."""
    p = torch.from_numpy(_pos(768))
    plain = getattr(H, f"{fn.__name__}_plain")
    assert torch.equal(fn(p, **kw), plain(p, **kw))
    with pytest.raises(ValueError, match="cuda or cpu"):
        fn(torch.empty((4, 768), device="meta"), **kw)


@pytest.mark.parametrize("v7", [False, True])
def test_harness_runs_on_cpu(v7):
    """The harness's rows: every case at N = 2048 runs, each full form
    within 1e-5 of v0, the attribution modes without an error."""
    rows = tool.run(2048, "cpu", reps=1, v7=v7, log=lambda s: None)
    assert [r["label"] for r in rows] == (
        [f"v7 banded t={t} kb={kb}" for t, kb in tool.V7_CASES] if v7
        else [c[0] for c in tool.CASES])
    for row in rows:
        assert row["ms"] > 0 and row["pairs_per_s"] > 0
        if "(attr)" in row["label"]:
            assert "rel_err" not in row
        else:
            assert row["rel_err"] <= 1e-5 and row["nan_share"] == 0


def test_harness_skips_untileable_and_needs_cuda(capsys):
    rows = tool.run(1536, "cpu", reps=1, log=lambda s: None)
    skipped = {r["label"] for r in rows if r.get("skipped")}
    assert skipped == {"v6 prefetch t=1024"}
    if not torch.cuda.is_available():
        assert tool.main(["2048"]) == 2
        assert "no CUDA device" in capsys.readouterr().err
