"""The half-pair kernel's schedule (`csrc/allpairs.cu`), on the CPU.

The kernel's work items come from `ops/allpairs.py::half_items`, a Python
table: pairs (A, B >= A) of super-tiles of `HALF_G` 512-wide tiles, in
i-major order. These tests hold that table to the JAX pair set (each
unordered pair of tiles once, each diagonal tile once), bound each item's
work and a call's launches, and run a torch model of what the kernels do
with it: each item sums its tile pairs into an i-side and a j-side slot,
and the fold adds each column's slots in table order with Kahan
compensation, chunk by chunk as `allpairs_half` launches them. The model
agrees with the plain twin to 1e-6 of max|a| (the same float32 terms,
summed in another order) and with the JAX Pallas kernel (interpret mode)
to 5e-6, the half-pair twin's own bound in tests/test_torch_allpairs.py.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multi_adapter_particles_tpu.ops.allpairs import (
    all_pairs_accel_halfpair as j_halfpair,
)

from multi_adapter_particles_torch import constants as C
from multi_adapter_particles_torch.ops.allpairs import (
    HALF_G,
    HALF_ITEM_BYTES,
    HALF_SCRATCH_BYTES,
    HALF_SUPER,
    HALF_T,
    _pair_terms,
    all_pairs_accel_halfpair_plain,
    half_chunk,
    half_items,
)

torch.set_num_threads(1)

PHYS = dict(mass=C.PARTICLE_MASS, softening_squared=C.SOFTENING_SQUARED)
N_1M = 1_048_576
WAVE = 264  # 2 CTAs an SM on 132 SMs: the H100's wave of the item kernel


def _tiles(s: int, nt: int) -> range:
    """The 512-tiles of super-tile s (the last one may be short)."""
    return range(s * HALF_G, min((s + 1) * HALF_G, nt))


def _tile_pairs(a_super: int, b_super: int, nt: int):
    """The tile pairs (a, b >= a) item (A, B) computes."""
    return [(a, b) for b in _tiles(b_super, nt) for a in _tiles(a_super, nt)
            if a_super != b_super or a <= b]


def _pos(n, seed):
    p = np.random.default_rng(seed).uniform(
        -400.0, 400.0, size=(4, n)).astype(np.float32)
    p[3] = 0.0
    return p


def _kahan(s, c, x):
    y = x - c
    t = s + y
    return t, (t - s) - y


def _row_start(a: int, ns: int) -> int:
    return a * ns - a * (a - 1) // 2


def schedule_model(position, mass, softening_squared, interaction_scale=1.0,
                   chunk=None):
    """What `allpairs_half` computes, as torch ops: item slots, then the
    fold of each chunk of `chunk` items (default: all) in table order."""
    n = position.shape[1]
    nt = n // HALF_T
    table = half_items(n, "cpu")
    k_all = table.shape[1]
    ns = math.ceil(nt / HALF_G)
    slots = torch.zeros((k_all, 2, 3, HALF_SUPER), dtype=torch.float32)
    for k in range(k_all):
        a_s, b_s = (int(v) for v in table[:, k])
        for a, b in _tile_pairs(a_s, b_s, nt):
            i0, j0 = a * HALF_T, b * HALF_T
            xi, yi, zi = (position[d, i0:i0 + HALF_T][:, None]
                          for d in range(3))
            tx, ty, tz = _pair_terms(xi, yi, zi,
                                     position[:3, j0:j0 + HALF_T],
                                     softening_squared)
            ci = (a - a_s * HALF_G) * HALF_T
            slots[k, 0, :, ci:ci + HALF_T] += torch.stack(
                [tx.sum(1), ty.sum(1), tz.sum(1)])
            if a < b:
                cj = (b - b_s * HALF_G) * HALF_T
                slots[k, 1, :, cj:cj + HALF_T] -= torch.stack(
                    [tx.sum(0), ty.sum(0), tz.sum(0)])
    chunk = chunk or k_all
    acc = torch.zeros((3, ns * HALF_SUPER), dtype=torch.float32)
    comp = torch.zeros_like(acc)
    for k0 in range(0, k_all, chunk):
        k1 = min(k0 + chunk, k_all)
        a0, a1 = int(table[0, k0]), int(table[0, k1 - 1])
        for s in range(ns):
            cols = slice(s * HALF_SUPER, (s + 1) * HALF_SUPER)
            sums, cmp = acc[:, cols], comp[:, cols]
            for a in range(a0, min(a1, s) + 1):
                k = _row_start(a, ns) + s - a
                if k0 <= k < k1:
                    if a == s:
                        sums, cmp = _kahan(sums, cmp, slots[k, 0])
                    sums, cmp = _kahan(sums, cmp, slots[k, 1])
            if a0 <= s <= a1:
                for k in range(max(_row_start(s, ns) + 1, k0),
                               min(_row_start(s + 1, ns), k1)):
                    sums, cmp = _kahan(sums, cmp, slots[k, 0])
            acc[:, cols], comp[:, cols] = sums, cmp
    a3 = ((acc - comp)[:, :n]
          * torch.tensor(float(mass) * float(interaction_scale)))
    amag = torch.sqrt(a3[0] * a3[0] + a3[1] * a3[1] + a3[2] * a3[2])
    return torch.cat([a3, amag[None]], dim=0)


@pytest.mark.parametrize("nt", [2, 3, 5, 8, 129])
def test_items_cover_each_tile_pair_once(nt):
    """Every unordered pair of 512-tiles, the diagonal ones included, in
    exactly one item."""
    table = half_items(nt * HALF_T, "cpu")
    ns = math.ceil(nt / HALF_G)
    assert table.dtype == torch.int32
    assert table.shape == (2, ns * (ns + 1) // 2)
    seen = [p for a, b in table.T.tolist() for p in _tile_pairs(a, b, nt)]
    want = [(a, b) for a in range(nt) for b in range(a, nt)]
    assert sorted(seen) == want  # each once: no duplicates, none missing
    # i-major: rows in order, each row's B ascending from A
    assert table.T.tolist() == [[a, b] for a in range(ns)
                                for b in range(a, ns)]


def test_items_at_1m_by_counts():
    """The 1M table (2,048 tiles, 512 super-tiles), checked by counts."""
    table = half_items(N_1M, "cpu")
    nt, ns = N_1M // HALF_T, N_1M // HALF_SUPER
    a, b = table.long()
    assert table.shape == (2, ns * (ns + 1) // 2) == (2, 131_328)
    assert bool((b >= a).all()) and int(b.max()) == ns - 1
    assert int((a == b).sum()) == ns
    # per row A: items (A, A .. ns - 1)
    assert torch.equal(torch.bincount(a, minlength=ns),
                       torch.arange(ns, 0, -1))
    diag, off = HALF_G * (HALF_G + 1) // 2, HALF_G * HALF_G
    tile_pairs = ns * diag + (table.shape[1] - ns) * off
    assert tile_pairs == nt * (nt + 1) // 2


def test_item_table_is_the_same_each_call():
    first = half_items(5 * HALF_T, "cpu")
    assert half_items(5 * HALF_T, "cpu") is first  # cached per (n, device)
    assert torch.equal(half_items.__wrapped__(5 * HALF_T, "cpu"), first)


@pytest.mark.parametrize("n", [4_608, 65_536, N_1M])
def test_item_work_and_launches_within_bounds(n):
    """An item computes at most HALF_G^2 tile pairs (HALF_G (HALF_G + 1) / 2
    on the diagonal), its slots take HALF_ITEM_BYTES, a launch at most
    HALF_SCRATCH_BYTES of them in whole waves; a call at most 32 launches
    (an item kernel and a fold each)."""
    nt = n // HALF_T
    table = half_items(n, "cpu")
    work = [len(_tile_pairs(a, b, nt)) for a, b in table.T.tolist()]
    diag = [w for (a, b), w in zip(table.T.tolist(), work) if a == b]
    assert max(work) <= HALF_G * HALF_G and min(work) >= 1
    assert max(diag) <= HALF_G * (HALF_G + 1) // 2
    assert sum(work) == nt * (nt + 1) // 2
    k = table.shape[1]
    chunk = half_chunk(k, WAVE)
    assert chunk == k or (chunk % WAVE == 0
                          and chunk * HALF_ITEM_BYTES <= HALF_SCRATCH_BYTES)
    assert 2 * math.ceil(k / chunk) <= 32


def test_one_launch_chunk_when_scratch_allows():
    assert half_chunk(528, WAVE) == 528
    assert half_chunk(131_328, WAVE) == 21_648  # 82 waves, 1.06 GB
    assert half_chunk(10**9, 10**6) == 10**6    # at least one wave


@pytest.mark.parametrize("n", [2_560, 4_608])
def test_schedule_model_matches_twin(n):
    """5 and 9 tiles: the last super-tile holds 1 tile."""
    pos = torch.from_numpy(_pos(n, seed=n))
    got = schedule_model(pos, **PHYS, interaction_scale=1.0 / n)
    want = all_pairs_accel_halfpair_plain(pos, **PHYS,
                                          interaction_scale=1.0 / n)
    scale = float(want[:3].abs().max())
    assert float((got - want).abs().max()) <= 1e-6 * scale


def test_schedule_model_chunks_fold_alike():
    """The fold in chunks of 1, 2 and all items gives the same bits: the
    table order is kept across launches."""
    pos = torch.from_numpy(_pos(4_608, seed=3))
    whole = schedule_model(pos, **PHYS)
    for chunk in (1, 2):
        assert torch.equal(schedule_model(pos, **PHYS, chunk=chunk), whole)


def test_schedule_model_matches_jax():
    n = 2_560
    pos = _pos(n, seed=11)
    want = np.asarray(j_halfpair(jnp.asarray(pos), mass=C.PARTICLE_MASS,
                                 softening_squared=C.SOFTENING_SQUARED,
                                 t=HALF_T, kb=2))
    got = schedule_model(torch.from_numpy(pos), **PHYS).numpy()
    scale = np.abs(want[:3]).max()
    assert np.abs(got[:3] - want[:3]).max() <= 5e-6 * scale
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5,
                               atol=1e-6 * scale)
