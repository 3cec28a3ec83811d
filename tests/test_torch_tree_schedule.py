"""The tree sweeps' work-item schedule (`csrc/treeforce.cu`), on the CPU.

The kernels' work items come from `ops/treeforce.py::sweep_items`, a torch
table built from the segment bounds of the i-major block-pair list: each
target block's segment cut into items of at most `ITEM_LEN` listed source
blocks, in a table of the static size `items_len`, launched longest first
within each chunk. These tests hold that table to the lists `tree_lists`
builds (every listed pair in exactly one item, no item longer than
ITEM_LEN, the static size, empty segments, the same table whatever the
chunking) and run a torch model of what the kernels do with it: each item
sums its source blocks' terms, one block at a time in list order, into a
slot; the fold adds each target's slots in table order, chunk by chunk;
the halved sweep adds the j-side rows in the j-major order, then the
i-side. The model agrees with the plain twins to 1e-5 of max|a| (max|u|
for the potential row: the same float32 terms summed in another order) and
is bitwise the same whatever the chunking; its forces agree with the JAX
package's near field (its XLA sweep, and its Newton-3rd Pallas kernel in
interpret mode) to the tolerances of tests/test_torch_treeforce.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multi_adapter_particles_tpu.ops import dispatch
from multi_adapter_particles_tpu.ops import treeforce as JT

from multi_adapter_particles_torch.ops import treeforce as T

torch.set_num_threads(1)

MASS, EPS2 = 70000.0, 25.0
BOX, R_C = 2048.0, 216.0
GN = int(BOX // R_C)
SIGMA = R_C * T._SIGMA_PER_CUTOFF
L = T.ITEM_LEN
# (wrapper flags) of the directed sweep's variants, by kernel variant index
FLAGS = ({}, dict(with_potential=True),
         dict(with_potential=True, potential_only=True),
         dict(with_potential=True, potential_only=True, half_pairs=True))


def _clustered(n, seed, spread=40.0):
    """A dense blob (its blocks list many blocks: long segments), a wide
    one, and a few particles out of the box (parked)."""
    rng = np.random.default_rng(seed)
    p = np.zeros((4, n), np.float32)
    p[:3] = np.concatenate([
        rng.normal(0, spread, (n // 2, 3)),
        rng.normal(300, 200, (n - n // 2 - 8, 3)),
        rng.uniform(3000, 4000, (8, 3))]).T
    return torch.from_numpy(p)


def _lists(n, seed, block, half_force=False, half_pairs=False):
    return T.tree_lists(_clustered(n, seed), BOX, R_C, GN, block=block,
                        half_force=half_force, half_pairs=half_pairs)


def _halved_bounds(lists):
    return T._n3_lists(lists.sweep_i, lists.sweep_j, lists.nb)[0]


def _bounds(lists):
    return _halved_bounds(lists) if lists.n3 else lists.bounds


def _without_segments(lists, every=3):
    """The list with the segments of every `every`-th target block removed
    (i-major order kept): (bounds, j_idx) directed, (sweep_i, sweep_j)
    halved."""
    i_idx, j_idx = lists.sweep_i, lists.sweep_j
    nb = lists.nb if lists.n3 else lists.sweep_nb
    keep = (i_idx < nb) & (i_idx % every != 1)
    i_idx, j_idx = i_idx[keep], j_idx[keep]
    if lists.n3:
        return i_idx, j_idx
    return T.pm._segment_bounds(i_idx, nb), j_idx


def _block_terms(spos, block, i, j, with_force, with_pot):
    """One listed pair's per-target sums over its source block: [4, B]
    (ax, ay, az, u), and its negated column sums [3, B] (the j-side)."""
    planes = T._blocks(spos, block)
    ti, tj = torch.tensor([i]), torch.tensor([j])
    d, d2 = T._pair_d(planes, ti, tj)
    rows = torch.zeros((4, block))
    cols = torch.zeros((3, block))
    if with_force:
        f = T.short_factor_cheb(d2, EPS2, SIGMA)
        terms = [dc * f for dc in d]
        rows[:3] = torch.stack([t[0].sum(1) for t in terms])
        cols[:] = -torch.stack([t[0].sum(0) for t in terms])
    if with_pot:
        rows[3] = T.short_potential_cheb(d2, EPS2, SIGMA)[0].sum(1)
    return rows, cols


def _item_slots(spos, block, j_idx, items, k0, k1, variant, halved=False):
    """The slots of table entries [k0, k1): [k1 - k0, 4, B], each item's
    sums over its source blocks added in list order (a diagonal pair
    weighted 1/2 under half_pairs); the j-side rows of a halved list by
    list position."""
    force = variant in (0, 1) or halved
    pot = variant in (1, 2, 3) and not halved
    slots = torch.zeros((k1 - k0, 4, block))
    jrows = {}
    for k in range(k0, k1):
        i, q0, q1 = (int(items.table[r, k]) for r in range(3))
        for q in range(q0, q1):
            j = int(j_idx[q])
            rows, cols = _block_terms(spos, block, i, j, force, pot)
            if variant == 3 and j == i:
                rows[3] = rows[3] * 0.5
            slots[k - k0] += rows
            if halved and j != i:
                jrows[q] = cols
    return slots, jrows


def _fold(out, slots, items, k0, k1, nb, block):
    """Each target block's slots in [k0, k1), added in table order to the
    sum `out` holds."""
    istart = items.istart.long()
    for i in range(nb):
        for k in range(max(int(istart[i]), k0), min(int(istart[i + 1]), k1)):
            out[:, i * block:(i + 1) * block] += slots[k - k0]


def directed_model(spos, bounds, j_idx, block, variant=0, chunk=None):
    """What `tree_sweep` computes with the item table: items a chunk at a
    time, each chunk's slots folded before the next."""
    nb = bounds.numel() - 1
    items = T.sweep_items(bounds, j_idx.numel(), chunk)
    kall = items.table.shape[1]
    out = torch.zeros((4, nb * block))
    for k0 in range(0, kall, items.chunk):
        k1 = min(k0 + items.chunk, kall)
        slots, _ = _item_slots(spos, block, j_idx, items, k0, k1, variant)
        _fold(out, slots, items, k0, k1, nb, block)
    if variant in (2, 3):
        out[:3] = 0.0
    if variant == 0:
        out[3] = 0.0
    return out


def n3_model(spos, sweep_i, sweep_j, nb, block, chunk=None):
    """What `tree_sweep_n3` computes: the i-side item slots folded chunk by
    chunk; then, per source block, its j-side rows in the j-major order
    summed from 0, and the i-side added."""
    bounds, jorder, jbounds = T._n3_lists(sweep_i, sweep_j, nb)
    items = T.sweep_items(bounds, sweep_j.numel(), chunk)
    kall = items.table.shape[1]
    out = torch.zeros((4, nb * block))
    jrows = {}
    for k0 in range(0, kall, items.chunk):
        k1 = min(k0 + items.chunk, kall)
        slots, rows = _item_slots(spos, block, sweep_j, items, k0, k1, 0,
                                  halved=True)
        jrows.update(rows)
        _fold(out, slots, items, k0, k1, nb, block)
    for j in range(nb):
        acc = torch.zeros((3, block))
        for q in jorder[int(jbounds[j]):int(jbounds[j + 1])].tolist():
            acc += jrows[q]
        out[:3, j * block:(j + 1) * block] = (
            acc + out[:3, j * block:(j + 1) * block])
    out[3] = 0.0
    return out


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _rel_live(got, want, live):
    return float((got[live] - want[live]).abs().max()
                 / want[live].abs().max())


# -- the item table -------------------------------------------------------------
LIST_CASES = [(2048, 3, 32, False), (2048, 3, 32, True),
              (4096, 5, 64, False), (4096, 5, 64, True),
              (4096, 7, 128, True)]


@pytest.mark.parametrize("n,seed,block,half", LIST_CASES)
def test_items_cover_each_listed_pair_once(n, seed, block, half):
    """Every listed pair lies in exactly one live item, of its own target
    block; no item is longer than ITEM_LEN; a block's items are
    consecutive in the table and in list order; padding names no block."""
    lists = _lists(n, seed, block, half_force=half)
    bounds = _bounds(lists)
    nb = bounds.numel() - 1
    items = T.sweep_items(bounds, lists.sweep_j.numel())
    target, q0, q1 = (t.long() for t in (items.target, items.q0, items.q1))
    live = target < nb
    count = int(items.istart[-1])
    assert int(live.sum()) == count
    assert bool(live[:count].all()) and not bool(live[count:].any())
    assert bool(((q1 - q0)[live] >= 1).all())
    assert bool(((q1 - q0)[live] <= L).all())
    assert bool((q0[~live] == 0).all() and (q1[~live] == 0).all())
    seen = torch.zeros(int(bounds[-1]), dtype=torch.long)
    owner = torch.full_like(seen, -1)
    for k in range(count):
        seen[q0[k]:q1[k]] += 1
        owner[q0[k]:q1[k]] = target[k]
    assert bool((seen == 1).all())
    i_of_q = lists.sweep_i.long()[:int(bounds[-1])]
    assert torch.equal(owner, i_of_q)
    istart = items.istart.long()
    for i in range(nb):
        ks = range(int(istart[i]), int(istart[i + 1]))
        assert all(int(target[k]) == i for k in ks)
        got = [(int(q0[k]), int(q1[k])) for k in ks]
        want = [(s, min(s + L, int(bounds[i + 1])))
                for s in range(int(bounds[i]), int(bounds[i + 1]), L)]
        assert got == want


@pytest.mark.parametrize("seed", range(6))
def test_static_size_bounds_any_segmentation(seed):
    """nb + ceil(list length / L) table entries hold the live items of any
    segmentation, from all entries in one segment to one each."""
    rng = np.random.default_rng(seed)
    nb = int(rng.integers(1, 40))
    length = int(rng.integers(0, 30 * L))
    cuts = np.sort(rng.integers(0, length + 1, nb - 1))
    for b in (np.concatenate([[0], cuts, [length]]),
              np.concatenate([[0], np.full(nb - 1, length), [length]]),
              np.concatenate([[0], np.minimum(np.arange(1, nb), length),
                              [length]])):
        bounds = torch.from_numpy(b.astype(np.int32))
        items = T.sweep_items(bounds, length)
        count = int(items.istart[-1])
        seg = np.diff(b)
        assert count == int(np.sum(-(-seg // L)))
        assert items.table.shape == (4, T.items_len(nb, length))
        assert count <= T.items_len(nb, length)


def test_empty_segments_take_no_item():
    lists = _lists(2048, 3, 32)
    bounds, j_idx = _without_segments(lists)
    items = T.sweep_items(bounds, j_idx.numel())
    seg = (bounds[1:] - bounds[:-1]).long()
    per_block = (items.istart[1:] - items.istart[:-1]).long()
    assert bool((seg == 0).any()) and bool((seg > L).any())
    assert torch.equal(per_block == 0, seg == 0)


@pytest.mark.parametrize("chunk", [1, 2, 5, 7])
def test_table_is_the_same_whatever_the_chunking(chunk):
    """Chunking moves only the launch order: longest items first within
    each chunk, a permutation of the chunk's own entries."""
    lists = _lists(4096, 5, 64)
    full = T.sweep_items(lists.bounds, lists.sweep_j.numel())
    cut = T.sweep_items(lists.bounds, lists.sweep_j.numel(), chunk)
    assert torch.equal(cut.table[:3], full.table[:3])
    assert torch.equal(cut.istart, full.istart)
    order = cut.order.long()
    size = (cut.q1 - cut.q0).long()
    kall = order.numel()
    for k0 in range(0, kall, chunk):
        part = order[k0:k0 + chunk]
        assert sorted(part.tolist()) == list(range(k0, min(k0 + chunk, kall)))
        assert bool((size[part][:-1] >= size[part][1:]).all())


def test_items_build_without_reading_the_device():
    """The table's size is static, and its build never reads a value back
    (a meta tensor has none to read): no host sync on a card."""
    bounds = torch.empty(65, dtype=torch.int32, device="meta")
    items = T.sweep_items(bounds, 1000)
    assert items.table.shape == (4, T.items_len(64, 1000))
    assert items.istart.shape == (65,)


# -- the model of the kernels -------------------------------------------------
@pytest.mark.parametrize("variant", [0, 1, 2])
@pytest.mark.parametrize("block", [32, 64])
def test_directed_model_matches_twin(variant, block):
    lists = _lists(2048, 3, block)
    args = (lists.spos, lists.bounds, lists.sweep_j)
    want = T.near_sweep_plain(*args, block=block, eps2=EPS2, sigma=SIGMA,
                              **FLAGS[variant])
    got = directed_model(*args, block, variant)
    if variant != 2:
        assert _rel(got[:3], want[:3]) < 1e-5
        assert float(want[:3].abs().max()) > 1e-3
    else:
        assert bool((got[:3] == 0).all())
    if variant:
        assert _rel_live(got[3], want[3], lists.live) < 1e-5
    else:
        assert bool((got[3] == 0).all())


def test_half_pairs_model_matches_twin():
    lists = _lists(2048, 3, 32, half_pairs=True)
    args = (lists.spos, lists.bounds, lists.sweep_j)
    want = T.near_sweep_plain(*args, block=32, eps2=EPS2, sigma=SIGMA,
                              **FLAGS[3])
    got = directed_model(*args, 32, 3)
    assert _rel_live(got[3], want[3], lists.live) < 1e-5


@pytest.mark.parametrize("block", [32, 64])
def test_n3_model_matches_twin(block):
    lists = _lists(2048, 3, block, half_force=True)
    args = (lists.spos, lists.sweep_i, lists.sweep_j)
    kw = dict(nb=lists.nb, block=block)
    want = T.near_sweep_n3_plain(*args, eps2=EPS2, sigma=SIGMA, **kw)
    got = n3_model(*args, **kw)
    assert _rel(got[:3], want[:3]) < 1e-5
    assert bool((got[3] == 0).all())


@pytest.mark.parametrize("half", [False, True])
def test_models_with_empty_segments_match_twins(half):
    lists = _lists(2048, 3, 32, half_force=half)
    a, b = _without_segments(lists)
    if half:
        want = T.near_sweep_n3_plain(lists.spos, a, b, nb=lists.nb,
                                     block=32, eps2=EPS2, sigma=SIGMA)
        got = n3_model(lists.spos, a, b, lists.nb, 32)
    else:
        want = T.near_sweep_plain(lists.spos, a, b, block=32, eps2=EPS2,
                                  sigma=SIGMA)
        got = directed_model(lists.spos, a, b, 32)
        empty = torch.repeat_interleave((a[1:] - a[:-1]) == 0, 32)
        assert bool((got[:, empty] == 0).all())
    assert _rel(got[:3], want[:3]) < 1e-5


@pytest.mark.parametrize("half", [False, True])
def test_models_are_bitwise_whatever_the_chunking(half):
    lists = _lists(2048, 3, 32, half_force=half)
    if half:
        args = (lists.spos, lists.sweep_i, lists.sweep_j, lists.nb, 32)
        runs = [n3_model(*args, chunk=c) for c in (None, 1, 3)]
    else:
        args = (lists.spos, lists.bounds, lists.sweep_j, 32, 1)
        runs = [directed_model(*args, chunk=c) for c in (None, 1, 3)]
    assert all(torch.equal(r, runs[0]) for r in runs[1:])


def test_model_invariants_across_variants():
    """The fused variant's force rows are the force-only sweep's bit for
    bit, and the potential-only row 3 the fused one's: the same items, the
    same terms, the same fold."""
    lists = _lists(2048, 3, 32)
    args = (lists.spos, lists.bounds, lists.sweep_j, 32)
    force, fused, pot = (directed_model(*args, v) for v in (0, 1, 2))
    assert torch.equal(fused[:3], force[:3])
    assert torch.equal(pot[3], fused[3])


# -- against the JAX package ----------------------------------------------------
def _near_field(lists, acc):
    return (T.unsort(lists, acc, MASS)).numpy()


def test_directed_model_matches_jax_xla_sweep():
    """Through the tree walk and the un-sort, as `near_field_tree` runs
    the sweep: the JAX package's directed XLA sweep, at the tolerances of
    tests/test_torch_treeforce.py."""
    pos = _clustered(2048, 3)
    want, dropped = JT.near_field_tree(jnp.asarray(pos.numpy()), BOX, MASS,
                                       EPS2, R_C, GN, block=64)
    lists = T.tree_lists(pos, BOX, R_C, GN, block=64)
    assert int(dropped) == lists.dropped == 0
    got = _near_field(lists, directed_model(lists.spos, lists.bounds,
                                            lists.sweep_j, 64))
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


def test_n3_model_matches_jax_n3_kernel(monkeypatch):
    """The JAX Newton-3rd Pallas kernel in interpret mode: 1e-6 of
    max|a|, as tests/test_torch_treeforce.py holds the twin."""
    pos = _clustered(2048, 3)
    monkeypatch.setattr(dispatch, "pallas_supported", lambda: True)
    want, dropped = JT.near_field_tree(jnp.asarray(pos.numpy()), BOX, MASS,
                                       EPS2, R_C, GN, block=128,
                                       half_force=True)
    lists = T.tree_lists(pos, BOX, R_C, GN, block=128, half_force=True)
    assert int(dropped) == lists.dropped == 0 and lists.n3
    got = _near_field(lists, n3_model(lists.spos, lists.sweep_i,
                                      lists.sweep_j, lists.nb, 128))
    want = np.asarray(want)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-6


# -- the profile tool's schedule model ------------------------------------------
def test_profile_schedule_model():
    """tools/tree_profile.py's model of the SMs: equal CTAs fill whole
    waves; a long CTA alone on its SM runs at the lone rate; the rate it
    calibrates reproduces the time it was given (to the 2% a list
    schedule's steps allow: its makespan jumps as the rate moves)."""
    from multi_adapter_particles_torch.tools import tree_profile as P

    full = [1.0] * (P.SMS * 4)
    assert P._makespan(full, 4, 4.0, 1.0) == pytest.approx(1.0)
    assert P._makespan(full, 4, 2.0, 1.0) == pytest.approx(2.0)
    assert P._makespan(full + full, 4, 4.0, 1.0) == pytest.approx(2.0)
    assert P._makespan([10.0] + [1.0] * 8, 4, 4.0, 2.0) == pytest.approx(5.0)
    work = [float(w) for w in np.random.default_rng(0).integers(1, 60, 2000)]
    rate = P._calibrate(work, 5, 3.0, 60.0)
    assert P._makespan(work, 5, rate, 3.0) == pytest.approx(60.0, rel=0.02)
