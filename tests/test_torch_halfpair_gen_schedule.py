"""Launch geometry of the half-pair generations' kernels
(`csrc/allpairs_halfpair.cu`), held on the host.

- The shared memory `tri_kernel` and `pair_kernel` ask for (the staged
  j-tile and the warps' column sums), at or under the 227 KB a CTA may
  take on sm_90, for every legal t and every team count up to the one the
  kernels run. The library checks these host mirrors against its own
  numbers when it loads.
- v7's bands: their tile pairs cover the JAX triangle exactly once; the
  fold's byte count.
- The slot fold's row count, hoisted out of its loop so that its loads go
  out ahead of the adds: the same rows, in the same order, as the loop
  that stopped at the triangle's edge (so the same bits).
- The harness's profile split and band-tail arithmetic.
"""

import numpy as np
import pytest
import torch

from multi_adapter_particles_torch.ops import allpairs_halfpair as H
from multi_adapter_particles_torch.tools import allpairs_halfpair as tool

torch.set_num_threads(1)

LEGAL_T = list(range(H.TILE, H.MAX_KERNEL_T + 1, H.TILE))


def test_smem_limit_is_sm90s():
    assert H.SMEM_LIMIT == 227 * 1024


@pytest.mark.parametrize("t", LEGAL_T)
def test_shared_memory_fits_every_team_count(t):
    teams = H.teams_for(t)
    assert 1 <= teams <= H.MAX_TEAMS
    assert teams * t // 4 <= 512            # the kernel's launch bound
    for s in range(1, teams + 1):
        need = H.tri_smem_bytes(t, s)
        assert need <= H.SMEM_LIMIT, (t, s, need)
        assert s * 3 * t * 4 <= need        # the i-side sums reuse it
    assert H.tri_smem_bytes(t) == teams * H.team_smem_bytes(t)
    assert H.team_smem_bytes(t) <= H.SMEM_LIMIT
    # one team more would not fit, or would pass 512 threads or 8 teams
    more = teams + 1
    assert (H.tri_smem_bytes(t, more) > H.SMEM_LIMIT
            or more * t // 4 > 512 or more > H.MAX_TEAMS)


def test_teams_at_the_harness_tiles():
    """512 threads at t = 256 and 512; one team at t = 1024, where two
    would need 256 KB."""
    assert [H.teams_for(t) for t in (128, 256, 512, 1024)] == [8, 8, 4, 1]
    assert H.tri_smem_bytes(1024, 2) > H.SMEM_LIMIT
    assert H.tri_smem_bytes(512) == 4 * (2 * 512 * 16 + 4 * 3 * 512 * 4)


@pytest.mark.parametrize("n,t,kb", [(4096, 128, 3), (4096, 256, 16),
                                    (3072, 128, 5), (2048, 512, 1)])
def test_v7_bands_cover_the_triangle_once(n, t, kb):
    nt = n // t
    seen = np.zeros((nt, nt), dtype=int)
    for j0, kbb, off in H.v7_bands(n, t, kb):
        band = [(i, j) for j in range(j0, j0 + kbb) for i in range(j + 1)]
        for i, j in band:
            seen[i, j] += 1
        assert off == sum(1 for i, j in band if i < j)
        assert kbb == sum(1 for i, j in band if i == j)
        assert max(i for i, _ in band) == j0 + kbb - 1  # i-tiles it meets
    assert (seen == np.triu(np.ones((nt, nt), dtype=int))).all()


def test_v7_fold_bytes_at_1m():
    """Each slot of a pair i < j read once: 12 B x t x nt(nt-1)/2, plus
    the band's sum and compensation planes read and written."""
    n = 1 << 20
    for t, kb in tool.V7_CASES:
        nt = n // t
        planes = 3 * n * 4 * 4
        assert H.v7_fold_bytes(n, t, kb) == 12 * t * nt * (nt - 1) // 2 \
            + planes
    assert round(H.v7_fold_bytes(n, 512, 128) / 3.35e12 * 1e3, 2) == 3.86
    assert round(H.v7_fold_bytes(n, 256, 256) / 3.35e12 * 1e3, 2) == 7.71


def _rows_by_loop(g, t, rows, i_first, triangle):
    """The rows the fold took before: r = 0, 1, ... until the triangle's
    edge (i-tile i_first + r >= the column's tile)."""
    out = []
    for r in range(rows):
        if triangle and i_first + r >= g // t:
            break
        out.append(r)
    return out


def _rows_hoisted(g, t, rows, i_first, triangle):
    """The fold kernel's count, known before its first load."""
    nr = rows
    if triangle:
        lim = g // t - i_first
        nr = 0 if lim < 0 else min(lim, rows)
    return list(range(nr))


@pytest.mark.parametrize("t,rows,i_first,triangle",
                         [(128, 7, 0, True), (256, 5, 3, True),
                          (128, 4, 6, False), (512, 9, 2, True)])
def test_fold_row_count_is_the_loops(t, rows, i_first, triangle):
    for g in range(0, 12 * t, 37):
        assert _rows_hoisted(g, t, rows, i_first, triangle) == \
            _rows_by_loop(g, t, rows, i_first, triangle)


def test_profile_split():
    calls = [("Memset (Device)", 0.01), ("tri_kernel<0,1>", 3.0),
             ("fold_kernel", 0.5), ("tri_kernel<0,1>", 4.0),
             ("fold_kernel", 0.25), ("finish_kernel", 0.02),
             ("pair_kernel", 1.0), ("pair_fold_kernel", 0.125)]
    parts = tool.split_kernels(calls)
    assert parts["tiles"] == (8.0, 3)
    assert parts["folds"] == (0.875, 3)
    assert parts["other"][1] == 2


def test_band_tails():
    """Times proportional to each band's work leave no tail; a band slower
    than its work shows by what it takes beyond the best band's rate."""
    n, t, kb = 4096, 128, 8
    work = [15 * off + 12 * kbb for _, kbb, off in H.v7_bands(n, t, kb)]
    assert tool.band_tail_ms([w * 1e-3 for w in work], n, t, kb) == \
        pytest.approx(0, abs=1e-9)
    slow = [w * 1e-3 for w in work]
    slow[0] += 0.5
    assert tool.band_tail_ms(slow, n, t, kb) == pytest.approx(0.5)
    with pytest.raises(ValueError, match="band times"):
        tool.band_tail_ms(slow[1:], n, t, kb)


def test_profile_needs_cuda():
    with pytest.raises(SystemExit) as e:
        tool.main(["v7", "1024", "--device", "cpu", "--profile"])
    assert e.value.code == 2
