"""Tree near field parity of the torch port against the JAX package.

The CUDA sweeps (`csrc/treeforce.cu`) are held against their plain twins on
the card by chip_smoke.py; here the port's tree walk and twins are held
against `multi_adapter_particles_tpu.ops.treeforce`: its XLA fallback (the
directed chunked sweep) and, with `dispatch.pallas_supported` patched, its
Pallas kernels in interpret mode (the Newton-3rd sweep, sub-block
expansion), as tests/test_treeforce.py runs them.

Inputs are seeded numpy handed to both packages. Tolerances: forces at
rtol 1e-5 against the directed XLA sweep (the JAX package's own
kernel-vs-XLA rtol) with an atol of 1e-6 of max|a| (the JAX Newton-3rd
pin), and 1e-6 of max|a| for the Newton-3rd sweep. Both packages add the
same pair terms in another order, and XLA:CPU fuses multiply-adds the
port's torch ops round separately. The JAX kernel-vs-XLA test's atol of
1e-4 is below one float32 ulp of the running sums at its scale (2.4e-4 for
sums of 2,048-4,096 at MASS = 70,000), so near-zero components of a sum
taken in another order miss it by up to 3x (measured ~2e-7 of max|a|
overall); the max|a|-relative atol is the bound two orders can share.
Integer bookkeeping
(Morton codes, pair counts, dropped pairs, the fitted coefficients) is
bitwise. The JAX device walk sorts Morton codes unstably and the port
stably, so block membership can differ where particles share a near cell;
counts are therefore pinned against the JAX host probe, which sorts stably.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multi_adapter_particles_tpu.models import init as jinit
from multi_adapter_particles_tpu.ops import dispatch
from multi_adapter_particles_tpu.ops import treeforce as JT

from multi_adapter_particles_torch.ops import treeforce as T

# The suite runs one xdist worker per core; torch's own thread pool on top
# only oversubscribes them.
torch.set_num_threads(1)

MASS = 70000.0
EPS2 = 25.0
BOX, R_C = 2048.0, 216.0
GN = int(BOX // R_C)


def _pos4(pos3):
    p = np.zeros((4, pos3.shape[0]), np.float32)
    p[:3] = pos3.T
    return p


def _clustered(n, seed):
    rng = np.random.default_rng(seed)
    return _pos4(np.concatenate([
        rng.normal(0, 90, (n // 2, 3)),
        rng.normal(250, 50, (n - n // 2, 3)),
    ]).astype(np.float32))


def _jax_tree(p, **kw):
    a, dropped = JT.near_field_tree(jnp.asarray(p), BOX, MASS, EPS2, R_C, GN,
                                    **kw)
    return np.asarray(a), int(dropped)


def _port_tree(p, **kw):
    a, dropped = T.near_field_tree(torch.from_numpy(p), BOX, MASS, EPS2, R_C,
                                   GN, **kw)
    return a.numpy(), dropped


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def _assert_forces_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


class TestPieces:
    def test_h_poly_bitwise(self):
        assert T._H_POLY == JT._H_POLY
        assert len(T._H_POLY) == T._POLY_DEG + 1

    @pytest.mark.parametrize("sigma", [24.0, 48.0])
    def test_short_factor_matches_jax(self, sigma):
        """Every separation from 0 to past the cutoff, and a parked pair:
        within 2e-6 of the exact force (the Horner chain's FMA rounding),
        exactly 0 where the JAX function is 0."""
        d2 = np.concatenate([
            np.linspace(0.0, (1.1 * JT._TC * sigma) ** 2, 50001),
            [3e18]]).astype(np.float32)
        want = np.asarray(JT.short_factor_cheb(jnp.asarray(d2), EPS2, sigma))
        got = T.short_factor_cheb(torch.from_numpy(d2), EPS2, sigma).numpy()
        s_exact = (d2.astype(np.float64) + EPS2) ** -1.5
        assert (np.abs(got - want) / s_exact).max() < 2e-6
        np.testing.assert_array_equal(got == 0.0, want == 0.0)

    @pytest.mark.parametrize("gn", [9, 18, 28, 75])
    def test_morton_codes_bitwise(self, gn):
        """The codes of the JAX walk as XLA compiles it (`x / hn + gn/2` is
        one fused multiply-add with the float32 reciprocal), including
        particles placed where a true division floors to another cell, and
        out-of-box particles at the sentinel."""
        hn = BOX / gn
        rng = np.random.default_rng(gn)
        p = rng.uniform(-1100, 1100, (4, 4096)).astype(np.float32)
        p[:, :8] = 1e9
        # cell boundaries k*hn - BOX/2, nudged an ulp either side
        k = rng.integers(1, gn, 64)
        edge = (k * np.float32(hn) - np.float32(BOX / 2)).astype(np.float32)
        p[0, 8:72] = np.nextafter(edge, np.float32(-np.inf))
        p[1, 8:72] = np.nextafter(edge, np.float32(np.inf))
        bits = max((gn - 1).bit_length(), 1)

        @jax.jit
        def jax_codes(pos):
            u = pos[:3] / jnp.float32(hn) + jnp.float32(gn / 2)
            ib = jnp.floor(u).astype(jnp.int32)
            inbox = jnp.all((ib >= 0) & (ib <= gn - 1), axis=0)
            code = JT._morton(jnp.clip(ib, 0, gn - 1), bits)
            return jnp.where(inbox, code, jnp.int32(1 << (3 * bits)))

        got, sentinel = T.morton_codes(torch.from_numpy(p), hn, gn)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jax_codes(p)))
        assert sentinel == 1 << (3 * bits)
        assert (got.numpy()[:8] == sentinel).all()


def _two_blobs(seed):
    """The clustered scene of tests/test_treeforce.py's sweep tests."""
    rng = np.random.default_rng(seed)
    return _pos4(np.concatenate([
        rng.normal(0, 60, (512, 3)), rng.normal(300, 60, (512, 3)),
    ]).astype(np.float32))


class TestDirectedSweep:
    def test_matches_jax_xla_sweep(self):
        """The JAX kernel-vs-XLA test's scene (tests/test_treeforce.py:
        291-316)."""
        p = _two_blobs(seed=5)
        want, d_jax = _jax_tree(p, block=128)
        got, d_port = _port_tree(p, block=128)
        assert d_jax == d_port == 0
        _assert_forces_close(got, want)
        assert np.abs(got).max() > 1e-3

    def test_padding_and_block_misalignment(self):
        """n = 333 in blocks of 64: the padded tail is force-inert and the
        un-sort exact."""
        rng = np.random.default_rng(7)
        p = _pos4(rng.normal(0, 150, (333, 3)).astype(np.float32))
        want, _ = _jax_tree(p, block=64)
        got, dropped = _port_tree(p, block=64)
        assert dropped == 0
        _assert_forces_close(got, want)
        got256, _ = _port_tree(p, block=256)
        np.testing.assert_allclose(got256, got, rtol=2e-4, atol=2e-2)

    def test_permutation_equivariance(self):
        rng = np.random.default_rng(9)
        pos3 = rng.normal(0, 150, (256, 3)).astype(np.float32)
        perm = rng.permutation(256)
        a, _ = _port_tree(_pos4(pos3), block=64)
        ap, _ = _port_tree(_pos4(pos3[perm]), block=64)
        np.testing.assert_allclose(a[:, perm], ap, rtol=2e-4, atol=1e-3)

    def test_out_of_box_gets_no_near_force(self):
        p = _pos4(np.array([[3000.0, 0, 0], [3010.0, 0, 0], [10.0, 0, 0],
                            [20.0, 0, 0]], np.float32))
        want, _ = _jax_tree(p, block=64)
        got, _ = _port_tree(p, block=64)
        assert np.all(got[:, :2] == 0.0)
        assert np.any(np.abs(got[:, 2:]) > 1e-3)
        _assert_forces_close(got, want)

    def test_pair_budget_overflow_is_counted(self):
        """One blob, 8 blocks, a budget of 8 pairs: dropped = the scene's
        pair count (the JAX host probe's) less the budget."""
        rng = np.random.default_rng(11)
        p = _pos4(rng.normal(0, 30, (512, 3)).astype(np.float32))
        r_c = 432.0
        gn = int(BOX // r_c)
        count, _ = JT.host_block_pairs(p, BOX, r_c, gn, block=64)
        a, dropped = T.near_field_tree(torch.from_numpy(p), BOX, MASS, EPS2,
                                       r_c, gn, block=64, pair_budget=8)
        assert dropped == count - 8 > 0
        assert torch.isfinite(a).all()

    def test_tree_list_count_equals_host_probe(self):
        """The port's walk (stable sort) counts exactly the JAX host
        probe's block pairs on the JAX device init."""
        p = np.array(jinit.initialize_particles_device(8192, seed=0)
                     .position)
        r_c = 6.75 * BOX / 64
        gn = int(BOX // r_c)
        coarse, sub, block = JT.host_tree_counts(p, BOX, r_c, gn)
        lists = T.tree_lists(torch.from_numpy(p), BOX, r_c, gn)
        assert sub is None and lists.block == block
        assert lists.pairs == coarse and lists.dropped == 0


class TestHalvedSweep:
    def test_matches_jax_n3_and_directed(self, monkeypatch):
        """The port's Newton-3rd twin against the JAX Newton-3rd kernel
        (interpret mode) and the JAX directed sweep: 1e-6 of max|a|."""
        p = _clustered(1536, seed=13)
        directed, _ = _jax_tree(p, block=128)
        monkeypatch.setattr(dispatch, "pallas_supported", lambda: True)
        n3_jax, d_jax = _jax_tree(p, block=128, half_force=True)
        got, d_port = _port_tree(p, block=128, half_force=True)
        assert d_jax == d_port == 0
        assert _rel(got, n3_jax) < 1e-6
        assert _rel(got, directed) < 1e-6

    def test_halved_list_is_the_directed_pairs_once(self):
        p = _clustered(1024, seed=3)
        t = torch.from_numpy(p)
        full = T.tree_lists(t, BOX, R_C, GN, block=128)
        half = T.tree_lists(t, BOX, R_C, GN, block=128, half_force=True)
        assert half.n3 and not full.n3
        assert bool((half.sweep_j >= half.sweep_i).all())
        diag = int((full.sweep_i == full.sweep_j).sum())
        assert 2 * half.pairs == full.pairs + diag

    def test_halved_budget_counts_the_halved_list(self):
        """The budget is the directed probe's; the halved sweep keeps
        (budget + nb)//2 + 1 pairs, rounded down to the chunk, and counts
        the rest of the halved list as dropped."""
        p = _clustered(1024, seed=3)
        t = torch.from_numpy(p)
        half = T.tree_lists(t, BOX, R_C, GN, block=128, half_force=True)
        budget = 20
        cut = T.tree_lists(t, BOX, R_C, GN, block=128, half_force=True,
                           pair_budget=budget, pair_chunk=4)
        p_max = ((budget + 8) // 2 + 1) // 4 * 4
        assert cut.pairs == p_max
        assert cut.dropped == half.pairs - p_max > 0

    def test_gate_falls_back_on_expansion(self, monkeypatch):
        """Blocks wider than the sweep keep the directed sweep, bitwise."""
        monkeypatch.setattr(T, "_SWEEP_MAX_BLOCK", 32)
        p = _clustered(1024, seed=11)
        a_dir, _ = _port_tree(p, block=128)
        a_n3, _ = _port_tree(p, block=128, half_force=True)
        np.testing.assert_array_equal(a_n3, a_dir)


class TestSubBlockExpansion:
    @pytest.fixture
    def narrow(self, monkeypatch):
        """Sweep width 32 in both packages: blocks of 128 split four ways
        (the JAX expansion runs only with its Pallas sweep)."""
        monkeypatch.setattr(dispatch, "pallas_supported", lambda: True)
        monkeypatch.setattr(JT, "_SWEEP_MAX_BLOCK", 32)
        monkeypatch.setattr(T, "_SWEEP_MAX_BLOCK", 32)

    def test_matches_jax_expanded_sweep(self, narrow):
        p = _two_blobs(seed=13)
        want, d_jax = _jax_tree(p, block=128)
        got, d_port = _port_tree(p, block=128)
        assert d_jax == d_port == 0
        _assert_forces_close(got, want)
        lists = T.tree_lists(torch.from_numpy(p), BOX, R_C, GN, block=128)
        assert lists.sweep_block == 32 and lists.sweep_nb == 32
        # the survivors are the host probe's sub-pair count
        _, sub, _ = T.host_tree_counts(p, BOX, R_C, GN, block=128)
        assert lists.pairs == sub

    def test_sub_pair_budget_truncates_and_counts(self, narrow):
        """A budget at the probe's count sheds only pruned entries (the
        forces are bitwise the untruncated ones); a starved one counts its
        live shortfall: the JAX host probe's sub-pair count less the
        budget."""
        p = _two_blobs(seed=17)
        full, _ = _port_tree(p, block=128)
        sub = JT.host_block_pairs(p, BOX, R_C, GN, block=32)[0]
        capped, d_cap = _port_tree(p, block=128, sub_pair_budget=sub + 2)
        assert d_cap == 0
        np.testing.assert_array_equal(capped, full)
        starved, d_st = _port_tree(p, block=128, sub_pair_budget=sub // 2)
        assert d_st == sub - sub // 2 > 0
        assert np.isfinite(starved).all()


class TestHostProbes:
    @pytest.mark.parametrize("seed,n,block", [(3, 4096, None), (5, 8192, 64),
                                              (23, 8192, 1024)])
    def test_counts_equal_jax(self, seed, n, block, monkeypatch):
        rng = np.random.default_rng(seed)
        p = np.full((4, n), 1e9, np.float32)
        p[:3, : n - 100] = rng.normal(0, 120, (3, n - 100))
        if block == 1024:  # the wide-block (two-level) count
            monkeypatch.setattr(JT, "_SWEEP_MAX_BLOCK", 256)
            monkeypatch.setattr(T, "_SWEEP_MAX_BLOCK", 256)
        args = (p, BOX, R_C, GN)
        assert T.host_tree_counts(*args, block=block) == \
            JT.host_tree_counts(*args, block=block)
        assert T.host_pair_budget(*args, block=block) == \
            JT.host_pair_budget(*args, block=block)
        assert T.host_sub_pair_budget(*args) == \
            JT.host_sub_pair_budget(*args)

    @pytest.mark.parametrize("n", [65_536, 262_144])
    def test_auto_grid_equals_jax(self, n):
        """On the JAX device init, with a budget that admits the grids the
        JAX package's 14 GiB roof admits (up to 256)."""
        p = np.array(jinit.initialize_particles_device(n, seed=0).position)
        cache = {}
        budget = 256 ** 3 * T.SOLVE_BYTES_PER_CELL
        got = T.auto_grid(p, BOX, 6.75, budget, counts_cache=cache)
        assert got == JT.auto_grid(p, BOX, 6.75)
        assert cache  # the probes were cached under counts_cache_key

    def test_feasibility_budget(self):
        per = T.SOLVE_BYTES_PER_CELL
        assert T.feasible_grid(128, 128 ** 3 * per)
        assert not T.feasible_grid(129, 128 ** 3 * per)
        rng = np.random.default_rng(1)
        p = np.full((4, 4096), 1e9, np.float32)
        p[:3] = rng.uniform(-900, 900, (3, 4096))
        assert T.auto_grid(p, BOX, 6.75, 128 ** 3 * per,
                           candidates=(384, 512, 128)) == 128
        with pytest.raises(ValueError, match="solve budget"):
            T.auto_grid(p, BOX, 6.75, 128 ** 3 * per, candidates=(384,))
        assert T.solve_budget("cpu") > 0


def _jax_potential(p, **kw):
    """The JAX package's per-particle potential (and accel where fused)."""
    out = JT.near_field_tree(jnp.asarray(p), BOX, MASS, EPS2, R_C, GN,
                             with_potential=True, **kw)
    return tuple(np.asarray(o) for o in out[:-1]), int(out[-1])


def _port_potential(p, **kw):
    out = T.near_field_tree(torch.from_numpy(p), BOX, MASS, EPS2, R_C, GN,
                            with_potential=True, **kw)
    return tuple(o.numpy() for o in out[:-1]), out[-1]


class TestPotentialChannel:
    """The diagnostics gauge's potential channel (`with_potential`), as
    tests/test_treeforce.py's TestPotentialChannel pins the JAX package's.
    Per-particle potentials agree with the JAX package's within 1e-5 of
    max|u| (each u_i sums ~1,000 terms of both signs in another order)."""

    def test_e_poly_and_self_constant_bitwise(self):
        assert T._E_POLY == JT._E_POLY
        assert len(T._E_POLY) == T._POLY_DEG + 1
        for sigma in (24.0, 48.0, 108.0):
            want = JT.short_potential_self(EPS2, sigma)
            assert T.short_potential_self(EPS2, sigma) == want
            # the CPU twins' evaluation at d2 = 0 is the constant, bitwise
            at0 = T.short_potential_cheb(torch.zeros(1), EPS2, sigma)
            assert float(at0[0]) == want
            assert T.potential_self(EPS2, sigma, "cpu") == want

    def test_short_potential_matches_f64_truth(self):
        """The JAX test's bound against the float64 erf formula inside the
        cutoff, exactly 0 beyond it, and within 1e-6 of max|u| of the JAX
        function everywhere."""
        import math

        sigma = 48.0
        r = np.concatenate([np.linspace(1e-3, T._TC * sigma, 4001),
                            np.linspace(T._TC * sigma * 1.0001,
                                        3 * T._TC * sigma, 64)])
        d2 = (r * r).astype(np.float32)
        got = T.short_potential_cheb(torch.from_numpy(d2), EPS2,
                                     sigma).numpy()
        erf_v = np.vectorize(math.erf)
        truth = -1.0 / np.sqrt(r ** 2 + EPS2) + erf_v(
            r / (math.sqrt(2.0) * sigma)) / r
        inside = r <= T._TC * sigma
        assert np.abs(got[inside] - truth[inside]).max() < 2e-5
        assert (got[~inside] == 0.0).all()
        want = np.asarray(JT.short_potential_cheb(jnp.asarray(d2), EPS2,
                                                  sigma))
        assert _rel(got, want) < 1e-6
        np.testing.assert_array_equal(got == 0.0, want == 0.0)

    @pytest.mark.parametrize("pallas", [False, True])
    def test_matches_jax_with_potential(self, pallas, monkeypatch):
        """Against the JAX XLA fallback and its Pallas sweep in interpret
        mode: u within 1e-5 of max|u|, the force as the force-only pin."""
        p = _clustered(768, seed=21)
        if pallas:
            monkeypatch.setattr(dispatch, "pallas_supported", lambda: True)
        (a_jax, u_jax), d_jax = _jax_potential(p, block=128)
        (a, u), d = _port_potential(p, block=128)
        assert d_jax == d == 0
        assert _rel(u, u_jax) < 1e-5
        _assert_forces_close(a, a_jax)

    def test_matches_direct_pair_sum(self):
        """The tree-swept potential is the direct all-pairs sum of the same
        u_short (0 past the cutoff), self pair removed."""
        p = _clustered(768, seed=11)
        (_, u), d = _port_potential(p)
        assert d == 0
        x = torch.from_numpy(p[:3].T.copy())
        d2 = ((x[None, :, :] - x[:, None, :]) ** 2).sum(-1)
        up = T.short_potential_cheb(d2, EPS2, R_C * T._SIGMA_PER_CUTOFF)
        up.fill_diagonal_(0.0)
        ref = (MASS * up.sum(1)).numpy()
        assert _rel(u, ref) < 1e-5

    def test_force_bitwise_with_and_without_potential(self):
        p = _clustered(768, seed=5)
        a0, d0 = _port_tree(p)
        (a1, _), d1 = _port_potential(p)
        np.testing.assert_array_equal(a0, a1)
        assert d0 == d1

    def test_potential_only_bitwise_fused(self):
        p = _clustered(768, seed=6)
        (_, u_fused), _ = _port_potential(p)
        (u_only,), d = _port_potential(p, potential_only=True)
        assert d == 0
        np.testing.assert_array_equal(u_only, u_fused)

    @pytest.mark.parametrize("kw", [{}, dict(potential_only=True,
                                             half_pairs=True)])
    def test_out_of_box_particles_get_zero_potential(self, kw):
        p = _clustered(768, seed=9)
        p[:3, :7] = 5000.0
        u = _port_potential(p, **kw)[0][-1]
        assert (u[:7] == 0.0).all()
        assert np.isfinite(u).all() and np.abs(u[7:]).max() > 0

    def test_twins_on_cpu_count_no_launch(self):
        """A CPU list runs the plain twin for every variant; row 3 is the
        list-order potential, rows 0-2 zero under potential_only."""
        p = torch.from_numpy(_clustered(1024, seed=2))
        lists = T.tree_lists(p, BOX, R_C, GN, block=128)
        sigma = R_C * T._SIGMA_PER_CUTOFF
        before = [getattr(T.near_sweep, c) for c in T.LAUNCH_COUNTERS]
        fused = T.tree_sweep(lists, EPS2, R_C, with_potential=True)
        only = T.tree_sweep(lists, EPS2, R_C, with_potential=True,
                            potential_only=True)
        force = T.tree_sweep(lists, EPS2, R_C)
        assert [getattr(T.near_sweep, c)
                for c in T.LAUNCH_COUNTERS] == before
        assert torch.equal(fused[:3], force[:3])
        assert torch.equal(only[3], fused[3])
        assert bool((only[:3] == 0).all()) and bool((force[3] == 0).all())
        want = T.near_sweep_plain(lists.spos, lists.bounds, lists.sweep_j,
                                  block=128, eps2=EPS2, sigma=sigma,
                                  with_potential=True)
        assert torch.equal(fused, want)


class TestHalfPairPotential:
    """`half_pairs`: each unordered block pair swept once, diagonal pairs
    weighted 1/2, as tests/test_treeforce.py's TestHalfPairPotential pins
    the JAX package's. The totals agree with the directed enumeration to
    rel 2e-6 (the JAX pin) and with the JAX package's totals to rel 1e-5.
    The JAX package's sliced-path test (its SMEM slice cap,
    `sweep_slice_cap`) has no counterpart: the port's sweeps take the whole
    list in one launch."""

    def _total(self, p, half, **kw):
        (u,), d = _port_potential(p, potential_only=True, half_pairs=half,
                                  **kw)
        return 0.5 * float(u.astype(np.float64).sum()), d

    def _total_only(self, p, half, **kw):
        u, d = T.near_field_tree(torch.from_numpy(p), BOX, MASS, EPS2, R_C,
                                 GN, with_potential=True, potential_only=True,
                                 half_pairs=half, total_only=True, **kw)
        assert u.dim() == 0
        return 0.5 * float(u), d

    def _jax_total(self, p, half, **kw):
        (u,), d = _jax_potential(p, potential_only=True, half_pairs=half,
                                 **kw)
        return 0.5 * float(u.astype(np.float64).sum()), d

    def test_total_matches_directed_and_jax(self):
        p = _clustered(768, seed=11)
        t_dir, d0 = self._total(p, False)
        t_half, d1 = self._total(p, True)
        assert d0 == d1 == 0
        assert t_half == pytest.approx(t_dir, rel=2e-6)
        assert t_half == pytest.approx(self._jax_total(p, True)[0], rel=1e-5)
        for half in (False, True):
            t, d = self._total_only(p, half)
            assert d == 0
            assert t == pytest.approx(t_dir, rel=2e-6)

    def test_total_matches_jax_pallas_interpret(self, monkeypatch):
        p = _clustered(768, seed=5)
        monkeypatch.setattr(dispatch, "pallas_supported", lambda: True)
        t_jax, d_jax = self._jax_total(p, True, block=128)
        t, d = self._total(p, True, block=128)
        assert d == d_jax == 0
        assert t == pytest.approx(t_jax, rel=1e-5)
        assert t == pytest.approx(self._total(p, False, block=128)[0],
                                  rel=2e-6)

    def test_total_matches_under_subblock_expansion(self, monkeypatch):
        """Blocks of 128 split four ways at a sweep width of 32, with the
        probed sub-pair budget: a parent diagonal pair keeps one order of
        its sub-pairs (sub-diagonals weighted 1/2). The halved list holds
        (S + D)/2 sub-pairs for the directed probe's S (D its diagonal
        sub-pairs), and the JAX expanded sweep agrees."""
        monkeypatch.setattr(dispatch, "pallas_supported", lambda: True)
        monkeypatch.setattr(JT, "_SWEEP_MAX_BLOCK", 32)
        monkeypatch.setattr(T, "_SWEEP_MAX_BLOCK", 32)
        p = _clustered(1024, seed=13)
        _, sub, _ = T.host_tree_counts(p, BOX, R_C, GN, block=128)
        cap = int(sub * T.PAIR_HEADROOM) + 2
        kw = dict(block=128, sub_pair_budget=cap)
        t_dir, d0 = self._total(p, False, **kw)
        t_half, d1 = self._total(p, True, **kw)
        assert d0 == d1 == 0
        assert t_half == pytest.approx(t_dir, rel=2e-6)
        t_jax, d_jax = self._jax_total(p, True, **kw)
        assert d_jax == 0 and t_half == pytest.approx(t_jax, rel=1e-5)
        t = torch.from_numpy(p)
        full = T.tree_lists(t, BOX, R_C, GN, block=128, sub_pair_budget=cap)
        half = T.tree_lists(t, BOX, R_C, GN, block=128, sub_pair_budget=cap,
                            half_pairs=True)
        assert full.pairs == sub and half.half_pairs and not half.n3
        live = half.sweep_i < half.sweep_nb
        assert bool((half.sweep_j[live] >= half.sweep_i[live]).all())
        fl = full.sweep_i < full.sweep_nb
        diag = int((full.sweep_i[fl] == full.sweep_j[fl]).sum())
        assert 2 * half.pairs == full.pairs + diag

    def test_probed_budget_never_drops(self):
        p = _clustered(768, seed=23)
        budget = JT.host_pair_budget(p, BOX, R_C, GN)
        assert T.host_pair_budget(p, BOX, R_C, GN) == budget
        assert self._total(p, True, pair_budget=budget)[1] == 0

    def test_starved_budget_counts_the_halved_list(self):
        """The halved list keeps (budget + nb)//2 + 1 pairs of the directed
        budget and counts the rest, as the JAX package counts them."""
        p = _clustered(2048, seed=3)
        d_jax = self._jax_total(p, True, pair_budget=40)[1]
        d = self._total(p, True, pair_budget=40)[1]
        assert d == d_jax > 0

    def test_half_force_and_half_pairs_are_exclusive(self):
        with pytest.raises(ValueError, match="halve different sweeps"):
            T.tree_lists(torch.from_numpy(_clustered(256, seed=3)), BOX, R_C,
                         GN, half_force=True, half_pairs=True)


class TestWrappers:
    def test_cpu_tensors_run_the_twins(self):
        p = torch.from_numpy(_clustered(1024, seed=2))
        for half in (False, True):
            lists = T.tree_lists(p, BOX, R_C, GN, block=128, half_force=half)
            before = (T.near_sweep.launches, T.near_sweep_n3.launches)
            got = T.tree_sweep(lists, EPS2, R_C)
            assert (T.near_sweep.launches,
                    T.near_sweep_n3.launches) == before
            sigma = R_C * T._SIGMA_PER_CUTOFF
            if half:
                want = T.near_sweep_n3_plain(
                    lists.spos, lists.sweep_i, lists.sweep_j, nb=lists.nb,
                    block=lists.block, eps2=EPS2, sigma=sigma)
            else:
                want = T.near_sweep_plain(
                    lists.spos, lists.bounds, lists.sweep_j,
                    block=lists.block, eps2=EPS2, sigma=sigma)
            assert torch.equal(got, want)
            assert bool((got[3] == 0).all())

    @pytest.mark.parametrize("half,block", [(False, 128), (True, 128),
                                            (False, 1024)])
    def test_pair_list_check(self, half, block):
        """The lists the walk makes (halved, directed, expanded) pass the
        check the CUDA wrappers run before a launch; lists that would
        index outside the blocks, or halved lists with j < i, raise."""
        p = torch.from_numpy(_clustered(1536, seed=4))
        L = T.tree_lists(p, BOX, R_C, GN, block=block, half_force=half)
        nb = L.spos.shape[1] // L.sweep_block
        if half:
            T._check_list("n3", L.spos, nb, L.sweep_j, i_idx=L.sweep_i)
            off = L.sweep_j > L.sweep_i
            with pytest.raises(ValueError, match="j < i"):
                T._check_list("n3", L.spos, nb, L.sweep_i[off],
                              i_idx=L.sweep_j[off])
        else:
            T._check_list("d", L.spos, nb, L.sweep_j, bounds=L.bounds)
            bounds = L.bounds.clone()
            bounds[-1] = L.sweep_j.numel() + 1
            with pytest.raises(ValueError, match="outside"):
                T._check_list("d", L.spos, nb, L.sweep_j, bounds=bounds)
        with pytest.raises(ValueError, match="outside"):
            T._check_list("d", L.spos, nb, L.sweep_j + nb)

    def test_other_devices_raise(self):
        spos = torch.zeros((4, 256), device="meta")
        idx = torch.zeros(2, dtype=torch.int64, device="meta")
        with pytest.raises(ValueError, match="cuda or cpu"):
            T.near_sweep(spos, idx, idx, block=128, eps2=EPS2, sigma=48.0)
        with pytest.raises(ValueError, match="cuda or cpu"):
            T.near_sweep_n3(spos, idx, idx, nb=2, block=128, eps2=EPS2,
                            sigma=48.0)

    @pytest.mark.parametrize("kw,err,match", [
        (dict(with_potential=True, half_force=True), ValueError,
         "force-trace option"),
        (dict(potential_only=True), ValueError, "requires with_potential"),
        (dict(with_potential=True, half_pairs=True), ValueError,
         "requires potential_only"),
        (dict(with_potential=True, total_only=True), ValueError,
         "requires potential_only"),
        (dict(block_owner_fn=lambda ids: ids >= 0), NotImplementedError,
         "ROADMAP queue 1 item 14"),
    ])
    def test_later_variants_raise(self, kw, err, match):
        """The combinations the JAX package refuses raise its ValueErrors;
        the mesh variant belongs to a later slice."""
        p = torch.from_numpy(_clustered(256, seed=1))
        with pytest.raises(err, match=match):
            T.near_field_tree(p, BOX, MASS, EPS2, R_C, GN, **kw)
