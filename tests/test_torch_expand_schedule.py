"""The host mirror of v1 / v1b's expansion kernel shape and shared-memory
layout (`ops/allpairs_variants.py`), which the library checks against
`csrc/allpairs_variants.cu`'s exports when it loads: whole CTAs and warps at
every legal N, stages that divide N, the shared memory of the two stage
buffers fitting the SM at the warps its launch bounds ask for, records and
column tables that hold the words each fragment load needs, and fragment
loads free of bank conflicts. Then the load check itself, against a
stand-in library. Runs on the CPU.
"""

import pytest

from multi_adapter_particles_torch.ops import allpairs_variants as V

BANKS = 32
SMEM_LIMIT = 232_448   # shared memory a CTA may use on an H100 (227 KB)
SM_SMEM = 233_472      # an H100 SM's shared memory; each CTA also holds 1 KB
SM_REGS = 65_536       # 32-bit registers an SM
MAX_REGS = 128         # what the launch bounds leave a thread (no spills:
                       # chip_smoke phase 2)
# N = 128 k: the chip_smoke shapes (98,304 = 768 · 128, 98,432 = 769 · 128,
# 131,072 and 1M) and every k to 64
LEGAL_N = [V.TILE * k for k in range(1, 65)] + [V.TILE * k for k in
                                                (768, 769, 1024, 8192)]
CHUNKS = (0, 1, V.EXPAND_STAGE // 16 - 1)
HALF_WARPS = (range(0, 16), range(16, 32))   # a 64-bit load's two passes
CASES = [(v1b, prec) for v1b in (True, False) for prec in V.PRECISIONS]


@pytest.mark.parametrize("n", LEGAL_N)
def test_ctas_and_warps_are_whole(n):
    """A warp's 32 targets lie all below N or all past it (a warp past N
    computes on a clamped target and writes nothing), the grid covers N
    with at most one partly filled CTA, and the SM's warps are whole
    CTAs."""
    per_warp = 16 * V.EXPAND_MT
    assert n % per_warp == 0
    assert V.EXPAND_TARGETS == per_warp * V.EXPAND_WARPS
    ctas = -(-n // V.EXPAND_TARGETS)
    assert 0 <= ctas * V.EXPAND_TARGETS - n < V.EXPAND_TARGETS
    assert V.EXPAND_SM_WARPS % V.EXPAND_WARPS == 0


@pytest.mark.parametrize("n", LEGAL_N)
def test_stage_divides_n(n):
    """The stage is the largest of 512, 256 and 128 dividing N; its chunks
    are a multiple of eight ("highest" folds its sums every eight chunks,
    and eight make the unrolled loop body)."""
    stage = V.expand_stage(n)
    assert stage in (V.EXPAND_STAGE, V.EXPAND_STAGE // 2, V.EXPAND_STAGE // 4)
    assert n % stage == 0
    assert all(n % s for s in (V.EXPAND_STAGE, V.EXPAND_STAGE // 2)
               if s > stage)
    assert (stage // 16) % 8 == 0
    # every thread of a CTA stages at most EXPAND_STAGE / threads sources
    assert V.EXPAND_STAGE % (32 * V.EXPAND_WARPS) == 0


@pytest.mark.parametrize("v1b,precision", CASES)
def test_smem_fits_the_stated_ctas(v1b, precision):
    """Two stage buffers (the double buffering) within 227 KB, and enough
    CTAs an SM, by shared memory and by registers at the launch bounds'
    cap, for its warps."""
    smem = V.expand_smem_bytes(v1b, precision)
    assert smem <= SMEM_LIMIT
    ctas = V.EXPAND_SM_WARPS // V.EXPAND_WARPS
    assert ctas * (smem + 1024) <= SM_SMEM
    assert V.EXPAND_SM_WARPS * 32 * MAX_REGS <= SM_REGS
    # the record's 64-bit and the r_j² 128-bit loads stay aligned: the
    # record, the column table and each buffer are multiples of 16 bytes
    rec = len(V.EXPAND_REC[precision])
    table = V.EXPAND_STAGE // 16 * V.EXPAND_COLS[precision] * 8
    assert (4 * V.EXPAND_STAGE * rec) % 16 == 0 and (4 * table) % 16 == 0
    assert smem % 32 == 0


def _conflict_free(words_of_lane, lanes):
    """No two distinct words read by `lanes` share a bank (the same word
    read twice is a broadcast)."""
    words = {w for lane in lanes for w in words_of_lane(lane)}
    return len({w % BANKS for w in words}) == len(words)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("half", [0, 1])
@pytest.mark.parametrize("precision", V.PRECISIONS)
def test_record_loads_are_conflict_free(precision, chunk, half):
    """The first mma's B: "highest" reads two words of a source's record as
    one 64-bit load (distinct banks in each half-warp), "default" one word
    (distinct banks across the warp, lanes t and t ^ 2 sharing theirs)."""
    def words(lane):
        return V.expand_rec_words(precision, lane, chunk, half)
    if precision == "highest":
        for lanes in HALF_WARPS:
            assert _conflict_free(words, lanes)
        assert all(words(ln)[0] % 2 == 0 for ln in range(32))
    else:
        assert _conflict_free(words, range(32))


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("half", [0, 1])
@pytest.mark.parametrize("precision", V.PRECISIONS)
def test_record_loads_hold_the_b_fragment(precision, chunk, half):
    """Lane (g, t) gets K words t and t + 4 of source chunk·16 + half·8 +
    g ("highest": then K words 8-11 are words 0-3 again and 12-15 zero, so
    the k8 step reuses the first register); "default" lanes t < 2 get K
    word t (group 0), lanes t >= 2 a word of the same source."""
    rec = V.EXPAND_REC[precision]
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        src = chunk * 16 + half * 8 + g
        got = V.expand_rec_words(precision, lane, chunk, half)
        assert all(w // len(rec) == src for w in got)
        kwords = [rec[w % len(rec)] for w in got]
        if precision == "highest":
            assert kwords == [t, t + 4]
        elif t < 2:
            assert kwords == [t]
    assert sorted(V.EXPAND_REC["highest"]) == list(range(8))


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("v1b,precision", CASES)
def test_column_loads_are_conflict_free(v1b, precision, chunk):
    """The second mma's B operands: one 64-bit load a lane, distinct banks
    in each half-warp (lanes reading the zero column share its words)."""
    for which in V.EXPAND_WHICH[precision]:
        def words(lane, which=which):
            return V.expand_tcol_words(precision, which, lane, chunk)
        for lanes in HALF_WARPS:
            assert _conflict_free(words, lanes)
        assert all(words(ln)[0] % 2 == 0 for ln in range(32))


@pytest.mark.parametrize("precision", V.PRECISIONS)
def test_columns_hold_the_operands(precision):
    """Column g of [hi | mid] is hi of coordinate g (g < 4, the 1 at 3) or
    mid of g - 4 (mid of 1 is the zero column); [hi | 0] and [lo | 0] give
    lanes g >= 4 the zero column, [lo | 0] lane 3 too (lo of 1 is 0); each
    lane's two words are source-pair words t and t + 4 of its column."""
    cols = V.EXPAND_COLS[precision]
    zero = V.EXPAND_ZERO_COL[precision]
    # column index -> (piece, coordinate) of the table's columns
    table = {4 * pi + k: (pi, k) for pi in range(3 if precision ==
                                                  "highest" else 1)
             for k in range(3)}
    table[3] = ("one", None)
    table[zero] = ("zero", None)
    assert sorted(table) == list(range(cols))
    for which in V.EXPAND_WHICH[precision]:
        for g in range(8):
            got = table[V.expand_col(precision, which, g)]
            if which == 0:
                want = (0, g) if g < 3 else ("one", None) if g == 3 else \
                    (1, g - 4) if g < 7 else ("zero", None)
            elif which == 1:
                want = (0, g) if g < 3 else ("one", None) if g == 3 else \
                    ("zero", None)
            else:
                want = (2, g) if g < 3 else ("zero", None)
            assert got == want, (which, g)
    for lane in range(32):
        t = lane & 3
        w = V.expand_tcol_words(precision, 1, lane, 0)
        assert [x % 8 for x in w] == [V.v3_tcol_slot(t),
                                      V.v3_tcol_slot(t + 4)]


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("half", [0, 1])
@pytest.mark.parametrize("precision", V.PRECISIONS)
def test_rj2_loads_are_conflict_free(precision, chunk, half):
    """v1's r_j²: lane t reads its accumulator columns' pair, (r, r', r,
    r') "highest" (the first mma's C quad, one 128-bit load: each
    quarter-warp's distinct words on distinct banks) or (r, r') "default"
    (one 64-bit load, each half-warp's)."""
    wide = precision == "highest"
    phases = [range(q, q + 8) for q in range(0, 32, 8)] if wide \
        else HALF_WARPS
    for lanes in phases:
        assert _conflict_free(
            lambda ln: V.expand_rj2_words(precision, ln, chunk, half), lanes)
    for lane in range(32):
        words = V.expand_rj2_words(precision, lane, chunk, half)
        size = 4 if wide else 2
        assert len(words) == size and words[0] % size == 0
        assert list(words) == list(range(words[0], words[0] + size))
        assert words[0] // size == chunk * 8 + half * 4 + (lane & 3)


class _MirrorLib:
    """A stand-in for the built library whose expansion exports answer from
    the mirror, with one export's answer changed by `bump`."""

    def __init__(self, bump=None):
        self.bump = bump

    def _ans(self, name, value):
        return value + 1 if name == self.bump else value

    def apv_expand_warps(self, sm):
        names = ("warps", "sm warps", "rows")
        return self._ans(names[sm], (V.EXPAND_WARPS, V.EXPAND_SM_WARPS,
                                     V.EXPAND_MT)[sm])

    def apv_expand_smem(self, v1b, highest):
        prec = "highest" if highest else "default"
        return self._ans("smem", V.expand_smem_bytes(bool(v1b), prec))

    def apv_expand_stage(self, n):
        return self._ans("stage", V.expand_stage(n))

    def apv_expand_rec_word(self, highest, c, h, lane):
        prec = "highest" if highest else "default"
        return self._ans("rec", V.expand_rec_words(prec, lane, c, h)[0])

    def apv_expand_tcol_word(self, highest, which, c, lane):
        prec = "highest" if highest else "default"
        return self._ans(f"tcol{which}",
                         V.expand_tcol_words(prec, which, lane, c)[0])

    def apv_expand_rj2_word(self, highest, c, h, lane):
        prec = "highest" if highest else "default"
        return self._ans("rj2", V.expand_rj2_words(prec, lane, c, h)[0])


def test_layout_check_accepts_the_mirror():
    V._check_expand_layout(_MirrorLib())


@pytest.mark.parametrize("bump", ["warps", "sm warps", "rows", "smem",
                                  "stage", "rec", "tcol0", "tcol1", "tcol2",
                                  "rj2"])
def test_layout_check_catches_a_change(bump):
    """A kernel whose shape, shared memory, stage or any fragment load
    differs from the mirror fails the library's load."""
    with pytest.raises(RuntimeError, match="expansion"):
        V._check_expand_layout(_MirrorLib(bump))
