"""The host mirror of the v3 kernel's shape and shared-memory layout
(`ops/allpairs_variants.py`), which the library checks against
`csrc/allpairs_variants.cu`'s exports when it loads: the CTA width
`apv_v3` launches, the shared memory of its two stage buffers and that
CTAs fit the SM at the warps its launch bounds ask for, stages that never
straddle a j-tile, and fragment loads free of bank conflicts. Then the load
check itself, against a stand-in library. Runs on the CPU.
"""

import pytest

from multi_adapter_particles_torch.ops import allpairs_variants as V

BANKS = 32
SMEM_LIMIT = 232_448   # shared memory a CTA may use on an H100 (227 KB)
SM_SMEM = 233_472      # an H100 SM's shared memory; each CTA also holds 1 KB
# ti / tj of the JAX harness (512, 1024), the CPU tests (128-1024) and the
# wrapper test (ti = 256, tj = 128)
TILES = [(ti, tj) for ti in (128, 256, 384, 512, 1024)
         for tj in (128, 256, 384, 512, 1024)]


@pytest.mark.parametrize("ti", range(V.TILE, 4096 + 1, V.TILE))
def test_cta_width(ti):
    """A CTA's targets (32 a warp) lie in one ti-block at every legal ti
    (a multiple of TILE), and the SM's warps are whole CTAs."""
    assert ti % (32 * V.V3_WARPS) == 0
    assert V.V3_SM_WARPS % V.V3_WARPS == 0


@pytest.mark.parametrize("tj", [128, 256, 384, 512, 640, 1024, 2048])
def test_stage_never_straddles_a_tile(tj):
    stage = V.v3_stage(tj)
    assert stage in (V.V3_STAGE, V.V3_STAGE // 2, V.V3_STAGE // 4)
    assert tj % stage == 0 and (stage // 16) % 4 == 0   # 2 bodies of 2
    assert all(tj % s for s in (V.V3_STAGE, V.V3_STAGE // 2) if s > stage)


@pytest.mark.parametrize("force_path", V.FORCE_PATHS)
@pytest.mark.parametrize("ti,tj", TILES)
def test_smem_fits_the_stated_ctas(force_path, ti, tj):
    """Two stage buffers (the double buffering) and the CTA's targets:
    within 227 KB, and enough CTAs an SM for the launch bounds' 20 warps;
    a stage buffer holds the largest stage and the CTA's targets lie in one
    ti-block, so no (ti, tj) needs more."""
    smem = V.v3_smem_bytes(force_path)
    assert smem <= SMEM_LIMIT
    ctas = SM_SMEM // (smem + 1024)
    assert ctas * V.V3_WARPS >= V.V3_SM_WARPS
    assert V.v3_stage(tj) <= V.V3_STAGE and ti % (32 * V.V3_WARPS) == 0


def _conflict_free(words_of_lane, lanes):
    """No two distinct words read by `lanes` share a bank (the same word
    read twice is a broadcast)."""
    words = {w for lane in lanes for w in words_of_lane(lane)}
    return len({w % BANKS for w in words}) == len(words)


HALF_WARPS = (range(0, 16), range(16, 32))   # a 64-bit load's two passes


def _one_64bit_load(words):
    return words[0] % 2 == 0 and words[1] == words[0] + 1


@pytest.mark.parametrize("chunk", [0, 1, 31])
@pytest.mark.parametrize("half", [0, 1])
def test_record_loads_are_conflict_free(chunk, half):
    """The first mma's B: each lane reads two words of a source's record as
    one 64-bit load; each half-warp's lanes land on distinct banks, and the
    four lanes of group g read all of source g's record."""
    for lanes in HALF_WARPS:
        assert _conflict_free(lambda ln: V.v3_rec_words(ln, chunk, half),
                              lanes)
    for g in range(8):
        words = [V.v3_rec_words(4 * g + t, chunk, half) for t in range(4)]
        assert all(_one_64bit_load(w) for w in words)
        src = chunk * 16 + half * 8 + g
        assert {x for w in words for x in w} == set(range(4 * src,
                                                          4 * src + 4))


@pytest.mark.parametrize("chunk", [0, 1, 31])
@pytest.mark.parametrize("low", [False, True])
def test_column_loads_are_conflict_free(chunk, low):
    """The second mma's B (and mm_split's B_l): distinct banks in each
    half-warp, one 64-bit load a lane, and the four lanes of a group read
    all 8 source-pair words of their column."""
    for lanes in HALF_WARPS:
        assert _conflict_free(lambda ln: V.v3_tcol_words(ln, chunk, low),
                              lanes)
    for g in range(8):
        words = [V.v3_tcol_words(4 * g + t, chunk, low) for t in range(4)]
        assert all(_one_64bit_load(w) for w in words)
        base = chunk * 64 + ((g & 3) if low else g) * 8
        assert {x for w in words for x in w} == set(range(base, base + 8))


def test_column_slots_are_a_permutation():
    """Slots of source-pair words t and t + 4 are adjacent and even-first
    (the B fragment's two registers in one 64-bit load)."""
    assert sorted(V.v3_tcol_slot(m) for m in range(8)) == list(range(8))
    assert all(V.v3_tcol_slot(t + 4) == V.v3_tcol_slot(t) + 1
               and V.v3_tcol_slot(t) % 2 == 0 for t in range(4))


@pytest.mark.parametrize("u", [0, 1])
def test_vpu_source_loads_are_conflict_free(u):
    """vpu's (q, r_j²): each lane reads a source's float4 as one 128-bit
    load; each quarter-warp's distinct float4s on distinct banks."""
    for chunk in (0, 1, 31):
        for h in (0, 1):
            def words(lane):
                src = V.v3_q_sources(lane, chunk, h)[u]
                return range(4 * src, 4 * src + 4)
            for q in range(4):
                assert _conflict_free(words, range(8 * q, 8 * q + 8))


class _MirrorLib:
    """A stand-in for the built library whose v3 exports answer from the
    mirror, with one export's answer changed by `bump`."""

    def __init__(self, bump=None):
        self.bump = bump

    def _ans(self, name, value):
        return value + 1 if name == self.bump else value

    def apv_v3_warps(self, sm):
        return self._ans("sm warps" if sm else "warps",
                         V.V3_SM_WARPS if sm else V.V3_WARPS)

    def apv_v3_smem(self, path):
        fp = {v: k for k, v in V._FORCE_PATH.items()}[path]
        return self._ans("smem", V.v3_smem_bytes(fp))

    def apv_v3_stage(self, tj):
        return self._ans("stage", V.v3_stage(tj))

    def apv_v3_rec_word(self, c, h, lane):
        return self._ans("rec", V.v3_rec_words(lane, c, h)[0])

    def apv_v3_tcol_word(self, c, low, lane):
        return self._ans("tcol", V.v3_tcol_words(lane, c, bool(low))[0])

    def apv_v3_tcol_slot(self, m):
        return self._ans("slot", V.v3_tcol_slot(m))

    def apv_v3_q_source(self, c, h, lane, u):
        return self._ans("q", V.v3_q_sources(lane, c, h)[u])


def test_layout_check_accepts_the_mirror():
    V._check_v3_layout(_MirrorLib())


@pytest.mark.parametrize("bump", ["warps", "sm warps", "smem", "stage",
                                  "rec", "tcol", "slot", "q"])
def test_layout_check_catches_a_change(bump):
    """A kernel whose widths, shared memory, stage or any fragment load
    differs from the mirror fails the library's load."""
    with pytest.raises(RuntimeError, match="v3"):
        V._check_v3_layout(_MirrorLib(bump))
