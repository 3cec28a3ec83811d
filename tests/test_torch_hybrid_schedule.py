"""The host mirror of hybrid's kernel shape and shared-memory layout
(`ops/allpairs_variants.py`), which the library checks against
`csrc/allpairs_variants.cu`'s exports when it loads: whole CTAs and warps
at every legal (N, tj), stages that divide tj, a stage order that sends
exactly the twin's partition through the expansion, the two stage buffers
fitting the SM at the CTAs its launch bounds ask for, fragment loads free
of bank conflicts and elementwise loads that are aligned broadcasts. Then
the load check itself, against a stand-in library. Runs on the CPU.
"""

import pytest

from multi_adapter_particles_torch.ops import allpairs_variants as V

BANKS = 32
SMEM_LIMIT = 232_448   # shared memory a CTA may use on an H100 (227 KB)
SM_SMEM = 233_472      # an H100 SM's shared memory; each CTA also holds 1 KB
SM_REGS = 65_536       # 32-bit registers an SM
MAX_REGS = 128         # what the launch bounds leave a thread (no spills:
                       # chip_smoke phase 2)
EXP_FOLD = 8           # chunks between the expansion's folds
TJS = (128, 256, 384, 512, 640, 1024)
# (N, tj) the shape rule allows: N = 3 tj k; the chip_smoke shapes (98,304
# at tj = 128 and 512, 97,920 at 384, 1,047,552 at 512) and small ones
LEGAL = sorted({(3 * tj * k, tj) for tj in TJS for k in (1, 2, 3, 5)}
               | {(98_304, 128), (98_304, 512), (97_920, 384),
                  (1_047_552, 512)})
SMALL = [(n, tj) for n, tj in LEGAL if n <= 20_000]
HALF_WARPS = (range(0, 16), range(16, 32))   # a 64-bit load's two passes


@pytest.mark.parametrize("n,tj", LEGAL)
def test_ctas_and_warps_are_whole(n, tj):
    """The shape rule holds, a warp's 32 targets lie all below N or all
    past it (a warp past N computes on a clamped target and writes
    nothing), the grid covers N with at most one partly filled CTA, and the
    SM's warps are whole CTAs."""
    assert V.hybrid_fits(n, tj)
    assert n % 32 == 0
    ctas = -(-n // V.EXPAND_TARGETS)
    assert 0 <= ctas * V.EXPAND_TARGETS - n < V.EXPAND_TARGETS
    assert V.EXPAND_SM_WARPS % V.EXPAND_WARPS == 0


@pytest.mark.parametrize("tj", [V.TILE * k for k in range(1, 33)])
def test_stage_divides_tj(tj):
    """S is the largest of 512, 256 and 128 dividing tj, so no stage
    straddles two groups; its chunks are a multiple of the fold's eight,
    each loop body takes HYBRID_ELEM elementwise sources beside one chunk
    (the 2:1 ratio), and every thread stages at most the expansion's two
    sources."""
    size = V.hybrid_stage(tj)
    assert size in (V.HYBRID_STAGE, V.HYBRID_STAGE // 2,
                    V.HYBRID_STAGE // 4)
    assert tj % size == 0
    assert all(tj % s for s in (V.HYBRID_STAGE, V.HYBRID_STAGE // 2)
               if s > size)
    chunks = size // 16
    assert chunks % EXP_FOLD == 0
    assert 2 * size == chunks * V.HYBRID_ELEM
    assert V.HYBRID_STAGE <= V.EXPAND_STAGE
    # the 16-byte copies of a plane: whole float4s
    assert (2 * size) % 4 == 0


@pytest.mark.parametrize("n,tj", SMALL + [(98_304, 128), (97_920, 384)])
def test_sources_are_the_twins_partition(n, tj):
    """Over the N / 3 S stages, every source is staged exactly once, and
    it goes through the expansion iff (j // tj) % 3 == 2: the twin's
    partition. A stage's elementwise and expansion sources are each one
    contiguous run, the first starting on a 16-byte boundary of its plane
    (the copies'; N % 128 == 0 keeps each plane's start aligned)."""
    size = V.hybrid_stage(tj)
    stages = n // (3 * size)
    assert stages * 3 * size == n
    elem, expand = [], []
    for s in range(stages):
        e = [V.hybrid_source(tj, s, j) for j in range(2 * size)]
        x = [V.hybrid_source(tj, s, j) for j in range(2 * size, 3 * size)]
        assert e == list(range(e[0], e[0] + 2 * size))
        assert x == list(range(x[0], x[0] + size))
        assert e[0] % 4 == 0
        elem += e
        expand += x
    assert sorted(elem + expand) == list(range(n))
    assert set(expand) == {j for j in range(n) if (j // tj) % 3 == 2}


@pytest.mark.parametrize("tj", TJS)
def test_a_stage_takes_one_group(tj):
    """Every source of a stage lies in the same group of three tj-tiles,
    tj = 128 (one stage a group) included."""
    size = V.hybrid_stage(tj)
    for s in range(3 * (tj // size)):
        groups = {V.hybrid_source(tj, s, j) // (3 * tj)
                  for j in range(3 * size)}
        assert groups == {s // (tj // size)}


def test_smem_fits_two_ctas():
    """Two stage buffers (the double buffering) within 227 KB, and the two
    CTAs an SM the launch bounds ask for fit by shared memory and by
    registers at the 128 they leave a thread; the elementwise planes start
    16-byte aligned (their copies and float4 loads)."""
    smem = V.hybrid_smem_bytes()
    assert smem <= SMEM_LIMIT
    ctas = V.EXPAND_SM_WARPS // V.EXPAND_WARPS
    assert ctas == 2
    assert ctas * (smem + 1024) <= SM_SMEM
    assert V.EXPAND_SM_WARPS * 32 * MAX_REGS <= SM_REGS
    expand_buf = V.expand_smem_bytes(True, "highest") // 2
    plane = 2 * V.HYBRID_STAGE * 4
    assert expand_buf % 16 == 0 and plane % 16 == 0
    assert smem == 2 * (expand_buf + 3 * plane)


def _conflict_free(words_of_lane, lanes):
    """No two distinct words read by `lanes` share a bank (the same word
    read twice is a broadcast)."""
    words = {w for lane in lanes for w in words_of_lane(lane)}
    return len({w % BANKS for w in words}) == len(words)


@pytest.mark.parametrize("size", [128, 256, 512])
def test_expansion_loads_are_conflict_free(size):
    """Every chunk of a stage of each size: the first mma's record loads
    (v1b "highest"'s, one 64-bit load) and the three column-table loads
    read distinct banks in each half-warp."""
    for c in range(size // 16):
        for h in (0, 1):
            for lanes in HALF_WARPS:
                assert _conflict_free(
                    lambda ln: V.expand_rec_words("highest", ln, c, h),
                    lanes)
        for which in V.EXPAND_WHICH["highest"]:
            for lanes in HALF_WARPS:
                assert _conflict_free(
                    lambda ln: V.expand_tcol_words("highest", which, ln, c),
                    lanes)


@pytest.mark.parametrize("size", [128, 256, 512])
def test_elementwise_loads_are_aligned_broadcasts(size):
    """Body c's float4 loads of each plane: 16-byte aligned, the same on
    every lane (one broadcast wavefront), and together the body's
    HYBRID_ELEM sources of the stage's 2 S, each once."""
    seen = []
    for c in range(size // 16):
        body = []
        for u in range(V.HYBRID_ELEM // 4):
            words = V.hybrid_elem_words(c, u)
            assert words[0] % 4 == 0
            assert list(words) == list(range(words[0], words[0] + 4))
            body += words
        assert body == list(range(c * V.HYBRID_ELEM,
                                  (c + 1) * V.HYBRID_ELEM))
        seen += body
    assert seen == list(range(2 * size))


class _MirrorLib:
    """A stand-in for the built library whose hybrid exports answer from
    the mirror, with one export's answer changed by `bump`."""

    def __init__(self, bump=None):
        self.bump = bump

    def _ans(self, name, value):
        return value + 1 if name == self.bump else value

    def apv_hybrid_warps(self, sm):
        names = ("warps", "sm warps", "rows")
        return self._ans(names[sm], (V.EXPAND_WARPS, V.EXPAND_SM_WARPS,
                                     V.EXPAND_MT)[sm])

    def apv_hybrid_smem(self):
        return self._ans("smem", V.hybrid_smem_bytes())

    def apv_hybrid_stage(self, tj):
        return self._ans("stage", V.hybrid_stage(tj))

    def apv_hybrid_source(self, tj, s, j):
        value = V.hybrid_source(tj, s, j)
        if self.bump == "expansion source":
            return value + (j >= 2 * V.hybrid_stage(tj))
        return self._ans("source", value)

    def apv_hybrid_elem_word(self, c, u):
        return self._ans("elem", V.hybrid_elem_words(c, u)[0])


def test_layout_check_accepts_the_mirror():
    V._check_hybrid_layout(_MirrorLib())


@pytest.mark.parametrize("bump", ["warps", "sm warps", "rows", "smem",
                                  "stage", "source", "expansion source",
                                  "elem"])
def test_layout_check_catches_a_change(bump):
    """A kernel whose shape, shared memory, stage, source order or
    elementwise loads differ from the mirror fails the library's load."""
    with pytest.raises(RuntimeError, match="hybrid"):
        V._check_hybrid_layout(_MirrorLib(bump))
