"""The port's stable key + payload sort against the JAX package's.

`sort_kv_stable_plain` (torch's stable sort + one gather per payload, what
the wrapper runs for a CPU tensor) is held bitwise against the JAX
package's `ops/sortkv.sort_kv_stable` — its Pallas bitonic network in
interpret mode, as `tests/test_sortkv.py` runs it — and against stable
`jax.lax.sort` at larger sizes. `sort_kv_stable_model`, the host replay of
the CUDA kernel's radix passes at its tile and digit constants, is held
bitwise against the twin and against stable `jax.lax.sort` over the key
kinds the renderer and general callers give it, with `live_digits` (the
digit passes the kernel runs) pinned. With a live length (`live=`) both
are held bitwise against the full-length sort on renderer-shaped inputs
with a sentinel tail, in place; the kernel's hop routing (`hops`) is
checked over every set of live digits. The renderer's packed (cg, cb) word
is pinned against the JAX package's bits. The CUDA kernel itself is held
against the twin by chip_smoke.py on the card."""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multi_adapter_particles_tpu.ops.sortkv import sort_kv_stable as jax_sort

from multi_adapter_particles_torch.ops import sortkv
from multi_adapter_particles_torch.render.renderer import pack_cgb, unpack_cgb

# The suite runs one xdist worker per core; torch's own thread pool on top
# only oversubscribes them.
torch.set_num_threads(1)

I32 = np.iinfo(np.int32)
RENDER_TILES = 8192   # gh * gw at 1024x1024: keys in [0, 8192]
KINDS = ["duplicates", "all_equal", "sentinels", "negative", "render",
         "top_digit_only", "full_range"]


def _keys(kind: str, e: int, rng) -> np.ndarray:
    if kind == "duplicates":          # the stability contract under test
        return rng.integers(0, 37, e, dtype=np.int32)
    if kind == "all_equal":
        return np.zeros(e, np.int32)
    if kind == "sentinels":           # INT32_MAX pads among real keys
        k = rng.integers(0, 100, e, dtype=np.int32)
        k[rng.random(e) < 0.4] = I32.max
        return k
    if kind == "negative":
        k = rng.integers(I32.min, I32.max, e, dtype=np.int32,
                         endpoint=True)
        corners = np.array((I32.min, I32.max, -1, 0), np.int32)
        k[:4] = corners[:min(e, 4)]
        return k
    if kind == "render":              # 1024x1024 tile ids, 1/3 "no tile"
        k = rng.integers(0, RENDER_TILES, e, dtype=np.int32)
        k[rng.random(e) < 1 / 3] = RENDER_TILES
        return k
    if kind == "top_digit_only":      # k << 24: digits 0-2 all zero
        return rng.integers(-128, 128, e, dtype=np.int32) << 24
    if kind == "full_range":
        return rng.integers(0, 1 << 32, e, dtype=np.uint64).astype(
            np.uint32).view(np.int32)
    raise ValueError(kind)


def _payloads(e: int, rng):
    """An f32 and an int32 payload (the renderer sorts both kinds)."""
    return (rng.standard_normal(e).astype(np.float32),
            rng.integers(I32.min, I32.max, e, dtype=np.int32))


def _torch_sort(key, *payloads):
    out = sortkv.sort_kv_stable_plain(
        torch.from_numpy(key), *(torch.from_numpy(p) for p in payloads))
    return [o.numpy() for o in out]


def _assert_all_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind", ["duplicates", "all_equal", "sentinels",
                                  "negative"])
def test_plain_matches_jax_network(kind):
    """Bitwise against the JAX bitonic network (interpret mode) at
    E = 2^10, blocks of 2^8: two merge rounds past the block."""
    rng = np.random.default_rng(len(kind))
    e = 1 << 10
    key = _keys(kind, e, rng)
    pay = _payloads(e, rng)
    want = jax_sort(jnp.asarray(key), *map(jnp.asarray, pay), block_log2=8)
    _assert_all_equal(_torch_sort(key, *pay), want)
    if kind == "all_equal":
        np.testing.assert_array_equal(_torch_sort(key, *pay)[1], pay[0])


@pytest.mark.parametrize("e", [1 << 12, 5000, 1 << 16, 65537])
@pytest.mark.parametrize("kind", ["duplicates", "negative"])
def test_plain_matches_stable_lax_sort(e, kind):
    """Bitwise against stable `jax.lax.sort` (the function the JAX network
    reproduces), powers of two and not."""
    rng = np.random.default_rng(e)
    key = _keys(kind, e, rng)
    pay = _payloads(e, rng)
    want = jax.lax.sort((jnp.asarray(key), *map(jnp.asarray, pay)),
                        dimension=0, num_keys=1, is_stable=True)
    _assert_all_equal(_torch_sort(key, *pay), want)


def _model_sort(key, *payloads):
    out, run = sortkv.sort_kv_stable_model(
        torch.from_numpy(key), *(torch.from_numpy(p) for p in payloads))
    return [o.numpy() for o in out], run


@pytest.mark.parametrize("e", [1, sortkv.TILE + 904, 1 << 14])
@pytest.mark.parametrize("kind", KINDS)
def test_model_matches_plain(kind, e):
    """The kernel's passes (per-tile bin counts, their scan in (bin, tile)
    order, the warps' stable in-tile rank, the scatter) give the twin's
    output bit for bit: at one entry, at a ragged last tile and at four
    full tiles. The passes run are the live digits."""
    rng = np.random.default_rng(e + len(kind))
    key = _keys(kind, e, rng)
    pay = _payloads(e, rng)
    got, run = _model_sort(key, *pay)
    _assert_all_equal(got, _torch_sort(key, *pay))
    assert run == sortkv.live_digits(torch.from_numpy(key))


@pytest.mark.parametrize("kind", KINDS)
def test_model_matches_stable_lax_sort(kind):
    """Bitwise against stable `jax.lax.sort`, the function the JAX
    package's network reproduces, at three tiles and a ragged fourth."""
    rng = np.random.default_rng(100 + len(kind))
    e = 3 * sortkv.TILE + 1001
    key = _keys(kind, e, rng)
    pay = _payloads(e, rng)
    want = jax.lax.sort((jnp.asarray(key), *map(jnp.asarray, pay)),
                        dimension=0, num_keys=1, is_stable=True)
    _assert_all_equal(_model_sort(key, *pay)[0], want)


@pytest.mark.parametrize("kind,digits", [
    ("render", [0, 1]), ("all_equal", []), ("negative", [0, 1, 2, 3]),
    ("top_digit_only", [3])])
def test_live_digits(kind, digits):
    """The digit passes the kernel runs: the renderer's tile keys need two,
    equal keys none (the identity), full-range keys all four, k << 24 only
    the top one."""
    rng = np.random.default_rng(7)
    key = torch.from_numpy(_keys(kind, 1 << 14, rng))
    assert sortkv.live_digits(key) == digits


def test_model_constants_mirror_the_kernel():
    """The model's tile and digit constants are csrc/sortkv.cu's."""
    from multi_adapter_particles_torch.ops import _build

    src = (_build.CSRC_DIR / "sortkv.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kRadixBits") == sortkv.RADIX_BITS
    assert const("kDigits") == sortkv.DIGITS
    assert const("kThreads") == 32 * sortkv.WARPS
    assert const("kItems") == sortkv.ITEMS
    assert const("kMaxPayloads") == sortkv.MAX_PAYLOADS
    assert "kMaxLength = (1LL << 30) - 1;" in src
    assert sortkv.MAX_LENGTH == (1 << 30) - 1


def test_wrapper_on_cpu_is_the_twin():
    rng = np.random.default_rng(5)
    key = torch.from_numpy(_keys("duplicates", 3000, rng))
    pay = [torch.from_numpy(p) for p in _payloads(3000, rng)]
    got = sortkv.sort_kv_stable(key, *pay)
    want = sortkv.sort_kv_stable_plain(key, *pay)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError, match="cuda or cpu"):
        sortkv.sort_kv_stable(torch.zeros(8, dtype=torch.int32,
                                          device="meta"))


# Renderer-shaped inputs with a live prefix: keys of a kind below the
# sentinel, then the sentinel tail with zero payloads, as the exact binning
# writes them. E spans three tiles and a ragged fourth.
LIVE_E = 3 * sortkv.TILE + 1001
LIVE_KINDS = {   # kind -> (sentinel, the prefix's live digits)
    "one_digit": (RENDER_TILES, [0]),
    "render": (RENDER_TILES, [0, 1]),
    "three_digits": (I32.max, [0, 1, 2]),
    "top_digit_only": (I32.max, [3]),
    "four_digits": (I32.max, [0, 1, 2, 3]),
}
LIVE_LENGTHS = [0, sortkv.TILE - 1, sortkv.TILE, sortkv.TILE + 1,
                2 * sortkv.TILE + 77, 3 * sortkv.TILE + 500, LIVE_E]


def _live_inputs(kind, live, rng):
    """(key, *payloads) [LIVE_E]: `live` entries of `kind`, the tail the
    sentinel with zero payloads."""
    sentinel, _ = LIVE_KINDS[kind]
    if kind == "one_digit":
        k = rng.integers(0, 37, LIVE_E, dtype=np.int32)
    elif kind == "render":
        k = rng.integers(0, RENDER_TILES, LIVE_E, dtype=np.int32)
    elif kind == "three_digits":
        k = rng.integers(0, 1 << 24, LIVE_E, dtype=np.int32)
    elif kind == "top_digit_only":
        k = _keys("top_digit_only", LIVE_E, rng)
        k[k == I32.max] = 0
    else:
        k = _keys("negative", LIVE_E, rng)
        k[k == I32.max] = 0
    k[live:] = sentinel
    pay = _payloads(LIVE_E, rng)
    for p in pay:
        p[live:] = 0
    return [torch.from_numpy(a) for a in (k, *pay)]


@pytest.mark.parametrize("live", LIVE_LENGTHS)
@pytest.mark.parametrize("kind", list(LIVE_KINDS))
def test_live_matches_the_full_sort(kind, live):
    """With `live`, the twin and the kernel's host replay are bitwise the
    stable sort of all E entries: at no live entry and at all, one below,
    at and one past a tile boundary, and inside the last tile; one, two,
    three and four live digits (odd counts take the in-place copy, before
    the pass for the top digit alone); the replay runs the prefix's live
    digits."""
    rng = np.random.default_rng(live + len(kind))
    args = _live_inputs(kind, live, rng)
    want = sortkv.sort_kv_stable_plain(*args)
    n = torch.tensor(live, dtype=torch.int32)
    got = sortkv.sort_kv_stable_plain(*(a.clone() for a in args), live=n)
    (model, run) = sortkv.sort_kv_stable_model(*(a.clone() for a in args),
                                               live=n)
    for g, m, w in zip(got, model, want):
        assert torch.equal(g, w) and torch.equal(m, w)
    digits = LIVE_KINDS[kind][1] if live > 1 else []
    assert run == sortkv.live_digits(args[0][:live]) == digits


@pytest.mark.parametrize("sort", ["plain", "model"])
def test_live_sorts_in_place(sort):
    """The result is the caller's arrays; the tail is left as it was."""
    rng = np.random.default_rng(3)
    args = _live_inputs("render", 2 * sortkv.TILE + 77, rng)
    tails = [a[2 * sortkv.TILE + 77:].clone() for a in args]
    live = torch.tensor(2 * sortkv.TILE + 77, dtype=torch.int32)
    if sort == "plain":
        out = sortkv.sort_kv_stable_plain(*args, live=live)
    else:
        out, _ = sortkv.sort_kv_stable_model(*args, live=live)
    assert all(o is a for o, a in zip(out, args))
    assert bool((args[0][:-1] <= args[0][1:]).all())
    for a, t in zip(args, tails):
        assert torch.equal(a[2 * sortkv.TILE + 77:], t)


@pytest.mark.parametrize("live,at", [(-5, 0), (LIVE_E + 9, LIVE_E)])
def test_live_is_clamped(live, at):
    """A live count out of [0, E] sorts as its nearest end."""
    rng = np.random.default_rng(11)
    args = _live_inputs("render", at, rng)
    want = sortkv.sort_kv_stable_plain(*args)
    n = torch.tensor(live, dtype=torch.int32)
    got = sortkv.sort_kv_stable_plain(*(a.clone() for a in args), live=n)
    model, run = sortkv.sort_kv_stable_model(*(a.clone() for a in args),
                                             live=n)
    for g, m, w in zip(got, model, want):
        assert torch.equal(g, w) and torch.equal(m, w)
    assert run == ([] if at == 0 else [0, 1])


@pytest.mark.parametrize("fault", ["tail_out_of_order", "tail_below_live"])
def test_plain_refuses_a_broken_promise(fault):
    """The twin checks the caller's promise on the host: a tail out of
    order, or a tail key below a live key, raises."""
    rng = np.random.default_rng(13)
    live = sortkv.TILE
    args = _live_inputs("render", live, rng)
    if fault == "tail_out_of_order":
        args[0][live + 10] = RENDER_TILES + 1
    else:
        args[0][live:] = 5
    with pytest.raises(ValueError, match="must be in order"):
        sortkv.sort_kv_stable_plain(
            *args, live=torch.tensor(live, dtype=torch.int32))


@pytest.mark.parametrize("in_place", [False, True])
def test_hops_route_every_live_set(in_place):
    """For each of the 16 live-digit sets: no hop reads the buffer it
    writes, the first reads the input, each later one what the hop before
    wrote, the last writes the outputs (in place, the input), and a copy
    runs only in a dead digit's launch: in place for an odd count, out of
    place for none."""
    out = "in" if in_place else "out"
    for mask in range(1 << sortkv.DIGITS):
        run = [d for d in range(sortkv.DIGITS) if mask >> d & 1]
        before, n_hops, copy_at = sortkv.hops(run, in_place)
        copies = (len(run) % 2 == 1) if in_place else not run
        assert (copy_at >= 0) == copies and copy_at not in run
        assert n_hops == len(run) + copies
        at = "in"
        for d in range(sortkv.DIGITS):
            if d not in run and d != copy_at:
                continue
            h = before[d]
            dst = out if (n_hops - 1 - h) % 2 == 0 else "scratch"
            assert dst != at
            at = dst
        assert at == (out if n_hops else "in")


def _jax_pack_cgb(gv, bv):
    """The JAX renderer's `pack_cgb` (`render/renderer.py` there), on
    already-clamped cg."""
    return (
        jnp.left_shift(
            gv.astype(jnp.float16).view(jnp.uint16).astype(jnp.uint32), 16)
        | bv.astype(jnp.float16).view(jnp.uint16).astype(jnp.uint32)
    ).view(jnp.int32)


def test_pack_cgb_bits_match_jax():
    """The renderer's packed (cg, cb) word equals the JAX package's bit for
    bit: f16 rounding (ties and subnormals), the cg clamp, and a negative
    cb whose f16 sign bit must not leak into the cg half."""
    rng = np.random.default_rng(9)
    cg = np.concatenate([
        rng.uniform(-1.0, 7.0e4, 4000), [0.0, 6.0e4, 1e9, -3.0, 1e-7, 2**-25],
        1.0 + rng.integers(0, 2**13, 500) * 2.0**-11,   # f16 half-way ties
    ]).astype(np.float32)
    cb = np.concatenate([rng.uniform(-1.0, 1.0, cg.size - 3),
                         [1.0, -0.0, 2**-24]]).astype(np.float32)
    got = pack_cgb(torch.from_numpy(cg), torch.from_numpy(cb)).numpy()
    want = np.asarray(_jax_pack_cgb(jnp.clip(jnp.asarray(cg), 0.0, 6.0e4),
                                    jnp.asarray(cb)))
    np.testing.assert_array_equal(got, want)
    g, b = unpack_cgb(torch.from_numpy(got))
    np.testing.assert_array_equal(
        g.numpy(), np.clip(cg, 0.0, 6.0e4).astype(np.float16)
        .astype(np.float32))
    np.testing.assert_array_equal(
        b.numpy(), cb.astype(np.float16).astype(np.float32))
