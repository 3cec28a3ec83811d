"""The port's stable key + payload sort against the JAX package's.

`sort_kv_stable_plain` (torch's stable sort + one gather per payload, what
the wrapper runs for a CPU tensor) is held bitwise against the JAX
package's `ops/sortkv.sort_kv_stable` — its Pallas bitonic network in
interpret mode, as `tests/test_sortkv.py` runs it — and against stable
`jax.lax.sort` at larger sizes. The kernel's host-side pieces (the packed
(key, index) order, the power-of-two padding, the slice back) are pinned
on the CPU, with the renderer's packed (cg, cb) word against the JAX
package's bits. The CUDA kernel itself is held against the twin by
chip_smoke.py on the card."""

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
        k[:4] = (I32.min, I32.max, -1, 0)
        return k
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


@pytest.mark.parametrize("e,ep", [(0, 1), (1, 1), (2, 2), (3, 4), (1000, 1024),
                                  (1024, 1024), (6 << 20, 8 << 20)])
def test_padded_length(e, ep):
    assert sortkv.padded_length(e) == ep


@pytest.mark.parametrize("kind,e", [("duplicates", 1000), ("sentinels", 777),
                                    ("negative", 1024), ("all_equal", 1)])
def test_packed_words_order_pad_and_slice(kind, e):
    """The kernel's packed words sort as (key, index): their order is the
    stable sort, every pad (INT32_MAX, index >= E) lands after every real
    entry — real INT32_MAX keys included — and the first E are the
    result."""
    rng = np.random.default_rng(e)
    key = torch.from_numpy(_keys(kind, e, rng))
    words = sortkv.packed_words(key)
    ep = sortkv.padded_length(e)
    assert words.shape == (ep,) and words.dtype == torch.int64
    assert int(torch.unique(words).numel()) == ep          # a strict order
    order = torch.sort(words).indices
    assert bool((order[e:] >= e).all())                    # pads last
    want = torch.sort(key, stable=True)
    assert torch.equal(order[:e], want.indices)
    assert torch.equal((words[order[:e]] >> 32).to(torch.int32),
                       want.values)
    # the kernel's unsigned words are these with the top bit flipped
    top = (words >> 63) & 1
    u_key = ((words >> 32) & 0xFFFFFFFF) ^ 0x80000000
    assert torch.equal(u_key >> 31, 1 - top)


def test_wrapper_on_cpu_is_the_twin():
    rng = np.random.default_rng(5)
    key = torch.from_numpy(_keys("duplicates", 3000, rng))
    pay = [torch.from_numpy(p) for p in _payloads(3000, rng)]
    before = sortkv.sort_kv_stable.launches
    got = sortkv.sort_kv_stable(key, *pay)
    want = sortkv.sort_kv_stable_plain(key, *pay)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert sortkv.sort_kv_stable.launches == before  # no kernel on the CPU


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError, match="cuda or cpu"):
        sortkv.sort_kv_stable(torch.zeros(8, dtype=torch.int32,
                                          device="meta"))


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
