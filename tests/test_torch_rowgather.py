"""The port's row gather against the JAX package's.

`gather_rows_plain` (what the wrapper runs for a CPU tensor) is held
bitwise against the JAX package's `ops/rowgather.gather_rows` and against
`table[idx]`, with out-of-range indices clamped as XLA's gather clamps
them; and the eager composite's packed payload layout (`packed_rows`:
[E, 4] payloads into [data_rows, 4Q] rows, gathered and viewed as
[4, Q, V]) against the JAX renderer's expression. The CUDA kernel is
held against the twin by chip_smoke.py on the card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multi_adapter_particles_tpu.ops.rowgather import gather_rows as jax_gather

from multi_adapter_particles_torch.ops import rowgather
from multi_adapter_particles_torch.ops.composite import packed_rows

# The suite runs one xdist worker per core; torch's own thread pool on top
# only oversubscribes them.
torch.set_num_threads(1)


def _table(r, w, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    if dtype == np.int32:
        return rng.integers(-2**31, 2**31 - 1, (r, w), dtype=np.int32)
    return rng.standard_normal((r, w)).astype(np.float32)


@pytest.mark.parametrize("w", [32, 1024, 7])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_plain_matches_jax_and_indexing(w, dtype):
    r, n = 1000, 4096   # r not a multiple of JAX's 128 // w line packing
    table = _table(r, w, w, dtype)
    idx = np.random.default_rng(w + 1).integers(0, r, n).astype(np.int32)
    got = rowgather.gather_rows_plain(torch.from_numpy(table),
                                      torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, table[idx])
    np.testing.assert_array_equal(
        got, np.asarray(jax_gather(jnp.asarray(table), jnp.asarray(idx))))


@pytest.mark.parametrize("w", [32, 1024, 7])
def test_out_of_range_indices_clamp(w):
    """Indices past the table read its last row, as XLA's gather does
    (the JAX renderer's dead virtual rows); negative ones its first."""
    r = 300
    table = _table(r, w, 3)
    rng = np.random.default_rng(4)
    idx = rng.integers(-400, 800, 2000).astype(np.int32)
    got = rowgather.gather_rows_plain(torch.from_numpy(table),
                                      torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, np.take(table, idx, axis=0,
                                               mode="clip"))
    past = np.abs(idx)      # past the end only: XLA's gather clamps them
    np.testing.assert_array_equal(
        rowgather.gather_rows_plain(torch.from_numpy(table),
                                    torch.from_numpy(past)).numpy(),
        np.asarray(jnp.asarray(table)[jnp.asarray(past)]))


def test_no_rows_asked():
    table = torch.from_numpy(_table(10, 32, 5))
    out = rowgather.gather_rows(table, torch.zeros(0, dtype=torch.int32))
    assert out.shape == (0, 32) and out.dtype == table.dtype


def test_wrapper_on_cpu_is_the_twin():
    table = torch.from_numpy(_table(64, 1024, 6))
    idx = torch.from_numpy(
        np.random.default_rng(6).integers(-3, 70, 500).astype(np.int32))
    assert torch.equal(rowgather.gather_rows(table, idx),
                       rowgather.gather_rows_plain(table, idx))


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError, match="cuda or cpu"):
        rowgather.gather_rows(torch.zeros((4, 4), device="meta"),
                              torch.zeros(2, dtype=torch.int32,
                                          device="meta"))


@pytest.mark.parametrize("q,e_pad", [(8, 0), (16, 5)])
def test_renderer_packed_layout_matches_jax(q, e_pad):
    """The eager composite's one packed gather (`packed_rows`, then the
    row gather) gives the JAX renderer's [4, Q, V] payload planes
    (`render/renderer.py` there: stack, pad, [data_rows, 4Q]
    channel-major rows, gather, transpose)."""
    rng = np.random.default_rng(q)
    e = 40 * q - e_pad
    data_rows = -(-e // q)
    payload = rng.integers(-2**31, 2**31 - 1, (e, 4), dtype=np.int32)
    j_v = rng.integers(0, data_rows + 3, 57).astype(np.int32)  # some dead
    padded = np.concatenate([payload, np.zeros((e_pad, 4), np.int32)])
    packed_j = jnp.asarray(padded).reshape(data_rows, q, 4).transpose(
        0, 2, 1).reshape(data_rows, 4 * q)
    want = np.asarray(packed_j[jnp.asarray(j_v)].reshape(57, 4, q)
                      .transpose(1, 2, 0))
    p = torch.from_numpy(payload)
    packed = packed_rows(p[:, 0].view(torch.float32),
                         p[:, 1].view(torch.float32),
                         p[:, 2].view(torch.float32), p[:, 3].contiguous(), q)
    got = rowgather.gather_rows(packed, torch.from_numpy(j_v)).reshape(
        57, 4, q).permute(1, 2, 0)
    np.testing.assert_array_equal(got.numpy(), want)
