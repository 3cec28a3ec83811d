"""Stable key + payload sort: CUDA kernel + plain torch twin.

`sort_kv_stable(key, *payloads)` sorts an int32 key ascending, stably, and
permutes each 32-bit payload alike: `(sorted_key, *sorted_payloads)`, bit
for bit what the JAX package's `ops/sortkv.py::sort_kv_stable` promises
(`jax.lax.sort` on (key, iota, *payloads) with `is_stable=True`, minus the
iota). The renderer sorts its tile keys with the four sprite payloads
through it (`render/renderer.py`). The kernel (`csrc/sortkv.cu`) replaces
that module's Pallas bitonic network (`_make_kernel`, launched by
`_vmem_pass`).

- CUDA tensors go to the kernel, or the wrapper raises.
- CPU tensors go to `sort_kv_stable_plain`: `torch.sort(key, stable=True)`
  and one index gather per payload.

Deviations from the JAX function:
- E need not be a power of two. The kernel pads to the next power of two
  with key = INT32_MAX (the rule the JAX module gives general callers);
  a padded entry's index is >= E, so it sorts after every real entry, a
  real INT32_MAX key included, and only the first E come back
  (`padded_length`, `packed_words` give the host's view of both).
- `block_log2` is TPU tuning and is not ported; the kernel picks its tile.

Payloads are opaque 32-bit words: float32, or int32 such as the renderer's
packed f16 pair.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from multi_adapter_particles_torch.ops import _build

Tensor = torch.Tensor

INT32_MAX = 2147483647
MAX_PAYLOADS = 8        # csrc/sortkv.cu kMaxPayloads
MAX_LENGTH = 1 << 31    # the index half of a packed word is 32 bits


def padded_length(e: int) -> int:
    """The power of two the kernel sorts E entries in (>= 1)."""
    return 1 << max(int(e) - 1, 0).bit_length()


def packed_words(key: Tensor) -> Tensor:
    """The kernel's packed words for `key`, padded to `padded_length`, as
    int64: key * 2^32 + index, with pad keys INT32_MAX. Signed int64 order
    of these is the kernel's unsigned order of ((u32)key ^ 2^31) << 32 |
    index (the same words with the top bit flipped): the lexicographic
    (key, index) order, strict, so sorting them is the stable sort."""
    e = key.shape[0]
    ep = padded_length(e)
    k = torch.full((ep,), INT32_MAX, dtype=torch.int64, device=key.device)
    k[:e] = key.to(torch.int64)
    return k * (1 << 32) + torch.arange(ep, dtype=torch.int64,
                                        device=key.device)


def sort_kv_stable_plain(key: Tensor, *payloads: Tensor):
    """(sorted_key, *sorted_payloads): torch's stable sort and one gather
    per payload."""
    sorted_key, perm = torch.sort(key, stable=True)
    return (sorted_key, *(p[perm] for p in payloads))


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("sortkv")
    fn = lib.sortkv_stable
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def sort_kv_stable(key: Tensor, *payloads: Tensor):
    """Stable ascending sort of int32 `key` [E] with up to 8 32-bit
    payloads [E] -> (sorted_key, *sorted_payloads). A CPU tensor runs the
    plain twin; a CUDA tensor launches the kernel (counted in
    `sort_kv_stable.launches`; E = 0 launches nothing)."""
    if key.device.type == "cpu":
        return sort_kv_stable_plain(key, *payloads)
    if key.device.type != "cuda":
        raise ValueError(f"sort_kv_stable runs on cuda or cpu, got "
                         f"{key.device}")
    if len(payloads) > MAX_PAYLOADS:
        raise ValueError(f"at most {MAX_PAYLOADS} payloads, got "
                         f"{len(payloads)}")
    if key.dim() != 1:
        raise ValueError(f"key must be [E], got {list(key.shape)}")
    e = key.shape[0]
    dev = key.device
    _build.check_arg(key, torch.int32, (e,), dev, "key")
    for i, p in enumerate(payloads):
        if p.element_size() != 4:
            raise TypeError(f"payload {i} must be 32-bit, got {p.dtype}")
        _build.check_arg(p, p.dtype, (e,), dev, f"payload {i}")
    ep = padded_length(e)
    if ep > MAX_LENGTH:
        raise ValueError(f"E={e} pads past {MAX_LENGTH} entries")
    key_out = torch.empty_like(key)
    outs = [torch.empty_like(p) for p in payloads]
    if e == 0:
        return (key_out, *outs)
    words = torch.empty((ep,), dtype=torch.int64, device=dev)  # scratch
    arr = ctypes.c_void_p * MAX_PAYLOADS
    ins = arr(*(p.data_ptr() for p in payloads))
    dsts = arr(*(o.data_ptr() for o in outs))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _library().sortkv_stable(key.data_ptr(), e, ep,
                                      words.data_ptr(), key_out.data_ptr(),
                                      ins, dsts, len(payloads), stream)
    _build.check(rc, "sortkv_stable")
    sort_kv_stable.launches += 1
    return (key_out, *outs)


sort_kv_stable.launches = 0
