"""Stable key + payload sort: CUDA kernel, plain torch twin, host model.

`sort_kv_stable(key, *payloads)` sorts an int32 key ascending, stably, and
permutes each 32-bit payload alike: `(sorted_key, *sorted_payloads)`, bit
for bit what the JAX package's `ops/sortkv.py::sort_kv_stable` promises
(`jax.lax.sort` on (key, iota, *payloads) with `is_stable=True`, minus the
iota), for any E. The renderer sorts its tile keys with the four sprite
payloads through it (`render/renderer.py`). The kernel (`csrc/sortkv.cu`,
a stable LSD radix sort over 8-bit digits that skips the digits all keys
share) replaces that module's Pallas bitonic network (`_make_kernel`,
launched by `_vmem_pass`).

- CUDA tensors go to the kernel, or the wrapper raises.
- CPU tensors go to `sort_kv_stable_plain`: `torch.sort(key, stable=True)`
  and one index gather per payload.
- `sort_kv_stable_model` replays the kernel's passes on the host at its
  tile and digit constants (tests only; nothing on the main path calls it).

Deviation from the JAX function: `block_log2` is TPU tuning and is not
ported; E is at most `MAX_LENGTH` (a look-back word's 30-bit count).

Payloads are opaque 32-bit words: float32, or int32 such as the renderer's
packed f16 pair.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from multi_adapter_particles_torch.ops import _build

Tensor = torch.Tensor

MAX_PAYLOADS = 8             # csrc/sortkv.cu kMaxPayloads
MAX_LENGTH = (1 << 30) - 1   # kMaxLength
RADIX_BITS = 8               # kRadixBits
RADIX = 1 << RADIX_BITS      # kRadix
DIGITS = 4                   # kDigits
WARPS = 16                   # kWarps
ITEMS = 12                   # kItems: a warp holds 32 * ITEMS entries a tile
TILE = 32 * WARPS * ITEMS    # kTile


def sort_kv_stable_plain(key: Tensor, *payloads: Tensor):
    """(sorted_key, *sorted_payloads): torch's stable sort and one gather
    per payload."""
    sorted_key, perm = torch.sort(key, stable=True)
    return (sorted_key, *(p[perm] for p in payloads))


def _digit(key: Tensor, d: int) -> Tensor:
    """Digit d (int64 in [0, RADIX)) of the kernel's ordering key
    (u32)key ^ 2^31."""
    u = (key.to(torch.int64) & 0xFFFFFFFF) ^ 0x80000000
    return (u >> (RADIX_BITS * d)) & (RADIX - 1)


def live_digits(key: Tensor) -> list:
    """The digits the kernel runs a pass for: those whose bins do not hold
    all E entries in one (none for E <= 1)."""
    e = key.shape[0]
    return [d for d in range(DIGITS)
            if e and int(torch.bincount(_digit(key, d),
                                        minlength=RADIX).max()) != e]


def _pass_positions(dig: Tensor) -> Tensor:
    """Each entry's output index in one digit pass, as the kernel builds
    it: per-tile bin counts, their exclusive scan in (bin, tile) order (the
    kernel's digit offsets plus its look-back), and the rank within the
    tile (the warp's exclusive offset plus the rank within the warp, whose
    rounds of 32 run in entry order)."""
    e = dig.shape[0]
    tiles = -(-e // TILE)
    padded = torch.full((tiles * TILE,), RADIX, dtype=torch.int64)
    padded[:e] = dig                      # RADIX: past the end, no bin
    hot = torch.nn.functional.one_hot(padded, RADIX + 1)[:, :RADIX]
    hot = hot.to(torch.int32).view(tiles, WARPS, 32 * ITEMS, RADIX)
    in_warp = hot.cumsum(2) - hot                       # earlier in the warp
    warp_count = hot.sum(2)                             # [tiles, WARPS, RADIX]
    warp_start = warp_count.cumsum(1) - warp_count
    count = warp_count.sum(1)                           # [tiles, RADIX]
    tile_start = count.cumsum(1) - count                # the stage's bin start
    flat = count.t().reshape(-1)                        # (bin, tile) order
    base = (flat.cumsum(0) - flat).view(RADIX, tiles).t()
    slot = tile_start[:, None, None, :] + warp_start[:, :, None, :] + in_warp
    out = base[:, None, None, :] - tile_start[:, None, None, :] + slot
    out = (out * hot).sum(3).reshape(-1)
    return out[:e].to(torch.int64)


def sort_kv_stable_model(key: Tensor, *payloads: Tensor):
    """The kernel's passes on the host: `((sorted_key, *sorted_payloads),
    digits_run)`. Each live digit scatters the key and every payload to the
    index `_pass_positions` gives; with no live digit the result is a copy
    of the input."""
    run = live_digits(key)
    cur = [key, *payloads]
    for d in run:
        to = _pass_positions(_digit(cur[0], d))
        nxt = [torch.empty_like(a) for a in cur]
        for a, b in zip(cur, nxt):
            b[to] = a
        cur = nxt
    if not run:
        cur = [a.clone() for a in cur]
    return tuple(cur), run


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("sortkv")
    fn = lib.sortkv_stable
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.sortkv_control_words.argtypes = [ctypes.c_longlong]
    lib.sortkv_control_words.restype = ctypes.c_longlong
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
    if e > MAX_LENGTH:
        raise ValueError(f"E={e} is past the kernel's {MAX_LENGTH} entries")
    key_out = torch.empty_like(key)
    outs = [torch.empty_like(p) for p in payloads]
    if e == 0:
        return (key_out, *outs)
    lib = _library()
    scratch = torch.empty(((1 + len(payloads)) * e,), dtype=torch.int32,
                          device=dev)
    control = torch.empty((lib.sortkv_control_words(e),), dtype=torch.int32,
                          device=dev)
    arr = ctypes.c_void_p * MAX_PAYLOADS
    ins = arr(*(p.data_ptr() for p in payloads))
    dsts = arr(*(o.data_ptr() for o in outs))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sortkv_stable(key.data_ptr(), e, key_out.data_ptr(), ins,
                               dsts, len(payloads), scratch.data_ptr(),
                               control.data_ptr(), stream)
    _build.check(rc, "sortkv_stable")
    sort_kv_stable.launches += 1
    return (key_out, *outs)


sort_kv_stable.launches = 0
