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

`live` (all three): a 0-dim integer tensor, the count of leading entries
to sort, clamped to [0, E]. The caller promises that the entries past it
are already in order and hold keys >= every key before it, as the exact
binning's sentinel tail does; the result is then bitwise the stable sort
of all E entries. The sort is in place: it writes the sorted prefix back
into the caller's arrays and returns them, and the tail is never moved.
The kernel reads `live` on the device (no host read, so a CUDA graph
captures the call); the plain twin checks the promise on the host.

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


def _live_length(key: Tensor, live) -> int:
    """`live` as a host int clamped to [0, E]."""
    return min(max(int(live), 0), key.shape[0])


def sort_kv_stable_plain(key: Tensor, *payloads: Tensor, live=None):
    """(sorted_key, *sorted_payloads): torch's stable sort and one gather
    per payload; with `live`, of the first `live` entries, in place, after
    a check that the tail keeps the promise (ValueError if not)."""
    if live is None:
        sorted_key, perm = torch.sort(key, stable=True)
        return (sorted_key, *(p[perm] for p in payloads))
    n = _live_length(key, live)
    tail = key[n:]
    if tail.numel() and (bool((tail[1:] < tail[:-1]).any())
                         or (n and int(tail[0]) < int(key[:n].max()))):
        raise ValueError(f"the entries past live={n} must be in order and "
                         "hold keys >= every key before it")
    sorted_key, perm = torch.sort(key[:n], stable=True)
    moved = [p[:n][perm] for p in payloads]
    for dst, src in zip((key, *payloads), (sorted_key, *moved)):
        dst[:n] = src
    return (key, *payloads)


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


def hops(run: list, in_place: bool):
    """The kernel's routing (`histogram_kernel`'s last CTA): (hop before
    each digit's launch, the number of hops, the dead digit that copies or
    -1). A hop is a live pass or the copy; hop h reads the input (h = 0)
    or hop h - 1's output and writes the outputs when n_hops - 1 - h is
    even, else the scratch set. Out of place with no live digit the copy
    moves the input to the outputs; in place an odd number of live digits
    takes one copy, so that the hops end in the caller's arrays."""
    copy = len(run) % 2 == 1 if in_place else not run
    copy_at = min(d for d in range(DIGITS) if d not in run) if copy else -1
    before, n = [], 0
    for d in range(DIGITS):
        before.append(n)
        n += d in run or d == copy_at
    return before, n, copy_at


def sort_kv_stable_model(key: Tensor, *payloads: Tensor, live=None):
    """The kernel's launches on the host: `((sorted_key, *sorted_payloads),
    digits_run)`. Each live digit scatters the first `live` (default all)
    keys and payloads to the index `_pass_positions` gives, and the copy
    moves them, between the input, a scratch set and the outputs as
    `hops` routes them; with `live` the outputs are the input's arrays."""
    n = key.shape[0] if live is None else _live_length(key, live)
    run = live_digits(key[:n])
    before, n_hops, copy_at = hops(run, live is not None)
    src_set = [key, *payloads]
    out = src_set if live is not None else [torch.empty_like(a)
                                            for a in src_set]
    scratch = [torch.empty_like(a) for a in src_set]

    def dst_of(h):
        return out if (n_hops - 1 - h) % 2 == 0 else scratch

    for d in range(DIGITS):
        if d not in run and d != copy_at:
            continue
        h = before[d]
        src, dst = (src_set if h == 0 else dst_of(h - 1)), dst_of(h)
        to = (_pass_positions(_digit(src[0][:n], d)) if d in run
              else torch.arange(n))
        for a, b in zip(src, dst):
            b[to] = a[:n]
    return tuple(out), run


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("sortkv")
    fn = lib.sortkv_stable
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.sortkv_control_words.argtypes = [ctypes.c_longlong]
    lib.sortkv_control_words.restype = ctypes.c_longlong
    return lib


def sort_kv_stable(key: Tensor, *payloads: Tensor, live=None):
    """Stable ascending sort of int32 `key` [E] with up to 8 32-bit
    payloads [E] -> (sorted_key, *sorted_payloads). With `live` (a 0-dim
    int32 tensor on key's device) only the first `live` entries are
    sorted, in place, under the promise in the module's docstring: the
    result is the caller's arrays, and what they held before is gone. A
    CPU tensor runs the plain twin; a CUDA tensor launches the kernels
    (E = 0 launches nothing)."""
    if key.device.type == "cpu":
        return sort_kv_stable_plain(key, *payloads, live=live)
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
    if live is None:
        key_out = torch.empty_like(key)
        outs = [torch.empty_like(p) for p in payloads]
    else:
        _build.check_arg(live, torch.int32, (), dev, "live")
        key_out, outs = key, list(payloads)
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
                               control.data_ptr(),
                               None if live is None else live.data_ptr(),
                               stream)
    _build.check(rc, "sortkv_stable")
    return (key_out, *outs)

