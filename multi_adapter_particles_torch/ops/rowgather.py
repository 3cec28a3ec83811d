"""Row gather: CUDA kernel + plain torch twin.

`gather_rows(table, idx)` is `table[idx]` with out-of-range indices clamped
to [0, R - 1], the semantics of XLA's gather that the JAX renderer relies
on for its dead virtual rows. The eager composite
(`ops/composite.composite_rows_inputs`) gathers its packed payload rows
with the plain version; the render path on the card runs no row gather.
The kernel (`csrc/rowgather.cu`) replaces the JAX package's Pallas
prototype `experiments/rowgather_pallas.py::pallas_gather`, a ring of
single-row DMAs; its `tile` and `depth` are TPU tuning and are not ported.

- CUDA tensors go to the kernel, or the wrapper raises.
- CPU tensors go to `gather_rows_plain`, the indexing expression.

The table holds 32-bit words of any type (float32, int32); the result is
bitwise the twin's.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from multi_adapter_particles_torch.ops import _build

Tensor = torch.Tensor


def gather_rows_plain(table: Tensor, idx: Tensor) -> Tensor:
    """table [R, W], idx [N] int -> [N, W] = table[clamp(idx, 0, R - 1)]."""
    return table[idx.clamp(0, table.shape[0] - 1).long()]


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("rowgather")
    fn = lib.gather_rows
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def gather_rows(table: Tensor, idx: Tensor) -> Tensor:
    """table [R, W] (32-bit), idx [N] int32 -> [N, W], rows clamped into
    range. A CPU tensor runs the plain twin; a CUDA tensor launches the
    kernel (counted in `gather_rows.launches`; N = 0 launches nothing)."""
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows runs on cuda or cpu, got {table.device}")
    if table.dim() != 2 or table.element_size() != 4 or idx.dim() != 1:
        raise ValueError(f"gather_rows takes table [R, W] of 32-bit words "
                         f"and idx [N], got {table.dtype} "
                         f"{list(table.shape)} and {list(idx.shape)}")
    rows, width = table.shape
    n = idx.shape[0]
    dev = table.device
    _build.check_arg(table, table.dtype, (rows, width), dev, "table")
    _build.check_arg(idx, torch.int32, (n,), dev, "idx")
    out = torch.empty((n, width), dtype=table.dtype, device=dev)
    if n == 0 or width == 0:
        return out
    if rows == 0:
        raise ValueError("gather_rows: a table with no rows has none to clamp to")
    vec = int(width % 4 == 0 and table.data_ptr() % 16 == 0
              and out.data_ptr() % 16 == 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _library().gather_rows(table.data_ptr(), rows, width,
                                    idx.data_ptr(), n, out.data_ptr(), vec,
                                    stream)
    _build.check(rc, "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
