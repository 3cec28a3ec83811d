"""Segmented sprite composite: CUDA kernel + plain torch twin.

The renderer splits the sorted sprite stream into virtual rows (one
tile slice of one Q-aligned data row each) and blends each row's Q slots
in draw order. `composite_rows` runs that depth-Q pass
(`csrc/composite.cu`, replacing the JAX package's Pallas
`ops/composite.py::_kernel`).

- CUDA tensors go to the kernel, or the wrapper raises.
- CPU tensors go to `composite_rows_plain`, a Python loop over Q that
  mirrors the renderer's XLA scan (`render/renderer.py:463-498` in the JAX
  package).

Layout (the JAX package's public one): sp [8, Q, V] with channels 0 cx,
1 cy, 2 1/(2hx), 3 1/(2hy), 4 r, 5 g, 6 b, 7 alpha scale (zero for dead
slots); bases [2, V] tile base pixel (x, y); row_hi [V] int32, the
exclusive bound of each row's live slots (slots at or past it must carry
alpha scale 0). Output [4, px, V]: premultiplied r, g, b and
transmittance, px = tile_h * tile_w.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from multi_adapter_particles_torch.ops import _build

Tensor = torch.Tensor

_BLENDS = {"over": 0, "additive": 1}
# Rounding after every multiply and add, like the twin's separate ops
# (see the note at the top of csrc/composite.cu).
_NVCC_FLAGS = ("-fmad=false",)


def _pixel_centers(bases: Tensor, tile_h: int, tile_w: int):
    """[px, V] pixel-center planes of every row's tile."""
    pix = torch.arange(tile_h * tile_w, device=bases.device)
    x_in = (pix % tile_w).to(torch.float32)[:, None]
    y_in = (pix // tile_w).to(torch.float32)[:, None]
    return bases[0][None, :] + x_in + 0.5, bases[1][None, :] + y_in + 0.5


def composite_rows_plain(
    sp: Tensor,
    bases: Tensor,
    tile_h: int,
    tile_w: int,
    blend: str = "over",
    row_hi: Optional[Tensor] = None,
) -> Tensor:
    """Plain torch twin: -> [4, px, V]. The loop stops at max(row_hi):
    slots past a row's bound blend alpha 0 — an exact identity — so this
    equals the full-Q loop bit for bit."""
    if blend not in _BLENDS:
        raise ValueError(f"unknown blend {blend!r}")
    _, q_len, v = sp.shape
    px = tile_h * tile_w
    pxc, pyc = _pixel_centers(bases, tile_h, tile_w)
    cr = torch.zeros((px, v), dtype=torch.float32, device=sp.device)
    cg = torch.zeros_like(cr)
    cb = torch.zeros_like(cr)
    tt = torch.ones_like(cr)
    trips = q_len if row_hi is None else min(
        max(int(row_hi.max()) if v else 0, 0), q_len
    )
    for q in range(trips):
        scx, scy, ihx, ihy, sr, sg, sb, sa = (sp[c, q][None, :]
                                              for c in range(8))
        du = (pxc - scx) * ihx
        dv = (pyc - scy) * ihy
        dist = torch.sqrt(du * du + dv * dv)
        alpha = torch.clamp(0.5 - dist, 0.0, 0.5) * sa
        if blend == "over":
            keep = 1.0 - alpha
            cr = cr * keep + torch.clamp(sr * alpha, 0.0, 1.0)
            cg = cg * keep + torch.clamp(sg * alpha, 0.0, 1.0)
            cb = cb * keep + torch.clamp(sb * alpha, 0.0, 1.0)
            tt = tt * keep
        else:
            cr = cr + torch.clamp(sr * alpha, 0.0, 1.0)
            cg = cg + torch.clamp(sg * alpha, 0.0, 1.0)
            cb = cb + torch.clamp(sb * alpha, 0.0, 1.0)
    return torch.stack([cr, cg, cb, tt])


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("composite", _NVCC_FLAGS)
    fn = lib.composite_rows
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def composite_rows(
    sp: Tensor,
    bases: Tensor,
    tile_h: int,
    tile_w: int,
    blend: str = "over",
    row_hi: Optional[Tensor] = None,
) -> Tensor:
    """-> [4, px, V] premultiplied rgb + transmittance per virtual row.

    A CPU tensor runs the plain twin; a CUDA tensor launches the kernel
    (counted in `composite_rows.launches`). `row_hi` None = every row
    loops the full Q."""
    if sp.device.type == "cpu":
        return composite_rows_plain(sp, bases, tile_h, tile_w, blend, row_hi)
    if sp.device.type != "cuda":
        raise ValueError(f"composite_rows runs on cuda or cpu, got {sp.device}")
    if blend not in _BLENDS:
        raise ValueError(f"unknown blend {blend!r}")
    if sp.dim() != 3 or sp.shape[0] != 8:
        raise ValueError(f"sp must be [8, Q, V], got {tuple(sp.shape)}")
    _, q_len, v = sp.shape
    dev = sp.device
    checks = [(sp, torch.float32, (8, q_len, v), "sp"),
              (bases, torch.float32, (2, v), "bases")]
    if row_hi is not None:
        checks.append((row_hi, torch.int32, (v,), "row_hi"))
    for t, dtype, shape, what in checks:
        _build.check_arg(t, dtype, shape, dev, what)
    px = tile_h * tile_w
    out = torch.empty((4, px, v), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _library().composite_rows(
            sp.data_ptr(), bases.data_ptr(),
            None if row_hi is None else row_hi.data_ptr(),
            out.data_ptr(), q_len, v, tile_h, tile_w, _BLENDS[blend], stream,
        )
    _build.check(rc, "composite_rows")
    composite_rows.launches += 1
    return out


composite_rows.launches = 0
