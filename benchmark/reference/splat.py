"""The demo's point-sprite frame (`ParticleDraw.hlsl`, blend state
`Render.cpp:522-532`), drawn the plain way: every sprite's pixels, blended
one after another in particle order.

- Each particle is a camera-facing square of half-size `size` (eye units).
  It projects to a screen rectangle centred at (cx, cy) with half-extents
  hx = size * p00 / w * W / 2 and hy = size * p11 / w * H / 2; it covers
  the pixels [ceil(cx - hx - 0.5), ceil(cx + hx - 0.5)) along x (pixel
  centres at +0.5), clipped to the frame, likewise along y. Particles
  past the first `num_draw`, or with w <= near, draw nothing.
- A pixel's alpha is clamp(0.5 - |((px - cx) / 2hx, (py - cy) / 2hy)|, 0,
  0.5) * intensity (the radial sprite).
- Colour: g = 0.1 + 0.9 * pos.w / 9 (unclamped), b = (id & 4095) / 4095,
  r = 1 - b (`ParticleDraw.hlsl:104-109`); g and b are stored as float16
  (g clamped to [0, 6e4] first) and r is 1 minus the stored b, as the
  frame's sprite records hold them.
- Blend "over" in draw order: C = C * (1 - alpha) + clamp(c * alpha, 0,
  1) per channel, from C = 0; the frame is clamp(C, 0, 1).

The geometry and the colours are worked out in float32 with the demo's
formulas and the blend in `dtype` (float64 for the reference); a control
in a precision below float32 works all of it in that precision. Sprites are
taken in blocks of `block` particles, each block's pixels blended in
order and the blocks folded in order (later = C_l + C_e T_l, T_e T_l),
which the "over" blend allows exactly.
"""

from __future__ import annotations

import numpy as np
import torch

COLD_G, HOT_G = 0.1, 1.0
ACCEL_COLOR_SCALE = 9.0
ID_MASK = 0xFFF


def _sprites(position, ids, view: dict, dtype):
    """Per sprite: pixel rectangle (int64), centre, 1/(2h) and colour."""
    wvp, p00, p11 = view["wvp"], view["p00"], view["p11"]
    width, height, size = view["width"], view["height"], view["size"]
    # the demo's float32 geometry; a control below float32 works in its own
    geo = torch.float32 if dtype == torch.float64 else dtype
    m = torch.as_tensor(wvp, device=position.device).to(geo)
    x, y, z, pw = (position[i].to(geo) for i in range(4))
    cx_clip = x * m[0, 0] + y * m[1, 0] + z * m[2, 0] + m[3, 0]
    cy_clip = x * m[0, 1] + y * m[1, 1] + z * m[2, 1] + m[3, 1]
    w = x * m[0, 3] + y * m[1, 3] + z * m[2, 3] + m[3, 3]
    inv_w = 1.0 / w
    cx = (cx_clip * inv_w + 1.0) * (0.5 * width)
    cy = (1.0 - cy_clip * inv_w) * (0.5 * height)
    # the sprite size times the projection's scale, a float32 product
    hx = float(np.float32(size) * np.float32(p00)) * inv_w * (0.5 * width)
    hy = float(np.float32(size) * np.float32(p11)) * inv_w * (0.5 * height)

    def bound(edge, limit):
        return torch.clamp(torch.ceil(edge - 0.5), 0.0, float(limit)).to(
            torch.int64)

    x0, x1 = bound(cx - hx, width), bound(cx + hx, width)
    y0, y1 = bound(cy - hy, height), bound(cy + hy, height)
    live = (ids < view["num_draw"]) & (w > view["near"])
    live &= (x0 < x1) & (y0 < y1)

    g = COLD_G + (pw * (1.0 / ACCEL_COLOR_SCALE)) * (HOT_G - COLD_G)
    b = (ids & ID_MASK).to(geo) * (1.0 / ID_MASK)
    if dtype == torch.float64:
        g = torch.clamp(g, 0.0, 6.0e4).to(torch.float16)
        b = b.to(torch.float16)
    g, b = g.to(dtype), b.to(dtype)
    color = torch.stack([1.0 - b, g, b])
    # 1 / (2 hx) = w / (size * p00 * W), as the sprite record keeps it
    ihx = w.to(dtype) * (1.0 / (size * p00 * width))
    ihy = w.to(dtype) * (1.0 / (size * p11 * height))
    sel = torch.nonzero(live).squeeze(1)
    return (sel, x0[sel], x1[sel], y0[sel], y1[sel], cx[sel].to(dtype),
            cy[sel].to(dtype), ihx[sel], ihy[sel], color[:, sel])


def _block(position, first_id: int, view: dict, dtype):
    """(C [3, H*W], T [H*W]) of one block of sprites blended in order."""
    dev = position.device
    width, height = view["width"], view["height"]
    ids = torch.arange(first_id, first_id + position.shape[1],
                       device=dev, dtype=torch.int64)
    sel, x0, x1, y0, y1, cx, cy, ihx, ihy, color = _sprites(
        position, ids, view, dtype)
    pixels = width * height
    c_out = torch.zeros((3, pixels), dtype=dtype, device=dev)
    t_out = torch.ones(pixels, dtype=dtype, device=dev)
    if sel.numel() == 0:
        return c_out, t_out
    # one entry per covered pixel, sprites in draw order
    span_x = x1 - x0
    count = span_x * (y1 - y0)
    sprite = torch.repeat_interleave(
        torch.arange(sel.numel(), device=dev), count)
    first = torch.cumsum(count, 0) - count
    k = torch.arange(sprite.numel(), device=dev) - first[sprite]
    px = x0[sprite] + k % span_x[sprite]
    py = y0[sprite] + k // span_x[sprite]
    du = (px.to(dtype) + 0.5 - cx[sprite]) * ihx[sprite]
    dv = (py.to(dtype) + 0.5 - cy[sprite]) * ihy[sprite]
    alpha = torch.clamp(0.5 - torch.sqrt(du * du + dv * dv), 0.0, 0.5)
    alpha = alpha * view["intensity"]
    src = torch.clamp(color[:, sprite] * alpha, 0.0, 1.0)
    pixel = py * width + px
    # entries by pixel, then draw order (sprite index follows the id)
    order = torch.argsort(pixel * sel.numel() + sprite)
    pixel, alpha, src = pixel[order], alpha[order], src[:, order]
    # pixel runs, deepest first: depth step k touches the runs longer
    # than k, which are a prefix of that order
    run_pixel, run_len = torch.unique_consecutive(pixel, return_counts=True)
    run_first = torch.cumsum(run_len, 0) - run_len
    by_len = torch.argsort(run_len, descending=True, stable=True)
    run_pixel, run_len, run_first = (run_pixel[by_len], run_len[by_len],
                                     run_first[by_len])
    # active[d]: the runs longer than d
    active = torch.bincount(run_len - 1, minlength=int(run_len[0]))
    active = torch.flip(torch.cumsum(torch.flip(active, [0]), 0), [0])
    runs = run_pixel.numel()
    c = torch.zeros((3, runs), dtype=dtype, device=dev)
    t = torch.ones(runs, dtype=dtype, device=dev)
    for depth, m in enumerate(active.tolist()):
        at = run_first[:m] + depth
        a = alpha[at]
        keep = 1.0 - a
        c[:, :m] = c[:, :m] * keep + src[:, at]
        t[:m] = t[:m] * keep
    c_out[:, run_pixel] = c
    t_out[run_pixel] = t
    return c_out, t_out


def render(position, view: dict, n: int, dtype=torch.float64,
           block: int = 1 << 22):
    """[H, W, 3] float32 frame of the first `n` particles of position
    [4, Np]. `view`: width, height, wvp, p00, p11, size, intensity, near,
    num_draw."""
    width, height = view["width"], view["height"]
    c_all = t_all = None
    for first in range(0, n, block):
        c, t = _block(position[:, first:min(first + block, n)], first,
                      view, dtype)
        if c_all is None:
            c_all, t_all = c, t
        else:
            c_all = c + c_all * t
            t_all = t_all * t
    frame = torch.clamp(c_all, 0.0, 1.0).to(torch.float32)
    return frame.reshape(3, height, width).permute(1, 2, 0)
