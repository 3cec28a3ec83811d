"""Minimal PNG encoder (stdlib only) for frame dumps and streaming.

The reference presents to a swap chain; headless, the equivalent artifacts
are a frame file (`write_png`) and the dashboard's live multipart stream
(`encode_png`, zlib level 1 for frame-rate encoding). Pillow isn't a baked
dependency, so this writes RGB8 PNGs with zlib directly (one IDAT,
filter 0 per scanline).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def encode_png(image: np.ndarray, level: int = 6) -> bytes:
    """[H, W, 3] uint8 (or float in [0, 1]) -> PNG bytes.

    `level` is the zlib effort: 6 for artifacts, 1 for the live stream
    (a 1280x720 frame encodes in a few ms at level 1).
    """
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3], got {img.shape}")
    h, w = img.shape[:2]
    # filter byte 0 prepended per scanline, vectorized
    rows = np.zeros((h, 1 + w * 3), dtype=np.uint8)
    rows[:, 1:] = img.reshape(h, w * 3)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # RGB8
    return (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
        + _chunk(b"IEND", b"")
    )


def write_png(path: str, image: np.ndarray) -> None:
    """image: [H, W, 3] uint8 or float in [0, 1]."""
    with open(path, "wb") as f:
        f.write(encode_png(image, level=6))
