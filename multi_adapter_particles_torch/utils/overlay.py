"""Panel-in-frame compositing — the imgui-drawn-into-the-swap-chain analog.

The port's own copy of the JAX package's `utils/overlay.py` (pure NumPy,
the same font, layout and hit test); its callers pass host frames
(`tensor.cpu().numpy()`).

The reference renders its control panel INTO the presented image
(`Render.cpp:894` draws imgui into the swap-chain target before Present).
The headless analog: the dashboard's viewer surfaces (the /stream push
and the HTML page) composite the text panel onto the frame pixels with a
5x7 bitmap font before encoding — the browser shows ONE image carrying
both the scene and the overlay, exactly like the reference's window.
`-dumpframe` stays clean (it is the scientific artifact, not the viewer).

Pure NumPy on the already-pulled host frame: zero device work, ~0.5 ms
for a 40x60-character panel at 720p.
"""

from __future__ import annotations

import numpy as np

# 5x7 font, one glyph per character: 7 rows of 5 bits (MSB = left column).
# Uppercase + digits + the punctuation the panel uses; lowercase is folded.
_GLYPHS = {
    " ": (0, 0, 0, 0, 0, 0, 0),
    "A": (0x0E, 0x11, 0x11, 0x1F, 0x11, 0x11, 0x11),
    "B": (0x1E, 0x11, 0x11, 0x1E, 0x11, 0x11, 0x1E),
    "C": (0x0E, 0x11, 0x10, 0x10, 0x10, 0x11, 0x0E),
    "D": (0x1E, 0x11, 0x11, 0x11, 0x11, 0x11, 0x1E),
    "E": (0x1F, 0x10, 0x10, 0x1E, 0x10, 0x10, 0x1F),
    "F": (0x1F, 0x10, 0x10, 0x1E, 0x10, 0x10, 0x10),
    "G": (0x0E, 0x11, 0x10, 0x17, 0x11, 0x11, 0x0F),
    "H": (0x11, 0x11, 0x11, 0x1F, 0x11, 0x11, 0x11),
    "I": (0x0E, 0x04, 0x04, 0x04, 0x04, 0x04, 0x0E),
    "J": (0x07, 0x02, 0x02, 0x02, 0x02, 0x12, 0x0C),
    "K": (0x11, 0x12, 0x14, 0x18, 0x14, 0x12, 0x11),
    "L": (0x10, 0x10, 0x10, 0x10, 0x10, 0x10, 0x1F),
    "M": (0x11, 0x1B, 0x15, 0x15, 0x11, 0x11, 0x11),
    "N": (0x11, 0x19, 0x15, 0x13, 0x11, 0x11, 0x11),
    "O": (0x0E, 0x11, 0x11, 0x11, 0x11, 0x11, 0x0E),
    "P": (0x1E, 0x11, 0x11, 0x1E, 0x10, 0x10, 0x10),
    "Q": (0x0E, 0x11, 0x11, 0x11, 0x15, 0x12, 0x0D),
    "R": (0x1E, 0x11, 0x11, 0x1E, 0x14, 0x12, 0x11),
    "S": (0x0F, 0x10, 0x10, 0x0E, 0x01, 0x01, 0x1E),
    "T": (0x1F, 0x04, 0x04, 0x04, 0x04, 0x04, 0x04),
    "U": (0x11, 0x11, 0x11, 0x11, 0x11, 0x11, 0x0E),
    "V": (0x11, 0x11, 0x11, 0x11, 0x11, 0x0A, 0x04),
    "W": (0x11, 0x11, 0x11, 0x15, 0x15, 0x1B, 0x11),
    "X": (0x11, 0x11, 0x0A, 0x04, 0x0A, 0x11, 0x11),
    "Y": (0x11, 0x11, 0x0A, 0x04, 0x04, 0x04, 0x04),
    "Z": (0x1F, 0x01, 0x02, 0x04, 0x08, 0x10, 0x1F),
    "0": (0x0E, 0x11, 0x13, 0x15, 0x19, 0x11, 0x0E),
    "1": (0x04, 0x0C, 0x04, 0x04, 0x04, 0x04, 0x0E),
    "2": (0x0E, 0x11, 0x01, 0x02, 0x04, 0x08, 0x1F),
    "3": (0x1F, 0x02, 0x04, 0x02, 0x01, 0x11, 0x0E),
    "4": (0x02, 0x06, 0x0A, 0x12, 0x1F, 0x02, 0x02),
    "5": (0x1F, 0x10, 0x1E, 0x01, 0x01, 0x11, 0x0E),
    "6": (0x06, 0x08, 0x10, 0x1E, 0x11, 0x11, 0x0E),
    "7": (0x1F, 0x01, 0x02, 0x04, 0x08, 0x08, 0x08),
    "8": (0x0E, 0x11, 0x11, 0x0E, 0x11, 0x11, 0x0E),
    "9": (0x0E, 0x11, 0x11, 0x0F, 0x01, 0x02, 0x0C),
    ".": (0x00, 0x00, 0x00, 0x00, 0x00, 0x0C, 0x0C),
    ",": (0x00, 0x00, 0x00, 0x00, 0x0C, 0x04, 0x08),
    ":": (0x00, 0x0C, 0x0C, 0x00, 0x0C, 0x0C, 0x00),
    ";": (0x00, 0x0C, 0x0C, 0x00, 0x0C, 0x04, 0x08),
    "-": (0x00, 0x00, 0x00, 0x1F, 0x00, 0x00, 0x00),
    "+": (0x00, 0x04, 0x04, 0x1F, 0x04, 0x04, 0x00),
    "_": (0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x1F),
    "=": (0x00, 0x00, 0x1F, 0x00, 0x1F, 0x00, 0x00),
    "/": (0x01, 0x01, 0x02, 0x04, 0x08, 0x10, 0x10),
    "\\": (0x10, 0x10, 0x08, 0x04, 0x02, 0x01, 0x01),
    "(": (0x02, 0x04, 0x08, 0x08, 0x08, 0x04, 0x02),
    ")": (0x08, 0x04, 0x02, 0x02, 0x02, 0x04, 0x08),
    "[": (0x0E, 0x08, 0x08, 0x08, 0x08, 0x08, 0x0E),
    "]": (0x0E, 0x02, 0x02, 0x02, 0x02, 0x02, 0x0E),
    "#": (0x0A, 0x1F, 0x0A, 0x0A, 0x0A, 0x1F, 0x0A),
    "%": (0x19, 0x19, 0x02, 0x04, 0x08, 0x13, 0x13),
    "*": (0x00, 0x0A, 0x04, 0x1F, 0x04, 0x0A, 0x00),
    "'": (0x04, 0x04, 0x08, 0x00, 0x00, 0x00, 0x00),
    '"': (0x0A, 0x0A, 0x14, 0x00, 0x00, 0x00, 0x00),
    "<": (0x02, 0x04, 0x08, 0x10, 0x08, 0x04, 0x02),
    ">": (0x08, 0x04, 0x02, 0x01, 0x02, 0x04, 0x08),
    "|": (0x04, 0x04, 0x04, 0x04, 0x04, 0x04, 0x04),
    "!": (0x04, 0x04, 0x04, 0x04, 0x04, 0x00, 0x04),
    "?": (0x0E, 0x11, 0x01, 0x06, 0x04, 0x00, 0x04),
}
_UNKNOWN = (0x1F, 0x11, 0x11, 0x11, 0x11, 0x11, 0x1F)

GLYPH_H = 7
GLYPH_W = 5
_CACHE: dict = {}


def _glyph(ch: str) -> np.ndarray:
    g = _CACHE.get(ch)
    if g is None:
        rows = _GLYPHS.get(ch.upper(), _UNKNOWN)
        g = np.array(
            [[(r >> (GLYPH_W - 1 - c)) & 1 for c in range(GLYPH_W)]
             for r in rows],
            dtype=bool,
        )
        _CACHE[ch] = g
    return g


def draw_text(
    img: np.ndarray,
    text: str,
    x: int = 6,
    y: int = 6,
    color=(255, 255, 255),
    shade: float = 0.55,
) -> np.ndarray:
    """Composite multi-line `text` onto img ([H, W, 3] uint8, IN PLACE).

    Each line gets a darkened backing strip (the imgui panel background
    analog) and 5x7 glyphs at 1 px tracking / 2 px leading."""
    h, w = img.shape[:2]
    color = np.asarray(color, dtype=np.uint8)
    line_h = GLYPH_H + 2
    for li, line in enumerate(text.splitlines()):
        ty = y + li * line_h
        if ty + GLYPH_H > h or not line:
            continue
        tw = min(len(line) * (GLYPH_W + 1) + 4, w - x)
        strip = img[ty - 1: ty + GLYPH_H + 1, x - 2: x - 2 + tw]
        np.multiply(strip, 1.0 - shade, out=strip, casting="unsafe")
        cx = x
        for ch in line:
            if cx + GLYPH_W > w:
                break
            if ch != " ":
                m = _glyph(ch)
                img[ty: ty + GLYPH_H, cx: cx + GLYPH_W][m] = color
            cx += GLYPH_W + 1
    return img


def composite_panel(frame, panel_text: str) -> np.ndarray:
    """[H, W, 3] float-or-uint8 frame -> uint8 frame with the panel drawn
    into the top-left corner (the in-window imgui analog)."""
    arr = np.asarray(frame)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    else:
        arr = arr.copy()
    return draw_text(arr, panel_text)


# -- click-on-frame hit testing ---------------------------------------------------
#
# The reference's panel is clickable INSIDE the render window: Win32
# messages go to imgui first (`WindowProc.cpp:39-42`), whose widgets
# live at known layout positions (`Particles.cpp:309-421`). The analog:
# the panel `draw_text` composites into the frame has fully deterministic
# geometry (TEXT_X/TEXT_Y origin, 6 px per character cell, 9 px per
# line), so a click on the STREAMED IMAGE maps back to a (line, column)
# of the very panel text that was drawn — and from there to the same
# named control the HTTP widgets drive (`runtime/controls.py`).

TEXT_X = 6
TEXT_Y = 6
CHAR_W = GLYPH_W + 1   # 6 px per character cell (1 px tracking)
LINE_H = GLYPH_H + 2   # 9 px per text line (2 px leading)

# panel slider label -> (control name, lo, hi or None=num_particles)
_SLIDER_CONTROLS = {
    "size": ("size", 0.0, 10.0),
    "intensity": ("intensity", 0.0, 1.0),
    "simulated": ("numsim", 0, None),
    "copied": ("numcopy", 0, None),
    "rendered": ("numdraw", 0, None),
}
_CHECKBOX_CONTROLS = {"linked", "vsync", "fullscreen", "ext", "draw"}


def hit_test(panel_text: str, px: int, py: int, num_particles: int):
    """Click at frame pixel (px, py) on the composited panel -> a
    `(control_name, value_string)` for `runtime.controls.apply_control`,
    or None when it misses every widget.

    Widgets, mirroring `render_ansi`'s layout:
    - slider rows (`label [####----] v`): clicking inside the bracket
      bar sets the value proportionally (imgui slider-drag semantics);
    - the checkbox row (`[x] linked  [ ] vsync ...`): clicking a box or
      its label toggles it;
    - adapter rows (`  [CR] i: ...`): the C column assigns that adapter
      the compute role, anywhere else on the row the render role (the
      two imgui list boxes, `Particles.cpp:339-352`).
    """
    col = (px - TEXT_X) // CHAR_W
    line_i = (py - (TEXT_Y - 1)) // LINE_H
    lines = panel_text.splitlines()
    if not (0 <= line_i < len(lines)) or col < 0:
        return None
    text = lines[line_i]
    if col >= len(text):
        return None

    # slider rows
    label = text[:12].strip().lower()
    if label in _SLIDER_CONTROLS and "[" in text:
        b0 = text.index("[") + 1
        b1 = text.index("]", b0)
        if b0 - 1 <= col <= b1:
            name, lo, hi = _SLIDER_CONTROLS[label]
            if hi is None:
                hi = num_particles
            t = (col - b0 + 0.5) / max(b1 - b0, 1)
            t = max(0.0, min(1.0, t))
            v = lo + t * (hi - lo)
            return (name, str(int(round(v))) if hi == num_particles
                    else f"{v:.2f}")

    # checkbox row(s): every "[x] label" / "[ ] label" segment
    i = 0
    while True:
        i = text.find("[", i)
        if i < 0 or i + 2 >= len(text):
            break
        if text[i + 2] == "]" and text[i + 1] in " x":
            rest = text[i + 4:]
            word = rest.split()[0].lower() if rest.split() else ""
            if word in _CHECKBOX_CONTROLS:
                end = i + 4 + len(word)
                if i <= col < end:
                    return (word, "0" if text[i + 1] == "x" else "1")
        i += 1

    # adapter rows: "  [CR] idx: platform description"
    if text.startswith("  [") and len(text) > 6 and text[5] == "]":
        after = text[6:].strip()
        idx = after.split(":", 1)[0].strip()
        if idx.isdigit():
            role = "computeadapter" if col <= 3 else "renderadapter"
            return (role, idx)
    return None
