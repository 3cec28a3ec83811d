"""Keyboard + mouse input handling — the WindowProc / InputState analog.

The port's own copy of the JAX package's `runtime/input.py` (same decoding
of keys, arrows and SGR mouse reports), with one addition: a stream that
is not a terminal is read as a script, one line a frame.

The reference translates Win32 messages into an `InputState` consumed by
the camera and app (`WindowProc.cpp:37-152`): ESC quits, SPACE toggles
drawing, arrows/WASD fly the camera (forwarded but effectively unused —
`Render.cpp:773` updates with dt=0), and WM_MOUSEMOVE deltas ride the
same struct (`WindowProc.h:39-72`). Headless, the same contract reads
raw terminal keys without blocking the frame loop, and mouse drags via
xterm SGR mouse reporting (modes 1002 button-event + 1006 SGR encoding:
`ESC [ < b ; x ; y M/m`) — unlike the reference, the drag actually
drives the camera (yaw/pitch), since dt=0 upstream made the fields dead.

`InputState` carries one frame's worth of edge/level state; `TerminalInput`
is the message pump: put the tty in cbreak mode, poll with select, decode
escape sequences for arrows.

A stream that is not a tty (a pipe, a file, an `io.StringIO`) is a script:
each poll takes its next line as that frame's keys (an empty line is a
frame with none; the end of the stream leaves every later frame without
keys). That drives `-interactive` on a machine without a terminal:
`printf 'c\\nc\\n \\nq\\n' | python -m multi_adapter_particles_torch
-interactive ...`. A stream that cannot be read gives no keys.
"""

from __future__ import annotations

import io
import os
import re
import select
import sys
from dataclasses import dataclass, field
from typing import List, Optional, Set


@dataclass
class InputState:
    """Per-frame input snapshot (`WindowProc.h:39-72` analog)."""

    quit: bool = False
    toggle_draw: bool = False          # SPACE edge (Main-Particles.cpp:86-88)
    keys_down: Set[str] = field(default_factory=set)   # held (level) keys
    pressed: List[str] = field(default_factory=list)   # this frame's edges
    mouse_dx: int = 0                  # drag deltas, terminal cells
    mouse_dy: int = 0                  # (accumulated over this frame)
    mouse_down: bool = False           # left button held (level)

    def clear_edges(self):
        self.toggle_draw = False
        self.pressed = []
        self.mouse_dx = 0
        self.mouse_dy = 0


_ESCAPE_SEQS = {
    "[A": "up", "[B": "down", "[C": "right", "[D": "left",
    "OA": "up", "OB": "down", "OC": "right", "OD": "left",
}

# SGR mouse report: ESC [ < button ; col ; row (M=press/motion, m=release)
_SGR_MOUSE = re.compile(r"\[<(\d+);(\d+);(\d+)([Mm])")

# A complete CSI sequence (ECMA-48): ESC [ params intermediates final.
# Unknown-but-complete sequences (F-keys \x1b[3~ / \x1bOP, Home \x1b[H,
# Shift-Tab \x1b[Z, modified arrows \x1b[1;5C, ...) are consumed
# silently — only a true lone ESC quits (WindowProc.cpp:66-69).
_CSI_SEQ = re.compile(r"\[[0-?]*[ -/]*[@-~]")
_SS3_SEQ = re.compile(r"O.")

# Everything (after the ESC) that could still grow into a complete
# sequence: nothing yet, an SS3 prefix, or a partial CSI (which covers
# partial SGR mouse reports). Drag reports arrive many per frame and
# fragment at os.read/select boundaries, so a trailing partial must wait
# for the next poll instead of being misread as a bare ESC (quit!) +
# control-panel key bytes.
_SEQ_PREFIX = re.compile(r"\[[0-?]*[ -/]*|O|")
_PENDING_MAX = 24  # longest legal report is ~16 bytes; beyond = garbage


class TerminalInput:
    """cbreak-mode key reader; a line-a-frame script reader when the
    stream is not a tty."""

    def __init__(self, stream=None, mouse: bool = True):
        self.stream = stream if stream is not None else sys.stdin
        self._fd: Optional[int] = None
        self._saved = None
        self._mouse_wanted = mouse
        self._mouse_on = False
        self._last_xy: Optional[tuple] = None
        self._pending = ""  # trailing partial escape sequence, carried
        self._script = False       # a non-tty stream, read a line a frame
        self._script_buf = ""
        self._script_eof = False
        self.state = InputState()

    # -- lifecycle -----------------------------------------------------------
    def __enter__(self):
        try:
            if self.stream.isatty():
                import termios
                import tty

                self._fd = self.stream.fileno()
                self._saved = termios.tcgetattr(self._fd)
                tty.setcbreak(self._fd)
                if self._mouse_wanted:
                    # 1002: report presses/releases + drag motion;
                    # 1006: SGR encoding (unambiguous, >223-col safe)
                    sys.stdout.write("\x1b[?1002h\x1b[?1006h")
                    sys.stdout.flush()
                    self._mouse_on = True
            else:
                self._script = True
        except (OSError, ValueError, ImportError):
            self._fd = None
        return self

    def __exit__(self, *exc):
        if self._mouse_on:
            sys.stdout.write("\x1b[?1002l\x1b[?1006l")
            sys.stdout.flush()
            self._mouse_on = False
        if self._fd is not None and self._saved is not None:
            import termios

            termios.tcsetattr(self._fd, termios.TCSADRAIN, self._saved)
        return False

    # -- polling -------------------------------------------------------------
    def _read_script(self) -> str:
        """What a non-tty stream holds now, without blocking: what select
        says is ready on a file descriptor, else the whole stream (an
        in-memory one). Sets `_script_eof` at its end."""
        try:
            fd = self.stream.fileno()
        except (OSError, ValueError, io.UnsupportedOperation):
            fd = None
        try:
            if fd is None:
                self._script_eof = True
                return self.stream.read()
            chunks = []
            while select.select([fd], [], [], 0)[0]:
                b = os.read(fd, 4096)
                if not b:
                    self._script_eof = True
                    break
                chunks.append(b.decode(errors="ignore"))
            return "".join(chunks)
        except (OSError, ValueError):
            self._script_eof = True   # unreadable (e.g. a captured stdin)
            return ""

    def _read_available(self) -> str:
        if self._script:
            buf = self._script_buf
            if "\n" not in buf and not self._script_eof:
                buf += self._read_script()
            if "\n" in buf:
                line, _, self._script_buf = buf.partition("\n")
                return line
            self._script_buf = "" if self._script_eof else buf
            return buf if self._script_eof else ""
        if self._fd is None:
            return ""
        chunks = []
        while select.select([self._fd], [], [], 0)[0]:
            try:
                chunks.append(os.read(self._fd, 64).decode(errors="ignore"))
            except OSError:
                break
        return "".join(chunks)

    def poll(self) -> InputState:
        """Drain pending keys into a fresh edge state (call once per frame)."""
        self.state.clear_edges()
        data = self._read_available()
        carried = self._pending
        buf = carried + data
        self._pending = ""
        i = 0
        while i < len(buf):
            ch = buf[i]
            if ch == "\x1b":
                m = _SGR_MOUSE.match(buf, i + 1)
                if m:
                    btn, col, row = (int(m.group(k)) for k in (1, 2, 3))
                    press = m.group(4) == "M"
                    if btn & 64:
                        # wheel / extended buttons: stateless one-shots
                        # with no release pair — must not latch
                        # mouse_down or move the drag anchor
                        pass
                    elif btn & 32:  # motion with a button held (mode 1002)
                        if self._last_xy is not None:
                            self.state.mouse_dx += col - self._last_xy[0]
                            self.state.mouse_dy += row - self._last_xy[1]
                        self._last_xy = (col, row)
                    elif (btn & 3) != 3 and press:  # button down
                        self.state.mouse_down = True
                        self._last_xy = (col, row)
                    else:  # release
                        self.state.mouse_down = False
                        self._last_xy = None
                    i = m.end()
                    continue
                key = _ESCAPE_SEQS.get(buf[i + 1 : i + 3])
                if key:
                    self.state.pressed.append(key)
                    i += 3
                    continue
                m = _CSI_SEQ.match(buf, i + 1) or _SS3_SEQ.match(buf, i + 1)
                if m:
                    i = m.end()  # complete unknown sequence: ignore it
                    continue
                rest = buf[i + 1 :]
                if len(rest) < _PENDING_MAX and _SEQ_PREFIX.fullmatch(rest):
                    # A sequence split across reads. Hold the tail for
                    # the next poll — unless it already waited a full
                    # poll with no new bytes: then a lone ESC is a real
                    # keypress and a longer fragment is line noise.
                    if not (data == "" and buf[i:] == carried):
                        self._pending = buf[i:]
                        break
                    if rest == "":
                        self.state.quit = True  # ESC (WindowProc.cpp:66-69)
                    i = len(buf)
                    continue
                self.state.quit = True  # ESC + plain byte (alt-key): ESC
                i += 1
                continue
            if ch == " ":
                self.state.toggle_draw = True
            elif ch in ("q", "\x03"):  # q / ctrl-c
                self.state.quit = True
            elif ch.lower() in "wasdcrvefl" or ch in "[]-=123456":
                # fly keys, adapter-cycle keys, and the control-panel keys
                # (size/intensity/counts/toggles — see runtime/controls.py)
                self.state.pressed.append(ch.lower())
            i += 1
        return self.state

    def feed(self, text: str) -> InputState:
        """Test hook: process keys as if typed."""
        self.state.clear_edges()
        saved_read = self._read_available
        try:
            self._read_available = lambda: text  # type: ignore
            return self.poll()
        finally:
            self._read_available = saved_read  # type: ignore
