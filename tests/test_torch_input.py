"""The port's InputState / TerminalInput (the WindowProc analog), mirroring
tests/test_input.py; plus the pin of the port's copy to the JAX package's
decoder (the same byte streams give the same states) and the port's
script reading: a stream that is not a tty yields one line of keys a
frame."""

import io
import os

import pytest

from multi_adapter_particles_tpu.runtime import input as jinput

from multi_adapter_particles_torch.runtime.input import InputState, TerminalInput


def make():
    ti = TerminalInput(stream=None)
    ti._fd = None  # force no-tty path; feed() injects keys
    return ti


def test_space_toggles_draw_edge():
    ti = make()
    st = ti.feed(" ")
    assert st.toggle_draw
    st = ti.feed("x")
    assert not st.toggle_draw  # edge cleared each frame


def test_escape_and_q_quit():
    # A lone ESC could be the start of a split escape sequence, so it
    # resolves one poll later (the standard terminal ESC-timeout, with
    # the frame poll as the timer).
    ti = make()
    assert not ti.feed("\x1b").quit
    assert ti.feed("").quit
    assert make().feed("q").quit
    assert make().feed("\x03").quit
    assert not make().feed("a").quit


def test_escape_then_key_quits_immediately():
    st = make().feed("\x1bw")  # ESC followed by a non-sequence byte
    assert st.quit and st.pressed == ["w"]


def test_arrow_escape_sequences():
    st = make().feed("\x1b[A\x1b[D")
    assert st.pressed == ["up", "left"]
    assert not st.quit  # arrows are not a bare ESC


def test_wasd_keys():
    st = make().feed("wasd")
    assert st.pressed == ["w", "a", "s", "d"]


def test_no_tty_is_noop():
    import io

    ti = TerminalInput(stream=io.StringIO())
    with ti:
        st = ti.poll()
    assert not st.quit and not st.pressed


def test_camera_integration():
    from multi_adapter_particles_torch.render.camera import Camera

    cam = Camera()
    y0 = cam.yaw
    st = make().feed("\x1b[D")
    for k in st.pressed:
        cam.key_down(k)
    cam.update(0.1)
    for k in st.pressed:
        cam.key_up(k)
    assert cam.yaw != y0  # left arrow turned the camera


def test_sgr_mouse_drag_deltas():
    """SGR drag: press at (10,5), motion to (14,8) then (13,8) — deltas
    accumulate over the frame; release clears the anchor."""
    ti = make()
    st = ti.feed("\x1b[<0;10;5M")         # left press
    assert st.mouse_down and st.mouse_dx == 0 and st.mouse_dy == 0
    st = ti.feed("\x1b[<32;14;8M\x1b[<32;13;8M")  # drag motion
    assert (st.mouse_dx, st.mouse_dy) == (3, 3)   # (4-1, 3+0)
    assert st.mouse_down
    st = ti.feed("\x1b[<0;13;8m")          # release
    assert not st.mouse_down
    # new frame: deltas are edges, cleared by poll
    st = ti.feed("")
    assert (st.mouse_dx, st.mouse_dy) == (0, 0)


def test_sgr_mouse_is_not_a_bare_escape():
    st = make().feed("\x1b[<0;1;1M\x1b[<0;1;1m")
    assert not st.quit and not st.pressed


def test_mouse_drag_drives_camera_yaw_pitch():
    from multi_adapter_particles_torch.render.camera import Camera

    cam = Camera()
    y0, p0 = cam.yaw, cam.pitch
    ti = make()
    ti.feed("\x1b[<0;10;5M")
    st = ti.feed("\x1b[<32;30;2M")
    cam.drag(st.mouse_dx, st.mouse_dy)
    assert cam.yaw != y0 and cam.pitch != p0
    # pitch clamp holds under a huge drag
    cam.drag(0, -10000)
    import math
    assert abs(cam.pitch) <= math.pi / 4 + 1e-9


def test_unknown_escape_sequences_are_ignored_not_quit():
    """F-keys, Delete, Home, Shift-Tab, modified arrows: complete CSI or
    SS3 sequences the app does not map must be consumed silently — not
    treated as a bare ESC (quit) + leaked control-panel key bytes."""
    for seq in ("\x1bOP",      # F1 (SS3)
                "\x1b[3~",     # Delete — '3' and '[' must not leak
                "\x1b[H",      # Home
                "\x1b[Z",      # Shift-Tab
                "\x1b[1;5C",   # Ctrl-Right
                "\x1b[15~"):   # F5
        st = make().feed(seq)
        assert not st.quit and st.pressed == [], seq


def test_unknown_sequence_split_across_polls_still_ignored():
    ti = make()
    assert not ti.feed("\x1b[1;5").quit      # Ctrl-Right, cut mid-params
    st = ti.feed("C")
    assert not st.quit and st.pressed == []


def test_truncated_sgr_report_resumes_across_polls():
    """A drag report split at an os.read boundary must neither quit the
    app nor leak its digits as control-panel keys — the tail waits for
    the next poll and decodes whole."""
    ti = make()
    ti.feed("\x1b[<0;10;5M")            # press anchors at (10, 5)
    st = ti.feed("\x1b[<32;14")          # fragment ends mid-report
    assert not st.quit and st.pressed == []
    assert (st.mouse_dx, st.mouse_dy) == (0, 0)
    st = ti.feed(";8M")                  # the rest arrives next frame
    assert not st.quit and st.pressed == []
    assert (st.mouse_dx, st.mouse_dy) == (4, 3)


def test_truncated_arrow_resumes_across_polls():
    ti = make()
    assert ti.feed("\x1b[").pressed == []
    st = ti.feed("A")
    assert st.pressed == ["up"] and not st.quit


def test_stale_fragment_is_dropped_not_quit():
    ti = make()
    ti.feed("\x1b[<32;1")   # fragment that never completes
    st = ti.feed("")        # one idle poll: line noise, discarded
    assert not st.quit and st.pressed == []
    st = ti.feed("w")       # stream keeps working afterwards
    assert st.pressed == ["w"]


def test_wheel_events_do_not_latch_mouse_down():
    """SGR wheel reports (btn>=64) have no release pair — they must not
    set mouse_down or move the drag anchor."""
    ti = make()
    st = ti.feed("\x1b[<64;10;5M\x1b[<65;10;5M")
    assert not st.mouse_down and not st.quit and st.pressed == []
    # a wheel event between press and drag must not poison the anchor
    ti.feed("\x1b[<0;10;5M")             # press at (10, 5)
    st = ti.feed("\x1b[<64;30;2M\x1b[<32;12;9M")  # wheel elsewhere, then drag
    assert (st.mouse_dx, st.mouse_dy) == (2, 4)
    assert st.mouse_down


def test_sgr_stream_split_at_every_boundary():
    """Fragmentation property: feeding a mixed key+mouse stream in two
    pieces — split at EVERY byte boundary — accumulates exactly the same
    state as the unsplit stream (no quit, no leaked keys, same deltas)."""
    stream = "w\x1b[<0;10;5M\x1b[<32;14;8M\x1b[A\x1b[<32;13;9M\x1b[<0;13;9ms"

    def run(feeds):
        ti = make()
        agg = {"dx": 0, "dy": 0, "pressed": [], "quit": False}
        for piece in feeds:
            st = ti.feed(piece)
            agg["dx"] += st.mouse_dx
            agg["dy"] += st.mouse_dy
            agg["pressed"] += st.pressed
            agg["quit"] |= st.quit
        # one more poll so a trailing fragment (if any) resolves
        st = ti.feed("")
        agg["dx"] += st.mouse_dx
        agg["dy"] += st.mouse_dy
        agg["pressed"] += st.pressed
        agg["quit"] |= st.quit
        return agg, ti.state.mouse_down

    want, down_want = run([stream])
    assert want == {"dx": 3, "dy": 4, "pressed": ["w", "up", "s"],
                    "quit": False}
    assert not down_want
    for cut in range(1, len(stream)):
        got, down = run([stream[:cut], stream[cut:]])
        assert got == want, f"split at {cut}: {got}"
        assert down == down_want, f"split at {cut}"


def test_pty_mouse_roundtrip():
    """End-to-end through a REAL pty: cbreak entry, injected SGR drag
    bytes, decoded deltas (the non-feed path: select + os.read)."""
    import os
    import pty
    import time

    master, slave = pty.openpty()
    stream = os.fdopen(slave, "rb", buffering=0)
    try:
        ti = TerminalInput(stream=stream)
        with ti:
            assert ti._fd is not None  # really went cbreak on the pty
            os.write(master, b"\x1b[<0;10;5M\x1b[<32;12;9M")
            time.sleep(0.05)
            st = ti.poll()
        assert st.mouse_down
        assert (st.mouse_dx, st.mouse_dy) == (2, 4)
    finally:
        stream.close()
        os.close(master)


# -- the pin: the port's decoder is the JAX package's ------------------------

_STREAMS = [
    " ", "q", "\x1b", "\x1bw", "\x1b[A\x1b[D", "wasd", "[]-=vefl123456",
    "\x1b[<0;10;5M\x1b[<32;14;8M\x1b[<32;13;8M\x1b[<0;13;8m",
    "\x1bOP\x1b[3~\x1b[H\x1b[Z\x1b[1;5C\x1b[15~", "\x1b[<32;1",
    "\x1b[<64;10;5M\x1b[<0;10;5M\x1b[<64;30;2M\x1b[<32;12;9M",
]


@pytest.mark.parametrize("stream", _STREAMS)
def test_decoder_equals_jax_package(stream):
    """Every split of each stream into two polls, then an idle poll, gives
    the same per-poll states in both packages."""
    for cut in range(len(stream) + 1):
        a, b = make(), jinput.TerminalInput(stream=None)
        b._fd = None
        for piece in (stream[:cut], stream[cut:], ""):
            sa, sb = a.feed(piece), b.feed(piece)
            assert vars(sa) == vars(sb), (cut, piece)


# -- scripted (non-tty) streams: a line a frame ------------------------------

def test_script_is_read_a_line_a_frame():
    ti = TerminalInput(stream=io.StringIO("c\n\n \nwq\n"))
    with ti:
        # poll() returns its one state object: copy each frame's fields
        frames = [dict(vars(ti.poll())) for _ in range(5)]
    assert frames[0]["pressed"] == ["c"] and not frames[0]["quit"]
    assert frames[1]["pressed"] == [] and not frames[1]["toggle_draw"]
    assert frames[2]["toggle_draw"]
    assert frames[3]["pressed"] == ["w"] and frames[3]["quit"]
    assert frames[4]["pressed"] == []  # past the end (quit stays latched)


def test_script_from_a_pipe():
    r, w = os.pipe()
    os.write(w, b"[\n")
    stream = os.fdopen(r, "r")
    try:
        ti = TerminalInput(stream=stream)
        with ti:
            assert ti.poll().pressed == ["["]
            assert ti.poll().pressed == []      # nothing written yet
            os.write(w, b"]")
            assert ti.poll().pressed == []      # a line without its end waits
            os.write(w, b"\nq\n")
            assert ti.poll().pressed == ["]"]
            os.close(w)
            w = None
            st = ti.poll()                      # end of the stream
            assert st.quit and st.pressed == []
    finally:
        stream.close()
        if w is not None:
            os.close(w)


def test_script_last_line_without_newline():
    ti = TerminalInput(stream=io.StringIO("c\nq"))
    with ti:
        assert ti.poll().pressed == ["c"]
        assert ti.poll().quit


def test_unreadable_stream_gives_no_keys():
    class Unreadable(io.StringIO):
        def read(self, *a):
            raise OSError("reading from stdin while output is captured")

    ti = TerminalInput(stream=Unreadable())
    with ti:
        st = ti.poll()
    assert not st.quit and not st.pressed
