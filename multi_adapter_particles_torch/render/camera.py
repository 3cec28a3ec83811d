"""Fly camera with DirectXMath-convention matrices.

Reproduces the reference camera exactly (`dx-samples-include/SimpleCamera.cpp`):
- yaw/pitch fly controls (WASD + arrows), pitch clamped to +/- pi/4,
  look direction (r*sin(yaw), sin(pitch), r*cos(yaw)) with r = cos(pitch)
  and yaw starting at pi (looking down -z);
- row-vector / row-major convention: v_clip = v_world @ view @ proj,
  matching XMMatrixLookToRH / XMMatrixPerspectiveFovRH so that constants
  (fov 0.8, near 1, far 5000, eye (0,0,1500) — `Render.cpp:139,776`)
  give the same image framing.

An own copy of the JAX package's numpy-only `render/camera.py` (that
package cannot be imported without jax); `tests/test_torch_basics.py`
asserts the matrices are equal.

In the demo the camera is effectively static (`Render.cpp:773` calls
Update(0) and keys are never forwarded), but the full control surface is
kept because it is part of the reference's capability set.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

from multi_adapter_particles_torch import constants as C


def look_to_rh(eye: np.ndarray, direction: np.ndarray, up: np.ndarray) -> np.ndarray:
    """XMMatrixLookToRH, row-vector convention (v' = v @ M). float32 [4, 4]."""
    eye = np.asarray(eye, dtype=np.float64)
    d = np.asarray(direction, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    z = -d / np.linalg.norm(d)
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    m = np.eye(4, dtype=np.float64)
    m[:3, 0] = x
    m[:3, 1] = y
    m[:3, 2] = z
    m[3, 0] = -np.dot(x, eye)
    m[3, 1] = -np.dot(y, eye)
    m[3, 2] = -np.dot(z, eye)
    return m.astype(np.float32)


def perspective_fov_rh(
    fov_y: float, aspect: float, near: float, far: float
) -> np.ndarray:
    """XMMatrixPerspectiveFovRH, row-vector convention. float32 [4, 4].

    Maps view z in [-near, -far] to ndc z in [0, 1]; w_clip = -z_view.
    """
    h = 1.0 / math.tan(fov_y * 0.5)
    w = h / aspect
    m = np.zeros((4, 4), dtype=np.float64)
    m[0, 0] = w
    m[1, 1] = h
    m[2, 2] = far / (near - far)
    m[2, 3] = -1.0
    m[3, 2] = near * far / (near - far)
    return m.astype(np.float32)


@dataclasses.dataclass
class Camera:
    """SimpleCamera-equivalent state machine."""

    position: Tuple[float, float, float] = C.CAMERA_POSITION
    yaw: float = math.pi
    pitch: float = 0.0
    move_speed: float = 250.0  # Render.cpp:140 SetMoveSpeed(250)
    turn_speed: float = math.pi / 2
    up: Tuple[float, float, float] = (0.0, 1.0, 0.0)

    def __post_init__(self):
        self._initial = tuple(self.position)
        self.keys = {
            k: False
            for k in ("w", "a", "s", "d", "left", "right", "up", "down")
        }

    # -- controls ------------------------------------------------------------
    def key_down(self, key: str):
        key = key.lower()
        if key in self.keys:
            self.keys[key] = True
        elif key == "escape":
            self.reset()

    def key_up(self, key: str):
        key = key.lower()
        if key in self.keys:
            self.keys[key] = False

    def reset(self):
        self.position = tuple(self._initial)
        self.yaw = math.pi
        self.pitch = 0.0

    def drag(self, dx: float, dy: float, sensitivity: float = 0.01):
        """Mouse-look: drag deltas to yaw/pitch (same clamp as keys).

        The reference FORWARDS mouse deltas into InputState
        (`WindowProc.cpp:37-152`) but its camera never consumes them
        (`Render.cpp:773` updates with dt=0) — here the drag is live;
        deviation noted in PARITY.md."""
        self.yaw -= dx * sensitivity
        self.pitch -= dy * sensitivity
        self.pitch = max(-math.pi / 4, min(math.pi / 4, self.pitch))

    def update(self, elapsed_seconds: float):
        """Advance the fly-cam state (the reference passes 0 every frame)."""
        mx = (-1.0 if self.keys["a"] else 0.0) + (1.0 if self.keys["d"] else 0.0)
        mz = (-1.0 if self.keys["w"] else 0.0) + (1.0 if self.keys["s"] else 0.0)
        if abs(mx) > 0.1 and abs(mz) > 0.1:
            inv = 1.0 / math.sqrt(mx * mx + mz * mz)
            mx *= inv
            mz *= inv
        move = self.move_speed * elapsed_seconds
        turn = self.turn_speed * elapsed_seconds
        if self.keys["left"]:
            self.yaw += turn
        if self.keys["right"]:
            self.yaw -= turn
        if self.keys["up"]:
            self.pitch += turn
        if self.keys["down"]:
            self.pitch -= turn
        self.pitch = max(-math.pi / 4, min(math.pi / 4, self.pitch))
        px, py, pz = self.position
        px += (mx * -math.cos(self.yaw) - mz * math.sin(self.yaw)) * move
        pz += (mx * math.sin(self.yaw) - mz * math.cos(self.yaw)) * move
        self.position = (px, py, pz)

    @property
    def look_direction(self) -> Tuple[float, float, float]:
        r = math.cos(self.pitch)
        return (r * math.sin(self.yaw), math.sin(self.pitch), r * math.cos(self.yaw))

    # -- matrices ------------------------------------------------------------
    def view_matrix(self) -> np.ndarray:
        return look_to_rh(
            np.asarray(self.position), np.asarray(self.look_direction), np.asarray(self.up)
        )

    def projection_matrix(
        self,
        aspect: float,
        fov_y: float = C.CAMERA_FOV_Y,
        near: float = C.CAMERA_NEAR,
        far: float = C.CAMERA_FAR,
    ) -> np.ndarray:
        return perspective_fov_rh(fov_y, aspect, near, far)

    def world_view_projection(self, aspect: float, **kw) -> np.ndarray:
        return (
            self.view_matrix().astype(np.float64)
            @ self.projection_matrix(aspect, **kw).astype(np.float64)
        ).astype(np.float32)

    def view_rotation(self) -> np.ndarray:
        """Upper-left 3x3 of the view matrix: world -> eye rotation
        (its transpose is the billboard orientation the GS uses via
        (float3x3)g_mInvView, `ParticleDraw.hlsl:126`)."""
        return self.view_matrix()[:3, :3]
