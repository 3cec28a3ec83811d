"""The demo's static camera (`SimpleCamera.cpp`, `Render.cpp:139,776`).

XMMatrixLookToRH and XMMatrixPerspectiveFovRH in the row-vector
convention (v_clip = v_world @ view @ proj), worked out in float64 and
kept in float32 as the demo's constant buffer holds them. The demo's
camera never moves (`Render.cpp:773` updates it with dt = 0): the eye
looks down -z from (0, 0, 1500) with yaw pi and pitch 0.
"""

from __future__ import annotations

import math

import numpy as np


def _look_to_rh(eye, direction, up) -> np.ndarray:
    eye = np.asarray(eye, np.float64)
    d = np.asarray(direction, np.float64)
    up = np.asarray(up, np.float64)
    z = -d / np.linalg.norm(d)
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2] = x, y, z
    m[3, 0], m[3, 1], m[3, 2] = -x @ eye, -y @ eye, -z @ eye
    return m.astype(np.float32)


def _perspective_fov_rh(fov_y, aspect, near, far) -> np.ndarray:
    h = 1.0 / math.tan(fov_y * 0.5)
    m = np.zeros((4, 4))
    m[0, 0] = h / aspect
    m[1, 1] = h
    m[2, 2] = far / (near - far)
    m[2, 3] = -1.0
    m[3, 2] = near * far / (near - far)
    return m.astype(np.float32)


def view_projection(camera: dict, width: int, height: int):
    """(wvp [4, 4] float32, p00, p11) of the static camera: the
    world-view-projection matrix and the projection's |[0, 0]| and
    |[1, 1]|, which scale a sprite's eye-space size to clip space."""
    yaw, pitch = math.pi, 0.0
    r = math.cos(pitch)
    direction = (r * math.sin(yaw), math.sin(pitch), r * math.cos(yaw))
    view = _look_to_rh(camera["position"], direction, (0.0, 1.0, 0.0))
    proj = _perspective_fov_rh(camera["fov_y"], width / height,
                               camera["near"], camera["far"])
    wvp = (view.astype(np.float64) @ proj.astype(np.float64)).astype(
        np.float32)
    return wvp, abs(float(proj[0, 0])), abs(float(proj[1, 1]))
