"""Orbit camera.

Ports the host-side camera math semantics (reference:
CVector.cpp, DrawPane.cpp:438-451,561-584): the orbit
rotates the camera *frame* (right/up/forward triple), not the scene; rays are
projected onto the frame inside the march.  The C code stores row-major
matrices applied as ``v' = M^T v`` and composes with
``mul(R1, R2) = R2 @ R1`` — the helpers below reproduce those exact
conventions in numpy so orbit trajectories match the desktop app.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .constants import IZOOM

_PI = 3.1415926  # the reference's PI (CVector.cpp:3)
_PI_2 = _PI / 2.0


def _euler_x(rads):
    return np.array(
        [
            [1.0, 0.0, 0.0],
            [0.0, np.sin(rads + _PI_2), np.cos(rads + _PI_2)],
            [0.0, np.sin(rads), np.cos(rads)],
        ]
    )


def _euler_y(rads):
    return np.array(
        [
            [np.cos(rads), 0.0, np.sin(rads)],
            [0.0, 1.0, 0.0],
            [np.cos(rads + _PI_2), 0.0, np.sin(rads + _PI_2)],
        ]
    )


def _euler_z(rads):
    return np.array(
        [
            [np.cos(rads), np.sin(rads), 0.0],
            [np.cos(rads + _PI_2), np.sin(rads + _PI_2), 0.0],
            [0.0, 0.0, 1.0],
        ]
    )


def _mul_vec(m, v):
    """C mul_Matrix3f_Vector3f: v' = M^T v (CVector.cpp:8-16)."""
    return m.T @ v


def _mul_mat(r1, r2):
    """C mul_Matrix3f_Matrix3f: returns R2 @ R1 in row-major (CVector.cpp:80-92)."""
    return r2 @ r1


def _inverse_euler(heading):
    """CVector.cpp:56-66."""
    a = np.arctan2(heading[2], heading[0])
    r1 = _euler_y(-a)
    h1 = _mul_vec(r1, heading)
    b = np.arctan2(h1[1], h1[0])
    r2 = _euler_z(-b)
    return _mul_mat(r2, r1)


def _euler_from_x_to(heading):
    """CVector.cpp:68-75."""
    a = np.arctan2(heading[2], heading[0])
    hxy = _mul_vec(_euler_y(-a), heading)
    b = np.arctan2(hxy[1], hxy[0])
    return _mul_mat(_euler_y(a), _euler_z(b))


def rotate_around_vector(axis, rads):
    """CVector.cpp:117-121: conjugate eulerX(rads) by the axis frame."""
    r1 = _inverse_euler(np.asarray(axis, dtype=np.float64))
    ar1 = _euler_from_x_to(np.asarray(axis, dtype=np.float64))
    return _mul_mat(ar1, _mul_mat(_euler_x(rads), r1))


@dataclasses.dataclass
class Camera:
    """Camera pose: position plus orthonormal frame triple."""

    position: np.ndarray
    right: np.ndarray
    up: np.ndarray
    forward: np.ndarray

    @staticmethod
    def initial(apply_default_orbit: bool = True) -> "Camera":
        """The viewport's startup pose: campos (0,0,-IZOOM), identity frame,
        then the one-time orbit yaw -pi/4 / pitch +pi/4
        (DrawPane.h:67-73, DrawPane.cpp:438-451)."""
        cam = Camera(
            position=np.array([0.0, 0.0, -IZOOM]),
            right=np.array([1.0, 0.0, 0.0]),
            up=np.array([0.0, 1.0, 0.0]),
            forward=np.array([0.0, 0.0, 1.0]),
        )
        if apply_default_orbit:
            cam.orbit(-_PI / 4.0, _PI / 4.0)
        return cam

    def orbit(self, da: float, db: float) -> "Camera":
        """Mouse-drag orbit (DrawPane.cpp:565-576): rotate the frame around
        the current up vector by ``da``, then eulerX by ``db``."""
        m = rotate_around_vector(self.up, da)
        m = _mul_mat(_euler_x(db), m)
        self.right = _mul_vec(m, self.right)
        self.up = _mul_vec(m, self.up)
        self.forward = _mul_vec(m, self.forward)
        return self

    def zoom(self, wheel: float) -> "Camera":
        """Wheel zoom adjusts campos.z (DrawPane.cpp:582-584)."""
        self.position = self.position + np.array([0.0, 0.0, wheel])
        return self

    def as_arrays(self):
        f32 = np.float32
        return (
            self.position.astype(f32),
            self.right.astype(f32),
            self.up.astype(f32),
            self.forward.astype(f32),
        )
