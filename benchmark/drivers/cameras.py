"""The drag path of the viewport traffic.

The camera is upstream's orbit camera (CVector.cpp, DrawPane.cpp:438-451,
561-584): position (0, 0, -10) and an identity frame, turned once by yaw
-pi/4 and pitch +pi/4 at start-up; a drag of (da, db) turns the frame about
its up vector by da, then by eulerX(db); the wheel moves the position's z.
Matrices are row-major and applied as ``v' = M^T v``, and ``mul(R1, R2) =
R2 @ R1``, with upstream's PI.

A path is a cycle of ``cycle`` views: view k turns ``degrees_per_frame * k``
about the start-up pose's up vector, pitches ``elevation_deg * sin(2 pi
elevation_swings k / cycle)`` and zooms the distance by ``zoom * cos(2 pi
zoom_swings k / cycle)`` of 10.  The seed picks only the view the path
starts from, so every seed asks for the same views in the same order.
"""

from __future__ import annotations

import random
from typing import List, Tuple

import numpy as np

_PI = 3.1415926
_PI_2 = _PI / 2.0
DISTANCE = 10.0

Pose = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def _euler_x(a):
    return np.array([[1.0, 0.0, 0.0],
                     [0.0, np.sin(a + _PI_2), np.cos(a + _PI_2)],
                     [0.0, np.sin(a), np.cos(a)]])


def _euler_y(a):
    return np.array([[np.cos(a), 0.0, np.sin(a)],
                     [0.0, 1.0, 0.0],
                     [np.cos(a + _PI_2), 0.0, np.sin(a + _PI_2)]])


def _euler_z(a):
    return np.array([[np.cos(a), np.sin(a), 0.0],
                     [np.cos(a + _PI_2), np.sin(a + _PI_2), 0.0],
                     [0.0, 0.0, 1.0]])


def _mul_vec(m, v):
    return m.T @ v


def _mul_mat(r1, r2):
    return r2 @ r1


def _rotate_around(axis, rads):
    a = np.arctan2(axis[2], axis[0])
    r1 = _euler_y(-a)
    b = np.arctan2(_mul_vec(r1, axis)[1], _mul_vec(r1, axis)[0])
    inverse = _mul_mat(_euler_z(-b), r1)
    to_axis = _mul_mat(_euler_y(a), _euler_z(b))
    return _mul_mat(to_axis, _mul_mat(_euler_x(rads), inverse))


def orbit(frame, da: float, db: float):
    right, up, forward = frame
    m = _mul_mat(_euler_x(db), _rotate_around(up, da))
    return _mul_vec(m, right), _mul_vec(m, up), _mul_vec(m, forward)


def start_frame():
    return orbit((np.array([1.0, 0.0, 0.0]), np.array([0.0, 1.0, 0.0]),
                  np.array([0.0, 0.0, 1.0])), -_PI / 4.0, _PI / 4.0)


def view(k: int, params: dict) -> Pose:
    cycle = params["cycle"]
    da = np.radians(params["degrees_per_frame"]) * k
    db = np.radians(params["elevation_deg"]) * np.sin(2 * np.pi * params["elevation_swings"] * k / cycle)
    zoom = params["zoom"] * np.cos(2 * np.pi * params["zoom_swings"] * k / cycle)
    right, up, forward = orbit(start_frame(), da, db)
    position = np.array([0.0, 0.0, -DISTANCE * (1.0 - zoom)])
    return tuple(np.asarray(a, np.float32) for a in (position, right, up, forward))


def path(seed: int, params: dict) -> List[Pose]:
    """The cycle's views, starting from the one the seed picks."""
    start = random.Random(seed).randrange(params["cycle"])
    return [view((start + k) % params["cycle"], params) for k in range(params["cycle"])]
