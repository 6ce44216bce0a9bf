"""Object frames of a flat CSG design, after the upstream scene compiler.

Upstream DesignCSG (scenecompiler.py:42-143, k2.cl:105-113) poses every
object by a 4x4 matrix ``translation @ eulerY(yaw) @ eulerX(pitch) @
eulerZ(roll) @ scaling``, under a root that scales by 5, and evaluates a
brush at the local coordinates ``((v - o) . c0, (v - o) . c1, (v - o) . c2)``
where ``o`` is the object's origin and ``c_i`` the matrix's i-th column
divided by its squared length.  The matrices are made in float64 and the
banks are float32, as upstream's are.  A design here is a root with leaf
children only: each child is added (min) or erased (max with its negation),
in order, onto the root's empty brush (64).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence

import numpy as np
import torch

ROOT_SCALE = 5.0
EMPTY = 64.0  # the empty brush, and the march's largest distance
_HALF_PI = np.pi / 2.0


def _rows_transposed(rows) -> np.ndarray:
    return np.asarray(rows, np.float64).T


def euler_y(yaw: float) -> np.ndarray:
    c, s = np.cos(-yaw), np.sin(-yaw)
    c2, s2 = np.cos(-yaw + _HALF_PI), np.sin(-yaw + _HALF_PI)
    return _rows_transposed([[c, 0, s, 0], [0, 1, 0, 0], [c2, 0, s2, 0], [0, 0, 0, 1]])


def euler_x(pitch: float) -> np.ndarray:
    s1, c1 = np.sin(pitch + _HALF_PI), np.cos(pitch + _HALF_PI)
    s2, c2 = np.sin(pitch), np.cos(pitch)
    return _rows_transposed([[1, 0, 0, 0], [0, s1, c1, 0], [0, s2, c2, 0], [0, 0, 0, 1]])


def euler_z(roll: float) -> np.ndarray:
    c1, s1 = np.cos(roll), np.sin(roll)
    c2, s2 = np.cos(roll + _HALF_PI), np.sin(roll + _HALF_PI)
    return _rows_transposed([[c1, s1, 0, 0], [c2, s2, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]])


def pose(position, yaw, pitch, roll, scale) -> np.ndarray:
    t = np.eye(4)
    t[:3, 3] = np.asarray(position, np.float64)
    s = np.diag(np.append(np.broadcast_to(np.asarray(scale, np.float64), (3,)), 1.0))
    return t @ euler_y(yaw) @ euler_x(pitch) @ euler_z(roll) @ s


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One child of the root: its brush ``fn(local f[..., 3]) -> f[...]``,
    its pose and whether it is erased."""

    brush: Callable
    matrix: np.ndarray
    erase: bool = False


class Design:
    """A flat design: ``leaves`` under a root of scale 5 and an optional
    root rotation ``orient`` (a 3x3 matrix applied before the scale).
    ``field(p)`` and ``leaf_values(p)`` take world points f[..., 3] of any
    float dtype; the banks follow the points' dtype and device.  A brush
    takes local coordinates f[..., 3] with any leading axes."""

    def __init__(self, leaves: Sequence[Leaf], orient=None):
        root = np.diag([ROOT_SCALE, ROOT_SCALE, ROOT_SCALE, 1.0])
        if orient is not None:
            r = np.eye(4)
            r[:3, :3] = np.asarray(orient, np.float64)
            root = r @ root
        self.leaves: List[Leaf] = list(leaves)
        origins, frames = [], []
        for leaf in self.leaves:
            m = root @ leaf.matrix
            origins.append(m[:3, 3])
            cols = m[:3, :3].T  # row i: column i of the matrix
            frames.append(cols / np.sum(cols * cols, axis=1, keepdims=True))
        self._origin = np.asarray(origins, np.float32)
        self._frame = np.asarray(frames, np.float32)  # [N, 3 (axis), 3]
        self._banks = {}
        self._groups = {}
        for i, leaf in enumerate(self.leaves):
            self._groups.setdefault(leaf.brush, []).append(i)

    def banks(self, like: torch.Tensor):
        key = (like.dtype, like.device)
        if key not in self._banks:
            self._banks[key] = (torch.as_tensor(self._origin).to(like.device, like.dtype),
                                torch.as_tensor(self._frame).to(like.device, like.dtype))
        return self._banks[key]

    def leaf_values(self, p: torch.Tensor) -> torch.Tensor:
        """f[..., N]: each leaf's brush at its local coordinates, the leaves
        of one brush in one call."""
        origin, frame = self.banks(p)
        rel = p[..., None, :] - origin  # [..., N, 3]
        local = torch.stack([dot3(rel, frame[:, k]) for k in range(3)], dim=-1)
        out = torch.empty(local.shape[:-1], dtype=p.dtype, device=p.device)
        for brush, index in self._groups.items():
            out[..., index] = brush(local[..., index, :])
        return out

    def field(self, p: torch.Tensor) -> torch.Tensor:
        values = self.leaf_values(p)
        acc = torch.full(p.shape[:-1], EMPTY, dtype=p.dtype, device=p.device)
        for i, leaf in enumerate(self.leaves):
            v = values[..., i]
            acc = torch.maximum(acc, -v) if leaf.erase else torch.minimum(acc, v)
        return acc


def dot3(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return u[..., 0] * v[..., 0] + u[..., 1] * v[..., 1] + u[..., 2] * v[..., 2]


def length3(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(dot3(v, v))


def box(q: torch.Tensor, half) -> torch.Tensor:
    """Chebyshev box ``max_i(|q_i| - half_i)``."""
    a = torch.abs(q) - torch.as_tensor(half, dtype=q.dtype, device=q.device)
    return torch.maximum(a[..., 0], torch.maximum(a[..., 1], a[..., 2]))


def axis_rotations() -> List[np.ndarray]:
    """The 24 proper rotations that map the axes onto the axes, in a fixed
    order: every signed permutation matrix of determinant +1."""
    out = []
    for perm in ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0)):
        for signs in np.ndindex(2, 2, 2):
            m = np.zeros((3, 3))
            for row, (col, s) in enumerate(zip(perm, signs)):
                m[row, col] = -1.0 if s else 1.0
            if np.linalg.det(m) > 0:
                out.append(m)
    return out
