"""Pose-space differentiable scene compile.

The compiled object banks (position + reciprocal frame axes) are derived from
each object's propagated transform ``M = T(position) @ R(yaw, pitch, roll) @
S(scale)`` (reference scenecompiler.py:133-135):

    position = M[:3, 3]
    right/up/forward = reciprocal_vector(M[:3, 0..2])   # v / ||v||^2

:func:`pose_params` decomposes a compiled scene's banks into a
``{"position", "yaw", "pitch", "roll", "scale"}`` dictionary (numpy, float64,
as the compiler works), and :func:`make_pose_to_arrays` rebuilds the banks
from such a dictionary as a torch function, so that gradients reach every pose
degree of freedom (designcsg_tpu/pose.py of the JAX package).  Poses
parameterize each object's propagated (world) frame, the flat representation
the banks use.  Mirrored frames (det < 0) decompose as a rotation with a
negative z scale and round-trip.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch

from . import transforms as tf
from .compiler import CompiledScene, SceneArrays


def _frame_matrix(arrays: SceneArrays) -> np.ndarray:
    """Each object's propagated 3x3 frame, columns first, from the banks: the
    banks store reciprocal axes r = c / ||c||^2, so c = r / ||r||^2."""
    cols = []
    for bank in (arrays.right, arrays.up, arrays.forward):
        r = np.asarray(bank, np.float64)
        cols.append(r / np.maximum((r * r).sum(-1, keepdims=True), 1e-30))
    return np.stack(cols, axis=-1)  # [N, 3, 3]


def pose_params(scene: CompiledScene) -> Dict[str, np.ndarray]:
    """Decompose the scene's object banks into T·R·S pose factors, float64:
    ``position`` [N, 3], ``yaw``/``pitch``/``roll`` [N], ``scale`` [N, 3].

    Inverts ``R = eulerY @ eulerX @ eulerZ`` (scenecompiler.py:129-130),
    whose product is::

        [cy*cr - sy*sp*sr,  -cy*sr - sy*sp*cr,  sy*cp]
        [cp*sr,              cp*cr,             sp   ]
        [-sy*cr - cy*sp*sr,  sy*sr - cy*sp*cr,  cy*cp]

    so pitch = asin(R[1,2]), yaw = atan2(R[0,2], R[2,2]),
    roll = atan2(R[1,0], R[1,1]); at gimbal lock (|cos pitch| ~ 0) yaw and
    roll are one degree of freedom and yaw takes it (pose.py:55-102 of the
    JAX package)."""
    arrays = scene.arrays
    M = _frame_matrix(arrays)
    scale = np.linalg.norm(M, axis=1)  # column norms, [N, 3]
    # A mirrored frame is not a rotation: its reflection becomes a negative
    # z scale.
    neg = np.linalg.det(M) < 0
    scale[neg, 2] *= -1.0
    R = M / np.where(np.abs(scale[:, None, :]) > 1e-30, scale[:, None, :], 1e-30)
    pitch = np.arcsin(np.clip(R[:, 1, 2], -1.0, 1.0))
    cp = np.cos(pitch)
    locked = np.abs(cp) < 1e-8
    yaw = np.where(
        locked,
        # cp ~ 0: roll = 0, leaving R[0,0] = cos(yaw), R[2,0] = -sin(yaw).
        np.arctan2(-R[:, 2, 0], R[:, 0, 0]),
        np.arctan2(R[:, 0, 2], R[:, 2, 2]),
    )
    roll = np.where(locked, 0.0, np.arctan2(R[:, 1, 0], R[:, 1, 1]))
    return {
        "position": np.asarray(arrays.position, np.float64),
        "yaw": yaw,
        "pitch": pitch,
        "roll": roll,
        "scale": scale,
    }


def _f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def make_pose_to_arrays(scene: CompiledScene) -> Callable:
    """``pose_to_arrays(params) -> SceneArrays``: the object banks rebuilt
    from a pose dictionary (numpy arrays or tensors) in float32, each a
    differentiable torch function of every pose entry.  The integer banks
    and the arbitrary data are the scene's, as tensors on the device of the
    pose tensors (the CPU for numpy poses).  Drop-in for the fit harness's
    ``param_to_arrays`` (:func:`pose_param_to_arrays`)."""
    bases = {}

    def pose_to_arrays(params) -> SceneArrays:
        device = next(
            (v.device for v in params.values() if isinstance(v, torch.Tensor)),
            torch.device("cpu"),
        )
        if device not in bases:
            bases[device] = scene.arrays.to_torch(device)
        pose = {k: _f32(params[k], device) for k in ("position", "yaw", "pitch", "roll", "scale")}
        M = tf.initial_t(pose["position"], pose["yaw"], pose["pitch"], pose["roll"], pose["scale"])
        return dataclasses.replace(
            bases[device],
            position=M[:, :3, 3].contiguous(),
            right=tf.reciprocal_vector_t(M[:, :3, 0]).contiguous(),
            up=tf.reciprocal_vector_t(M[:, :3, 1]).contiguous(),
            forward=tf.reciprocal_vector_t(M[:, :3, 2]).contiguous(),
        )

    return pose_to_arrays


def pose_param_to_arrays(scene: CompiledScene) -> Callable:
    """``param_to_arrays`` for :func:`parallel.fit.make_fit_harness`: fit in
    pose space (positions, euler angles, per-axis scales) rather than in raw
    bank space, so the banks stay consistent frames by construction."""
    return make_pose_to_arrays(scene)
