"""Homogeneous transform algebra (float64 numpy, and a differentiable torch
copy of the chain the fit needs).

Reproduces the reference's conventions exactly so compiled scenes are
bit-comparable (reference: scenecompiler.py:42-143):

* Euler matrices are written down row-wise and then transposed, i.e. the listed
  rows become *columns* of the returned matrix.
* ``rotation(yaw, pitch, roll) = eulerY(yaw) @ eulerX(pitch) @ eulerZ(roll)``.
* ``initial = translation @ rotation @ scaling``.
* ``axes(v1, v2, v3)`` puts v1/v2/v3 in the matrix *columns*.
* ``reciprocal_vector(v) = v / ||v||**2`` — the trick that lets a non-uniform
  scale+rotation frame be inverted row-by-row without a matrix inverse.

The scene compiler is host code and uses the numpy functions.  The functions
ending in ``_t`` are the same chain in torch (the JAX package's ``xp=jnp``
path, transforms.py:27-154 there), batched over leading axes and
differentiable: pose.py rebuilds the object banks from pose tensors with them.
"""

from __future__ import annotations

import numpy as np
import torch

_HALF_PI = np.pi / 2.0


def homogenize(v):
    v = np.asarray(v)
    return np.concatenate([v[:3], np.zeros((1,), dtype=v.dtype)])


def to_homogenous(v):
    v = np.asarray(v)
    return np.concatenate([v, np.ones((1,), dtype=v.dtype)])


def from_homogenous(v):
    return v[0:3]


def reciprocal_vector(v):
    """v / ||v||^2 (scenecompiler.py:77-80)."""
    v = np.asarray(v)
    return v / np.sum(v * v)


def normalized(v):
    v = np.asarray(v)
    return v / np.sqrt(np.sum(v * v))


def axes(v1, v2, v3):
    """Direct frame: v1/v2/v3 become the columns (scenecompiler.py:53-56)."""
    v1 = np.asarray(v1) * 1.0
    r = np.stack(
        [
            homogenize(v1),
            homogenize(np.asarray(v2) * 1.0),
            homogenize(np.asarray(v3) * 1.0),
            np.asarray([0.0, 0.0, 0.0, 1.0], dtype=v1.dtype),
        ]
    )
    return r.T


def identity():
    return axes([1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0])


def translation(offset):
    out = np.eye(4)
    out[0:3, 3] = np.asarray(offset, dtype=np.float64)
    return out


def _rows_transposed(rows):
    return np.stack([np.stack(r) for r in rows]).T


def eulerY(yaw):
    """scenecompiler.py:83-91 — rows listed, then transposed."""
    c, s = np.cos(-yaw), np.sin(-yaw)
    c2, s2 = np.cos(-yaw + _HALF_PI), np.sin(-yaw + _HALF_PI)
    zero, one = np.zeros_like(c), np.ones_like(c)
    return _rows_transposed(
        [[c, zero, s, zero], [zero, one, zero, zero], [c2, zero, s2, zero],
         [zero, zero, zero, one]]
    )


def eulerX(pitch):
    """scenecompiler.py:94-103."""
    s1, c1 = np.sin(pitch + _HALF_PI), np.cos(pitch + _HALF_PI)
    s2, c2 = np.sin(pitch), np.cos(pitch)
    zero, one = np.zeros_like(s1), np.ones_like(s1)
    return _rows_transposed(
        [[one, zero, zero, zero], [zero, s1, c1, zero], [zero, s2, c2, zero],
         [zero, zero, zero, one]]
    )


def eulerZ(roll):
    """scenecompiler.py:105-114."""
    c1, s1 = np.cos(roll), np.sin(roll)
    c2, s2 = np.cos(roll + _HALF_PI), np.sin(roll + _HALF_PI)
    zero, one = np.zeros_like(c1), np.ones_like(c1)
    return _rows_transposed(
        [[c1, s1, zero, zero], [c2, s2, zero, zero], [zero, zero, one, zero],
         [zero, zero, zero, one]]
    )


def scaling(scale):
    """Diagonal scale (scenecompiler.py:116-125; transpose is a no-op).

    Accepts a 3-vector like the reference, or a scalar (uniform scale)."""
    scale = np.asarray(scale)
    if scale.ndim == 0:
        scale = np.broadcast_to(scale, (3,))
    return np.diag(np.concatenate([scale, np.ones((1,), dtype=scale.dtype)]))


def rotation(yaw, pitch, roll):
    """Y * X * Z composition (scenecompiler.py:129-130)."""
    return eulerY(yaw) @ eulerX(pitch) @ eulerZ(roll)


def initial(position, yaw, pitch, roll, scale):
    """T * R * S (scenecompiler.py:133-135)."""
    return translation(position) @ rotation(yaw, pitch, roll) @ scaling(scale)


def _matrix_t(rows):
    """f[..., 4, 4] from a 4x4 nested list of f[...] tensors, rows first."""
    return torch.stack([torch.stack(row, dim=-1) for row in rows], dim=-2)


def reciprocal_vector_t(v):
    """v / ||v||^2 over the last axis."""
    return v / torch.sum(v * v, dim=-1, keepdim=True)


def translation_t(offset):
    """f[..., 4, 4] translation by ``offset`` f[..., 3]."""
    x, y, z = offset.unbind(-1)
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    return _matrix_t([[one, zero, zero, x], [zero, one, zero, y], [zero, zero, one, z],
                      [zero, zero, zero, one]])


def eulerY_t(yaw):
    """:func:`eulerY` for f[...] angles: rows listed, then transposed."""
    c, s = torch.cos(-yaw), torch.sin(-yaw)
    c2, s2 = torch.cos(-yaw + _HALF_PI), torch.sin(-yaw + _HALF_PI)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return _matrix_t([[c, zero, s, zero], [zero, one, zero, zero], [c2, zero, s2, zero],
                      [zero, zero, zero, one]]).transpose(-1, -2)


def eulerX_t(pitch):
    """:func:`eulerX` for f[...] angles."""
    s1, c1 = torch.sin(pitch + _HALF_PI), torch.cos(pitch + _HALF_PI)
    s2, c2 = torch.sin(pitch), torch.cos(pitch)
    zero, one = torch.zeros_like(s1), torch.ones_like(s1)
    return _matrix_t([[one, zero, zero, zero], [zero, s1, c1, zero], [zero, s2, c2, zero],
                      [zero, zero, zero, one]]).transpose(-1, -2)


def eulerZ_t(roll):
    """:func:`eulerZ` for f[...] angles."""
    c1, s1 = torch.cos(roll), torch.sin(roll)
    c2, s2 = torch.cos(roll + _HALF_PI), torch.sin(roll + _HALF_PI)
    zero, one = torch.zeros_like(c1), torch.ones_like(c1)
    return _matrix_t([[c1, s1, zero, zero], [c2, s2, zero, zero], [zero, zero, one, zero],
                      [zero, zero, zero, one]]).transpose(-1, -2)


def scaling_t(scale):
    """f[..., 4, 4] diagonal scale from ``scale`` f[..., 3]."""
    return torch.diag_embed(torch.cat([scale, torch.ones_like(scale[..., :1])], dim=-1))


def rotation_t(yaw, pitch, roll):
    """Y * X * Z composition, as :func:`rotation`."""
    return eulerY_t(yaw) @ eulerX_t(pitch) @ eulerZ_t(roll)


def initial_t(position, yaw, pitch, roll, scale):
    """T * R * S, as :func:`initial`: ``position`` and ``scale`` f[..., 3],
    the angles f[...]."""
    return translation_t(position) @ rotation_t(yaw, pitch, roll) @ scaling_t(scale)


class Transform:
    """Namespace mirroring the reference's ``Transform`` static class API."""

    homogenize = staticmethod(homogenize)
    to_homogenous = staticmethod(to_homogenous)
    from_homogenous = staticmethod(from_homogenous)
    reciprocal_vector = staticmethod(reciprocal_vector)
    normalized = staticmethod(normalized)
    axes = staticmethod(axes)
    identity = staticmethod(identity)
    translation = staticmethod(translation)
    eulerX = staticmethod(eulerX)
    eulerY = staticmethod(eulerY)
    eulerZ = staticmethod(eulerZ)
    scaling = staticmethod(scaling)
    rotation = staticmethod(rotation)
    initial = staticmethod(initial)
