"""Brushes and materials: a torch function plus a CUDA source snippet each.

This is the reference's own model: its brushes were OpenCL source strings
concatenated into the kernels (scenecompiler.py:227-258,489-511).  Here a
brush carries both forms:

* ``fn(v: Tensor[..., 3], ctx) -> Tensor[...]`` — plain PyTorch, used by the
  interpreter (the plain SDF) on any device;
* ``cuda`` — the body of a C++ function
  ``float brush(float a, float b, float c, const float* ad)`` over the point's
  local coordinates ``(a, b, c)`` and the arbitrary-data array ``ad``.  The
  code generator (ops/cuda/tape.py) pastes it into every kernel; the same
  text also compiles for the host (``HD`` functions), which is how the tests
  check it without a card.

A material's ``cuda`` body has the signature
``Rgb material(float gx, float gy, float gz, float lx, float ly, float lz,
float nx, float ny, float nz, const Cam& cam, const float* ad)`` where ``g`` is
the global hit point, ``l`` the hit point in the attributed object's frame,
``n`` the surface normal and ``cam.rgt/upp/fwd`` the camera frame.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from .constants import MAX_DISTANCE


@dataclasses.dataclass
class EvalContext:
    """Runtime context handed to brush/material functions."""

    ad: Any = None  # arbitrary data, f32[ARBITRARY_DATA_POINTS]
    rgt: Any = None  # camera frame (materials only), f32[3]
    upp: Any = None
    fwd: Any = None


@dataclasses.dataclass(frozen=True)
class Brush:
    """A signed-distance function, its CUDA body and its bank index.

    ``cuda_flops`` is the FP32 operation count of one call of the CUDA body
    (a fused multiply-add counts 2; fabsf, fmaxf and sqrtf 1 each), from
    which chip_smoke.py computes the kernels' lower bound."""

    fn: Callable[..., Any]
    bank_index: int
    name: str = ""
    cuda: Optional[str] = None
    cuda_flops: Optional[int] = None

    def __call__(self, v, ctx: Optional[EvalContext] = None):
        return self.fn(v, ctx if ctx is not None else EvalContext())


@dataclasses.dataclass(frozen=True)
class Material:
    """A shader function, its CUDA body and its bank index."""

    fn: Callable[..., Any]
    bank_index: int
    name: str = ""
    cuda: Optional[str] = None

    def __call__(self, gv, lv, n, ctx: Optional[EvalContext] = None):
        return self.fn(gv, lv, n, ctx if ctx is not None else EvalContext())


# ---------------------------------------------------------------------------
# Builtin brushes: empty (bank 0) and space (bank 1) come from the scene
# compiler (scenecompiler.py:424-425); sphere/cylinder/box (banks 2-4) from
# the API facade (DesignCSG.py:9-22).
# ---------------------------------------------------------------------------


def empty_brush_fn(v, ctx):
    """MIN-identity used for group/root nodes ("return MAX_DISTANCE;")."""
    return torch.full(v.shape[:-1], MAX_DISTANCE, dtype=v.dtype, device=v.device)


EMPTY_CUDA = "return MAX_DISTANCE;"


def space_brush_fn(v, ctx):
    """MAX-identity used by intersections ("return 0.0;")."""
    return torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)


SPACE_CUDA = "return 0.0f;"


def sphere_brush_fn(v, ctx):
    """Unit sphere of radius 0.5 ("return length(v)-0.5;", DesignCSG.py:9)."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]) - 0.5


SPHERE_CUDA = "return sqrtf(a * a + b * b + c * c) - 0.5f;"


def cylinder_brush_fn(v, ctx):
    """Y-axis unit cylinder (DesignCSG.py:10-17)."""
    v = torch.abs(v)
    x = torch.sqrt(v[..., 0] ** 2 + v[..., 2] ** 2)
    return torch.maximum(x - 0.5, v[..., 1] - 0.5)


CYLINDER_CUDA = "return fmaxf(sqrtf(a * a + c * c) - 0.5f, fabsf(b) - 0.5f);"


def box_brush_fn(v, ctx):
    """Unit box (Chebyshev-distance form, DesignCSG.py:19-22)."""
    v = torch.abs(v)
    return torch.maximum(
        v[..., 0] - 0.5, torch.maximum(v[..., 1] - 0.5, v[..., 2] - 0.5)
    )


BOX_CUDA = (
    "return fmaxf(fabsf(a) - 0.5f, fmaxf(fabsf(b) - 0.5f, fabsf(c) - 0.5f));"
)


# ---------------------------------------------------------------------------
# Builtin materials (scenecompiler.py:426-435): abs_normals (bank 0) and
# basic_lighting (bank 1, the default material).
# ---------------------------------------------------------------------------


def abs_normals_fn(gv, lv, n, ctx):
    """"return fabs(n);" — local-frame normal visualisation."""
    return torch.abs(n)


ABS_NORMALS_CUDA = "return Rgb{fabsf(nx), fabsf(ny), fabsf(nz)};"


def basic_lighting_fn(gv, lv, n, ctx):
    """Headlamp shading: rotate the local normal into the global (camera)
    frame, then L = dot(n_g, (0,0,-1)) (scenecompiler.py:427-435)."""
    n_g = n[..., 0:1] * ctx.rgt + n[..., 1:2] * ctx.upp + n[..., 2:3] * ctx.fwd
    light = -n_g[..., 2]
    return torch.stack([light, light, light], dim=-1)


BASIC_LIGHTING_CUDA = (
    "float light = -(nx * cam.rgt[2] + ny * cam.upp[2] + nz * cam.fwd[2]);\n"
    "return Rgb{light, light, light};"
)
