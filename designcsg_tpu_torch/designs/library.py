"""Reusable prefab component library.

The reference ships an empty, user-editable ``designlibrary.py``; this is its
populated equivalent: parametric prefab builders returning :class:`Component`
trees that any design can ``fabricate`` under its own transforms.  Each
prefab brush carries its torch function and its CUDA body.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import api
from ..api import Transform
from ..ops.cull import (
    iv_abs,
    iv_add,
    iv_const,
    iv_max,
    iv_min,
    iv_norm3,
    iv_sqrt,
    iv_square,
    iv_sub,
)


def _rounded_box_fn(v, ctx):
    """Box of half-extent 0.4 with corner radius 0.1 (unit-ish envelope)."""
    q = torch.abs(v) - 0.4
    p = torch.clamp(q, min=0.0)
    outside = torch.sqrt(p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1] + p[..., 2] * p[..., 2])
    inside = torch.clamp(torch.maximum(q[..., 0], torch.maximum(q[..., 1], q[..., 2])), max=0.0)
    return outside + inside - 0.1


ROUNDED_BOX_CUDA = (
    "const float qx = fabsf(a) - 0.4f, qy = fabsf(b) - 0.4f, qz = fabsf(c) - 0.4f;\n"
    "    const float px = fmaxf(qx, 0.0f), py = fmaxf(qy, 0.0f), pz = fmaxf(qz, 0.0f);\n"
    "    const float outside = sqrtf(px * px + py * py + pz * pz);\n"
    "    const float inside = fminf(fmaxf(qx, fmaxf(qy, qz)), 0.0f);\n"
    "    return outside + inside - 0.1f;"
)
# 3 fabsf + 3 sub + 3 fmaxf; 3 mul + 2 add + sqrtf; 2 fmaxf + fminf; add, sub.
ROUNDED_BOX_FLOPS = 20


def _rounded_box_interval(ia, ib, ic, ctx):
    """Interval twin (designs/library.py:59-73 of the JAX package)."""
    qx, qy, qz = (iv_sub(iv_abs(iv), iv_const(0.4)) for iv in (ia, ib, ic))
    zero = iv_const(0.0)
    outside = iv_norm3(iv_max(qx, zero), iv_max(qy, zero), iv_max(qz, zero))
    inside = iv_min(iv_max(qx, iv_max(qy, qz)), zero)
    return iv_sub(iv_add(outside, inside), iv_const(0.1))


ROUNDED_BOX_INTERVAL_CUDA = (
    "const Iv qx = iv_sub(iv_abs(a), iv_const(0.4f)), qy = iv_sub(iv_abs(b), iv_const(0.4f)),\n"
    "             qz = iv_sub(iv_abs(c), iv_const(0.4f));\n"
    "    const Iv zero = iv_const(0.0f);\n"
    "    const Iv outside = iv_norm3(iv_max(qx, zero), iv_max(qy, zero), iv_max(qz, zero));\n"
    "    const Iv inside = iv_min(iv_max(qx, iv_max(qy, qz)), zero);\n"
    "    return iv_sub(iv_add(outside, inside), iv_const(0.1f));"
)


def _torus_fn(v, ctx):
    """Torus in the xz-plane: major radius 0.35, minor 0.15."""
    ring = torch.sqrt(v[..., 0] * v[..., 0] + v[..., 2] * v[..., 2]) - 0.35
    return torch.sqrt(ring * ring + v[..., 1] * v[..., 1]) - 0.15


TORUS_CUDA = (
    "const float ring = sqrtf(a * a + c * c) - 0.35f;\n"
    "    return sqrtf(ring * ring + b * b) - 0.15f;"
)
TORUS_FLOPS = 10  # twice: 2 mul, add, sqrtf, sub


def _torus_interval(ia, ib, ic, ctx):
    """Interval twin (designs/library.py:76-85 of the JAX package)."""
    ring = iv_sub(iv_sqrt(iv_add(iv_square(ia), iv_square(ic))), iv_const(0.35))
    return iv_sub(iv_sqrt(iv_add(iv_square(ring), iv_square(ib))), iv_const(0.15))


TORUS_INTERVAL_CUDA = (
    "const Iv ring = iv_sub(iv_sqrt(iv_add(iv_square(a), iv_square(c))), iv_const(0.35f));\n"
    "    return iv_sub(iv_sqrt(iv_add(iv_square(ring), iv_square(b))), iv_const(0.15f));"
)


def rounded_box(compiler=None, transform=None):
    c = compiler if compiler is not None else api.current()
    brush = c.define_brush(
        _rounded_box_fn, name="rounded_box", cuda=ROUNDED_BOX_CUDA, cuda_flops=ROUNDED_BOX_FLOPS,
        interval=_rounded_box_interval, interval_cuda=ROUNDED_BOX_INTERVAL_CUDA,
    )
    return api.Component(brush, transform=transform, compiler=c)


def torus(compiler=None, transform=None):
    c = compiler if compiler is not None else api.current()
    brush = c.define_brush(
        _torus_fn, name="torus", cuda=TORUS_CUDA, cuda_flops=TORUS_FLOPS,
        interval=_torus_interval, interval_cuda=TORUS_INTERVAL_CUDA,
    )
    return api.Component(brush, transform=transform, compiler=c)


def capsule(A, B, thickness=1.0, compiler=None):
    """Capsule prefab between two points: the facade's counter-scaled
    cylinder + spheres construction (DesignCSG.py:45-102), returned as a
    component instead of drawn."""
    cyl, pose = api._capsule_component(np.asarray(A), np.asarray(B), thickness, compiler)
    return cyl.fabricate(transform=pose)


def ring_of(component, count, radius, compiler=None, axis="y"):
    """A group with ``count`` fabricated copies of ``component`` arranged on
    a circle (prefab fabrication, scenecompiler.py:293-301)."""
    c = compiler if compiler is not None else api.current()
    group = api.Component(c.null_brush(), compiler=c)
    for k in range(count):
        angle = 2 * np.pi * k / count
        if axis == "y":
            pos = np.array([radius * np.cos(angle), 0.0, radius * np.sin(angle)])
            yaw = -angle
            pitch = 0.0
        else:
            pos = np.array([radius * np.cos(angle), radius * np.sin(angle), 0.0])
            yaw = 0.0
            pitch = angle
        group.add_child(
            component.fabricate(
                transform=Transform.initial(
                    position=pos, yaw=yaw, pitch=pitch, roll=0, scale=np.ones(3)
                )
            )
        )
    return group
