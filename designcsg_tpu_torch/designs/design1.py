"""Design1 — sphere union box minus eight corner spheres.

The reference's canonical test model (Designs/Design1.py).  The design defines
its own sphere/box brushes (bank indices 5 and 6, after the facade's builtin
0-4) exactly as the reference does, so compiled artifacts are comparable
line-for-line.  Each brush carries its torch function and its CUDA body; the
CUDA bodies are the reference's OpenCL strings.  The interval twins of the
cull are the builtin sphere's and box's (designs/design1.py:50-62 of the JAX
package).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import api
from ..api import Transform
from ..ops import cull


def _sphere_fn(v, ctx):
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]) - 0.5


_SPHERE_CUDA = "return sqrtf(a * a + b * b + c * c) - 0.5f;"


def _box_fn(v, ctx):
    v = torch.abs(v)
    return torch.maximum(torch.maximum(v[..., 0] - 0.5, v[..., 1] - 0.5), v[..., 2] - 0.5)


_BOX_CUDA = "return fmaxf(fmaxf(fabsf(a) - 0.5f, fabsf(b) - 0.5f), fabsf(c) - 0.5f);"


def build(compiler=None):
    c = api.new_design() if compiler is None else compiler
    PI = np.pi

    sphere_brush = c.define_brush(
        _sphere_fn, name="design1_sphere", cuda=_SPHERE_CUDA, cuda_flops=7,
        interval=cull.sphere_interval, interval_cuda=cull.SPHERE_INTERVAL_CUDA,
    )
    box_brush = c.define_brush(
        _box_fn, name="design1_box", cuda=_BOX_CUDA, cuda_flops=8,
        interval=cull.box_interval, interval_cuda=cull.BOX_INTERVAL_CUDA,
    )

    for brush, scale in ((sphere_brush, 1.25), (box_brush, 0.95)):
        api.draw(
            brush,
            Transform.initial(
                position=np.array([0.0, -0.0, 0.0]),
                yaw=-PI / 2,
                pitch=0,
                roll=0,
                scale=np.array([scale, scale, scale]),
            ),
            compiler=c,
        )
    for _x, _y, _z in np.ndindex((3, 3, 3)):
        x, y, z = _x - 1, _y - 1, _z - 1
        if abs(x) + abs(y) + abs(z) == 3:
            api.erase(
                sphere_brush,
                Transform.initial(
                    position=np.array([x, y, z], dtype=np.float64),
                    yaw=-PI / 2,
                    pitch=0,
                    roll=0,
                    scale=2.15 * np.ones(3),
                ),
                compiler=c,
            )

    c.set_export_config(
        boundingBoxHalfDiameter=2.0,
        minimumOctreeLevel=5,
        maximumOctreeLevel=7,
        gridLevel=8,
        complexSurfaceThreshold=np.pi / 2.0 * 0.5,
        gradientDescentSteps=50,
        cacheSubdivision=16,
        queriesBeforeGC=512,
        queriesBeforeFree=4096,
    )
    return c.commit()
