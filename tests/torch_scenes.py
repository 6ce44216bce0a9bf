"""Synthetic scenes of the port's tests, built through the port's API alone
(no JAX): importable by the CPU tests and by the card's tests."""

import numpy as np
import torch

from designcsg_tpu_torch import api
from designcsg_tpu_torch.api import Transform


def many_groups_scene(n: int = 44):
    """``n`` turned boxes, each with a spherical dent cut into its top, on an
    11-wide grid one unit apart: each box and each dent is a group of the
    cull plan (89 groups with the union's own for ``n`` = 44)."""
    c = api.new_design()
    for i in range(n):
        x, y = (i % 11) * 1.0 - 5.0, (i // 11) * 1.0 - 1.5
        box = api.Component(api.box_brush(compiler=c), Transform.initial(
            position=[x, y, 0.0], yaw=0.3 * i, pitch=0.0, roll=0.0, scale=np.full(3, 0.7)), compiler=c)
        dent = api.Component(api.sphere_brush(compiler=c), Transform.initial(
            position=[x, y, 0.3], yaw=0.0, pitch=0.0, roll=0.0, scale=np.full(3, 0.5)),
            subtractive=True, compiler=c)
        api.drawUnion(box, dent, compiler=c)
    return c.commit()


def custom_brush_scene():
    """A design with a ``define_brush(fn)``-only brush (no CUDA body) beside
    a builtin box."""
    c = api.new_design()

    def rounded(v, ctx):
        return torch.linalg.vector_norm(v, dim=-1) - 0.4

    brush = api.define_brush(rounded, name="rounded", compiler=c)
    api.draw(brush, Transform.initial(position=[0.0, 0.0, 0.0], yaw=0, pitch=0, roll=0,
                                      scale=np.ones(3)), compiler=c)
    api.draw(api.box_brush(compiler=c), Transform.initial(position=[0.8, 0.0, 0.0], yaw=0.3,
                                                          pitch=0, roll=0, scale=np.ones(3)),
             compiler=c)
    return c.commit()


def ring_scene(n_objects: int):
    """``n_objects`` spheres on a ring: a flat additive scene of n + 1
    objects (the root's empty brush first) and 2n + 2 tape commands, the
    JAX package's capacity scene (tests/test_capacity.py _ring_scene) on the
    port's API."""
    c = api.new_design()
    brush = api.sphere_brush(compiler=c)
    for k in range(n_objects):
        angle = 2 * np.pi * k / n_objects
        api.draw(
            brush,
            Transform.initial(
                position=[1.5 * np.cos(angle), 0.0, 1.5 * np.sin(angle)],
                yaw=0.0, pitch=0.0, roll=0.0, scale=[0.2, 0.2, 0.2],
            ),
            compiler=c,
        )
    return c.commit()
