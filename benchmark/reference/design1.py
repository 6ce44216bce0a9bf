"""Design1, frozen from upstream DesignCSG ``Designs/Design1.py``.

A sphere (scale 1.25) joined with a box (scale 0.95), both turned by a yaw
of -pi/2, minus eight spheres of scale 2.15 at the corners (x, y, z) of
{-1, 1}^3, visited in (x, y, z) order.  The brushes are upstream's:
``length(v) - 0.5`` and the Chebyshev box of half-extent 0.5.
"""

from __future__ import annotations

import itertools

import numpy as np

from .geometry import Design, Leaf, box, length3, pose

# FP32 operations of one brush call, counted from upstream's OpenCL bodies:
# the sphere's three products, two sums, root and difference; the box's
# three |.|, three differences and two maxima.
SPHERE_FLOPS = 7
BOX_FLOPS = 8


def sphere(v):
    return length3(v) - 0.5


def cube(v):
    return box(v, (0.5, 0.5, 0.5))


sphere.flops, cube.flops = SPHERE_FLOPS, BOX_FLOPS


def design(orient=None) -> Design:
    leaves = [Leaf(sphere, pose((0.0, 0.0, 0.0), -np.pi / 2, 0.0, 0.0, 1.25)),
              Leaf(cube, pose((0.0, 0.0, 0.0), -np.pi / 2, 0.0, 0.0, 0.95))]
    for x, y, z in itertools.product((-1, 0, 1), repeat=3):
        if abs(x) + abs(y) + abs(z) == 3:
            leaves.append(Leaf(sphere, pose((x, y, z), -np.pi / 2, 0.0, 0.0, 2.15), erase=True))
    return Design(leaves, orient)
