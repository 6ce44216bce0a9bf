"""Design2, frozen from upstream DesignCSG ``Designs/Design2.py``: the
level-2 Hilbert-curve sculpture on a turned base.

Two leaves, both added: the Hilbert brush turned by yaw = pitch = roll =
pi/4 at the origin, and the base at (0, -sqrt(0.75) + 0.0075, 0), both of
scale 1.

The Hilbert brush is upstream's cell evaluator (its OpenCL defines and
auxiliary functions).  A table of 27 quadrant matrices, indexed by
``(x+1)*9 + (y+1)*3 + (z+1)``, holds a rotation for each of the 8 corner
quadrants (x, y, z) of {-1, 1}^3 (the other 19 entries are the identity
and never read).  In each corner quadrant the point is moved to the
quadrant's centre ``(x, y, z) / 3``, scaled by 3, multiplied by the
quadrant's matrix, swizzled twice (``(v.y, -v.x, v.z)``, then ``(v.z,
v.y, -v.x)``) and held to the unit cell: 7 Chebyshev struts of line width
0.1.  Seven connector struts join the quadrants.  The brush is the minimum
of all of them, starting from the empty brush (64).  The base is a ring of
outer radius 0.5 and height 0.05 whose inner radius shrinks from 0.5 to
0.45 across its upper half: ``max(r - radius(y), |y| - 0.05)``.

Departures from upstream: the quadrant product is written out as sums of
plain products (no matrix product, so no TF32 question arises on the card).
Each matrix is a signed permutation, so the product gives each
coordinate as +-w of one input exactly; the program picks that coordinate
instead, the same values in fewer operations, and ``hilbert.flops`` counts
the program's form.
"""

from __future__ import annotations

import numpy as np
import torch

from .geometry import EMPTY, Design, Leaf, box, pose

LINE_WIDTH = 0.1

# The corner quadrants' rows, from upstream's 27-entry table.
QUADRANTS = {
    (-1, -1, -1): ((0, 1, 0), (0, 0, 1), (1, 0, 0)),
    (-1, -1, +1): ((1, 0, 0), (0, -1, 0), (0, 0, -1)),
    (-1, +1, -1): ((0, 0, 1), (1, 0, 0), (0, 1, 0)),
    (-1, +1, +1): ((0, 0, 1), (1, 0, 0), (0, 1, 0)),
    (+1, -1, -1): ((0, 1, 0), (0, 0, 1), (-1, 0, 0)),
    (+1, -1, +1): ((-1, 0, 0), (0, -1, 0), (0, 0, -1)),
    (+1, +1, -1): ((0, 0, -1), (-1, 0, 0), (0, 1, 0)),
    (+1, +1, +1): ((0, 0, -1), (-1, 0, 0), (0, 1, 0)),
}

_W = LINE_WIDTH
# The unit cell's struts: (centre, half extent).
CELL_STRUTS = (
    ((-0.5, -0.5, 0.0), (_W, _W, 0.5 + _W)),
    ((0.5, -0.5, 0.0), (_W, _W, 0.5 + _W)),
    ((0.0, -0.5, -0.5), (0.5 + _W, _W, _W)),
    ((-0.5, 0.5, 0.0), (_W, _W, 0.5 + _W)),
    ((0.5, 0.5, 0.0), (_W, _W, 0.5 + _W)),
    ((0.0, 0.5, -0.5), (0.5 + _W, _W, _W)),
    ((0.5, 0.0, 0.5), (_W, 0.5 + _W, _W)),
)

# Connectors: (large_i, large_j, large_k, i, j, k, axis): a strut along
# ``axis``, centred at ((large + small / 2) / 3) on each axis, in the 3x
# scaled frame.
CONNECTORS = (
    (0, -1, 1, 0, 1, 1, 0),
    (1, 0, -1, 1, 0, -1, 1),
    (-1, 0, -1, -1, 0, -1, 1),
    (1, 0, 1, 1, 0, 1, 1),
    (-1, 0, 1, -1, 0, 1, 1),
    (1, 1, 0, 1, -1, 0, 2),
    (-1, 1, 0, -1, -1, 0, 2),
)

BASE_OUTER, BASE_INNER, BASE_HEIGHT = 0.5, 0.45, 0.05
# FP32 operations of the base: the root of two products and a sum (4), the
# radius (a division, a product and two sums: 4), both branches and the
# select (3), |y|, a difference and the maximum (3).
BASE_FLOPS = 14


def connector(spec):
    """(centre, half extent) of a connector strut."""
    li, lj, lk, i, j, k, axis = spec
    centre = ((li + i / 2.0) / 3.0, (lj + j / 2.0) / 3.0, (lk + k / 2.0) / 3.0)
    half = [_W] * 3
    half[axis] = 0.5 + _W
    return centre, tuple(half)


def _strut(q, centre, half):
    return box(q - torch.as_tensor(centre, dtype=q.dtype, device=q.device), half)


def _unit_cell(v):
    v = torch.stack([v[..., 1], -v[..., 0], v[..., 2]], -1)
    v = torch.stack([v[..., 2], v[..., 1], -v[..., 0]], -1)
    out = None
    for centre, half in CELL_STRUTS:
        d = _strut(v, centre, half)
        out = d if out is None else torch.minimum(out, d)
    return out


def hilbert(v):
    m = torch.full(v.shape[:-1], EMPTY, dtype=v.dtype, device=v.device)
    for corner, rows in QUADRANTS.items():
        c = torch.as_tensor([t / 3.0 for t in corner], dtype=v.dtype, device=v.device)
        w = 3.0 * (v - c)
        local = torch.stack([w[..., 0] * r[0] + w[..., 1] * r[1] + w[..., 2] * r[2]
                             for r in rows], -1)
        m = torch.minimum(m, _unit_cell(local))
    for spec in CONNECTORS:
        centre, half = connector(spec)
        c = torch.as_tensor(centre, dtype=v.dtype, device=v.device)
        m = torch.minimum(m, box(3.0 * (v - c), half))
    return m


def base(v):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    r = torch.sqrt(x * x + z * z)
    height = torch.tensor(BASE_HEIGHT, dtype=v.dtype, device=v.device)
    radius = BASE_INNER + (BASE_OUTER - BASE_INNER) * (1.0 - y / height)
    d = torch.where(y > 0, r - radius, r - BASE_OUTER)
    return torch.maximum(d, torch.abs(y) - BASE_HEIGHT)


def hilbert_flops() -> int:
    """FP32 operations of one Hilbert call in the program's form.  A box
    costs, on each axis, a difference where its centre is not 0, |.| and a
    difference, then two maxima.  A quadrant: its centre's 3 differences
    and 3 products, the picked coordinates (free), 7 boxes, 6 minima inside
    the cell and 1 into the brush.  A connector: on each axis a difference
    where its centre is not 0 and the product by 3, a box centred at 0 and
    a minimum."""
    def box_ops(centre):
        return 2 + sum(3 if c != 0.0 else 2 for c in centre)

    quadrant = 6 + sum(box_ops(c) for c, _ in CELL_STRUTS) + (len(CELL_STRUTS) - 1) + 1
    connectors = sum(sum(2 if c != 0.0 else 1 for c in connector(s)[0]) + box_ops((0, 0, 0)) + 1
                     for s in CONNECTORS)
    return len(QUADRANTS) * quadrant + connectors


hilbert.flops, base.flops = hilbert_flops(), BASE_FLOPS


def design(orient=None) -> Design:
    return Design([Leaf(hilbert, pose((0.0, 0.0, 0.0), np.pi / 4, np.pi / 4, np.pi / 4, 1.0)),
                   Leaf(base, pose((0.0, -np.sqrt(0.75) + 0.0075, 0.0), 0.0, 0.0, 0.0, 1.0))],
                  orient)
