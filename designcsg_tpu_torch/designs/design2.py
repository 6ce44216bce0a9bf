"""Design2 — level-2 Hilbert-curve sculpture on a turned base.

The reference's most complex example (Designs/Design2.py).  The reference
builds the Hilbert brush from OpenCL defines, a table of 27 quadrant rotation
matrices and a cell evaluator; here it is a torch function over the same
tables, and its CUDA body is generated from them as straight-line code: the 8
occupied corner quadrants, 7 boxes each, and 7 connector struts.

Every quadrant matrix is a signed permutation, so the generated code writes
each rotated coordinate as ``+-w`` of one input coordinate instead of a
product with 0/+-1: the same value (a sum with +-0 changes nothing, and the
box takes ``fabsf``) in fewer operations.  The torch function does the same
pick, so both round identically.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import api
from ..api import Transform
from ..constants import MAX_DISTANCE
from ..ops.cuda.tape import f32_literal
from ..ops.cull import (
    f32,
    fmax,
    fmin,
    fmul,
    fselect,
    fsub,
    iv_abs,
    iv_add,
    iv_const,
    iv_max,
    iv_sqrt,
    iv_square,
    iv_sub,
    register_lipschitz_interval,
)

LINE_WIDTH = 0.1

# Quadrant rotation matrices (row-major 3x3 per corner), indexed by
# (x+1)*9 + (y+1)*3 + (z+1).  Only the 8 corners with |x|+|y|+|z| == 3 are
# used; every other entry is the identity.
_QUADRANT_MATRICES = np.tile(np.eye(3), (27, 1, 1))


def _set_quadrant(x, y, z, rows):
    _QUADRANT_MATRICES[(x + 1) * 9 + (y + 1) * 3 + (z + 1)] = np.asarray(rows, float)


_set_quadrant(-1, -1, -1, [[0, 1, 0], [0, 0, 1], [1, 0, 0]])
_set_quadrant(-1, -1, +1, [[1, 0, 0], [0, -1, 0], [0, 0, -1]])
_set_quadrant(-1, +1, -1, [[0, 0, 1], [1, 0, 0], [0, 1, 0]])
_set_quadrant(-1, +1, +1, [[0, 0, 1], [1, 0, 0], [0, 1, 0]])
_set_quadrant(+1, -1, -1, [[0, 1, 0], [0, 0, 1], [-1, 0, 0]])
_set_quadrant(+1, -1, +1, [[-1, 0, 0], [0, -1, 0], [0, 0, -1]])
_set_quadrant(+1, +1, -1, [[0, 0, -1], [-1, 0, 0], [0, 1, 0]])
_set_quadrant(+1, +1, +1, [[0, 0, -1], [-1, 0, 0], [0, 1, 0]])

DIRECTION_X, DIRECTION_Y, DIRECTION_Z = 0, 1, 2

CORNERS = [(i, j, k) for i in (-1, 1) for j in (-1, 1) for k in (-1, 1)]

# The unit cell's 7 struts: (center, half extent).
_W = LINE_WIDTH
CELL_BOXES = [
    ((-0.5, -0.5, 0.0), (_W, _W, 0.5 + _W)),
    ((0.5, -0.5, 0.0), (_W, _W, 0.5 + _W)),
    ((0.0, -0.5, -0.5), (0.5 + _W, _W, _W)),
    ((-0.5, 0.5, 0.0), (_W, _W, 0.5 + _W)),
    ((0.5, 0.5, 0.0), (_W, _W, 0.5 + _W)),
    ((0.0, 0.5, -0.5), (0.5 + _W, _W, _W)),
    ((0.5, 0.0, 0.5), (_W, 0.5 + _W, _W)),
]

# Connector struts between the quadrants: (large_i, large_j, large_k, i, j, k,
# direction).
CONNECTOR_SPECS = [
    (0, -1, 1, 0, 1, 1, DIRECTION_X),
    (1, 0, -1, 1, 0, -1, DIRECTION_Y),
    (-1, 0, -1, -1, 0, -1, DIRECTION_Y),
    (1, 0, 1, 1, 0, 1, DIRECTION_Y),
    (-1, 0, 1, -1, 0, 1, DIRECTION_Y),
    (1, 1, 0, 1, -1, 0, DIRECTION_Z),
    (-1, 1, 0, -1, -1, 0, DIRECTION_Z),
]


def _signed_permutation(i, j, k):
    """``[(column, sign)] * 3`` of the corner's quadrant matrix."""
    m = _QUADRANT_MATRICES[(i + 1) * 9 + (j + 1) * 3 + (k + 1)]
    rows = []
    for row in m:
        (col,) = np.flatnonzero(row)
        assert abs(row[col]) == 1.0 and np.count_nonzero(row) == 1
        rows.append((int(col), float(row[col])))
    return rows


def _connector(spec):
    """(center, half extent) of a connector strut, before its 3x scaling."""
    li, lj, lk, i, j, k, direction = spec
    center = ((li + i / 2.0) / 3.0, (lj + j / 2.0) / 3.0, (lk + k / 2.0) / 3.0)
    half = [LINE_WIDTH] * 3
    half[direction] = 0.5 + LINE_WIDTH
    return center, tuple(half)


def _box(x, y, z, center, half):
    """Chebyshev box ``max(|x-cx|-hx, max(|y-cy|-hy, |z-cz|-hz))``; a zero
    centre coordinate is not subtracted (``x - 0 == x``)."""
    q = [
        torch.abs(v - c if c != 0.0 else v) - h
        for v, c, h in zip((x, y, z), center, half)
    ]
    return torch.maximum(q[0], torch.maximum(q[1], q[2]))


def _hilbert_brush_fn(v, ctx):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    m = torch.full_like(x, MAX_DISTANCE)
    for i, j, k in CORNERS:
        w = (3.0 * (x - i / 3.0), 3.0 * (y - j / 3.0), 3.0 * (z - k / 3.0))
        a, b, c = (w[col] if sign > 0 else -w[col] for col, sign in _signed_permutation(i, j, k))
        # the reference's two swizzles compose to (a, b, c) -> (c, -a, -b)
        cell = None
        for center, half in CELL_BOXES:
            d = _box(c, -a, -b, center, half)
            cell = d if cell is None else torch.minimum(cell, d)
        m = torch.minimum(m, cell)
    for spec in CONNECTOR_SPECS:
        (cx, cy, cz), half = _connector(spec)
        p = [3.0 * (t - ct if ct != 0.0 else t) for t, ct in ((x, cx), (y, cy), (z, cz))]
        m = torch.minimum(m, _box(*p, (0.0, 0.0, 0.0), half))
    return m


def _cuda_box(x, y, z, center, half):
    """C++ of :func:`_box` and its FP32 operation count."""
    terms, ops = [], 2  # two fmaxf
    for v, c, h in zip((x, y, z), center, half):
        arg = f"{v} - {f32_literal(c)}" if c != 0.0 else v
        ops += 3 if c != 0.0 else 2  # (sub,) fabsf, sub
        terms.append(f"fabsf({arg}) - {f32_literal(h)}")
    return f"fmaxf({terms[0]}, fmaxf({terms[1]}, {terms[2]}))", ops


def hilbert_cuda():
    """The Hilbert brush's CUDA body and its FP32 operation count, generated
    from the quadrant tables and connector specs."""
    lines = ["float m = MAX_DISTANCE;"]
    ops = 0
    for i, j, k in CORNERS:
        lines.append(f"{{  // quadrant ({i:+d}, {j:+d}, {k:+d})")
        lines.append(
            f"    const float w0 = 3.0f * (a - {f32_literal(i / 3.0)}), "
            f"w1 = 3.0f * (b - {f32_literal(j / 3.0)}), "
            f"w2 = 3.0f * (c - {f32_literal(k / 3.0)});"
        )
        ops += 6
        picks = [f"{'' if sign > 0 else '-'}w{col}" for col, sign in _signed_permutation(i, j, k)]
        # (a, b, c) -> (c, -a, -b); a double negation cancels.
        neg = [p[1:] if p.startswith("-") else "-" + p for p in picks]
        lines.append(f"    const float X = {picks[2]}, Y = {neg[0]}, Z = {neg[1]};")
        for n, (center, half) in enumerate(CELL_BOXES):
            expr, box_ops = _cuda_box("X", "Y", "Z", center, half)
            lines.append(f"    {'float d = ' if n == 0 else 'd = fminf(d, '}{expr}{'' if n == 0 else ')'};")
            ops += box_ops + (n > 0)
        lines.append("    m = fminf(m, d);")
        ops += 1
        lines.append("}")
    for spec in CONNECTOR_SPECS:
        (cx, cy, cz), half = _connector(spec)
        coords = []
        for v, ct in (("a", cx), ("b", cy), ("c", cz)):
            coords.append(f"3.0f * ({v} - {f32_literal(ct)})" if ct != 0.0 else f"3.0f * {v}")
            ops += 2 if ct != 0.0 else 1
        lines.append(f"{{  // connector {spec}")
        lines.append(f"    const float X = {coords[0]}, Y = {coords[1]}, Z = {coords[2]};")
        expr, box_ops = _cuda_box("X", "Y", "Z", (0.0, 0.0, 0.0), half)
        lines.append(f"    m = fminf(m, {expr});")
        ops += box_ops + 1
        lines.append("}")
    lines.append("return m;")
    return "\n    ".join(lines), ops


_HEIGHT = torch.tensor(0.05)


def _base_brush_fn(v, ctx):
    outer, inner, height = 0.5, 0.45, 0.05
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    r = torch.sqrt(x * x + z * z)
    # Divided by a tensor, as the kernel divides (a CUDA tensor divided by a
    # host scalar is multiplied by its reciprocal).
    new_radius = inner + (outer - inner) * (1.0 - y / _HEIGHT.to(v.device))
    d = torch.where(y > 0, r - new_radius, r - outer)
    return torch.maximum(d, torch.abs(y) - height)


BASE_CUDA = (
    "const float r = sqrtf(a * a + c * c);\n"
    f"    const float new_radius = {f32_literal(0.45)} + {f32_literal(0.5 - 0.45)} * "
    f"(1.0f - b / {f32_literal(0.05)});\n"
    "    const float d = b > 0.0f ? r - new_radius : r - 0.5f;\n"
    f"    return fmaxf(d, fabsf(b) - {f32_literal(0.05)});"
)
# sqrt(a*a + c*c): 4; the radius: 4; both branches and the select: 3;
# fabsf, sub, fmaxf: 3.
BASE_FLOPS = 14

# Interval twins of the cull (designs/design2.py:213-246 of the JAX package).
# Hilbert: the generic Lipschitz and far-field bounds about a strut centre
# (the 3x quadrant scaling makes L = 3; the solid lies within Chebyshev
# radius 1.3 of the anchor), so far tiles skip the expensive brush.
HILBERT_ANCHOR, HILBERT_LIPSCHITZ, HILBERT_ENCLOSURE = (-0.5, -0.5, 0.0), 3.0, 1.3

# Base: by hand (a Lipschitz upper bound would outgrow Hilbert's far-field
# lower bound and block all pruning).  new_radius = inner + (outer - inner) *
# (1 - y / height) is affine and decreasing in y, so its interval swaps y's
# endpoints; where y's sign is open the two branches' intervals are joined.
_BASE_TOP = f32(0.45 + (0.5 - 0.45))
_BASE_SLOPE = f32((0.5 - 0.45) / 0.05)


def _base_interval(ia, ib, ic, ctx):
    r = iv_sqrt(iv_add(iv_square(ia), iv_square(ic)))
    nr = (fsub(_BASE_TOP, fmul(ib[1], _BASE_SLOPE)), fsub(_BASE_TOP, fmul(ib[0], _BASE_SLOPE)))
    d_pos = iv_sub(r, nr)
    d_neg = iv_sub(r, iv_const(0.5))
    both = (fmin(d_pos[0], d_neg[0]), fmax(d_pos[1], d_neg[1]))
    d = tuple(
        fselect(ib[0] > 0, d_pos[i], fselect(ib[1] <= 0, d_neg[i], both[i])) for i in range(2)
    )
    return iv_max(d, iv_sub(iv_abs(ib), iv_const(0.05)))


BASE_INTERVAL_CUDA = (
    "const Iv r = iv_sqrt(iv_add(iv_square(a), iv_square(c)));\n"
    f"    const Iv nr = Iv{{sub_rn({f32_literal(_BASE_TOP)}, mul_rn(b.hi, {f32_literal(_BASE_SLOPE)})),\n"
    f"                    sub_rn({f32_literal(_BASE_TOP)}, mul_rn(b.lo, {f32_literal(_BASE_SLOPE)}))}};\n"
    "    const Iv d_pos = iv_sub(r, nr), d_neg = iv_sub(r, iv_const(0.5f));\n"
    "    const Iv d = b.lo > 0.0f ? d_pos\n"
    "               : b.hi <= 0.0f ? d_neg\n"
    "               : Iv{fminf(d_pos.lo, d_neg.lo), fmaxf(d_pos.hi, d_neg.hi)};\n"
    f"    return iv_max(d, iv_sub(iv_abs(b), iv_const({f32_literal(0.05)})));"
)


def build(compiler=None):
    c = api.new_design() if compiler is None else compiler
    hilbert_body, hilbert_flops = hilbert_cuda()
    hilbert_interval, hilbert_interval_cuda = register_lipschitz_interval(
        _hilbert_brush_fn, HILBERT_ANCHOR, HILBERT_LIPSCHITZ, HILBERT_ENCLOSURE
    )
    hilbert_brush = c.define_brush(
        _hilbert_brush_fn, name="hilbert", cuda=hilbert_body, cuda_flops=hilbert_flops,
        interval=hilbert_interval, interval_cuda=hilbert_interval_cuda,
    )
    base_brush = c.define_brush(
        _base_brush_fn, name="hilbert_base", cuda=BASE_CUDA, cuda_flops=BASE_FLOPS,
        interval=_base_interval, interval_cuda=BASE_INTERVAL_CUDA,
    )

    api.draw(
        hilbert_brush,
        Transform.initial(
            position=np.zeros(3),
            yaw=np.pi / 4,
            pitch=np.pi / 4,
            roll=np.pi / 4,
            scale=np.ones(3),
        ),
        compiler=c,
    )
    api.draw(
        base_brush,
        Transform.initial(
            position=np.array([0.0, -np.sqrt(3 * 0.25) + 0.0075, 0.0]),
            yaw=0.0,
            pitch=0.0,
            roll=0.0,
            scale=np.ones(3),
        ),
        compiler=c,
    )

    c.set_export_config(
        boundingBoxHalfDiameter=2.0,
        minimumOctreeLevel=6,
        maximumOctreeLevel=8,
        gridLevel=9,
        complexSurfaceThreshold=np.pi / 2.0 * 0.5,
        gradientDescentSteps=50,
        cacheSubdivision=16,
        queriesBeforeGC=512,
        queriesBeforeFree=4096,
    )
    return c.commit()
