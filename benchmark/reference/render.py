"""The viewport frame of upstream's k1 kernel (k1.cl:280-580), in plain PyTorch.

Each pixel (ix, iy) of a W x H frame casts the camera-space direction
``((ix - W/2) / (W/2), -(iy - H/2) / (W/2), 1)``, projected onto the
camera's rows (right, up, forward), from the camera position projected the
same way; directions are not normalised.  The march steps by ``0.85 f``
until ``0.85 f < 0.005`` (a hit, at the distance reached so far) or the
distance passes 64 or 512 steps are spent (a miss).  ``f`` is the design's
field joined with the axis gizmo: three cylinders of radius 0.015 from the
origin along +x, +y and +z, of length 1, at a fifth of world scale.

A hit at a distance above 0 is shaded at ``o + d r``: the normal is the
central difference of ``f`` over 0.005 on each axis, normalised; the last
object in bank order whose own brush reads under 0.01 there gives the
colour, and every object of these designs has upstream's default material,
the headlamp ``-(n_x right_z + n_y up_z + n_z forward_z)`` on all three
channels.  A hit that no object claims takes the gizmo's colour when a
gizmo cylinder of radius 0.025 reads under 0.01 there (x red over y green
over z blue), else the background (239, 66, 245) / 255.  A miss, or a hit
at distance 0, is white.
"""

from __future__ import annotations

import numpy as np
import torch

from .geometry import Design, dot3

MAX_STEPS = 512
MAX_DISTANCE = 64.0
EPSILON = 0.005
STEP_FACTOR = 0.85
MATERIAL_FACTOR = 2.0
BACKGROUND = (239.0 / 255.0, 66.0 / 255.0, 245.0 / 255.0)
# FP32 operations: one frame transform (3 differences, 3 dot products of 5)
# and the gizmo (3 divisions; 3 cylinders of 2 products, a sum, a root, |.|,
# 2 differences and a maximum; 2 minima).
TRANSFORM_FLOPS = 18
GIZMO_FLOPS = 3 + 3 * 9 + 2


def field_flops(design: Design, gizmo: bool = True) -> int:
    """FP32 operations of one evaluation of the design's field: each leaf's
    transform and brush and its fold (a minimum, or a negation and a
    maximum), and with ``gizmo`` the gizmo and its minimum."""
    leaves = sum(TRANSFORM_FLOPS + leaf.brush.flops + (2 if leaf.erase else 1)
                 for leaf in design.leaves)
    return leaves + (GIZMO_FLOPS + 1 if gizmo else 0)


def shade_flops(design: Design) -> int:
    """FP32 operations of one hit pixel's shading: every leaf's transform
    and brush, the headlamp (3 products, 2 sums, a negation)."""
    return sum(TRANSFORM_FLOPS + leaf.brush.flops for leaf in design.leaves) + 6


def _cylinder(r, h, radius):
    return torch.maximum(torch.abs(h) - 0.5, r - radius)


def gizmo(p: torch.Tensor, radius: float):
    """The three gizmo cylinders (x, y, z) at the points."""
    v = p / torch.tensor(5.0, dtype=p.dtype, device=p.device)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return (_cylinder(torch.sqrt(y * y + z * z), x - 0.5, radius),
            _cylinder(torch.sqrt(x * x + z * z), y - 0.5, radius),
            _cylinder(torch.sqrt(x * x + y * y), z - 0.5, radius))


def viewport_field(design: Design, p: torch.Tensor) -> torch.Tensor:
    gx, gy, gz = gizmo(p, 0.015)
    return torch.minimum(design.field(p), torch.minimum(gx, torch.minimum(gy, gz)))


def rays(camera, width: int, height: int, dtype, device):
    """(origin f[3], directions f[H*W, 3]) projected onto the camera rows;
    ``camera`` is (position, right, up, forward), each float32[3]."""
    pos, rgt, upp, fwd = (torch.as_tensor(np.asarray(a, np.float32)) for a in camera)
    ix = torch.arange(width, dtype=torch.float32)
    iy = torch.arange(height, dtype=torch.float32)
    u = (ix - width / 2.0) / (width / 2.0)
    v = -(iy - height / 2.0) / (width / 2.0)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    cam = torch.stack([uu, vv, torch.ones_like(uu)], dim=-1).reshape(-1, 3)
    rows = torch.stack([rgt, upp, fwd])
    r = torch.stack([dot3(cam, rows[k]) for k in range(3)], dim=-1)
    o = torch.stack([dot3(pos, rows[k]) for k in range(3)])
    return o.to(device, dtype), r.to(device, dtype)


def march(design: Design, o: torch.Tensor, r: torch.Tensor):
    """(distance f[N]: -1 on a miss, steps i64[N]: field evaluations)."""
    n = r.shape[0]
    v = o.expand(n, 3).clone()
    d = torch.zeros(n, dtype=r.dtype, device=r.device)
    hit = torch.zeros(n, dtype=torch.bool, device=r.device)
    steps = torch.zeros(n, dtype=torch.int64, device=r.device)
    live = torch.arange(n, device=r.device)
    for _ in range(MAX_STEPS):
        if live.numel() == 0:
            break
        steps[live] += 1
        s = viewport_field(design, v[live]) * STEP_FACTOR
        stop = s < EPSILON
        hit[live[stop]] = True
        live, s = live[~stop], s[~stop]
        v[live] = v[live] + s[:, None] * r[live]
        d_live = d[live] + s
        d[live] = d_live
        live = live[~(d_live > MAX_DISTANCE)]
    return torch.where(hit, d, torch.full_like(d, -1.0)), steps


def normals(design: Design, p: torch.Tensor) -> torch.Tensor:
    e = torch.tensor(EPSILON, dtype=p.dtype, device=p.device)
    g = []
    for axis in range(3):
        step = torch.zeros(3, dtype=p.dtype, device=p.device)
        step[axis] = e
        g.append(viewport_field(design, p + step) - viewport_field(design, p - step))
    g = torch.stack(g, dim=-1) / (2.0 * e)
    return g / torch.sqrt(dot3(g, g))[..., None]


def shade(design: Design, p: torch.Tensor, n: torch.Tensor, camera) -> torch.Tensor:
    threshold = EPSILON * MATERIAL_FACTOR
    claimed = (design.leaf_values(p) < threshold).any(-1)
    z = torch.as_tensor(np.asarray([camera[1][2], camera[2][2], camera[3][2]], np.float32))
    z = z.to(p.device, p.dtype)
    light = -(n[..., 0] * z[0] + n[..., 1] * z[1] + n[..., 2] * z[2])
    color = torch.tensor(BACKGROUND, dtype=p.dtype, device=p.device).expand(p.shape).clone()
    gx, gy, gz = gizmo(p, 0.025)
    for g, rgb in ((gz, (0.0, 0.0, 1.0)), (gy, (0.0, 1.0, 0.0)), (gx, (1.0, 0.0, 0.0))):
        color[g < threshold] = torch.tensor(rgb, dtype=p.dtype, device=p.device)
    return torch.where(claimed[..., None], light[..., None].expand(p.shape), color)


def render(design: Design, camera, width: int, height: int, dtype=torch.float32,
           device="cpu", block: int = 1 << 17):
    """(frame float32[H, W, 3] on ``device``, field evaluations of the march
    and the normals, hit pixels), computed in ``dtype``, ``block`` pixels
    at a time."""
    o, r = rays(camera, width, height, dtype, device)
    out = torch.empty((r.shape[0], 3), dtype=torch.float32, device=device)
    evals = hits = 0
    for start in range(0, r.shape[0], block):
        rb = r[start:start + block]
        d, steps = march(design, o, rb)
        hit = d > 0.0
        color = torch.ones((rb.shape[0], 3), dtype=dtype, device=device)
        if bool(hit.any()):
            p = o + d[hit][:, None] * rb[hit]
            color[hit] = shade(design, p, normals(design, p), camera)
        out[start:start + block] = color.float()
        evals += int(steps.sum()) + 6 * int(hit.sum())
        hits += int(hit.sum())
    return out.reshape(height, width, 3), evals, hits
