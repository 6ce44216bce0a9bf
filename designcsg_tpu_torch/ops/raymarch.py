"""Sphere-traced viewport renderer (kernel k1 semantics), forward only.

Reference: k1.cl:280-580.  :func:`make_renderer` is the plain PyTorch
renderer: the whole pixel grid marches in lockstep as a masked loop that ends
when every ray has hit or missed, shading scans the object bank with
last-match material attribution, and the gizmo/background rules match the
viewport kernel.  It is the plain version of the fused CUDA renderer
(ops/cuda/march_kernel.py), which :func:`render_scene` takes on the card.

Replicated quirks:
  * ray directions are *not* normalized (the march steps along ``uv,IFOV``
    projected onto the camera frame, k1.cl:444-448);
  * a hit at march step 0 returns d == 0.0, which renders the miss color
    (``if (d > 0.0)``, k1.cl:552);
  * material attribution is the *last* object in bank order within
    2*SDF_EPSILON (k1.cl:319-322);
  * pixel bytes are ``clip(trunc(255*c))`` (C float->int cast truncates).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..brushes import EvalContext
from ..camera import Camera
from ..compiler import CompiledScene, SceneArrays
from ..config import RenderConfig
from ..constants import AXES_SHADE_RADIUS, INITIAL_SCALE
from .interpreter import (
    axes_cylinder_sdf,
    dot3,
    import_local_coords,
    make_normal_fn,
    make_primary_sdf,
)


def ray_directions(config: RenderConfig, device=None):
    """Pinhole rays in camera coordinates: ``(uv.x, uv.y, IFOV)`` with
    ``uv = ((ix - W/2), -(iy - H/2)) / (W/2)`` (k1.cl:506-528); f32[H, W, 3]."""
    w, h = config.width, config.height
    # Made on the CPU, where dividing by a scalar is a true division (a CUDA
    # tensor divided by a host scalar is multiplied by its reciprocal).
    ix = torch.arange(w, dtype=torch.float32)
    iy = torch.arange(h, dtype=torch.float32)
    uvx = (ix - w / 2.0) / (w / 2.0)
    uvy = -(iy - h / 2.0) / (w / 2.0)
    uvx, uvy = torch.meshgrid(uvx, uvy, indexing="xy")  # [H, W]
    rays = torch.stack([uvx, uvy, torch.full_like(uvx, config.ifov)], dim=-1)
    return rays.to(device)


def project(v, rgt, upp, fwd):
    """Project a vector (or vector field) onto the camera frame rows."""
    return torch.stack([dot3(v, rgt), dot3(v, upp), dot3(v, fwd)], dim=-1)


def camera_rows(campos, rgt, upp, fwd) -> np.ndarray:
    """f32[4, 3]: the camera position projected onto the frame, then the frame
    rows — what a renderer needs of the camera."""
    frame = [torch.as_tensor(np.asarray(a, np.float32)) for a in (campos, rgt, upp, fwd)]
    o_proj = project(frame[0], *frame[1:])
    return torch.stack([o_proj] + frame[1:]).numpy()


def make_march(scene: CompiledScene, config: RenderConfig):
    """``march(origins, dirs, arrays, return_steps=False) -> d``: signed hit
    distance along the (unnormalized) ray, -1 on a miss (k1.cl:420-470).
    With ``return_steps`` also the number of SDF evaluations of each ray."""
    sdf = make_primary_sdf(scene, gizmo=config.gizmo)
    eps = config.sdf_epsilon
    tol = config.march_tolerance
    max_d = config.max_distance

    def march(origins, dirs, arrays: SceneArrays, return_steps: bool = False):
        batch = dirs.shape[:-1]
        v = torch.broadcast_to(origins, dirs.shape).to(dirs.dtype)
        d = torch.zeros(batch, dtype=dirs.dtype, device=dirs.device)
        hit = torch.zeros(batch, dtype=torch.bool, device=dirs.device)
        miss = torch.zeros_like(hit)
        steps = torch.zeros(batch, dtype=torch.int32, device=dirs.device)
        for _ in range(config.max_steps):
            active = ~(hit | miss)
            if not bool(active.any()):
                break
            steps += active.to(torch.int32)
            s = sdf(v, arrays) * tol
            new_hit = active & (s < eps)
            advance = active & ~new_hit
            v = torch.where(advance[..., None], v + s[..., None] * dirs, v)
            d = torch.where(advance, d + s, d)
            miss = miss | (advance & (d > max_d))
            hit = hit | new_hit
        # Rays still active after max_steps are misses (k1.cl:469).
        d_out = torch.where(hit, d, torch.full_like(d, -1.0))
        return (d_out, steps) if return_steps else d_out

    return march


def make_shade(scene: CompiledScene, config: RenderConfig):
    """``shade(p, n, arrays, ctx) -> rgb`` (k1.cl:280-379): linear scan of all
    objects re-evaluating each object's own SDF; the last match within
    eps*TOLERANCE_FACTOR_MATERIAL picks the material; otherwise the axis
    gizmo colors; otherwise the magenta background."""
    shape_id = [int(s) for s in scene.arrays.shape_id]
    material_id = [int(m) for m in scene.arrays.material_id]
    thresh = config.sdf_epsilon * config.material_tolerance

    def shade(p, n, arrays: SceneArrays, ctx: EvalContext):
        batch = p.shape[:-1]
        match = torch.full(batch, -1, dtype=torch.int64, device=p.device)
        abc = torch.zeros_like(p)
        for i, shape in enumerate(shape_id):
            local = import_local_coords(p, arrays, i)
            is_match = scene.brush_fns[shape](local, ctx) < thresh
            match = torch.where(is_match, i, match)
            abc = torch.where(is_match[..., None], local, abc)

        color = torch.zeros(batch + (3,), dtype=p.dtype, device=p.device)
        match_material = torch.as_tensor(material_id, device=p.device)[match.clamp(min=0)]
        for m in sorted(set(material_id)):
            cm = scene.material_fns[m](p, abc, n, ctx)
            color = torch.where(((match >= 0) & (match_material == m))[..., None], cm, color)

        # Unmatched: axis gizmo attribution at 1/5 scale, radius 0.025
        # (k1.cl:331-373), else the background.  Later rules win: z, y, x.
        v = p / torch.tensor(INITIAL_SCALE, dtype=p.dtype, device=p.device)
        x, y, z = v[..., 0], v[..., 1], v[..., 2]
        unmatched = torch.tensor(config.background, dtype=p.dtype, device=p.device).expand(
            batch + (3,)
        )
        for g, rgb in (
            (axes_cylinder_sdf(torch.sqrt(x * x + y * y), z - 0.5, 0.5, AXES_SHADE_RADIUS), (0.0, 0.0, 1.0)),
            (axes_cylinder_sdf(torch.sqrt(x * x + z * z), y - 0.5, 0.5, AXES_SHADE_RADIUS), (0.0, 1.0, 0.0)),
            (axes_cylinder_sdf(torch.sqrt(y * y + z * z), x - 0.5, 0.5, AXES_SHADE_RADIUS), (1.0, 0.0, 0.0)),
        ):
            unmatched = torch.where(
                (g < thresh)[..., None], torch.tensor(rgb, dtype=p.dtype, device=p.device), unmatched
            )
        return torch.where((match >= 0)[..., None], color, unmatched)

    return shade


def make_renderer(scene: CompiledScene, config: Optional[RenderConfig] = None):
    """``render(arrays, campos, rgt, upp, fwd) -> f32[H, W, 3]`` linear RGB on
    the device of ``arrays``; wrap with :func:`to_u8` for the reference's byte
    pixels."""
    config = config or RenderConfig()
    march = make_march(scene, config)
    normal_fn = make_normal_fn(
        make_primary_sdf(scene, gizmo=config.gizmo), epsilon=config.normal_epsilon
    )
    shade = make_shade(scene, config)

    def render(arrays: SceneArrays, campos, rgt, upp, fwd):
        device = arrays.ad.device
        o_proj, rgt, upp, fwd = torch.as_tensor(camera_rows(campos, rgt, upp, fwd), device=device)
        r_proj = project(ray_directions(config, device), rgt, upp, fwd)
        d = march(o_proj, r_proj, arrays)
        p = o_proj + d[..., None] * r_proj
        ctx = EvalContext(ad=arrays.ad, rgt=rgt, upp=upp, fwd=fwd)
        color = shade(p, normal_fn(p, arrays), arrays, ctx)
        miss_color = torch.tensor(config.miss_color, dtype=color.dtype, device=device)
        return torch.where((d > 0.0)[..., None], color, miss_color)

    return render


def to_u8(image):
    """RGB888 conversion with the reference's clip(trunc(255*c)) semantics
    (k1.cl:8-10,472-478)."""
    return torch.clamp(torch.trunc(255.0 * image), 0.0, 255.0).to(torch.uint8)


def render_scene(
    scene: CompiledScene,
    camera: Optional[Camera] = None,
    config: Optional[RenderConfig] = None,
    arrays: Optional[SceneArrays] = None,
    device=None,
):
    """One-shot viewport render with the default camera: the fused CUDA
    renderer on the card (the default), the plain renderer with
    ``device="cpu"``.  ``arrays`` defaults to the scene's own banks."""
    from .cuda.march_kernel import make_cuda_renderer

    device = resolve_device(device)
    camera = camera or Camera.initial()
    arrays = (arrays or scene.arrays).to_torch(device)
    renderer = make_cuda_renderer(scene, config or RenderConfig())
    return renderer(arrays, *camera.as_arrays())
