"""Sphere-traced viewport renderer (kernel k1 semantics) and the
differentiable renders of the shape fit.

Reference: k1.cl:280-580.  :func:`make_renderer` is the plain PyTorch
renderer, forward only: every pixel marches in one loop that evaluates the
SDF at the rays still marching and ends when each has hit or missed, shading
scans the object bank with last-match material attribution, and the
gizmo/background rules match the viewport kernel.  The march is exact or
over-relaxed and may start from a per-pixel ``t0`` plane;
:func:`make_cone_march` and :func:`make_hierarchical_renderer` are the cone
prepass and the two-pass fast viewport built on it.  These are the plain
versions of the CUDA kernels of ops/cuda/march_kernel.py, which
:func:`render_scene` takes on the card, so by default they march, take
normals and shade on the field the kernels compute: each brush's twin
(ops/interpreter.py), which is the exact tape for every design but Logo,
whose kernels sample baked letter tables.  ``field="exact"`` takes the
brushes' own functions instead.

Off the kernels, :func:`render_scene` renders as the JAX package does off
its TPU (raymarch.py:611-655 there): on the exact field, through
:func:`make_compacted_renderer` for a scene with safe brush proxies (Logo's
letter plates; :func:`make_proxy_prepass` marches them through open space
and only the surviving rays march the exact tape), else through
:func:`make_renderer` on the exact field.

:func:`make_differentiable_march`, :func:`make_ray_renderer` and
:func:`make_geometry_renderer` are the fit's renders: the fit's ray-march
kernel (or, for CPU tensors, its plain version) marches with the banks
detached, and gradients are reattached at the points it returns by the plain
tape under autograd -- the implicit function theorem at the hit point, the
envelope rule at the closest approach (raymarch.py:341-565 of the JAX
package).  The march rides the twin field, as the JAX package's kernels do;
the reattachment evaluates the exact tape, or the twin with
``fit_field="twin"`` in the geometry renderer.

Replicated quirks:
  * ray directions are *not* normalized (the march steps along ``uv,IFOV``
    projected onto the camera frame, k1.cl:444-448);
  * a hit at march step 0 returns d == 0.0, which renders the miss color
    (``if (d > 0.0)``, k1.cl:552); a ray that stops at its ``t0 > 0`` is
    shaded (the JAX package's hierarchical renderer);
  * material attribution is the *last* object in bank order within
    2*SDF_EPSILON (k1.cl:319-322);
  * pixel bytes are ``clip(trunc(255*c))`` (C float->int cast truncates).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..brushes import EvalContext
from ..camera import Camera
from ..compiler import CompiledScene, SceneArrays
from ..config import RenderConfig
from ..constants import AXES_SHADE_RADIUS, INITIAL_SCALE, MAX_DISTANCE
from .cull import (
    array_bank_reader,
    build_tape_tree,
    inflate,
    make_culled_sdf,
    make_tape_culler,
    push_neg,
    ray_box,
    stack_cull,
    tree_leaves,
)
from .interpreter import (
    axes_cylinder_sdf,
    brush_bank,
    dot3,
    eval_context,
    import_local_coords,
    make_normal_fn,
    make_primary_sdf,
)

logger = logging.getLogger("designcsg_tpu_torch")


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


#: A warp of the renderer kernel: a 16x2 patch of its 16x8 blocks, the tile of
#: its exact cull (csrc/march_kernel.cu).
WARP_W, WARP_H = 16, 2


def warp_tiles(config: RenderConfig, device=None):
    """(i64[H, W] the warp tile of each pixel, the number of tiles)."""
    tw = -(-config.width // WARP_W)
    ty = torch.arange(config.height, device=device) // WARP_H
    tx = torch.arange(config.width, device=device) // WARP_W
    return ty[:, None] * tw + tx[None, :], tw * -(-config.height // WARP_H)


def _tile_span(values, tiles, n_tiles, reduce):
    """Per tile, the least (``"amin"``) or largest (``"amax"``) of ``values``
    f32[N, ...] over the rows of each tile."""
    fill = float("inf") if reduce == "amin" else float("-inf")
    out = torch.full((n_tiles,) + values.shape[1:], fill, dtype=values.dtype, device=values.device)
    index = tiles.reshape((-1,) + (1,) * (values.dim() - 1)).expand_as(values)
    return out.scatter_reduce(0, index, values, reduce)


def hoisted_boxes(config: RenderConfig, o_proj, r_proj, t0=None):
    """The hoisted cull's box of each warp tile (march_kernel.py:468-491 of
    the JAX package; csrc/march.cuh hoisted_box): the axis box of o + d*r
    over the tile's rays ``r_proj`` f32[H, W, 3] for d from the tile's least
    start parameter (``t0`` f32[H, W], else 0) to ``max_distance``, widened by
    the FD probes' reach and the march's drift.  Returns (the box, (lo, hi)
    f32[T] per axis; the tile of each ray, i64[H*W]; the number of tiles)."""
    tiles, n_tiles = warp_tiles(config, r_proj.device)
    tiles = tiles.reshape(-1)
    d0 = torch.zeros(tiles.shape, device=r_proj.device) if t0 is None else t0.reshape(-1)
    r = r_proj.reshape(-1, 3)
    r_lo, r_hi = _tile_span(r, tiles, n_tiles, "amin"), _tile_span(r, tiles, n_tiles, "amax")
    seg = (_tile_span(d0, tiles, n_tiles, "amin"), float(np.float32(config.max_distance)))
    r_ivs = [(r_lo[:, i], r_hi[:, i]) for i in range(3)]
    drift = float(config.max_steps) * 1.5e-7
    box = tuple(
        inflate(iv, config.normal_epsilon, drift)
        for iv in ray_box([float(v) for v in o_proj], r_ivs, seg)
    )
    return box, tiles, n_tiles


class MarchCull:
    """The plain version's per-tile cull of one march (K7): ``tiles`` i64[N]
    the kernel tile of each ray, and either ``hoisted`` (the per-tile
    predicates bool[T, G] and substitutes f32[T, S] of the hoisted cull) or,
    with ``dynamic``, the culler and bank to cull every step on the box of
    each tile's live rays.  ``counts`` accumulates ``evals``, ``group_evals``
    and ``chains`` (tile culls)."""

    def __init__(self, culler, culled_sdf, tiles, bank, ctx, hoisted=None, dynamic=False,
                 counts=None):
        self.culler, self.culled_sdf = culler, culled_sdf
        self.tiles, self.bank, self.ctx = tiles, bank, ctx
        self.hoisted, self.dynamic, self.counts = hoisted, dynamic, counts

    def sdf(self, v, live, arrays):
        """The culled tape at the live rays' points ``v`` f32[n, 3]."""
        tl = self.tiles[live]
        if self.dynamic:
            present, slot = torch.unique(tl, return_inverse=True)
            lo = _tile_span(v, slot, present.numel(), "amin")
            hi = _tile_span(v, slot, present.numel(), "amax")
            box = tuple((lo[:, i], hi[:, i]) for i in range(3))
            preds, substs = stack_cull(*self.culler(box, self.bank, self.ctx), (present.numel(),))
            preds, substs = preds[slot], substs[slot]
            if self.counts is not None:
                self.counts["chains"] = self.counts.get("chains", 0) + present.numel()
        else:
            preds, substs = self.hoisted[0][tl], self.hoisted[1][tl]
        return self.culled_sdf(v, arrays, preds, substs, self.counts)


def _has_safe_proxies(scene: CompiledScene) -> bool:
    """True when some brush carries a ``__proxy_fn__`` (a cheap lower bound
    of its field) and every proxied brush sits at positive parity in the
    CSG tree: under an odd number of NEGATEs a lower bound becomes an upper
    bound, and the proxy march could step through a surface
    (raymarch.py:88-118 of the JAX package)."""
    proxied = [getattr(fn, "__proxy_fn__", None) is not None for fn in scene.brush_fns]
    if not any(proxied):
        return False
    root, _ = build_tape_tree([tuple(int(v) for v in row) for row in scene.arrays.tape])
    if root is None:
        return False

    return not any(proxied[leaf.brush] and leaf.negated for leaf in tree_leaves(push_neg(root)))


def make_proxy_prepass(scene: CompiledScene, config: RenderConfig):
    """Phase 1 of the proxy march (raymarch.py:121-163 of the JAX package):
    ``prepass(origins, dirs f32[..., 3], arrays) -> (t0 f32[...], miss
    bool[...])``.  Each ray sphere-traces the proxy scene (each proxied
    brush replaced by its lower bound) and stops where the proxy dips under
    epsilon: every true hit has ``sdf < eps``, hence ``proxy < eps``, so no
    hit is stepped over.  A ray past ``max_distance`` is a miss; one out of
    steps hands over where it stands."""
    proxy_sdf = make_primary_sdf(scene, gizmo=config.gizmo, proxy=True)
    eps, tol, max_d = config.sdf_epsilon, config.march_tolerance, config.max_distance

    def prepass(origins, dirs, arrays: SceneArrays):
        batch = dirs.shape[:-1]
        r = dirs.reshape(-1, 3)
        v = torch.broadcast_to(origins, r.shape).to(r.dtype).clone()
        d = torch.zeros(r.shape[0], dtype=r.dtype, device=r.device)
        miss = torch.zeros(d.shape, dtype=torch.bool, device=r.device)
        live = torch.arange(d.shape[0], device=r.device)
        for _ in range(config.max_steps):
            if live.numel() == 0:
                break
            s = proxy_sdf(v[live], arrays) * tol
            go = ~(s < eps)
            adv, s = live[go], s[go]
            v[adv] = v[adv] + s[:, None] * r[adv]
            d_adv = d[adv] + s
            d[adv] = d_adv
            out = d_adv > max_d
            miss[adv[out]] = True
            live = adv[~out]
        return d.reshape(batch), miss.reshape(batch)

    return prepass


def make_march(scene: CompiledScene, config: RenderConfig, field: str = "twin"):
    """``march(origins, dirs, arrays, return_steps=False, t0=None,
    return_closest=False) -> d``: signed hit distance along the
    (unnormalized) ray, -1 on a miss (k1.cl:420-470).  With
    ``return_closest`` also ``vmin`` f32[..., 3], each ray's closest
    approach: the evaluated point of smallest ``s = sdf*tol``, strictly
    below the smallest so far (from ``MAX_DISTANCE``), taken before the hit
    test and the advance, starting at the ray's first point (raymarch.py:
    225-247 and 286-293 of the JAX package; the plain version of the fit's
    ray-march kernel).  With ``return_steps`` also the number of SDF
    evaluations of each ray, last.

    ``t0`` (one start parameter per ray, the cone prepass's handoff) starts
    each ray at ``o + t0*r`` with ``d = t0``, and a ray with ``t0 > max_d``
    is a miss before its first step (march_kernel.py:447-460 of the JAX
    package).  With ``config.march_overrelax > 1`` the march is over-relaxed
    (Keinert et al. 2014): it steps by ``omega*s`` and, when consecutive
    bounding spheres stop overlapping (``|s| + prev_|s| < last_step``),
    retracts the last step and drops that ray to plain sphere tracing
    (raymarch.py:252-336 and march_kernel.py:565-632 of the JAX package).
    ``field`` is "twin" (the plain version of the kernels' marches) or
    "exact".  ``cull`` (a :class:`MarchCull`) evaluates the culled tape at
    each step instead, as the culled renderer kernel does.

    With ``config.march_proxy`` True and safe proxies
    (:func:`_has_safe_proxies`) the march has two phases, as the JAX
    package's make_march (raymarch.py:166-249): a ray without ``t0`` starts
    from :func:`make_proxy_prepass`'s handoff, a proxy miss beyond
    ``max_distance`` so that it is a miss before its first step."""
    sdf = make_primary_sdf(scene, gizmo=config.gizmo, field=field)
    eps = config.sdf_epsilon
    tol = config.march_tolerance
    max_d = config.max_distance
    omega = float(config.march_overrelax)
    if omega > 1.0:
        warn_if_not_lipschitz(scene, "over-relaxed march")
    prepass = (make_proxy_prepass(scene, config)
               if config.march_proxy and _has_safe_proxies(scene) else None)

    def march(origins, dirs, arrays: SceneArrays, return_steps: bool = False, t0=None,
              return_closest: bool = False, cull: Optional[MarchCull] = None):
        batch = dirs.shape[:-1]
        r = dirs.reshape(-1, 3)
        v = torch.broadcast_to(origins, r.shape).to(r.dtype).clone()
        d = torch.zeros(r.shape[0], dtype=r.dtype, device=r.device)
        if prepass is not None and t0 is None:
            t0 = prepass(origins, dirs, arrays)[0]
        if t0 is not None:
            # A copy: the march updates d in place.
            d = torch.broadcast_to(torch.as_tensor(t0, device=r.device), batch).to(r.dtype).flatten().clone()
            v = v + d[:, None] * r
        hit = torch.zeros(d.shape, dtype=torch.bool, device=r.device)
        steps = torch.zeros(d.shape, dtype=torch.int32, device=r.device)
        prev_r = torch.zeros_like(d)
        step_len = torch.zeros_like(d)
        omg = torch.full_like(d, omega)
        smin = torch.full_like(d, MAX_DISTANCE)
        vmin = v.clone() if return_closest else None
        # The rays still marching; each step evaluates the SDF at these only.
        live = torch.nonzero(~(d > max_d)).squeeze(1)
        for _ in range(config.max_steps):
            if live.numel() == 0:
                break
            steps[live] += 1
            s = (sdf(v[live], arrays) if cull is None else cull.sdf(v[live], live, arrays)) * tol
            if return_closest:
                closer = s < smin[live]
                near = live[closer]
                smin[near] = s[closer]
                vmin[near] = v[near]
            if omega > 1.0:
                sl, om = step_len[live], omg[live]
                sor_ok = ~((om > 1.0) & (torch.abs(s) + prev_r[live] < sl))
                new_hit = sor_ok & (s < eps)
                sl = torch.where(sor_ok, om * s, sl * (1.0 - om))
                omg[live] = torch.where(sor_ok, om, torch.ones_like(om))
                step_len[live] = sl
                prev_r[live] = torch.abs(s)
                step = sl
            else:
                new_hit = s < eps
                step = s
            hit[live[new_hit]] = True
            adv, step = live[~new_hit], step[~new_hit]
            v[adv] = v[adv] + step[:, None] * r[adv]
            d_adv = d[adv] + step
            d[adv] = d_adv
            live = adv[~(d_adv > max_d)]
        # Rays still marching after max_steps are misses (k1.cl:469).
        out = (torch.where(hit, d, torch.full_like(d, -1.0)).reshape(batch),)
        if return_closest:
            out += (vmin.reshape(batch + (3,)),)
        if return_steps:
            out += (steps.reshape(batch),)
        return out if len(out) > 1 else out[0]

    return march


def fit_ray_march(scene: CompiledScene, config: RenderConfig):
    """The march of the differentiable renders: the fit's ray-march kernel
    (:func:`~designcsg_tpu_torch.ops.cuda.march_kernel.make_cuda_ray_march`,
    which takes its plain version for CPU tensors), or that plain version on
    every device when ``config.use_pallas_march is False`` -- the JAX
    package's switch from its kernel to its jnp march (raymarch.py:67-85).
    ``(arrays, o_proj f32[3], rays f32[..., 3]) -> (d, vmin)``, detached."""
    from .cuda.march_kernel import make_cuda_ray_march

    ray_march = make_cuda_ray_march(scene, config)
    return ray_march.plain if config.use_pallas_march is False else ray_march


def ift_depth(sdf, d0, origins, dirs, arrays: SceneArrays):
    """Reattach gradients to a detached march's hit distances ``d0`` by the
    implicit function theorem (raymarch.py:341-371,556-560 of the JAX
    package).  At a hit, ``f(d, theta) = sdf(o + d*r)`` is pinned, so
    ``dd/dtheta = -f_theta / f_d`` with ``f_d`` the derivative of the SDF
    along the ray at ``p = o + d0*r`` (a ``jvp`` with the banks frozen).  The
    value equals ``d0`` bit for bit (``f - f.detach()`` is 0); misses are -1
    with no gradient."""
    frozen = arrays.detach()
    hit = d0 > 0.0
    p = origins + d0[..., None] * dirs
    f = sdf(p, arrays)
    _, f_d = torch.func.jvp(lambda q: sdf(q, frozen), (p,), (dirs,))
    denom = torch.where(f_d.abs() > 1e-6, f_d, torch.sign(f_d) * 1e-6 + 1e-12)
    return torch.where(hit, d0 - (f - f.detach()) / denom.detach(), -1.0)


def soft_alpha(s_min, config: RenderConfig, bandwidth: float):
    """The soft silhouette ``sigmoid((eps - s_min) / bandwidth)``
    (raymarch.py:487,562 of the JAX package).  The bandwidth is a tensor so
    that CUDA divides too, as the CPU does."""
    bw = torch.tensor(bandwidth, dtype=s_min.dtype, device=s_min.device)
    return torch.sigmoid((config.sdf_epsilon - s_min) / bw)


def make_differentiable_march(scene: CompiledScene, config: RenderConfig):
    """``march_diff(origins f32[3], dirs f32[..., 3], arrays) -> d``: the
    march with exact implicit-function-theorem gradients
    (raymarch.py:341-371 of the JAX package).  It marches detached (the
    fit's ray-march kernel on the card) and reattaches by :func:`ift_depth`:
    O(1) memory in the march's steps, one more SDF evaluation and one
    ``jvp``."""
    ray_march = fit_ray_march(scene, config)
    sdf = make_primary_sdf(scene, gizmo=config.gizmo)

    def march_diff(origins, dirs, arrays: SceneArrays):
        d0, _ = ray_march(arrays, origins, dirs)
        return ift_depth(sdf, d0, origins, dirs, arrays)

    return march_diff


def cone_slope(config: RenderConfig) -> float:
    """The cone prepass's slope: ``cone_safety`` times the largest uv
    distance of a fine ray from its FxF block's centre ray,
    ``((F-1)/2)*sqrt(2) / (W/2)`` (march_kernel.py:809-818 of the JAX
    package)."""
    half = (config.hierarchical_factor - 1) / 2.0
    return config.cone_safety * (half * float(np.sqrt(2.0)) / (config.width / 2.0))


def make_cone_march(scene: CompiledScene, config: RenderConfig):
    """Cone prepass (the semantics of K5, march_kernel.py:209-294 of the JAX
    package): ``cone_march(arrays, o_proj f32[3], rays f32[..., 3],
    return_steps=False) -> t_safe f32[...]``.

    Each ray marches with the cone-inflated stop test
    ``s < eps + d*slope`` on ``s = sdf*tol`` (``slope`` from
    :func:`cone_slope`) and returns the parameter of the last point it
    stepped past (committed just before stepping past it), so every fine ray
    its cone covers is epsilon-clear up to ``t_safe``.  A ray that leaves the
    scene (``d > max_d``) returns that ``d`` unless ``config.cone_strict``;
    one that runs out of steps returns its last committed point.  The field
    is the twin, as the kernel's."""
    sdf = make_primary_sdf(scene, gizmo=config.gizmo, field="twin")
    eps = config.sdf_epsilon
    tol = config.march_tolerance
    max_d = config.max_distance
    slope = cone_slope(config)
    strict = config.cone_strict

    def cone_march(arrays: SceneArrays, o_proj, rays, return_steps: bool = False):
        batch = rays.shape[:-1]
        r = rays.reshape(-1, 3)
        v = torch.broadcast_to(torch.as_tensor(o_proj, device=r.device), r.shape).to(r.dtype).clone()
        d = torch.zeros(r.shape[0], dtype=r.dtype, device=r.device)
        tprev = torch.zeros_like(d)
        steps = torch.zeros(d.shape, dtype=torch.int32, device=r.device)
        live = torch.arange(d.shape[0], device=r.device)
        for _ in range(config.max_steps):
            if live.numel() == 0:
                break
            steps[live] += 1
            s = sdf(v[live], arrays) * tol
            go = ~(s < eps + d[live] * slope)
            adv, s = live[go], s[go]
            # Commit the point just before stepping past it.
            tprev[adv] = d[adv]
            v[adv] = v[adv] + s[:, None] * r[adv]
            d_adv = d[adv] + s
            d[adv] = d_adv
            out = d_adv > max_d
            if not strict:
                tprev[adv[out]] = d_adv[out]
            live = adv[~out]
        tprev = tprev.reshape(batch)
        return (tprev, steps.reshape(batch)) if return_steps else tprev

    return cone_march


def make_shade(scene: CompiledScene, config: RenderConfig, field: str = "exact"):
    """``shade(p, n, arrays, ctx) -> rgb`` (k1.cl:280-379): linear scan of all
    objects re-evaluating each object's own SDF (of ``field``); the last
    match within eps*TOLERANCE_FACTOR_MATERIAL picks the material; otherwise
    the axis gizmo colors; otherwise the magenta background."""
    brush_fns = brush_bank(scene, field)
    shape_id = [int(s) for s in scene.arrays.shape_id]
    material_id = [int(m) for m in scene.arrays.material_id]
    thresh = config.sdf_epsilon * config.material_tolerance

    def shade(p, n, arrays: SceneArrays, ctx: EvalContext):
        batch = p.shape[:-1]
        match = torch.full(batch, -1, dtype=torch.int64, device=p.device)
        abc = torch.zeros_like(p)
        for i, shape in enumerate(shape_id):
            local = import_local_coords(p, arrays, i)
            is_match = brush_fns[shape](local, ctx) < thresh
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


def make_renderer(scene: CompiledScene, config: Optional[RenderConfig] = None,
                  field: str = "twin"):
    """``render(arrays, campos, rgt, upp, fwd, t0=None, cull_counts=None,
    rows=None) -> f32[H, W, 3]`` linear RGB on the device of ``arrays``;
    wrap with :func:`to_u8` for the reference's byte pixels.  ``t0``
    f32[H, W] is a per-pixel start parameter (see :func:`make_march`); a ray
    that stops at its ``t0 > 0`` is shaded.  ``rows=(row0, n)`` renders
    rows ``[row0, row0 + n)`` of the frame alone (``t0`` then f32[n, W]),
    as the renderer kernel does for a sharded frame.  March, normals and shading ride ``field``:
    the twin (the default) makes it the plain version of the fused renderer
    kernel, whose normals are FD whatever ``config.normal_mode`` says, as
    the JAX package's Pallas renderer's are; "exact" makes it the JAX
    package's jnp renderer (raymarch.py:568-590), with
    ``config.normal_mode``'s normals.

    With ``config.march_cull`` (and a tape that can be culled) it is the
    plain version of the culled kernel, at the kernel's tiles (warps,
    :func:`warp_tiles`): each tile's hoisted cull over its view cone
    (march_kernel.py:462-495 of the JAX package) serves the march (or, with
    ``"dynamic"``, the cull of each step's live rays does) and the FD
    normals.  ``cull_counts``, a dict, then accumulates the march's and the
    hit pixels' normal evaluations (``evals``), per group those that
    evaluated it (``group_evals``) and the tile culls (``chains``)."""
    config = config or RenderConfig()
    march = make_march(scene, config, field)
    normal_fn = make_normal_fn(make_primary_sdf(scene, gizmo=config.gizmo, field=field),
                               mode=config.normal_mode if field == "exact" else "fd",
                               epsilon=config.normal_epsilon)
    shade = make_shade(scene, config, field=field)
    culler = make_tape_culler(scene, gizmo=config.gizmo) if config.march_cull else None
    culled_sdf = None if culler is None else make_culled_sdf(scene, culler, field=field)

    def cull_for(o_proj, r_proj, t0, arrays, counts):
        """The frame's :class:`MarchCull` and the FD normal's culled field
        (the kernel's warp tiles of the rows ``r_proj`` holds)."""
        frame = dataclasses.replace(config, height=r_proj.shape[0])
        box, tiles, n_tiles = hoisted_boxes(frame, o_proj, r_proj, t0)
        bank, ctx = array_bank_reader(arrays), eval_context(scene, arrays)
        hoisted = stack_cull(*culler(box, bank, ctx), (n_tiles,))
        if counts is not None:
            counts.setdefault("evals", 0)
            counts.setdefault("group_evals", [0] * len(culler.groups))
            counts["chains"] = counts.get("chains", 0) + n_tiles
        mc = MarchCull(culler, culled_sdf, tiles, bank, ctx, hoisted=hoisted,
                       dynamic=config.march_cull == "dynamic", counts=counts)
        preds, substs = hoisted[0][tiles], hoisted[1][tiles]

        def normal_field(points, arrays):
            flat = points.reshape(-1, 3)
            return culled_sdf(flat, arrays, preds, substs).reshape(points.shape[:-1])

        return mc, normal_field, preds

    def render(arrays: SceneArrays, campos, rgt, upp, fwd, t0=None, cull_counts=None, rows=None):
        device = arrays.ad.device
        o_proj, rgt, upp, fwd = torch.as_tensor(camera_rows(campos, rgt, upp, fwd), device=device)
        r_proj = project(ray_directions(config, device), rgt, upp, fwd)
        if rows is not None:
            r_proj = r_proj[rows[0] : rows[0] + rows[1]]
        if culler is None:
            d = march(o_proj, r_proj, arrays, t0=t0)
            normals = normal_fn
        else:
            mc, normal_field, preds = cull_for(o_proj, r_proj, t0, arrays, cull_counts)
            d = march(o_proj, r_proj, arrays, t0=t0, cull=mc)
            normals = make_normal_fn(normal_field, epsilon=config.normal_epsilon)
            if cull_counts is not None:
                hit = (d > 0.0).reshape(-1)
                cull_counts["evals"] += 6 * int(hit.sum())
                cull_counts["group_evals"] = [
                    a + 6 * int(b) for a, b in zip(cull_counts["group_evals"], preds[hit].sum(0))
                ]
        p = o_proj + d[..., None] * r_proj
        ctx = eval_context(scene, arrays, rgt=rgt, upp=upp, fwd=fwd)
        color = shade(p, normals(p, arrays), arrays, ctx)
        miss_color = torch.tensor(config.miss_color, dtype=color.dtype, device=device)
        return torch.where((d > 0.0)[..., None], color, miss_color)

    render.culler = culler
    return render


def make_ray_renderer(scene: CompiledScene, config: Optional[RenderConfig] = None):
    """``render_rays(arrays, o_proj f32[3], r_proj f32[..., 3], rgt, upp,
    fwd) -> f32[..., 3]``: the ray-level renderer of the fit
    (raymarch.py:434-491 of the JAX package), differentiable with respect to
    ``arrays``.  With ``config.differentiable`` the hit distance carries the
    implicit-function-theorem gradient (:func:`ift_depth`).

    With ``config.soft_silhouette_bandwidth > 0`` a near-miss ray shades at
    its closest approach ``vmin`` and fades with ``sigma = sigmoid((eps -
    sdf(vmin)) / bw)``; a hit keeps its hard value with ``sigma`` as a
    zero-valued gradient carrier (``alpha = 1 + (sigma - sigma.detach())``).
    By the envelope theorem reattaching only through the SDF value at the
    frozen closest point is first-order exact.  The JAX package marches twice
    here (its differentiable march, then the closest-approach march); one
    march returns both, so this port marches once."""
    config = config or RenderConfig()
    ray_march = fit_ray_march(scene, config)
    sdf = make_primary_sdf(scene, gizmo=config.gizmo)
    normal_fn = make_normal_fn(sdf, mode=config.normal_mode, epsilon=config.normal_epsilon)
    shade = make_shade(scene, config)
    soft_bw = config.soft_silhouette_bandwidth

    def render_rays(arrays: SceneArrays, o_proj, r_proj, rgt, upp, fwd):
        d, vmin = ray_march(arrays, o_proj, r_proj)
        if config.differentiable:
            d = ift_depth(sdf, d, o_proj, r_proj, arrays)
        hit = d > 0.0
        p = o_proj + d[..., None] * r_proj
        ctx = eval_context(scene, arrays, rgt=rgt, upp=upp, fwd=fwd)
        miss_color = torch.tensor(config.miss_color, dtype=p.dtype, device=p.device)
        if soft_bw <= 0:
            color = shade(p, normal_fn(p, arrays), arrays, ctx)
            return torch.where(hit[..., None], color, miss_color)
        p_used = torch.where(hit[..., None], p, vmin)
        color = shade(p_used, normal_fn(p_used, arrays), arrays, ctx)
        sigma = soft_alpha(sdf(vmin, arrays), config, soft_bw)
        alpha = torch.where(hit, 1.0 + (sigma - sigma.detach()), sigma)[..., None]
        return alpha * color + (1.0 - alpha) * miss_color

    return render_rays


def make_geometry_renderer(scene: CompiledScene, config: Optional[RenderConfig] = None):
    """``render_geom(arrays, o_proj f32[3], r_proj f32[..., 3]) -> (depth,
    alpha)``: the depth and soft-silhouette renderer of the geometric fit
    (raymarch.py:494-565 of the JAX package).  One detached march returns
    both the hit distance and the closest approach; depth carries the
    implicit-function-theorem gradient (:func:`ift_depth`, continuous across
    union creases), alpha ``= sigmoid((eps - sdf(vmin)) / bw)`` the boundary
    gradient, with ``bw = soft_silhouette_bandwidth or 0.02``.

    ``config.fit_field`` names the field the gradient reattachment
    evaluates: ``"exact"`` (the tape of each brush's own function: gradients
    reach every bank, Logo's curve control points in ``ad`` included) or
    ``"twin"`` (the field the kernels compute: for Logo the baked letter
    tables, which are scene constants, so gradients reach the object banks
    only).  For Design1 and Design2 the two are the same tape.  Any other
    value raises ``ValueError``."""
    if config is None:
        config = RenderConfig(differentiable=True, soft_silhouette_bandwidth=0.02)
    if config.fit_field not in ("exact", "twin"):
        raise ValueError(f"fit_field must be 'exact' or 'twin', got {config.fit_field!r}")
    ray_march = fit_ray_march(scene, config)
    sdf = make_primary_sdf(scene, gizmo=config.gizmo, field=config.fit_field)
    bw = config.soft_silhouette_bandwidth or 0.02

    def render_geom(arrays: SceneArrays, o_proj, r_proj):
        d0, vmin = ray_march(arrays, o_proj, r_proj)
        depth = ift_depth(sdf, d0, o_proj, r_proj, arrays)
        return depth, soft_alpha(sdf(vmin, arrays), config, bw)

    return render_geom


def coarse_ray_uv(config: RenderConfig) -> np.ndarray:
    """f32[H/F, W/F, 3]: ``(uv.x, uv.y, IFOV)`` of the ray through the centre
    pixel of each FxF block, made on the host in float64 and rounded once, as
    the JAX package makes them (march_kernel.py:824-837).  Asserts an odd F
    (a centre pixel exists) that divides the viewport."""
    f = config.hierarchical_factor
    assert f % 2 == 1, "hierarchical_factor must be odd (centre ray exists)"
    assert config.width % f == 0 and config.height % f == 0, (
        f"viewport {config.width}x{config.height} must divide by hierarchical_factor {f}"
    )
    w2, h2, half = config.width / 2.0, config.height / 2.0, (f - 1) / 2.0
    hc, wc = config.height // f, config.width // f
    uvx = (np.arange(wc) * f + half - w2) / w2
    uvy = -(np.arange(hc) * f + half - h2) / w2
    return np.stack(
        [
            np.broadcast_to(uvx[None, :], (hc, wc)),
            np.broadcast_to(uvy[:, None], (hc, wc)),
            np.full((hc, wc), config.ifov),
        ],
        axis=-1,
    ).astype(np.float32)


def upload(a: np.ndarray, device) -> torch.Tensor:
    """``a`` as a tensor on ``device``.  To a card it goes through pinned
    memory without blocking: a pageable copy would wait for the stream's
    queued work, and a frame would then wait for the last one to finish
    before it could enqueue its first kernel."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def compose_hierarchical(config: RenderConfig, cone, fine):
    """Two-pass render (march_kernel.py:782-860 of the JAX package): ``cone``
    (``(arrays, o_proj, rays) -> t_safe``) marches the block-centre rays,
    each block's ``t_safe`` is repeated over its FxF pixels, and ``fine``
    (``(arrays, campos, rgt, upp, fwd, t0, rows=None) -> image``) marches
    every pixel from there.  The coarse rays are projected as the fine rays
    are, ``(uvx*a0 + uvy*a1) + IFOV*a2`` per frame axis ``a``.
    ``render(..., rows=(row0, n))`` renders rows ``[row0, row0 + n)`` alone,
    from the block rows that cover them: each ray gives the bits it gives in
    the whole frame."""
    f = config.hierarchical_factor
    uv = {"cpu": torch.from_numpy(coarse_ray_uv(config))}  # per device, copied once

    def render(arrays: SceneArrays, campos, rgt, upp, fwd, rows=None):
        device = arrays.ad.device
        if str(device) not in uv:
            uv[str(device)] = uv["cpu"].to(device)
        cam = upload(camera_rows(campos, rgt, upp, fwd), device)
        row0, n = (0, config.height) if rows is None else rows
        c0, c1 = row0 // f, -(-(row0 + n) // f)
        t_safe = cone(arrays, cam[0], project(uv[str(device)][c0:c1], *cam[1:]))
        t0 = t_safe.repeat_interleave(f, dim=0).repeat_interleave(f, dim=1)
        t0 = t0[row0 - c0 * f : row0 - c0 * f + n].contiguous()
        if rows is None:
            return fine(arrays, campos, rgt, upp, fwd, t0)
        return fine(arrays, campos, rgt, upp, fwd, t0, rows=rows)

    return render


def make_hierarchical_renderer(scene: CompiledScene, config: Optional[RenderConfig] = None):
    """``render(arrays, campos, rgt, upp, fwd) -> f32[H, W, 3]``: the cone
    prepass (:func:`make_cone_march`, slope :func:`cone_slope`) at
    1/``hierarchical_factor`` resolution hands each pixel a safe start
    parameter, from which :func:`make_renderer` marches.  The plain version
    of the CUDA hierarchical renderer, on the twin field: for Logo, the
    baked letters."""
    config = config or RenderConfig()
    warn_if_not_lipschitz(scene, "hierarchical cone prepass")
    cone = make_cone_march(scene, config)
    return compose_hierarchical(config, cone, make_renderer(scene, config))


def to_u8(image):
    """RGB888 conversion with the reference's clip(trunc(255*c)) semantics
    (k1.cl:8-10,472-478)."""
    return torch.clamp(torch.trunc(255.0 * image), 0.0, 255.0).to(torch.uint8)


def _compaction_eligible(scene: CompiledScene, config: RenderConfig) -> bool:
    """The compacted renderer serves plain forward frames of a scene with
    safe proxies, unless ``config.march_proxy`` is False
    (raymarch.py:726-736 of the JAX package)."""
    return (
        config.march_proxy is not False
        and not config.differentiable
        and config.soft_silhouette_bandwidth <= 0
        and _has_safe_proxies(scene)
    )


#: The compacted batch: survivors padded to a power of two, at least this.
MIN_COMPACT_BATCH = 1024
#: A padding ray's direction; it starts beyond ``max_distance``, so it is a
#: miss before its first step and costs the march nothing.
INERT_RAY = (0.0, 0.0, 1e-6)


def make_compacted_renderer(scene: CompiledScene, config: Optional[RenderConfig] = None):
    """``render(arrays, campos, rgt, upp, fwd, rows=None) -> f32[H, W, 3]``
    for a scene with safe brush proxies (:func:`_has_safe_proxies`), on the
    exact field (raymarch.py:739-844 of the JAX package; ``rows=(row0, n)``:
    those rows alone, each ray's bits the same):

    1. :func:`make_proxy_prepass` marches every ray on the proxy scene; a
       proxy miss is a pixel of ``miss_color`` and never touches the exact
       brushes;
    2. each survivor's handoff retreats by ``2*sdf_epsilon`` (not below 0),
       so that phase 2 approaches the surface with its own steps;
    3. the survivors are gathered into a batch padded to a power of two of
       at least ``MIN_COMPACT_BATCH`` rays with inert padding rays
       (``INERT_RAY``), and :func:`make_march` (``march_proxy`` off, the
       exact field) marches it from ``o + t0*r``, giving ``dd`` per ray;
    4. a ray with ``dd >= 0`` and ``t0 + max(dd, 0) > 0`` is shaded at
       ``o + t0*r + max(dd, 0)*r`` (the reference's ``d == 0`` miss rule
       applies to the whole parameter: a hit at the handoff is shaded),
       with ``config.normal_mode``'s normals, and scattered back.

    The JAX package jits each stage per batch size; the plain march here
    drops finished rays itself, so the padding keeps the JAX package's
    batch and buys no speed.  Normals and shading run on the survivors,
    which are pointwise the same values as on the whole batch."""
    config = config or RenderConfig()
    prepass = make_proxy_prepass(scene, config)
    march = make_march(scene, dataclasses.replace(config, march_proxy=False), field="exact")
    normal_fn = make_normal_fn(make_primary_sdf(scene, gizmo=config.gizmo),
                               mode=config.normal_mode, epsilon=config.normal_epsilon)
    shade = make_shade(scene, config)

    def render(arrays: SceneArrays, campos, rgt, upp, fwd, rows=None):
        device = arrays.ad.device
        row0, n_rows = (0, config.height) if rows is None else rows
        o_proj, rgt, upp, fwd = torch.as_tensor(camera_rows(campos, rgt, upp, fwd), device=device)
        r_proj = project(ray_directions(config, device)[row0 : row0 + n_rows], rgt, upp, fwd)
        r_proj = r_proj.reshape(-1, 3)
        miss_color = torch.tensor(config.miss_color, dtype=r_proj.dtype, device=device)
        t0, miss = prepass(o_proj, r_proj, arrays)
        t0 = torch.clamp(t0 - 2.0 * config.sdf_epsilon, min=0.0)
        img = miss_color.expand(r_proj.shape).clone()
        idx = torch.nonzero(~miss).squeeze(1)
        n = idx.numel()
        render.survivors = n
        if n:
            n_pad = max(MIN_COMPACT_BATCH, 1 << (n - 1).bit_length())
            r_flat = torch.tensor(INERT_RAY, dtype=r_proj.dtype, device=device).repeat(n_pad, 1)
            r_flat[:n] = r_proj[idx]
            t0_flat = torch.zeros(n_pad, dtype=r_proj.dtype, device=device)
            t0_flat[:n] = t0[idx]
            o_shift = o_proj + t0_flat[:, None] * r_flat
            # Padding rays start beyond max_distance: misses before a step.
            start = torch.full_like(t0_flat, float("inf"))
            start[:n] = 0.0
            dd = march(o_shift, r_flat, arrays, t0=start)
            dd, o_shift, t0_flat, r_flat = dd[:n], o_shift[:n], t0_flat[:n], r_flat[:n]
            step = torch.clamp(dd, min=0.0)
            shaded = (dd >= 0.0) & (t0_flat + step > 0.0)
            p = o_shift + step[:, None] * r_flat
            ctx = eval_context(scene, arrays, rgt=rgt, upp=upp, fwd=fwd)
            color = shade(p, normal_fn(p, arrays), arrays, ctx)
            img[idx] = torch.where(shaded[:, None], color, miss_color)
        return img.reshape(n_rows, config.width, 3)

    render.survivors = 0
    return render


def make_scene_renderer(scene: CompiledScene, config: RenderConfig, device: torch.device):
    """``render(arrays, campos, rgt, upp, fwd) -> f32[H, W, 3]`` for
    ``device``, routed from the scene before anything is built
    (raymarch.py:631-651 of the JAX package).  On the card: the CUDA
    renderer when every brush and material the scene uses has a CUDA body
    (and, under ``march_cull``, its CUDA interval twin;
    brushes_kernel.supports_scene), for proxy scenes too, as the JAX
    package's TPU route keeps its Pallas renderer.  Otherwise, on either
    device, the plain route: the plain hierarchical or culled renderer
    (the plain versions of those kernels, on the twin field) under
    ``march_hierarchical`` or ``march_cull``, else the JAX package's
    off-TPU route on the exact field: :func:`make_compacted_renderer` for a
    scene with safe proxies (:func:`_compaction_eligible`), else
    :func:`make_renderer` with ``field="exact"``.  ``render.engine`` names
    the route: "cuda" or "tape".  Every route's ``render`` also takes
    ``rows=(row0, n)``: rows ``[row0, row0 + n)`` of the frame alone, each
    ray's bits those of the whole frame (the sharded renderer's blocks,
    parallel/render.py)."""
    from .cuda.brushes_kernel import supports_scene
    from .cuda.march_kernel import make_cuda_hierarchical_renderer, make_cuda_renderer

    cuda = device.type == "cuda"
    if cuda and not supports_scene(scene, cull=bool(config.march_cull), gizmo=config.gizmo):
        logger.warning("scene has brushes or materials without CUDA bodies; rendering "
                       "through the plain tape on %s", device)
        cuda = False
    if cuda:
        render = (make_cuda_hierarchical_renderer if config.march_hierarchical
                  else make_cuda_renderer)(scene, config)
    elif config.march_hierarchical:
        render = make_hierarchical_renderer(scene, config)
    elif config.march_cull:
        render = make_renderer(scene, config)
    elif _compaction_eligible(scene, config):
        render = make_compacted_renderer(scene, config)
    else:
        render = make_renderer(scene, config, field="exact")
    render.engine = "cuda" if cuda else "tape"
    return render


def render_scene(
    scene: CompiledScene,
    camera: Optional[Camera] = None,
    config: Optional[RenderConfig] = None,
    arrays: Optional[SceneArrays] = None,
    device=None,
):
    """One-shot viewport render with the default camera through
    :func:`make_scene_renderer`: the CUDA renderers on the card (the
    default) for a scene with CUDA bodies; otherwise, and with
    ``device="cpu"``, the plain route (the JAX package's off-TPU frames on
    the exact field, or the plain hierarchical and culled renderers).
    ``config.march_hierarchical`` takes the cone prepass + ``t0`` renderer,
    otherwise the renderer marches exactly or, with ``march_overrelax > 1``,
    over-relaxed.  ``arrays`` defaults to the scene's own banks."""
    device = resolve_device(device)
    camera = camera or Camera.initial()
    config = config or RenderConfig()
    arrays = (arrays or scene.arrays).to_torch(device)
    return make_scene_renderer(scene, config, device)(arrays, *camera.as_arrays())


def check_scene_lipschitz(
    scene: CompiledScene,
    radius: float = MAX_DISTANCE / 4.0,
    samples: int = 8192,
    probe: float = 1e-2,
    seed: int = 0,
) -> float:
    """Sampled estimate of the scene SDF's Lipschitz constant,
    ``max |f(a)-f(b)| / |a-b|`` over random short segments in the world
    domain (raymarch.py:658-687 of the JAX package), with the plain SDF on
    the CPU.  The over-relaxed march's retraction and the cone prepass's
    clearance both assume a (<=1)-Lipschitz tape; a sampled max is a lower
    bound of the true constant."""
    sdf = make_primary_sdf(scene)
    arrays = scene.arrays.to_torch("cpu")
    rng = np.random.default_rng(seed)
    a = rng.uniform(-radius, radius, size=(samples, 3)).astype(np.float32)
    step = rng.normal(size=(samples, 3)).astype(np.float32)
    step /= np.linalg.norm(step, axis=-1, keepdims=True)
    b = a + probe * radius * step
    fa = sdf(torch.from_numpy(a), arrays).numpy()
    fb = sdf(torch.from_numpy(b), arrays).numpy()
    d = np.linalg.norm(b - a, axis=-1)
    return float(np.max(np.abs(fa - fb) / d))


_LIPSCHITZ_CACHE: dict = {}


def warn_if_not_lipschitz(scene: CompiledScene, where: str, threshold: float = 1.02) -> float:
    """Run :func:`check_scene_lipschitz` and log a warning when the estimate
    exceeds ``threshold``: called by the over-relaxed and hierarchical
    builders so their safety assumptions are checked per scene.  Cached by
    scene content (tape, banks, arbitrary data)."""
    key = scene.arrays.content_digest()
    if key not in _LIPSCHITZ_CACHE:
        est = _LIPSCHITZ_CACHE[key] = check_scene_lipschitz(scene, samples=4096)
        if est > threshold:
            logger.warning(
                "%s: scene SDF Lipschitz estimate %.2f > 1; the over-relaxed "
                "retraction and the cone clearance assume a distance-like "
                "(<=1-Lipschitz) tape, so the approximate march modes may drop "
                "thin features of this scene. Use exact semantics "
                "(march_overrelax=1, march_hierarchical=False) for final renders.",
                where,
                est,
            )
    return _LIPSCHITZ_CACHE[key]
