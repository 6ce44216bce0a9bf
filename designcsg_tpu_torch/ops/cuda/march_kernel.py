"""Fused k1 viewport renderer, cone prepass and the fit's ray march: CUDA
kernels and their plain versions.

Counterparts of the JAX package's ops/pallas/march_kernel.py
``make_pallas_renderer`` (exact and over-relaxed march, optional ``t0``
input, the exact per-tile cull K7 hoisted or dynamic),
``make_pallas_cone_march``, ``make_hierarchical_renderer`` and
``make_pallas_ray_march``.  Kernel sources: csrc/march_kernel.cu,
csrc/cone_kernel.cu, csrc/ray_march_kernel.cu and csrc/march.cuh plus the
scene code generated by ops/cuda/tape.py.  The plain versions are
ops/raymarch.py's :func:`make_renderer`, :func:`make_cone_march`,
:func:`make_hierarchical_renderer` and :func:`make_march` with
``return_closest``; kernels and plain versions march each brush's twin (for
Logo the baked letter tables, csrc/table.cuh, K6).

Launch counts: ``renderer`` (exact march from the camera),
``renderer_overrelax`` (over-relaxed, from the camera), ``renderer_t0``
(from a start plane, either march), each with ``_cull`` or ``_cull_dynamic``
appended when the config culls (``renderer_cull``, ``renderer_t0_cull_dynamic``,
...), ``cone_march`` and ``ray_march``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from ...compiler import CompiledScene, SceneArrays
from ...config import RenderConfig
from ..raymarch import (
    camera_rows,
    compose_hierarchical,
    make_cone_march,
    make_hierarchical_renderer,
    make_march,
    make_renderer,
)
from .build import check_call, check_launch, load, on_cuda, ptr, require_cuda_f32, scene_args
from .tape import (
    cone_kernel_source,
    cull_mode,
    march_kernel_source,
    ray_march_kernel_source,
)

_P = ctypes.c_void_p
_F = ctypes.c_float
_I = ctypes.c_int
# The launchers' trailing arguments (csrc/common.cuh SCENE_PARAMS): the bank
# pointers, the bank buffer, the card and the stream.
_SCENE = [_P] * 7 + [_I, _P]


def make_cuda_renderer(
    scene: CompiledScene, config: Optional[RenderConfig] = None, cull_stats: bool = False,
):
    """``render(arrays, campos, rgt, upp, fwd, t0=None, rows=None) -> f32[H,
    W, 3]`` on the device of ``arrays``: the fused kernel on a CUDA device,
    the plain renderer on the CPU.  The march is exact, or over-relaxed when
    ``config.march_overrelax > 1``; ``t0`` f32[H, W] starts each pixel's
    march there.  ``rows=(row0, n)`` renders rows ``[row0, row0 + n)`` of the
    frame alone (``t0`` then f32[n, W]), the sharded renderer's blocks.  With
    ``config.march_cull`` the kernel culls each warp's tape by interval
    arithmetic (K7), hoisted or ``"dynamic"``, unless the tape has nothing to
    cull.  ``render.plain`` is the plain version.  The kernel builds with
    ``-fmad=false`` (ops/cuda/build.py ``EXTRA_FLAGS``), so that a ray stops
    at its plain version's step.  ``cull_stats=True`` builds the dynamic
    culled kernel with its counters (CULL_STATS, csrc/march.cuh; launches
    counted with ``_stats`` appended) and makes ``render`` also return the
    frame's ``evals``, ``group_evals`` (over all groups) and ``chains``."""
    config = config or RenderConfig()
    plain = make_renderer(scene, config)
    if cull_stats and (plain.culler is None or cull_mode(config) != 2):
        raise ValueError("cull_stats counts the dynamic cull: it needs march_cull='dynamic' "
                         "and a tape that can be culled")
    mode = "renderer_overrelax" if config.march_overrelax > 1.0 else "renderer"
    suffix = ""
    if plain.culler is not None:
        suffix = "_cull_dynamic" if cull_mode(config) == 2 else "_cull"
    libs = {}

    def library(device):
        if device not in libs:
            source = march_kernel_source(scene, config)
            lib = load("march", ("#define CULL_STATS 1\n" if cull_stats else "") + source, device)
            lib.launch_render.argtypes = [_P, _I, _I, _I, _I, _P, _P] + _SCENE
            lib.launch_render.restype = ctypes.c_int
            if cull_stats:
                lib.read_cull_stats.argtypes = [_I, ctypes.POINTER(ctypes.c_ulonglong)]
                lib.read_cull_stats.restype = ctypes.c_int
            libs[device] = lib
        return libs[device]

    def render(arrays: SceneArrays, campos, rgt, upp, fwd, t0=None, rows=None) -> torch.Tensor:
        if not on_cuda(arrays.ad):
            if cull_stats:
                raise ValueError("cull_stats counts the kernel's cull: it needs a CUDA device")
            return plain(arrays, campos, rgt, upp, fwd, t0=t0, rows=rows)
        device = arrays.ad.device
        row0, n_rows = (0, config.height) if rows is None else rows
        if not 0 <= row0 <= row0 + n_rows <= config.height:
            raise ValueError(f"rows {rows} are not rows of a {config.height}-row frame")
        if t0 is not None:
            require_cuda_f32("t0", t0, device)
            if tuple(t0.shape) != (n_rows, config.width):
                raise ValueError(f"t0 must be [{n_rows}, {config.width}], got {tuple(t0.shape)}")
        lib = library(device)
        cam = np.ascontiguousarray(camera_rows(campos, rgt, upp, fwd), np.float32)
        out = torch.empty((n_rows, config.width, 3), dtype=torch.float32, device=device)
        args, _bank = scene_args(scene, arrays, device, lib)
        rc = lib.launch_render(ptr(out), config.height, config.width, row0, n_rows,
                               _P(cam.ctypes.data), None if t0 is None else ptr(t0), *args)
        check_launch((mode if t0 is None else "renderer_t0") + suffix + ("_stats" if cull_stats else ""),
                     rc)
        if not cull_stats:
            return out
        counts = (ctypes.c_ulonglong * 3)()
        check_call("read_cull_stats", lib.read_cull_stats(device.index, counts))
        return out, dict(zip(("evals", "group_evals", "chains"), counts))

    render.plain = plain
    return render


def make_cuda_cone_march(scene: CompiledScene, config: Optional[RenderConfig] = None):
    """``cone_march(arrays, o_proj f32[3], rays f32[..., 3]) -> t_safe
    f32[...]`` on the device of ``arrays``, with the slope of
    :func:`~designcsg_tpu_torch.ops.raymarch.cone_slope` and
    ``config.cone_strict``.  On the card ``o_proj`` is read by the kernel
    where it lies (a CUDA tensor stays on the card; a host array is copied
    up).  ``cone_march.plain`` is the plain version."""
    config = config or RenderConfig()
    plain = make_cone_march(scene, config)
    libs = {}

    def cone_march(arrays: SceneArrays, o_proj, rays: torch.Tensor) -> torch.Tensor:
        if not on_cuda(arrays.ad):
            return plain(arrays, o_proj, rays)
        device = arrays.ad.device
        require_cuda_f32("rays", rays, device)
        if rays.shape[-1] != 3:
            raise ValueError(f"rays must be [..., 3], got {tuple(rays.shape)}")
        if device not in libs:
            lib = load("cone", cone_kernel_source(scene, config), device)
            lib.launch_cone_march.argtypes = [_P, ctypes.c_longlong, _P, _P] + _SCENE
            lib.launch_cone_march.restype = ctypes.c_int
            libs[device] = lib
        o = torch.as_tensor(o_proj, dtype=torch.float32).to(device).reshape(3).contiguous()
        out = torch.empty(rays.shape[:-1], dtype=torch.float32, device=device)
        args, _bank = scene_args(scene, arrays, device, libs[device])
        rc = libs[device].launch_cone_march(ptr(out), out.numel(), ptr(rays), ptr(o), *args)
        check_launch("cone_march", rc)
        return out

    cone_march.plain = plain
    return cone_march


def make_cuda_hierarchical_renderer(scene: CompiledScene, config: Optional[RenderConfig] = None):
    """``render(arrays, campos, rgt, upp, fwd) -> f32[H, W, 3]``: the cone
    kernel on the block-centre rays, then the fused renderer from the
    resulting ``t0`` plane: two launches per frame on a CUDA device, the
    plain hierarchical renderer on the CPU.  ``render.plain`` is the plain
    version."""
    config = config or RenderConfig()
    # On the CPU both wrappers take their plain versions, so this composition
    # is then the plain hierarchical renderer.
    render = compose_hierarchical(
        config, make_cuda_cone_march(scene, config), make_cuda_renderer(scene, config)
    )
    render.plain = make_hierarchical_renderer(scene, config)
    return render


def make_cuda_ray_march(scene: CompiledScene, config: Optional[RenderConfig] = None):
    """``ray_march(arrays, o_proj f32[3], rays f32[..., 3]) -> (d f32[...],
    vmin f32[..., 3])`` on the device of ``arrays``: each ray's hit distance
    (-1 on a miss) and closest-approach point, for the step budget, march
    mode (``config.march_overrelax``) and gizmo of ``config``.  The banks and
    rays are taken detached (the JAX package's ``stop_gradient`` around its
    kernel, raymarch.py:205-208), so nothing it returns carries a gradient.
    On the card ``o_proj`` is read by the kernel where it lies (a CUDA
    tensor stays on the card; a host array is copied up).
    ``ray_march.plain`` is the plain version (:func:`make_march` with
    ``return_closest``)."""
    config = config or RenderConfig(gizmo=False)
    march = make_march(scene, config)
    libs = {}

    def plain(arrays: SceneArrays, o_proj, rays: torch.Tensor):
        o = torch.as_tensor(o_proj, dtype=torch.float32).detach().to(rays.device)
        with torch.no_grad():
            return march(o, rays.detach(), arrays.detach(), return_closest=True)

    def ray_march(arrays: SceneArrays, o_proj, rays: torch.Tensor):
        arrays, rays = arrays.detach(), rays.detach()
        if not on_cuda(arrays.ad):
            return plain(arrays, o_proj, rays)
        device = arrays.ad.device
        require_cuda_f32("rays", rays, device)
        if rays.shape[-1] != 3:
            raise ValueError(f"rays must be [..., 3], got {tuple(rays.shape)}")
        if device not in libs:
            lib = load("ray_march", ray_march_kernel_source(scene, config), device)
            lib.launch_ray_march.argtypes = [_P, _P, ctypes.c_longlong, _P, _P] + _SCENE
            lib.launch_ray_march.restype = ctypes.c_int
            libs[device] = lib
        o = torch.as_tensor(o_proj, dtype=torch.float32).detach().to(device).reshape(3).contiguous()
        d = torch.empty(rays.shape[:-1], dtype=torch.float32, device=device)
        vmin = torch.empty(rays.shape, dtype=torch.float32, device=device)
        args, _bank = scene_args(scene, arrays, device, libs[device])
        rc = libs[device].launch_ray_march(ptr(d), ptr(vmin), d.numel(), ptr(rays), ptr(o), *args)
        check_launch("ray_march", rc)
        return d, vmin

    ray_march.plain = plain
    return ray_march
