"""Brush and material CUDA bodies of a scene, as device functions.

Counterpart of the JAX package's ops/pallas/brushes_kernel.py.  There, each
brush registers a component-wise twin, and a scene without twins takes the
plain path (``supports_scene``, brushes_kernel.py:56-61 there); here each
brush carries its CUDA body (brushes.py).  :func:`supports_scene` decides the
route before anything is built: the evaluator and the renderer take the
kernels only for a scene it accepts, and the plain tape on the same device
otherwise.  Generating the source of a scene it rejects raises; a scene it
accepts whose build or launch fails raises too.
"""

from __future__ import annotations

from typing import List

from ...compiler import CompiledScene


def used_brushes(scene: CompiledScene) -> List[int]:
    return sorted({int(s) for s in scene.arrays.shape_id})


def used_materials(scene: CompiledScene) -> List[int]:
    return sorted({int(m) for m in scene.arrays.material_id})


def _has_body(bodies, k: int) -> bool:
    return k < len(bodies) and bool(bodies[k])


def supports_scene(scene: CompiledScene, cull: bool = False, gizmo: bool = False) -> bool:
    """True iff every brush and material the scene's tape and banks use has
    a CUDA body and, with ``cull`` (a culled kernel, ``march_cull``), every
    such brush that the cull plan twins (a torch ``interval``) also has its
    CUDA interval body (``interval_cuda``)."""
    brushes = used_brushes(scene)
    if not all(_has_body(scene.brush_cuda, k) for k in brushes):
        return False
    if not all(_has_body(scene.material_cuda, m) for m in used_materials(scene)):
        return False
    if cull:
        from ..cull import make_cull_plan

        plan = make_cull_plan(scene, gizmo)
        if plan is not None:
            return all(_has_body(scene.brush_interval_cuda, k) for k in brushes if plan.twinned[k])
    return True


def _require(bodies, indices, kind: str, names=()):
    missing = [
        names[i] if i < len(names) and names[i] else f"bank {i}"
        for i in indices
        if i >= len(bodies) or not bodies[i]
    ]
    if missing:
        raise NotImplementedError(
            f"no CUDA source for {kind} {missing}: give define_{kind}(..., cuda=...) "
            f"the body of its device function to run this scene on the card"
        )


def extras_constants(scene: CompiledScene) -> str:
    """``constexpr int EX_<name> = <offset>;`` for each of the scene's extra
    tables: its float offset in the concatenation ``ex`` the kernels get."""
    return "".join(
        f"constexpr int EX_{name} = {offset};\n" for name, offset in scene.extras_offsets().items()
    )


def brush_functions(scene: CompiledScene) -> str:
    """``HD float brush_<k>(a, b, c, ad, ex)`` for every brush the scene
    uses; ``ex`` is the scene's extra tables (null for a scene without)."""
    used = used_brushes(scene)
    _require(scene.brush_cuda, used, "brush", scene.brush_names)
    return "\n".join(
        f"HD float brush_{k}(float a, float b, float c, const float* ad, const float* ex) {{\n"
        f"    {scene.brush_cuda[k]}\n}}\n"
        for k in used
    )


def material_functions(scene: CompiledScene) -> str:
    """``HD Rgb material_<k>(g, l, n, cam, ad)`` for every material the scene
    uses."""
    used = used_materials(scene)
    _require(scene.material_cuda, used, "material")
    return "\n".join(
        f"HD Rgb material_{k}(float gx, float gy, float gz, float lx, float ly, "
        f"float lz, float nx, float ny, float nz, const Cam& cam, const float* ad) {{\n"
        f"    {scene.material_cuda[k]}\n}}\n"
        for k in used
    )
