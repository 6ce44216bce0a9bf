"""Brush and material CUDA bodies of a scene, as device functions.

Counterpart of the JAX package's ops/pallas/brushes_kernel.py.  There, each
brush registers a component-wise twin and a scene without twins falls back to
the plain path; here each brush carries its CUDA body (brushes.py) and a
scene whose tape uses a brush or material without one cannot run on the card:
generating its source raises.  There is no fallback.
"""

from __future__ import annotations

from typing import List

from ...compiler import CompiledScene


def used_brushes(scene: CompiledScene) -> List[int]:
    return sorted({int(s) for s in scene.arrays.shape_id})


def used_materials(scene: CompiledScene) -> List[int]:
    return sorted({int(m) for m in scene.arrays.material_id})


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


def brush_functions(scene: CompiledScene) -> str:
    """``HD float brush_<k>(a, b, c, ad)`` for every brush the scene uses."""
    used = used_brushes(scene)
    _require(scene.brush_cuda, used, "brush", scene.brush_names)
    return "\n".join(
        f"HD float brush_{k}(float a, float b, float c, const float* ad) {{\n"
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
