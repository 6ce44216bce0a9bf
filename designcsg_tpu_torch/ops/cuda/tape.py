"""CUDA source of a scene: the tape unrolled at generation time.

Counterpart of the JAX package's ops/pallas/tape.py, which unrolls the tape at
trace time into component-plane code; here the same walk emits C++ text, the
move the reference made by concatenating OpenCL sources.  The inputs are only
the files of ``csrc/``, the scene's brush and material bodies, and the tape.

Every per-point function is ``HD`` (see csrc/common.cuh), so one generated
source serves the CUDA kernels and the host build the tests make.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ...compiler import CompiledScene
from ...config import RenderConfig
from ...constants import OP_EXPORT, OP_IDENTITY, OP_IMPORT, OP_MAX, OP_MIN, OP_NEGATE
from ..raymarch import cone_slope
from .brushes_kernel import (
    brush_functions,
    extras_constants,
    material_functions,
    used_brushes,
    used_materials,
)
from .build import csrc


def f32_literal(x: float) -> str:
    """Exact C++ literal of ``x`` rounded to float32."""
    return float.hex(float(np.float32(x))) + "f"


def _brush_at(brushes) -> str:
    """``brush_<k>_at(x, y, z, o, ad, ex)``: brush k at a world point, through
    the object's frame row ``o`` (3 subtractions and a 3x3 matrix-vector
    product: 18 FP32 operations, k2.cl:105-113)."""
    return "\n".join(
        f"HD float brush_{k}_at(float x, float y, float z, const float* o, const float* ad,\n"
        f"                      const float* ex) {{\n"
        f"    const float dx = x - o[0], dy = y - o[1], dz = z - o[2];\n"
        f"    return brush_{k}(dx * o[3] + dy * o[4] + dz * o[5],\n"
        f"                     dx * o[6] + dy * o[7] + dz * o[8],\n"
        f"                     dx * o[9] + dy * o[10] + dz * o[11], ad, ex);\n}}\n"
        for k in brushes
    )


def tape_function(scene: CompiledScene, gizmo: bool) -> str:
    """``HD float field_sdf(x, y, z, bank, ad, ex)``: the scene tape unrolled into
    straight-line code over register variables, with the k1 gizmo min-ed onto
    the result when ``gizmo`` (tape.py:101-103 of the JAX package)."""
    tape = [tuple(int(v) for v in row) for row in np.asarray(scene.arrays.tape)]
    registers = set()
    for opcode, left, right, dest in tape:
        if opcode in (OP_MIN, OP_MAX):
            registers |= {left, right, dest}
        elif opcode in (OP_NEGATE, OP_IDENTITY):
            registers |= {left, dest}
        elif opcode == OP_IMPORT:
            registers.add(dest)
        elif opcode == OP_EXPORT:
            registers.add(left)
    lines = [
        "HD float field_sdf(float x, float y, float z, const float* bank, const float* ad,",
        "                   const float* ex) {",
        "    float " + ", ".join(f"r{i} = MAX_DISTANCE" for i in sorted(registers)) + ";",
        "    float result = MAX_DISTANCE;",
    ]
    for opcode, left, right, dest in tape:
        if opcode == OP_IMPORT:
            lines.append(
                f"    r{dest} = brush_{left}_at(x, y, z, bank + {right} * BANK_STRIDE, ad, ex);"
            )
        elif opcode == OP_EXPORT:
            lines.append(f"    result = r{left};")
        elif opcode == OP_MIN:
            lines.append(f"    r{dest} = fminf(r{left}, r{right});")
        elif opcode == OP_MAX:
            lines.append(f"    r{dest} = fmaxf(r{left}, r{right});")
        elif opcode == OP_NEGATE:
            lines.append(f"    r{dest} = -r{left};")
        elif opcode == OP_IDENTITY:
            lines.append(f"    r{dest} = r{left};")
        else:
            raise ValueError(f"unknown opcode {opcode}")
    if gizmo:
        lines.append("    result = fminf(result, gizmo_sdf(x, y, z));")
    lines += ["    return result;", "}", ""]
    return "\n".join(lines)


def shade_function(scene: CompiledScene) -> str:
    """``HD Rgb scene_shade(p, n, cam, bank, ad, ex)``: the last object (in bank
    order) whose own SDF at ``p`` is below MAT_THRESH picks the material;
    unmatched hits take the gizmo colours (z, then y, then x, later wins) or
    the background (k1.cl:280-379)."""
    shape_id = [int(s) for s in scene.arrays.shape_id]
    material_id = [int(m) for m in scene.arrays.material_id]
    lines = [
        "HD Rgb scene_shade(float px, float py, float pz, float nx, float ny, float nz,",
        "                   const Cam& cam, const float* bank, const float* ad, const float* ex) {",
        "    int mat = -1;",
        "    float lx = 0.0f, ly = 0.0f, lz = 0.0f;",
    ]
    for obj, (brush, material) in enumerate(zip(shape_id, material_id)):
        lines += [
            "    {",
            f"        const float* o = bank + {obj} * BANK_STRIDE;",
            "        const float dx = px - o[0], dy = py - o[1], dz = pz - o[2];",
            "        const float a = dx * o[3] + dy * o[4] + dz * o[5];",
            "        const float b = dx * o[6] + dy * o[7] + dz * o[8];",
            "        const float c = dx * o[9] + dy * o[10] + dz * o[11];",
            f"        if (brush_{brush}(a, b, c, ad, ex) < MAT_THRESH) {{",
            f"            mat = {material};",
            "            lx = a; ly = b; lz = c;",
            "        }",
            "    }",
        ]
    for m in used_materials(scene):
        lines.append(
            f"    if (mat == {m}) return material_{m}(px, py, pz, lx, ly, lz, nx, ny, nz, cam, ad);"
        )
    lines += [
        "    const float sx = px / INITIAL_SCALE, sy = py / INITIAL_SCALE, sz = pz / INITIAL_SCALE;",
        "    Rgb col{BG_R, BG_G, BG_B};",
        "    if (axes_cylinder(sx * sx + sy * sy, sz - 0.5f, AXES_SHADE_RADIUS) < MAT_THRESH) col = Rgb{0.0f, 0.0f, 1.0f};",
        "    if (axes_cylinder(sx * sx + sz * sz, sy - 0.5f, AXES_SHADE_RADIUS) < MAT_THRESH) col = Rgb{0.0f, 1.0f, 0.0f};",
        "    if (axes_cylinder(sy * sy + sz * sz, sx - 0.5f, AXES_SHADE_RADIUS) < MAT_THRESH) col = Rgb{1.0f, 0.0f, 0.0f};",
        "    return col;",
        "}",
        "",
    ]
    return "\n".join(lines)


def _march_constants(config: RenderConfig) -> str:
    floats = dict(
        EPS=config.sdf_epsilon,
        TOL=config.march_tolerance,
        MAX_D=config.max_distance,
        N_EPS=config.normal_epsilon,
        MAT_THRESH=config.sdf_epsilon * config.material_tolerance,
        IFOV=config.ifov,
        BG_R=config.background[0],
        BG_G=config.background[1],
        BG_B=config.background[2],
        MISS_R=config.miss_color[0],
        MISS_G=config.miss_color[1],
        MISS_B=config.miss_color[2],
    )
    floats.update(OMEGA=config.march_overrelax, CONE_SLOPE=cone_slope(config))
    return (
        f"constexpr int MAX_STEPS = {int(config.max_steps)};\n"
        f"constexpr bool CONE_STRICT = {'true' if config.cone_strict else 'false'};\n"
        + "".join(f"constexpr float {k} = {f32_literal(v)};\n" for k, v in floats.items())
    )


def scene_source(scene: CompiledScene, render_config: Optional[RenderConfig] = None) -> str:
    """The generated scene code: constants (the extras' offsets among them),
    common.cuh, table.cuh (K6), brush functions and the unrolled tape (the k2
    field, no gizmo).  With ``render_config``: the k1
    field (with the gizmo iff the config says so), the material and shading
    functions and march.cuh's ``render_pixel``, ``cone_ray`` and
    ``march_ray_closest``."""
    parts = [
        "// Generated from the scene tape by designcsg_tpu_torch/ops/cuda/tape.py.\n"
        f"constexpr int N_OBJ = {scene.num_objects};\n" + extras_constants(scene)
    ]
    gizmo = False
    if render_config is not None:
        gizmo = render_config.gizmo
        parts.append(_march_constants(render_config))
    parts += [
        csrc("common.cuh"), csrc("table.cuh"), brush_functions(scene), _brush_at(used_brushes(scene)),
    ]
    parts.append(tape_function(scene, gizmo))
    if render_config is not None:
        parts += [material_functions(scene), shade_function(scene), csrc("march.cuh")]
    return "\n".join(parts)


def sdf_kernel_source(scene: CompiledScene) -> str:
    """Translation unit of the point and grid eval kernels (k2 field)."""
    return scene_source(scene) + "\n" + csrc("sdf_kernels.cu")


def march_kernel_source(scene: CompiledScene, config: RenderConfig) -> str:
    """Translation unit of the fused renderer kernel (march mode and cone
    constants from ``config``)."""
    return scene_source(scene, render_config=config) + "\n" + csrc("march_kernel.cu")


def cone_kernel_source(scene: CompiledScene, config: RenderConfig) -> str:
    """Translation unit of the cone prepass kernel."""
    return scene_source(scene, render_config=config) + "\n" + csrc("cone_kernel.cu")


def ray_march_kernel_source(scene: CompiledScene, config: RenderConfig) -> str:
    """Translation unit of the fit's ray-march kernel (march mode, step
    budget and gizmo from ``config``)."""
    return scene_source(scene, render_config=config) + "\n" + csrc("ray_march_kernel.cu")
