"""The plain SDF: the CSG tape unrolled into eager PyTorch.

The scene IR is a register-machine tape of IMPORT/EXPORT/MIN/MAX/NEGATE/
IDENTITY commands over a small register file (reference semantics:
k2.cl:47-144, identical copy in k1.cl:186-234).  The tape is static once a
scene is compiled, so :func:`make_primary_sdf` walks it in Python: registers
become tensors, brush dispatch becomes a direct call.  This is the plain
version that every CUDA kernel of ops/cuda is held against, and the path the
CPU runs.

``points`` is f32[..., 3] on any device; the result is f32[...].  ``arrays``
is a :class:`~designcsg_tpu_torch.compiler.SceneArrays` of tensors on the
points' device.

Two fields: ``"exact"`` calls each brush's own function, ``"twin"`` the field
its CUDA body computes (``Brush.twin``: the same function for every brush but
a baked one, such as Logo's letters).  The plain versions of the kernels
evaluate the twin; the evaluator's exact field and the fit's gradients the
exact tape.  ``proxy=True`` puts each brush's ``__proxy_fn__`` (a cheap lower
bound, Logo's letter plates) in its place: the field of the proxy march
(ops/raymarch.py).

:func:`make_dynamic_primary_sdf` is the runtime-tape interpreter of the JAX
package (interpreter.py:143-206 there): it reads the tape when it is called,
so a tape passed at call time changes the result without a rebuild.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..brushes import EvalContext
from ..compiler import CompiledScene, SceneArrays
from ..constants import (
    AXES_RADIUS,
    INITIAL_SCALE,
    MAX_DISTANCE,
    NORMAL_EPSILON,
    OP_EXPORT,
    OP_IDENTITY,
    OP_IMPORT,
    OP_MAX,
    OP_MIN,
    OP_NEGATE,
)


def dot3(u, v):
    """``u . v`` over the last axis as ``(u0*v0 + u1*v1) + u2*v2``: the order
    the CUDA kernels add in, on every device (a ``torch.sum`` over 3 elements
    may add in another order on CUDA)."""
    return u[..., 0] * v[..., 0] + u[..., 1] * v[..., 1] + u[..., 2] * v[..., 2]


def import_local_coords(points, arrays: SceneArrays, obj_index: int):
    """World points into an object's local frame:
    ``((v-o)@right, (v-o)@up, (v-o)@forward)`` with reciprocal frame rows
    (k2.cl:105-113)."""
    rel = points - arrays.position[obj_index]
    return torch.stack(
        [
            dot3(rel, arrays.right[obj_index]),
            dot3(rel, arrays.up[obj_index]),
            dot3(rel, arrays.forward[obj_index]),
        ],
        dim=-1,
    )


def axes_cylinder_sdf(r, h, half_length, radius):
    """max(|h|-halfLength, r-radius) (k1.cl:41-43)."""
    return torch.maximum(torch.abs(h) - half_length, r - radius)


def gizmo_sdf(points, radius=AXES_RADIUS):
    """The three axis-gizmo cylinders the viewport kernel unions in after the
    tape, at 1/5 world scale (k1.cl:237-270).  k2 (export) has no gizmo.
    The scale is a tensor so that CUDA divides too, as the kernels do, where
    a host scalar divisor would become a reciprocal product."""
    v = points / torch.tensor(INITIAL_SCALE, dtype=points.dtype, device=points.device)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    dx = axes_cylinder_sdf(torch.sqrt(y * y + z * z), x - 0.5, 0.5, radius)
    dy = axes_cylinder_sdf(torch.sqrt(x * x + z * z), y - 0.5, 0.5, radius)
    dz = axes_cylinder_sdf(torch.sqrt(x * x + y * y), z - 0.5, 0.5, radius)
    return torch.minimum(dx, torch.minimum(dy, dz))


FIELDS = ("exact", "twin")


def _device_arrays(scene: CompiledScene, arrays, device):
    return arrays if arrays is not None else scene.arrays.to_torch(device)


def brush_bank(scene: CompiledScene, field: str):
    """The brush functions of ``field`` ("exact" or "twin"), by bank index."""
    if field not in FIELDS:
        raise ValueError(f"field must be 'exact' or 'twin', got {field!r}")
    return scene.brush_fns if field == "exact" else scene.brush_twin


def eval_context(scene: CompiledScene, arrays: SceneArrays, **frame) -> EvalContext:
    """The context of a brush call: the arbitrary data, the scene's extra
    tables on the same device, and (for materials) the camera frame."""
    return EvalContext(ad=arrays.ad, extras=scene.device_extras(arrays.ad.device)[1], **frame)


def make_primary_sdf(scene: CompiledScene, gizmo: bool = False, field: str = "exact",
                     proxy: bool = False) -> Callable:
    """``sdf(points, arrays=None, slots=None) -> distances`` with the scene's
    tape unrolled over the brushes of ``field``; ``arrays`` defaults to the
    scene's own banks.  ``slots`` maps IMPORT positions (and ``n_imports``,
    the gizmo) to values that stand in for their evaluation: the culled tape
    (ops/cull.py) passes the slots it evaluated or substituted.  ``proxy``
    evaluates each brush's ``__proxy_fn__`` where its exact function has
    one (interpreter.py:92-139 of the JAX package)."""
    tape = [tuple(int(x) for x in row) for row in scene.arrays.tape]
    brush_fns = brush_bank(scene, field)
    if proxy:
        brush_fns = [getattr(exact, "__proxy_fn__", None) or fn
                     for exact, fn in zip(scene.brush_fns, brush_fns)]
    n_imports = sum(1 for row in tape if row[0] == OP_IMPORT)

    def primary_sdf(points, arrays: Optional[SceneArrays] = None, slots=None):
        arrays = _device_arrays(scene, arrays, points.device)
        ctx = eval_context(scene, arrays)
        slots = slots or {}
        regs = {}
        export = torch.full(
            points.shape[:-1], MAX_DISTANCE, dtype=points.dtype, device=points.device
        )
        k = 0
        for opcode, left, right, dest in tape:
            if opcode == OP_IMPORT:
                regs[dest] = (
                    slots[k] if k in slots
                    else brush_fns[left](import_local_coords(points, arrays, right), ctx)
                )
                k += 1
            elif opcode == OP_EXPORT:
                export = regs[left]
            elif opcode == OP_MIN:
                regs[dest] = torch.minimum(regs[left], regs[right])
            elif opcode == OP_MAX:
                regs[dest] = torch.maximum(regs[left], regs[right])
            elif opcode == OP_NEGATE:
                regs[dest] = -regs[left]
            elif opcode == OP_IDENTITY:
                regs[dest] = regs[left]
            else:
                raise ValueError(f"unknown opcode {opcode}")
        if gizmo:
            export = torch.minimum(export, slots[n_imports] if n_imports in slots else gizmo_sdf(points))
        return export

    return primary_sdf


def make_dynamic_primary_sdf(scene: CompiledScene, gizmo: bool = False) -> Callable:
    """``sdf(points, arrays=None) -> distances`` over the tape in
    ``arrays.tape`` as it is when called (interpreter.py:143-206 of the JAX
    package): a dense register file f32[R, ...] and a loop over the tape's
    rows, read from the tensor once per call (on the card, one host sync).
    Opcodes clip to 0-5, register operands and brush indices to their
    banks; a destination outside the register file is dropped and an object
    index clamps to the bank, as JAX's scatter and gather do.  The brush
    bank (the exact functions) stays the scene's."""
    brush_fns = scene.brush_fns
    num_registers = max(scene.num_registers, 1)

    def clip(i: int, n: int) -> int:
        return min(max(i, 0), n - 1)

    def primary_sdf(points, arrays: Optional[SceneArrays] = None):
        arrays = _device_arrays(scene, arrays, points.device)
        ctx = eval_context(scene, arrays)
        batch = points.shape[:-1]
        regs = torch.full((num_registers,) + batch, MAX_DISTANCE, dtype=points.dtype,
                          device=points.device)
        export = torch.full(batch, MAX_DISTANCE, dtype=points.dtype, device=points.device)
        n_objects = arrays.position.shape[0]
        for opcode, left, right, dest in torch.as_tensor(arrays.tape).tolist():
            opcode = clip(opcode, 6)
            lhs = regs[clip(left, num_registers)]
            rhs = regs[clip(right, num_registers)]
            if opcode == OP_EXPORT:
                export = lhs
                continue
            if opcode == OP_IMPORT:
                obj = clip(right + n_objects if right < 0 else right, n_objects)
                value = brush_fns[clip(left, len(brush_fns))](
                    import_local_coords(points, arrays, obj), ctx)
            elif opcode == OP_MIN:
                value = torch.minimum(lhs, rhs)
            elif opcode == OP_MAX:
                value = torch.maximum(lhs, rhs)
            elif opcode == OP_NEGATE:
                value = -lhs
            else:
                value = lhs
            dest = dest + num_registers if dest < 0 else dest
            if 0 <= dest < num_registers:
                # Out of place: autograd keeps the registers read before.
                index = torch.tensor([dest], device=points.device)
                regs = regs.index_put((index,), value[None])
        if gizmo:
            export = torch.minimum(export, gizmo_sdf(points))
        return export

    return primary_sdf


def brute_force_min_sdf(scene: CompiledScene, points, arrays: Optional[SceneArrays] = None):
    """The semantic oracle for purely-additive scenes: MIN over every object's
    own SDF (the commented-out reference loop, k1.cl:157-184)."""
    arrays = _device_arrays(scene, arrays, points.device)
    ctx = eval_context(scene, arrays)
    best = torch.full(points.shape[:-1], MAX_DISTANCE, dtype=points.dtype, device=points.device)
    for i, shape in enumerate(scene.arrays.shape_id):
        d = scene.brush_fns[int(shape)](import_local_coords(points, arrays, i), ctx)
        best = torch.minimum(best, d)
    return best


def make_normal_fn(sdf_fn: Callable, mode: str = "fd", epsilon: float = NORMAL_EPSILON) -> Callable:
    """Surface normals ``normals(points, arrays) -> f32[..., 3]``.

    ``mode="fd"``: the reference's central finite differences, 6 extra SDF
    evals at offset ``epsilon``, divided by ``2*epsilon`` and normalized
    (k1.cl:381-418).  ``mode="analytic"``: the gradient of the field at each
    point by autograd, normalized (interpreter.py:251-266 of the JAX
    package).  The tape is pointwise, so one ``torch.autograd.grad`` of the
    summed field gives each point's own gradient; the graph is kept when the
    caller differentiates through the normals (the points or the banks need
    gradients).  The norm's square root is taken through float64, so it is
    IEEE-rounded on every device (PyTorch's float32 ``sqrt`` on the CPU can
    be an ulp off); with FD the glue gives the bits of K1's FD form
    (csrc/common.cuh ``sdf_fd_normal``) over the same seven field values."""
    if mode not in ("fd", "analytic"):
        raise ValueError(f"unknown normal mode {mode!r}")

    def normalize(g):
        return g / torch.sqrt(dot3(g, g).double()).to(g.dtype)[..., None]

    def fd_normals(points, arrays=None):
        e = torch.tensor(epsilon, dtype=points.dtype, device=points.device)
        g = []
        for axis in range(3):
            offset = torch.zeros(3, dtype=points.dtype, device=points.device)
            offset[axis] = e
            g.append(sdf_fn(points + offset, arrays) - sdf_fn(points - offset, arrays))
        return normalize(torch.stack(g, dim=-1) / (2.0 * e))

    def analytic_normals(points, arrays=None):
        banks = arrays.fields() if arrays is not None else ()
        keep = torch.is_grad_enabled() and (
            points.requires_grad or any(getattr(a, "requires_grad", False) for a in banks))
        with torch.enable_grad():
            q = points if points.requires_grad else points.detach().requires_grad_()
            (g,) = torch.autograd.grad(sdf_fn(q, arrays).sum(), q, create_graph=keep)
        return normalize(g)

    return fd_normals if mode == "fd" else analytic_normals
