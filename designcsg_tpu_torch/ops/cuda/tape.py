"""CUDA source of a scene: the tape unrolled at generation time.

Counterpart of the JAX package's ops/pallas/tape.py, which unrolls the tape at
trace time into component-plane code; here the same walk emits C++ text, the
move the reference made by concatenating OpenCL sources.  The inputs are only
the files of ``csrc/``, the scene's brush and material bodies, and the tape.

Every per-point function is ``HD`` (see csrc/common.cuh), so one generated
source serves the CUDA kernels and the host build the tests make.
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np

from ...compiler import CompiledScene
from ...config import RenderConfig
from ...constants import OP_EXPORT, OP_IDENTITY, OP_IMPORT, OP_MAX, OP_MIN, OP_NEGATE
from ..cull import BIG, CullPlan, leaf_cost, make_cull_plan, post_order, tree_leaves
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
    """``brush_<k>_column(z, h, o, ad, ex)``: brush k at height z of a lattice
    column whose frame terms ``h`` (csrc/common.cuh frame_terms) were made
    once for the column, through the object's frame row ``o`` (one
    subtraction and three multiply-adds: 7 FP32 operations); and
    ``brush_<k>_at(x, y, z, o, ad, ex)``, the same at a world point: the
    column's terms made there (11 more: 18, k2.cl:105-113)."""
    return "\n".join(
        f"HD float brush_{k}_column(float z, const float* h, const float* o, const float* ad,\n"
        f"                          const float* ex) {{\n"
        f"    const float dz = sub_rn(z, o[2]);\n"
        f"    return brush_{k}(madd(dz, o[5], h[0]), madd(dz, o[8], h[1]), madd(dz, o[11], h[2]),\n"
        f"                     ad, ex);\n}}\n\n"
        f"HD float brush_{k}_at(float x, float y, float z, const float* o, const float* ad,\n"
        f"                      const float* ex) {{\n"
        f"    float h[3];\n"
        f"    frame_terms(x, y, o, h);\n"
        f"    return brush_{k}_column(z, h, o, ad, ex);\n}}\n"
        for k in brushes
    )


def _registers(row):
    """The registers a tape row reads or writes."""
    opcode, left, right, dest = row
    if opcode in (OP_MIN, OP_MAX):
        return (left, right, dest)
    if opcode in (OP_NEGATE, OP_IDENTITY):
        return (left, dest)
    if opcode == OP_IMPORT:
        return (dest,)
    if opcode == OP_EXPORT:
        return (left,)
    raise ValueError(f"unknown opcode {opcode}")


def _tape_line(opcode, left, right, dest) -> str:
    """C++ of a tape row other than IMPORT."""
    if opcode == OP_EXPORT:
        return f"    result = r{left};"
    if opcode == OP_MIN:
        return f"    r{dest} = fminf(r{left}, r{right});"
    if opcode == OP_MAX:
        return f"    r{dest} = fmaxf(r{left}, r{right});"
    if opcode == OP_NEGATE:
        return f"    r{dest} = -r{left};"
    if opcode == OP_IDENTITY:
        return f"    r{dest} = r{left};"
    raise ValueError(f"unknown opcode {opcode}")


def _tape(scene: CompiledScene):
    return [tuple(int(v) for v in row) for row in np.asarray(scene.arrays.tape)]


def _imports(scene: CompiledScene):
    """(brush, object) of each IMPORT row in tape order: slot k of the cull
    plan and of the cone prepass's split is the k-th."""
    return [(left, right) for opcode, left, right, _ in _tape(scene) if opcode == OP_IMPORT]


# Runs of at least this many IMPORT-and-combine row pairs that differ only in
# their object (consecutive objects of one brush, the same registers: a flat
# union, such as the capacity rings' chain of one min an object) are
# generated as a loop over the objects: the same operations in the same
# order, so the same bits, where the unrolled rows would grow the unit by a
# brush body an object.  The 512-ring's units took nvcc 4.5-5.1 s so,
# 54-94 s unrolled (ring_nvcc_timing.py on the H100's host, PERF.md).
TAPE_LOOP_MIN_RUN = 8


def _tape_runs(scene: CompiledScene, loopable):
    """The tape as items ``("row", row)`` and ``("run", first row, count,
    first slot)``: a run is TAPE_LOOP_MIN_RUN or more pairs (IMPORT brush b
    of object o + n into register R, then the same MIN or MAX row), every
    slot k of it ``loopable(first slot, k)``."""
    tape = _tape(scene)
    items, i, k = [], 0, 0
    while i < len(tape):
        row, n = tape[i], 0
        if row[0] == OP_IMPORT and i + 1 < len(tape) and tape[i + 1][0] in (OP_MIN, OP_MAX):
            _, brush, obj, dest = row
            while (i + 2 * n + 1 < len(tape)
                   and tape[i + 2 * n] == (OP_IMPORT, brush, obj + n, dest)
                   and tape[i + 2 * n + 1] == tape[i + 1] and loopable(k, k + n)):
                n += 1
        if n >= TAPE_LOOP_MIN_RUN:
            items.append(("run", i, n, k))
            i, k = i + 2 * n, k + n
        else:
            items.append(("row", row))
            i, k = i + 1, k + (row[0] == OP_IMPORT)
    return items


def _tape_lines(scene: CompiledScene, slot, gizmo_value: Optional[str], slot_at=None,
                loopable=lambda k0, k: True):
    """The tape's registers, rows and result as C++ lines: ``slot(k)`` is
    the value of IMPORT slot k, ``gizmo_value`` the gizmo's (min-ed onto the
    result, tape.py:101-103 of the JAX package) or None.  With ``slot_at``
    (``(first slot, brush, object expression, slot expression) -> C++``)
    the runs of :func:`_tape_runs` over ``loopable`` slots become loops over
    their objects."""
    tape = _tape(scene)
    registers = sorted({r for row in tape for r in _registers(row)})
    lines = [
        "    float " + ", ".join(f"r{i} = MAX_DISTANCE" for i in registers) + ";",
        "    float result = MAX_DISTANCE;",
    ]
    k = 0
    for item in _tape_runs(scene, loopable if slot_at is not None else lambda k0, k: False):
        if item[0] == "run":
            _, first, n, k0 = item
            _, brush, obj, dest = tape[first]
            lines += [f"    for (int i = 0; i < {n}; ++i) {{",
                      f"        r{dest} = {slot_at(k0, brush, f'{obj} + i', f'{k0} + i')};",
                      "    " + _tape_line(*tape[first + 1]),
                      "    }"]
            k = k0 + n
            continue
        opcode, left, right, dest = item[1]
        if opcode == OP_IMPORT:
            lines.append(f"    r{dest} = {slot(k)};")
            k += 1
        else:
            lines.append(_tape_line(opcode, left, right, dest))
    if gizmo_value is not None:
        lines.append(f"    result = fminf(result, {gizmo_value});")
    return lines + ["    return result;", "}", ""]


# Past this many IMPORT slots outside the tape's loops, the tape's functions
# (``field_sdf``, its column and culled forms, ``scene_shade``) are called
# where a kernel would otherwise inline a copy at each call site: the
# renderer's march, its six FD probes and its shading, K1's seven FD
# evaluations.  Measured with the 512-ring unrolled (ring_nvcc_timing.py on
# the H100's host, 8 builds at once; PERF.md): inlined, its K1 took 251 s of
# nvcc and its K2, K5 and K4 more than 300 s each; called, 54-94 s each.
TAPE_INLINE_MAX_SLOTS = 256


def tape_qualifier(scene: CompiledScene) -> str:
    """``HD`` (inlined, csrc/common.cuh) or, for a tape of more than
    TAPE_INLINE_MAX_SLOTS slots outside its loops (:func:`_tape_runs`),
    ``HD_CALL`` (one body, called)."""
    unrolled = sum(item[0] == "row" and item[1][0] == OP_IMPORT
                   for item in _tape_runs(scene, lambda k0, k: True))
    return "HD" if unrolled <= TAPE_INLINE_MAX_SLOTS else "HD_CALL"


# The column form keeps three registers of frame terms per hoisted import
# for its whole column.  Past this many imports it hoists no more (their
# slots keep the point form), so that a scene of many objects keeps its
# registers: the 89-group scene has 133 imports.
COLUMN_HOIST_MAX = 16
GIZMO = "gizmo_sdf(x, y, z)"


def column_hoisted(scene: CompiledScene) -> dict:
    """{import slot: its index among the column form's frame terms}: every
    slot whose brush reads its coordinates (``cuda_flops`` not 0; the
    compiler drops the transform of a brush that does not), the first
    COLUMN_HOIST_MAX of them."""
    out = {}
    for k, (brush, _) in enumerate(_imports(scene)):
        reads = brush >= len(scene.brush_flops) or scene.brush_flops[brush] != 0
        if reads and len(out) < COLUMN_HOIST_MAX:
            out[k] = len(out)
    return out


def _slot_value(imports, k: int, column: Optional[dict] = None) -> str:
    """C++ of import slot ``k`` (``imports``: :func:`_imports`) at (x, y, z):
    through the column's frame terms ``h`` where ``column``
    (:func:`column_hoisted`) hoists it."""
    brush, obj = imports[k]
    o = f"bank + {obj} * BANK_STRIDE"
    if column is not None and k in column:
        return f"brush_{brush}_column(z, h + {3 * column[k]}, {o}, ad, ex)"
    return f"brush_{brush}_at(x, y, z, {o}, ad, ex)"


def _slot_at(brush: int, obj: str) -> str:
    """C++ of brush ``brush`` at (x, y, z) for the object of index ``obj``
    (a C++ expression: a loop's), in the point form."""
    return f"brush_{brush}_at(x, y, z, bank + ({obj}) * BANK_STRIDE, ad, ex)"


def tape_function(scene: CompiledScene, gizmo: bool, column: bool = False) -> str:
    """``HD float field_sdf(x, y, z, bank, ad, ex)``: the scene tape unrolled into
    straight-line code over register variables, with the k1 gizmo min-ed onto
    the result when ``gizmo`` (tape.py:101-103 of the JAX package).  With
    ``column``, its column twin ``field_sdf_column(x, y, z, h, bank, ad, ex)``
    over the frame terms ``h`` that :func:`column_terms_function` made for
    the lattice column (x, y): the same bits (csrc/common.cuh frame_terms)."""
    hoisted = column_hoisted(scene) if column else None
    imports = _imports(scene)
    name = "field_sdf_column(float x, float y, float z, const float* h," if column else \
        "field_sdf(float x, float y, float z,"
    lines = [f"{tape_qualifier(scene)} float {name} const float* bank,",
             "                   const float* ad, const float* ex) {"]
    return "\n".join(lines + _tape_lines(scene, lambda k: _slot_value(imports, k, hoisted),
                                          GIZMO if gizmo else None,
                                          slot_at=lambda k0, b, obj, k: _slot_at(b, obj),
                                          loopable=lambda k0, k: hoisted is None or k not in hoisted))


def column_terms_function(scene: CompiledScene, plan: Optional[CullPlan] = None) -> str:
    """``N_COLUMN_TERMS`` and ``HD void column_terms(x, y, bank, h)``: the
    frame terms (csrc/common.cuh frame_terms) of every hoisted import at the
    lattice column (x, y), made once per column by the grid kernel.  With a
    cull ``plan``, ``column_terms_culled(x, y, bank, preds, h)``: only those
    of the groups the tile's predicates evaluate."""
    hoisted = column_hoisted(scene)
    imports = _imports(scene)

    def terms(k):
        return (f"    frame_terms(x, y, bank + {imports[k][1]} * BANK_STRIDE, "
                f"h + {3 * hoisted[k]});")

    if plan is None:
        lines = [f"constexpr int N_COLUMN_TERMS = {3 * max(1, len(hoisted))};",
                 "HD void column_terms(float x, float y, const float* bank, float* h) {"]
        lines += [terms(k) for k in hoisted]
        return "\n".join(lines + ["}", ""])
    grouped = {k for members in plan.groups for k in members}
    lines = ["HD void column_terms_culled(float x, float y, const float* bank, const Preds& preds,",
             "                            float* h) {"]
    lines += [terms(k) for k in hoisted if k not in grouped]
    for g, members in enumerate(plan.groups):
        inner = [terms(k) for k in members if k in hoisted]
        if inner:
            lines.append(f"    if (preds.w[{g >> 5}] & {1 << (g & 31)}u) {{")
            lines += ["    " + line for line in inner]
            lines.append("    }")
    return "\n".join(lines + ["}", ""])


# FP32 operations of the frame transform's two parts (csrc/common.cuh; a
# multiply-add counts 2): ``frame_terms``, 2 subtractions and per row a
# product and a multiply-add; per point the subtraction of z and a
# multiply-add per row (``brush_<k>_column``).  The point form runs both: 18.
FRAME_TERMS_OPS = 2 + 3 * 3
FRAME_ROW_OPS = 1 + 3 * 2


def column_frame_ops(scene: CompiledScene, gizmo: bool = False) -> dict:
    """The frame transforms' FP32 operations of the grid kernel, counted from
    the generated code: per point in the point form (``field_sdf``: each
    ``brush_<k>_at`` of a brush that reads its coordinates) and in the
    column form (``field_sdf_column``: each ``brush_<k>_column``, and the
    point form where it stays), and per column (``column_terms``' calls of
    ``frame_terms``)."""
    def reads(brush):
        return brush >= len(scene.brush_flops) or scene.brush_flops[brush] != 0

    def at_calls(text):
        return sum(reads(int(b)) for b in re.findall(r"\bbrush_(\d+)_at\(", text))

    column = tape_function(scene, gizmo, column=True)
    hoisted = len(re.findall(r"\bbrush_\d+_column\(", column))
    full = FRAME_TERMS_OPS + FRAME_ROW_OPS
    return dict(point_form=full * at_calls(tape_function(scene, gizmo)),
                column_form=FRAME_ROW_OPS * hoisted + full * at_calls(column),
                per_column=FRAME_TERMS_OPS * column_terms_function(scene).count("frame_terms("),
                hoisted=hoisted)


def interval_functions(scene: CompiledScene, plan: CullPlan) -> str:
    """``HD Iv ivbrush_<k>(a, b, c, ad, ex)``, the interval twin of every
    brush with one that the scene uses (csrc/interval.cuh)."""
    used = [k for k in used_brushes(scene) if plan.twinned[k]]
    missing = [scene.brush_names[k] or f"bank {k}" for k in used if not scene.brush_interval_cuda[k]]
    if missing:
        raise NotImplementedError(
            f"no CUDA interval twin for brush {missing}: give define_brush(..., interval_cuda=...) "
            f"the body of its interval function to cull this scene on the card"
        )
    return "\n".join(
        f"HD Iv ivbrush_{k}(Iv a, Iv b, Iv c, const float* ad, const float* ex) {{\n"
        f"    {scene.brush_interval_cuda[k]}\n}}\n"
        for k in used
    )


# The dynamic cull's held box (csrc/march.cuh hold_box): the chain runs on
# the marching points' box widened by this margin (world units, about one
# part of the shipped designs) on every side, and its predicates serve every
# later step whose box stays inside.  A trade measured on the H100 (PERF.md;
# ab_render_timing.py's levers, chip_smoke.py's k7_dynamic_held_box): at 1
# Design1's dynamic frame took 0.62 ms against 1.65 with a chain every step,
# and the cull still skipped 24% of its group evaluations (Logo 28%; 52%
# each per step); at 0.25 the frames ran slower on Design2 and Logo, and
# wider margins ran them faster still while the held box lets the cull
# skip ever less: the margin bounds what the cull can do for a scene whose
# groups it can skip.
CULL_HOLD_MARGIN = 1.0


def cull_words(plan: CullPlan) -> int:
    """32-bit words of the predicate mask: one bit per group, no cap."""
    return max(1, -(-len(plan.groups) // 32))


def _cull_leaves(plan: CullPlan):
    """The plan's leaves (slot nodes: brushes and the gizmo), each slot once,
    in the order the chain computes them."""
    done, out = set(), []
    for node in tree_leaves(plan.root):
        if node.slot not in done:
            done.add(node.slot)
            out.append(node)
    return out


def _slot_interval(plan: CullPlan, node) -> str:
    """C++ of a leaf's padded interval over the box (bx, by, bz)."""
    if node.op == "gizmo":
        return "iv_pad(iv_gizmo(bx, by, bz))"
    if plan.twinned[node.brush]:
        return f"iv_pad(ivbrush_{node.brush}(b{node.slot}a, b{node.slot}b, b{node.slot}c, ad, ex))"
    big = f32_literal(BIG)
    return f"Iv{{-{big}, {big}}}"


def _cull_relevance(plan: CullPlan, lines) -> None:
    """Append the relevance tree of the plan: relevance top-down into the bit
    mask ``preds`` (bit g % 32 of word g / 32: group g must be evaluated),
    each interior interval computed where relevance reads it, over the
    slots' intervals ``b<slot>``."""
    names = {}

    def fold(op, exprs):
        expr = exprs[0]
        for e in exprs[1:]:
            expr = f"{'iv_min' if op == 'min' else 'iv_max'}({expr}, {e})"
        return expr

    def emit(node):
        """C++ name of the node's analysis interval (leaf parity applied),
        its subtree's intervals emitted first where not yet."""
        if node.op in ("leaf", "gizmo"):
            return f"iv_neg(b{node.slot})" if node.negated else f"b{node.slot}"
        for n in post_order(node):
            if id(n) not in names:
                expr = fold(n.op, [emit(c) if c.op in ("leaf", "gizmo") else names[id(c)]
                                   for c in n.children])
                names[id(n)] = f"n{len(names)}"
                lines.append(f"    const Iv {names[id(n)]} = {expr};")
        return names[id(node)]

    lines += [f"    preds.w[{i}] = 0u;" for i in range(cull_words(plan))]
    count = [0]

    def fresh(prefix):
        count[0] += 1
        return f"{prefix}{count[0]}"

    # Relevance top-down, depth first: a stack of (node, its relevance, its
    # units' walk, its units' interval names).
    stack = [(plan.root, "true", iter(enumerate(plan.units[id(plan.root)])), None)]
    while stack:
        node, rel, walk, uivs = stack.pop()
        units = plan.units[id(node)]
        if uivs is None:
            uivs = []
            if len(units) > 1:
                for u in units:
                    expr = fold(node.op, [emit(m) for m in u[2]]) if u[0] == "bucket" else emit(u[1])
                    uivs.append(fresh("u"))
                    lines.append(f"    const Iv {uivs[-1]} = {expr};")
        step = next(walk, None)
        if step is None:
            continue
        stack.append((node, rel, walk, uivs))
        i, u = step
        rel_u = rel
        if len(units) > 1:
            others = [iv for j, iv in enumerate(uivs) if j != i]
            if node.op == "min":
                # unit i can win the min somewhere only if its lower bound
                # is below the least upper bound of the others
                bound = f"{others[0]}.hi"
                for iv in others[1:]:
                    bound = f"fminf({bound}, {iv}.hi)"
                cond = f"{uivs[i]}.lo < {bound}"
            else:
                bound = f"{others[0]}.lo"
                for iv in others[1:]:
                    bound = f"fmaxf({bound}, {iv}.lo)"
                cond = f"{uivs[i]}.hi > {bound}"
            rel_u = fresh("q")
            lines.append(f"    const bool {rel_u} = {cond if rel == 'true' else f'{rel} && {cond}'};")
        if u[0] == "bucket":
            lines.append(f"    preds.w[{u[1] >> 5}] |= (unsigned)({rel_u}) << {u[1] & 31};")
        elif u[0] == "sub":
            stack.append((u[1], rel_u, iter(enumerate(plan.units[id(u[1])])), None))


def cull_tile_function(plan: CullPlan) -> str:
    """``HD void cull_tile(bx, by, bz, bank, ad, ex, preds, substs)``: the
    culler of ops/cull.py unrolled over the plan's tree, in one thread --
    every slot's padded brush interval and substitute, then the relevance
    tree (the renderer's hoisted cull runs it in every lane; the dynamic
    cull and the culled grid run the lane chain, its bits)."""
    lines = [
        "HD void cull_tile(Iv bx, Iv by, Iv bz, const float* bank, const float* ad, const float* ex,",
        "                  Preds& preds, float* substs) {",
    ]
    for node in _cull_leaves(plan):
        b = f"b{node.slot}"
        if node.op == "leaf" and plan.twinned[node.brush]:
            lines.append(f"    Iv {b}a, {b}b, {b}c;")
            lines.append(f"    iv_local(bx, by, bz, bank + {node.obj} * BANK_STRIDE, {b}a, {b}b, {b}c);")
        lines.append(f"    const Iv {b} = {_slot_interval(plan, node)};")
        lines.append(f"    substs[{node.slot}] = {b}.lo;")
    _cull_relevance(plan, lines)
    lines += ["}", ""]
    return "\n".join(lines)


def cull_chunks(plan: CullPlan) -> int:
    """Chunks of 32 slots the lane chain runs, one slot per lane."""
    return -(-plan.n_slots // 32)


def _lane_kinds(plan: CullPlan):
    """{kind: slots} of the lane chain's passes: each twinned brush its own
    kind, the gizmo one, untwinned slots none (a constant interval)."""
    kinds = {}
    for node in _cull_leaves(plan):
        if node.op == "gizmo":
            kinds.setdefault("gizmo", []).append(node.slot)
        elif plan.twinned[node.brush]:
            kinds.setdefault(node.brush, []).append(node.slot)
    return kinds


def _lane_mask(slots, chunk: int) -> str:
    bits = sum(1 << (k - 32 * chunk) for k in slots if 32 * chunk <= k < 32 * chunk + 32)
    return f"0x{bits:08x}u"


def _per_chunk(values) -> str:
    """C++ selecting ``values[chunk]`` (a literal per chunk)."""
    expr = values[-1]
    for c in range(len(values) - 2, -1, -1):
        expr = f"chunk == {c} ? {values[c]} : {expr}"
    return expr


def cull_lane_function(plan: CullPlan) -> str:
    """``HD Iv cull_lane(chunk, lane, bx, by, bz, bank, ad, ex)``: the padded
    interval of slot 32 * chunk + lane over the box, the per-slot work of
    the lane chain (march.cuh cull_tile_lanes), the same operations as
    ``cull_tile``'s for that slot.  Lanes run their slots' frame intervals
    together (the object's bank row read at a lane-dependent index), then
    one pass per brush kind under a lane mask, so a warp issues each
    interval body once per chunk, not once per slot; slots past the plan's
    return an unused constant.  ``chunk`` is a constant where it is
    inlined, so the masks fold."""
    leaves = _cull_leaves(plan)
    chunks = cull_chunks(plan)
    local = [n for n in leaves if n.op == "leaf" and plan.twinned[n.brush]]
    big = f32_literal(BIG)
    lines = [
        "HD Iv cull_lane(int chunk, int lane, Iv bx, Iv by, Iv bz, const float* bank,",
        "                const float* ad, const float* ex) {",
        "    const unsigned bit = 1u << lane;",
        f"    Iv iv{{-{big}, {big}}};",
    ]
    if local:
        if all(n.obj == n.slot for n in local):
            obj = "32 * chunk + lane"
        else:
            obj = "0"
            for n in sorted(local, key=lambda n: -n.slot):
                obj = f"32 * chunk + lane == {n.slot} ? {n.obj} : {obj}"
        lines += [
            "    Iv a{0.0f, 0.0f}, b{0.0f, 0.0f}, c{0.0f, 0.0f};",
            f"    if (({_per_chunk([_lane_mask([n.slot for n in local], c) for c in range(chunks)])}) & bit)",
            f"        iv_local(bx, by, bz, bank + ({obj}) * BANK_STRIDE, a, b, c);",
        ]
    for kind, slots in _lane_kinds(plan).items():
        mask = _per_chunk([_lane_mask(slots, c) for c in range(chunks)])
        body = "iv_gizmo(bx, by, bz)" if kind == "gizmo" else f"ivbrush_{kind}(a, b, c, ad, ex)"
        lines.append(f"    if (({mask}) & bit) iv = iv_pad({body});")
    lines += ["    return iv;", "}", ""]
    return "\n".join(lines)


def cull_tree_function(plan: CullPlan) -> str:
    """``HD void cull_tree(bv, preds, substs)``: ``cull_tile``'s relevance
    tree and substitutes over the slots' padded intervals ``bv[slot]``, as
    the lane chain gathers them into every lane."""
    lines = ["HD void cull_tree(const Iv* bv, Preds& preds, float* substs) {"]
    for node in _cull_leaves(plan):
        lines.append(f"    const Iv b{node.slot} = bv[{node.slot}];")
        lines.append(f"    substs[{node.slot}] = b{node.slot}.lo;")
    _cull_relevance(plan, lines)
    lines += ["}", ""]
    return "\n".join(lines)


def culled_tape_function(scene: CompiledScene, plan: CullPlan, column: bool = False) -> str:
    """``HD float field_sdf_culled(x, y, z, bank, ad, ex, preds, substs)``:
    :func:`tape_function`'s field with each group's slots evaluated under
    ``if (preds.w[word] & bit)`` and given their substitutes otherwise (the gizmo is
    slot ``n_imports`` when the plan has it).  With ``column``, its column
    twin ``field_sdf_culled_column(x, y, z, h, ...)`` over the terms of
    ``column_terms_culled``."""
    group_of = {k: g for g, members in enumerate(plan.groups) for k in members}
    hoisted = column_hoisted(scene) if column else None
    imports = _imports(scene)

    def loopable(k0, k):
        """A run's slots share one group (one predicate) and are not hoisted."""
        return k in group_of and group_of[k] == group_of.get(k0) and (
            hoisted is None or k not in hoisted)

    def looped_slot(k0, brush, obj, k):
        g = group_of[k0]
        return f"(preds.w[{g >> 5}] & {1 << (g & 31)}u) ? {_slot_at(brush, obj)} : substs[{k}]"

    looped = {k for item in _tape_runs(scene, loopable) if item[0] == "run"
              for k in range(item[3], item[3] + item[2])}
    grouped = set(group_of) - looped
    name = "field_sdf_culled_column(float x, float y, float z, const float* h," if column else \
        "field_sdf_culled(float x, float y, float z,"
    lines = [
        f"{tape_qualifier(scene)} float {name} const float* bank,",
        "                          const float* ad, const float* ex, const Preds& preds,",
        "                          const float* substs) {",
    ]
    if grouped:
        lines.append("    float " + ", ".join(f"s{k}" for k in sorted(grouped)) + ";")

    def slot_value(k):
        return GIZMO if k == plan.n_imports else _slot_value(imports, k, hoisted)

    # Slots in a loop of the tape (_tape_runs) take their group's predicate
    # there, each slot's value or substitute as the group's block gives it.
    for g, members in enumerate(plan.groups):
        members = [k for k in members if k not in looped]
        if not members:
            continue
        lines.append(f"    if (preds.w[{g >> 5}] & {1 << (g & 31)}u) {{")
        lines += [f"        s{k} = {slot_value(k)};" for k in members]
        lines.append("    } else {")
        lines += [f"        s{k} = substs[{k}];" for k in members]
        lines.append("    }")
    gizmo = None
    if plan.gizmo:
        gizmo = f"s{plan.n_imports}" if plan.n_imports in grouped else slot_value(plan.n_imports)
    return "\n".join(lines + _tape_lines(
        scene, lambda k: f"s{k}" if k in grouped else slot_value(k), gizmo,
        slot_at=looped_slot, loopable=loopable))


def cull_source(scene: CompiledScene, plan: Optional[CullPlan], mode: int,
                config: Optional[RenderConfig] = None) -> str:
    """``#define CULL_MODE <mode>`` (0 off, 1 hoisted, 2 dynamic; the point
    and grid unit uses 1) and, with a plan, the cull's constants, the
    interval twins, the chain in one thread (``cull_tile``) and spread over
    a warp's lanes (``cull_lane`` and ``cull_tree``: the dynamic cull's and
    the culled grid's), and ``field_sdf_culled``; without a renderer's
    ``config`` (the point and grid unit) also the culled grid's column form
    (``column_terms_culled``, ``field_sdf_culled_column``).  A renderer's
    ``config`` adds the hoisted cull's drift pad: accumulated positions
    stray from o + d*r by up to MAX_STEPS ulps (march_kernel.py:477-491 of
    the JAX package)."""
    if plan is None:
        return "#define CULL_MODE 0\n"
    drift = ""
    if config is not None:
        drift = (f"constexpr float CULL_DRIFT = {f32_literal(float(config.max_steps) * 1.5e-7)};\n"
                 f"constexpr float CULL_HOLD = {f32_literal(CULL_HOLD_MARGIN)};\n")
    return "\n".join(
        [
            f"#define CULL_MODE {mode}\n"
            f"constexpr int N_CULL_SLOTS = {plan.n_slots};\n"
            f"constexpr int N_CULL_WORDS = {cull_words(plan)};\n"
            f"constexpr int N_CULL_CHUNKS = {cull_chunks(plan)};\n" + drift,
            csrc("interval.cuh"),
            interval_functions(scene, plan),
            cull_tile_function(plan),
            cull_lane_function(plan),
            cull_tree_function(plan),
            culled_tape_function(scene, plan),
        ] + ([] if config is not None else [
            column_terms_function(scene, plan), culled_tape_function(scene, plan, column=True)])
    )


# FP32 operations of each interval helper and C++ operation that the
# generated cull chain calls (csrc/interval.cuh; fminf, fmaxf, sqrtf, fabsf,
# a rounded sum or product and a comparison count 1).
IV_OPS = {
    "iv_const": 0, "iv_add": 2, "iv_sub": 2, "iv_neg": 2, "iv_min": 2, "iv_max": 2,
    "iv_mul_scalar": 4, "iv_mul": 12, "iv_abs": 5, "iv_square": 7, "iv_sqrt": 4, "iv_norm3": 29,
    "iv_pad": 7, "iv_local": 54, "iv_gizmo": 115, "fminf": 1, "fmaxf": 1, "sqrtf": 1,
    "fabsf": 1, "mul_rn": 1, "add_rn": 1, "sub_rn": 1,
}
_CALL = re.compile(r"\b(" + "|".join(IV_OPS) + r")\(")
_COMPARE = re.compile(r"(?<![<>-])(<=|>=|<|>)(?![<>=])")


def _text_ops(text: str) -> int:
    return sum(IV_OPS[m] for m in _CALL.findall(text)) + len(_COMPARE.findall(text))


def cull_chain_ops(scene: CompiledScene, gizmo: bool) -> Optional[int]:
    """FP32 operations of one ``cull_tile`` call, counted from the generated
    code: its own text plus each interval twin's body per leaf that calls
    it (None when the scene has no cull)."""
    plan = make_cull_plan(scene, gizmo)
    if plan is None:
        return None
    chain = cull_tile_function(plan)
    body_ops = {
        k: _text_ops(scene.brush_interval_cuda[k]) for k in used_brushes(scene) if plan.twinned[k]
    }
    calls = re.findall(r"\bivbrush_(\d+)\(", chain)
    return _text_ops(chain) + sum(body_ops[int(k)] for k in calls)


def lane_chain_ops(scene: CompiledScene, gizmo: bool) -> Optional[dict]:
    """What a warp issues for one lane chain (march.cuh cull_tile_lanes),
    counted from the generated code as :func:`cull_chain_ops` counts the
    chain of one thread: per chunk of 32 slots, the frame interval
    (``iv_local``) once if a slot of the chunk needs it and each kind's
    interval body with its pad once if a slot of the chunk has that kind (the
    lanes of a pass run together), and two shuffles per slot; then the
    relevance tree, once.  FP32 operations and shuffles are counted apart;
    the lane masks and the object index are not counted (constants and
    loop-invariant selects).  None when the scene has no cull."""
    plan = make_cull_plan(scene, gizmo)
    if plan is None:
        return None
    kinds = _lane_kinds(plan)
    local = [n.slot for n in _cull_leaves(plan) if n.op == "leaf" and plan.twinned[n.brush]]
    slot_ops = 0
    for c in range(cull_chunks(plan)):
        def present(slots):
            return any(32 * c <= k < 32 * c + 32 for k in slots)

        slot_ops += IV_OPS["iv_local"] if present(local) else 0
        for kind, slots in kinds.items():
            if present(slots):
                body = IV_OPS["iv_gizmo"] if kind == "gizmo" else _text_ops(scene.brush_interval_cuda[kind])
                slot_ops += body + IV_OPS["iv_pad"]
    tree = _text_ops(cull_tree_function(plan))
    return dict(slot_ops=slot_ops, tree_ops=tree, fp32_ops=slot_ops + tree,
                shuffles=2 * plan.n_slots, chunks=cull_chunks(plan), kinds=len(kinds))


def shade_function(scene: CompiledScene) -> str:
    """``HD Rgb scene_shade(p, n, cam, bank, ad, ex)``: the last object (in bank
    order) whose own SDF at ``p`` is below MAT_THRESH picks the material;
    unmatched hits take the gizmo colours (z, then y, then x, later wins) or
    the background (k1.cl:280-379)."""
    shape_id = [int(s) for s in scene.arrays.shape_id]
    material_id = [int(m) for m in scene.arrays.material_id]
    lines = [
        f"{tape_qualifier(scene)} Rgb scene_shade(float px, float py, float pz, float nx, float ny,"
        " float nz,",
        "                   const Cam& cam, const float* bank, const float* ad, const float* ex) {",
        "    int mat = -1;",
        "    float lx = 0.0f, ly = 0.0f, lz = 0.0f;",
    ]

    def match(brush, material, obj, indent):
        """The object ``obj``'s (a C++ expression) test, in bank order."""
        w = [f"bank_word(o, {i})" for i in range(12)]
        body = [
            f"const float* o = bank + {obj} * BANK_STRIDE;",
            f"const float dx = px - {w[0]}, dy = py - {w[1]}, dz = pz - {w[2]};",
            f"const float a = dx * {w[3]} + dy * {w[4]} + dz * {w[5]};",
            f"const float b = dx * {w[6]} + dy * {w[7]} + dz * {w[8]};",
            f"const float c = dx * {w[9]} + dy * {w[10]} + dz * {w[11]};",
            f"if (brush_{brush}(a, b, c, ad, ex) < MAT_THRESH) {{",
            f"    mat = {material};",
            "    lx = a; ly = b; lz = c;",
            "}",
        ]
        return [" " * indent + line for line in body]

    # Runs of objects of one brush and material test in a loop (the same
    # tests in the same order), as the tape's runs do (TAPE_LOOP_MIN_RUN).
    obj, n_obj = 0, len(shape_id)
    while obj < n_obj:
        end = obj + 1
        while end < n_obj and (shape_id[end], material_id[end]) == (shape_id[obj], material_id[obj]):
            end += 1
        if end - obj >= TAPE_LOOP_MIN_RUN:
            lines.append(f"    for (int obj = {obj}; obj < {end}; ++obj) {{")
            lines += match(shape_id[obj], material_id[obj], "obj", 8)
            lines.append("    }")
        else:
            for k in range(obj, end):
                lines.append("    {")
                lines += match(shape_id[k], material_id[k], str(k), 8)
                lines.append("    }")
        obj = end
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


def cull_mode(config: RenderConfig) -> int:
    """The renderer's ``CULL_MODE`` for ``config.march_cull``: 0 off, 2 for
    "dynamic", 1 (hoisted) for any other true value, as the JAX package
    reads it (march_kernel.py:380-384)."""
    if not config.march_cull:
        return 0
    return 2 if config.march_cull == "dynamic" else 1


# Floats an object of the kernels' interleaved bank (csrc/common.cuh).
BANK_STRIDE = 12
# Objects a __constant__ bank holds: 64 KB of constant memory over
# BANK_STRIDE floats an object.
BANK_CONSTANT_MAX_OBJECTS = 65536 // (BANK_STRIDE * 4)
# Static shared memory a kernel may declare (48 KB on every CUDA card).
STATIC_SHARED_BYTES = 48 * 1024
# The bank's placements (csrc/common.cuh SCENE_BANK).
BANK_PLACEMENTS = ("shared", "constant", "global")


def bank_placement(scene: CompiledScene, constant: bool = False, other_shared: int = 0) -> str:
    """Where a unit keeps the object bank, from the bytes each placement
    needs: "constant" where the unit's rule asks for it (``constant``) and
    the 64 KB of constant memory hold it (BANK_CONSTANT_MAX_OBJECTS);
    "shared" where the bank (48 B an object) and the kernel's other static
    shared buffers (``other_shared`` bytes) fit the 48 KB a block may
    declare; else "global", a buffer passed with each launch, which has no
    limit (csrc/common.cuh BANK_GLOBAL).  Hopper's opt-in dynamic shared
    memory (227 KB a block) would only move the shared limit to about 4,700
    objects, and the JAX package has none: global memory is the rule above
    the static limits."""
    if constant and scene.num_objects <= BANK_CONSTANT_MAX_OBJECTS:
        return "constant"
    if 4 * BANK_STRIDE * scene.num_objects + other_shared <= STATIC_SHARED_BYTES:
        return "shared"
    return "global"


def unit_bank(source: str) -> str:
    """The bank placement a generated unit was made with."""
    if "#define BANK_CONSTANT 1" in source:
        return "constant"
    return "global" if "#define BANK_GLOBAL 1" in source else "shared"


def scene_source(scene: CompiledScene, render_config: Optional[RenderConfig] = None,
                 cull: int = 0, gizmo: bool = False, bank: str = "shared") -> str:
    """The generated scene code: constants (the extras' offsets among them),
    common.cuh, table.cuh (K6), brush functions and the unrolled tape (the k2
    field, with the k1 gizmo when ``gizmo``; without ``render_config`` also
    its column form for the grid kernel).  With ``render_config``: the k1
    field (with the gizmo iff the config says so), the material and shading
    functions and march.cuh's ``render_pixel``, ``cone_ray`` and
    ``march_ray_closest``.  With ``cull`` (a ``CULL_MODE``) and a scene
    whose tape can be culled: the interval twins, ``cull_tile`` and
    ``field_sdf_culled`` of the same field (:func:`cull_source`).
    ``bank`` is the kernels' object bank placement (:func:`bank_placement`;
    ``BANK_CONSTANT`` and ``BANK_GLOBAL``, csrc/common.cuh): "constant"
    holds at most BANK_CONSTANT_MAX_OBJECTS objects."""
    if bank not in BANK_PLACEMENTS:
        raise ValueError(f"bank must be one of {BANK_PLACEMENTS}, got {bank!r}")
    if bank == "constant" and scene.num_objects > BANK_CONSTANT_MAX_OBJECTS:
        raise ValueError(
            f"the scene has {scene.num_objects} objects; a kernel's __constant__ object bank "
            f"holds at most {BANK_CONSTANT_MAX_OBJECTS} (64 KB)")
    parts = [
        "// Generated from the scene tape by designcsg_tpu_torch/ops/cuda/tape.py.\n"
        f"constexpr int N_OBJ = {scene.num_objects};\n"
        f"#define BANK_CONSTANT {int(bank == 'constant')}\n"
        f"#define BANK_GLOBAL {int(bank == 'global')}\n" + extras_constants(scene)
    ]
    if render_config is not None:
        gizmo = render_config.gizmo
        parts.append(_march_constants(render_config))
    parts += [
        csrc("common.cuh"), csrc("table.cuh"), brush_functions(scene), _brush_at(used_brushes(scene)),
    ]
    parts.append(tape_function(scene, gizmo))
    if render_config is None:  # the point and grid unit: the grid kernel's column form
        parts += [column_terms_function(scene), tape_function(scene, gizmo, column=True)]
    parts.append(cull_source(scene, make_cull_plan(scene, gizmo) if cull else None, cull,
                             render_config))
    if render_config is not None:
        parts += [material_functions(scene), shade_function(scene), csrc("march.cuh")]
    return "\n".join(parts)


# K3's culled grid runs its tile's chain over the first warp's lanes where
# the lane chain's FP32 operations (lane_chain_ops: its kinds' passes run one
# after another) are at most this share of the one-thread chain's
# (cull_chain_ops); else one thread runs the chain.  From the A/B on the
# H100 (PERF.md; ab_render_timing.py times the other side of each unit's
# choice): on the lanes Design1's culled grid took 0.0223 ms against 0.0278
# in one thread (its chain 163 of 1,007 operations), Design2's the same
# 0.0366 (178 of 286), Logo's 0.0195 against 0.0191 (1,137 of 1,360: its
# letters each a kind of their own).
GRID_LANE_CHAIN_MAX_SHARE = 0.8


def grid_cull_lanes(scene: CompiledScene, gizmo: bool) -> bool:
    """Whether the culled grid kernel runs the lane chain (``GRID_CULL_LANES``)
    for this field: where it cuts the chain's operations to at most
    GRID_LANE_CHAIN_MAX_SHARE of one thread's (Design1 and Design2, with
    and without the gizmo), not where the lanes' passes, one per brush kind,
    add up to nearly the whole chain (Logo)."""
    lanes = lane_chain_ops(scene, gizmo)
    return lanes is not None and (
        lanes["fp32_ops"] <= GRID_LANE_CHAIN_MAX_SHARE * cull_chain_ops(scene, gizmo))


# K3's culled grid runs its z loop in the column form where the form hoists
# at least this many imports' frame terms; else in the point form, as the
# kernel did before columns.  From the A/B on the H100 (PERF.md;
# ab_render_timing.py times both forms with either chain): the column form
# took Design1's culled grid from 0.0354 ms to 0.0222 (10 imports hoisted,
# 110 of its 269 operations a point saved) and Logo's from 0.0205 to 0.0191
# (3 hoisted), and matched the point form with the gizmo on Logo (0.0211
# against 0.0212); on Design2 (2 hoisted, 22 of 814 operations) it gained
# nothing without the gizmo (0.0367 either way) and lost with it (0.0431
# against 0.0417).
GRID_CULL_COLUMN_MIN_HOISTED = 3


def grid_cull_column(scene: CompiledScene, gizmo: bool) -> bool:
    """Whether the culled grid kernel's z loop runs the column form of the
    culled field (``GRID_CULL_COLUMN``): where it hoists at least
    GRID_CULL_COLUMN_MIN_HOISTED imports (Design1, Logo, the 89-group
    scene; with and without the gizmo, which has no frame to hoist), not
    Design2's two."""
    return len(column_hoisted(scene)) >= GRID_CULL_COLUMN_MIN_HOISTED


def sdf_kernel_source(scene: CompiledScene, gizmo: bool = False, cull: bool = False) -> str:
    """Translation unit of the point and grid eval kernels (the k2 field, or
    with ``gizmo`` the k1 field: the tape min-ed with the axis gizmo); with
    ``cull`` and a tape that can be culled, the culled grid kernel too (the
    gizmo then has its own cull slot; its chain on the lanes by
    :func:`grid_cull_lanes`, its z loop's form by :func:`grid_cull_column`).
    Without ``cull`` no cull plan is made, as the JAX package's point kernel
    builds no culler unless asked (sdf_kernel.py:211 there).  Its bank stays
    in shared memory where it fits (the A/B timed it in constant memory too,
    PERF.md), with the culled grid's predicate and substitute buffers beside
    it; else in global memory (:func:`bank_placement`)."""
    plan = make_cull_plan(scene, gizmo) if cull else None
    other = 0 if plan is None else 4 * (cull_words(plan) + plan.n_slots)
    source = scene_source(scene, cull=int(plan is not None), gizmo=gizmo,
                          bank=bank_placement(scene, other_shared=other))
    if plan is not None:
        source += (f"\n#define GRID_CULL_LANES {int(grid_cull_lanes(scene, gizmo))}\n"
                   f"#define GRID_CULL_COLUMN {int(grid_cull_column(scene, gizmo))}\n")
    return source + "\n" + csrc("sdf_kernels.cu")


# Where each sphere-trace unit keeps the object bank: rules from the A/B on
# the H100 that chose them (PERF.md; ab_render_timing.py times both
# placements beside each other, the constant bank's fill included).
#
# The renderer (K2): constant memory for a bank of more than 4 objects,
# except under the hoisted cull.  Design1's 11 objects, held in registers by
# the shared build, took 208 registers (2 blocks an SM), and its unculled
# and dynamic frames ran faster with constant operands; Logo's shared build
# reloaded its bank each step; Design2's 3 objects sit in registers at 80
# and its frames ran slower with constant operands.  Design1's hoisted
# frames, whose every lane runs the one-thread chain once, ran slower with
# the constant bank than with the shared one.  Past 64 KB of constant memory
# or 48 KB of shared memory the bank lies in global memory
# (:func:`bank_placement`).
RENDER_CONSTANT_BANK_MIN_OBJECTS = 5


def ray_march_bank_constant(scene: CompiledScene) -> bool:
    """Whether the fit's ray march (K4) takes its bank from constant memory:
    with baked tables (Logo), whose shared build reloaded the bank every
    step; a scene without keeps the shared build, whose bank the compiler
    holds in registers (Design1: 149, 3 blocks an SM, enough for its step)."""
    return bool(scene.extras or scene.derived_extras)


def march_kernel_source(scene: CompiledScene, config: RenderConfig) -> str:
    """Translation unit of the fused renderer kernel (march mode, cone
    constants and cull mode from ``config``); its bank in constant memory
    by the rule above RENDER_CONSTANT_BANK_MIN_OBJECTS, where it fits
    (:func:`bank_placement`)."""
    cull = cull_mode(config)
    constant = scene.num_objects >= RENDER_CONSTANT_BANK_MIN_OBJECTS and cull != 1
    return scene_source(scene, render_config=config, cull=cull,
                        bank=bank_placement(scene, constant=constant)) + (
        "\n" + csrc("march_kernel.cu"))


# The cone prepass (K5) splits each ray's tape across the warps of a block
# (csrc/cone_kernel.cu): S warps serve 32 rays, warp j evaluating its share
# of the tape's slots for all 32.  S is one of these; 0 is one thread a ray.
CONE_WARP_CHOICES = (1, 2, 4, 8)
# FP32 operations of common.cuh gizmo_sdf: 3 divisions, 3 cylinders (two
# products, a sum, an absolute value, 2 subtractions, a square root and a
# max: 9 each) and 2 mins.
GIZMO_FLOPS = 3 + 3 * 9 + 2


def cone_slot_costs(scene: CompiledScene, gizmo: bool):
    """FP32 operations of each slot of the cone's field: each import's
    (ops/cull.py leaf_cost: its CUDA body and frame transform), then the
    gizmo's."""
    return [leaf_cost(scene, brush) for brush, _ in _imports(scene)] + (
        [GIZMO_FLOPS] if gizmo else [])


def cone_deal(scene: CompiledScene, gizmo: bool, warps: int):
    """The slots each of ``warps`` warps evaluates, dealt by their operation
    counts: the costliest first, each to the warp with the least work so
    far (the lower warp on a tie)."""
    costs = cone_slot_costs(scene, gizmo)
    loads, deal = [0] * warps, [[] for _ in range(warps)]
    for k in sorted(range(len(costs)), key=lambda k: (-costs[k], k)):
        w = min(range(warps), key=lambda w: (loads[w], w))
        deal[w].append(k)
        loads[w] += costs[k]
    return [sorted(d) for d in deal]


# The cone kernel's warps a block, from the A/B on the H100 (PERF.md;
# ab_render_timing.py times S = 0, 1, 2, 4 and 8 on every design): four
# warps ran fastest on Design1 (0.048 ms against 0.058 with one thread a
# ray), Logo (0.038 against 0.073) and Design2 (0.039 against 0.040, its
# Hilbert slot 92% of the field on one warp).  Eight lost to four on every
# design (each warp also runs the tape's rows, its loads and the barrier),
# two left half of Design1's and Logo's field on one warp, and one warp (a
# barrier a step on one thread's tape) lost to one thread a ray.
CONE_WARPS = 4
def cone_split_bytes(scene: CompiledScene, gizmo: bool, warps: int) -> int:
    """Shared memory of the cone kernel's split at ``warps`` warps a block:
    the two buffers of each slot's value for the block's 32 rays."""
    return 4 * 2 * 32 * len(cone_slot_costs(scene, gizmo)) if warps else 0


def cone_shared_bytes(scene: CompiledScene, gizmo: bool, warps: int) -> int:
    """Shared memory of the cone kernel at ``warps`` warps a block with its
    bank in shared memory (csrc/common.cuh SCENE_BANK): the bank and the
    split's buffers."""
    return 4 * BANK_STRIDE * scene.num_objects + cone_split_bytes(scene, gizmo, warps)


def cone_warps(scene: CompiledScene, gizmo: bool) -> int:
    """The cone kernel's S (``CONE_WARPS``) for a scene: CONE_WARPS where
    its shared memory fits the 48 KB a kernel may declare (every shipped
    design; a scene of up to about 160 imports), else 0, one thread a ray,
    whose bank stays in shared memory while it fits there alone and lies in
    global memory above (:func:`bank_placement`)."""
    fits = cone_shared_bytes(scene, gizmo, CONE_WARPS) <= STATIC_SHARED_BYTES
    return CONE_WARPS if fits else 0


def cone_split_function(scene: CompiledScene, gizmo: bool, warps) -> str:
    """``N_CONE_SLOTS``; ``cone_slots<S>(warp, x, y, z, bank, ad, ex, v)``
    for each S of ``warps``: warp ``warp``'s slots of the field
    (:func:`cone_deal`) at (x, y, z) into ``v[slot * 32]``, the same
    ``brush_<k>_at`` and ``gizmo_sdf`` calls as ``field_sdf``'s; and
    ``cone_tape(v)``: the tape's rows over those values, ``field_sdf``'s
    rows in its order, so it returns its bits."""
    imports = _imports(scene)
    n = len(imports) + int(gizmo)

    def value(k):
        return GIZMO if k == len(imports) else _slot_value(imports, k)

    args = ("float x, float y, float z, const float* bank, const float* ad, const float* ex, "
            "float* v")
    lines = ["#define CONE_SPLIT 1", f"constexpr int N_CONE_SLOTS = {n};",
             f"template <int S> HD void cone_slots(int warp, {args});"]
    for s in warps:
        lines.append(f"template <> HD void cone_slots<{s}>(int warp, {args}) {{")
        for w, slots in enumerate(cone_deal(scene, gizmo, s)):
            if slots:
                lines.append(f"    if (warp == {w}) {{")
                lines += [f"        v[{k} * 32] = {value(k)};" for k in slots]
                lines.append("    }")
        lines += ["}", ""]
    lines.append("HD float cone_tape(const float* v) {")
    lines += _tape_lines(scene, lambda k: f"v[{k} * 32]", f"v[{len(imports)} * 32]" if gizmo else None)
    return "\n".join(lines)


def cone_kernel_source(scene: CompiledScene, config: RenderConfig,
                       warps: Optional[int] = None) -> str:
    """Translation unit of the cone prepass kernel (its bank in shared
    memory where it fits, as the point/grid unit's): :func:`cone_warps` warps a block of
    32 rays (``CONE_WARPS``; 0: one thread a ray), or ``warps`` (the A/B's
    levers)."""
    s = cone_warps(scene, config.gizmo) if warps is None else warps
    bank = bank_placement(scene, other_shared=cone_split_bytes(scene, config.gizmo, s))
    return (scene_source(scene, render_config=config, bank=bank) + "\n"
            + cone_split_function(scene, config.gizmo, (s,) if s else ())
            + f"\n#define CONE_WARPS {s}\n" + csrc("cone_kernel.cu"))


def ray_march_kernel_source(scene: CompiledScene, config: RenderConfig) -> str:
    """Translation unit of the fit's ray-march kernel (march mode, step
    budget and gizmo from ``config``; the bank's placement by
    :func:`ray_march_bank_constant` where it fits, :func:`bank_placement`)."""
    bank = bank_placement(scene, constant=ray_march_bank_constant(scene))
    return scene_source(scene, render_config=config, bank=bank) + "\n" + csrc(
        "ray_march_kernel.cu")
