"""Exact per-tile object culling by interval arithmetic (K7).

Counterpart of the JAX package's ops/pallas/cull.py.  Every kernel of the
port evaluates the whole tape at every point; this module proves, for a box
of points (a tile), which IMPORTs cannot change the CSG result anywhere in
the box, so that a kernel can skip their brushes:

1. the tape is executed symbolically into an expression tree (IMPORTs are
   leaves, MIN/MAX/NEGATE/IDENTITY interior nodes), NEGATEs are pushed down
   to the leaves and min/max chains flattened into n-ary nodes;
2. a static, cost-aware partition groups each node's cheap sibling leaves
   into one branch and gives expensive brushes and subtrees their own;
3. at run time each leaf's brush interval twin bounds it over the box, the
   bounds propagate bottom-up, and relevance flows top-down: at MIN a unit
   whose lower bound is not below the least upper bound of its siblings
   cannot win anywhere in the box (MAX mirrored);
4. a skipped leaf is replaced by the lower bound of its padded interval, a
   value inside the proven interval, so every ancestor min/max returns what
   it would have returned: the culled evaluation is exact.

The interval helpers are elementwise, so one call bounds a batch of boxes:
``box`` components may be tensors of any one shape (the plain versions cull
every tile of a frame at once).  Each brush carries its interval twin
``interval(ia, ib, ic, ctx) -> (lo, hi)`` and its C++ form
``interval_cuda`` (brushes.py); ops/cuda/tape.py generates ``cull_tile``
from the same :class:`CullPlan`, operation for operation, over
csrc/interval.cuh.  A brush without a twin gets (-3e38, 3e38) and is never
skipped.

Every value is a float32 tensor or a Python float holding a float32 value,
and every helper rounds each operation to float32 as its C++ twin does, so
the plain culler and the generated ``cull_tile`` give the same bits.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..brushes import EvalContext
from ..constants import (
    AXES_RADIUS,
    INITIAL_SCALE,
    MAX_DISTANCE,
    OP_EXPORT,
    OP_IDENTITY,
    OP_IMPORT,
    OP_MAX,
    OP_MIN,
    OP_NEGATE,
)

if TYPE_CHECKING:  # the compiler imports this module for the builtin twins
    from ..compiler import CompiledScene, SceneArrays

BIG = float(np.float32(3.0e38))

# -- float32 scalar/tensor arithmetic -----------------------------------------


def f32(c) -> float:
    """``c`` rounded to float32, as a Python float."""
    return float(np.float32(c))


def _op(a, b, fn):
    out = fn(a, b)
    return f32(out) if isinstance(out, float) else out


def fadd(a, b):
    return _op(a, b, lambda x, y: x + y)


def fsub(a, b):
    return _op(a, b, lambda x, y: x - y)


def fmul(a, b):
    return _op(a, b, lambda x, y: x * y)


def fmin(a, b):
    if isinstance(a, float) and isinstance(b, float):
        return min(a, b)
    if isinstance(a, float):
        a, b = b, a
    return torch.clamp(a, max=b) if isinstance(b, float) else torch.minimum(a, b)


def fmax(a, b):
    if isinstance(a, float) and isinstance(b, float):
        return max(a, b)
    if isinstance(a, float):
        a, b = b, a
    return torch.clamp(a, min=b) if isinstance(b, float) else torch.maximum(a, b)


def fabs(a):
    return abs(a) if isinstance(a, float) else torch.abs(a)


def fsqrt(a):
    """Correctly rounded, as C's sqrtf: through float64 (PyTorch's float32
    square root on the CPU can be an ulp off)."""
    if isinstance(a, float):
        return float(np.sqrt(np.float32(a)))
    return torch.sqrt(a.double()).to(a.dtype)


def fselect(cond, a, b):
    """``cond ? a : b`` elementwise."""
    if isinstance(cond, bool):
        return a if cond else b
    return torch.where(cond, a, b)


# -- interval helpers (csrc/interval.cuh mirrors each one) --------------------


def iv_const(c):
    c = f32(c)
    return (c, c)


def iv_add(a, b):
    return (fadd(a[0], b[0]), fadd(a[1], b[1]))


def iv_sub(a, b):
    return (fsub(a[0], b[1]), fsub(a[1], b[0]))


def iv_neg(a):
    return (-a[1], -a[0])


def iv_min(a, b):
    return (fmin(a[0], b[0]), fmin(a[1], b[1]))


def iv_max(a, b):
    return (fmax(a[0], b[0]), fmax(a[1], b[1]))


def iv_mul_scalar(a, c):
    """Interval times a (possibly negative) scalar."""
    x, y = fmul(a[0], c), fmul(a[1], c)
    return (fmin(x, y), fmax(x, y))


def iv_mul(a, b):
    """General interval product (endpoint extremes)."""
    p0, p1 = fmul(a[0], b[0]), fmul(a[0], b[1])
    p2, p3 = fmul(a[1], b[0]), fmul(a[1], b[1])
    return (fmin(fmin(p0, p1), fmin(p2, p3)), fmax(fmax(p0, p1), fmax(p2, p3)))


def iv_abs(a):
    return (fmax(fmax(a[0], -a[1]), 0.0), fmax(-a[0], a[1]))


def iv_square(a):
    lo, hi = iv_abs(a)
    return (fmul(lo, lo), fmul(hi, hi))


def iv_sqrt(a):
    return (fsqrt(fmax(a[0], 0.0)), fsqrt(fmax(a[1], 0.0)))


def iv_norm3(a, b, c):
    """Interval of sqrt(a^2 + b^2 + c^2)."""
    return iv_sqrt(iv_add(iv_add(iv_square(a), iv_square(b)), iv_square(c)))


def iv_pad(iv):
    """Widen by ``1e-6 (|lo| + |hi|) + 1e-6`` (cull.py:539-545 of the JAX
    package): a bound that holds in real arithmetic can be a few ulps off
    the float evaluation of the brush, so the cull engages only with that
    margin and the substitution stays exact."""
    slack = fadd(fmul(fadd(fabs(iv[0]), fabs(iv[1])), 1e-6), 1e-6)
    return (fsub(iv[0], slack), fadd(iv[1], slack))


def ray_box(o_proj, ray_ivs, ivd):
    """Axis box of ``o + d * r`` for d in ``ivd`` and per-component ray
    intervals ``ray_ivs`` (march_kernel.py:98-105 of the JAX package)."""
    return tuple(iv_add(iv_const(o), iv_mul(ivd, rc)) for o, rc in zip(o_proj, ray_ivs))


def inflate(iv, n_eps, drift):
    """Widen one axis of the hoisted cull's box by ``n_eps + drift (|lo| +
    |hi| + 1)``, so that it holds the FD normal's probes and the march's
    accumulated positions (march_kernel.py:477-491 of the JAX package;
    csrc/march.cuh ray_span)."""
    slack = fadd(f32(n_eps), fmul(fadd(fadd(fabs(iv[0]), fabs(iv[1])), 1.0), f32(drift)))
    return (fsub(iv[0], slack), fadd(iv[1], slack))


def iv_local(box, o3, r3, u3, f3):
    """Interval of an object's local coordinates over ``box``: the frame
    transform ``((v-o).r, (v-o).u, (v-o).f)`` of the IMPORT."""
    d = [iv_sub(iv, iv_const(o)) for iv, o in zip(box, o3)]

    def dot(v3):
        return iv_add(
            iv_add(iv_mul_scalar(d[0], v3[0]), iv_mul_scalar(d[1], v3[1])),
            iv_mul_scalar(d[2], v3[2]),
        )

    return dot(r3), dot(u3), dot(f3)


def gizmo_interval(ivx, ivy, ivz):
    """Interval twin of the k1 gizmo (cull.py:347-364 of the JAX package)."""
    inv = f32(1.0 / INITIAL_SCALE)
    xs, ys, zs = (iv_mul_scalar(iv, inv) for iv in (ivx, ivy, ivz))

    def cyl(r2, h):
        return iv_max(iv_sub(iv_abs(h), iv_const(0.5)), iv_sub(iv_sqrt(r2), iv_const(AXES_RADIUS)))

    half = iv_const(0.5)
    dx = cyl(iv_add(iv_square(ys), iv_square(zs)), iv_sub(xs, half))
    dy = cyl(iv_add(iv_square(xs), iv_square(zs)), iv_sub(ys, half))
    dz = cyl(iv_add(iv_square(xs), iv_square(ys)), iv_sub(zs, half))
    return iv_min(dx, iv_min(dy, dz))


# -- interval twins of the builtin brushes (cull.py:223-250) ------------------


def empty_interval(ia, ib, ic, ctx):
    return iv_const(MAX_DISTANCE)


def space_interval(ia, ib, ic, ctx):
    return iv_const(0.0)


def sphere_interval(ia, ib, ic, ctx):
    return iv_sub(iv_norm3(ia, ib, ic), iv_const(0.5))


def cylinder_interval(ia, ib, ic, ctx):
    r = iv_sqrt(iv_add(iv_square(ia), iv_square(ic)))
    return iv_max(iv_sub(r, iv_const(0.5)), iv_sub(iv_abs(ib), iv_const(0.5)))


def box_interval(ia, ib, ic, ctx):
    return iv_sub(iv_max(iv_abs(ia), iv_max(iv_abs(ib), iv_abs(ic))), iv_const(0.5))


EMPTY_INTERVAL_CUDA = "return iv_const(MAX_DISTANCE);"
SPACE_INTERVAL_CUDA = "return iv_const(0.0f);"
SPHERE_INTERVAL_CUDA = "return iv_sub(iv_norm3(a, b, c), iv_const(0.5f));"
CYLINDER_INTERVAL_CUDA = (
    "return iv_max(iv_sub(iv_sqrt(iv_add(iv_square(a), iv_square(c))), iv_const(0.5f)),\n"
    "                  iv_sub(iv_abs(b), iv_const(0.5f)));"
)
BOX_INTERVAL_CUDA = (
    "return iv_sub(iv_max(iv_abs(a), iv_max(iv_abs(b), iv_abs(c))), iv_const(0.5f));"
)


def register_lipschitz_interval(fn: Callable, anchor=(0.0, 0.0, 0.0), lipschitz: float = 1.0,
                                enclosure_radius: Optional[float] = None, ctx=None):
    """``(interval, interval_cuda)``: a sound interval twin of a Lipschitz
    brush in both forms, for ``define_brush`` (cull.py:253-304 of the JAX
    package, which registers it).  With ``c0 = fn(anchor)``:

    * Lipschitz band: ``|sdf(p) - c0| <= L |p - anchor|``, the only upper
      bound;
    * far field (with ``enclosure_radius`` R): ``sdf(p) >= ||p - anchor||_inf
      - R``, which lets a far tile skip the brush.

    ``lipschitz`` must bound |grad sdf| and R must hold everywhere, both in
    local coordinates; an underestimate silently breaks the cull's
    exactness, so fuzz the twin with :func:`verify_interval_twin`."""
    from .cuda.tape import f32_literal as _literal  # tape.py imports this module

    p0 = [f32(v) for v in anchor]
    pts = torch.tensor([p0], dtype=torch.float32)
    c0 = f32(float(fn(pts, ctx if ctx is not None else EvalContext()).reshape(())))
    L = f32(lipschitz)
    R = None if enclosure_radius is None else f32(enclosure_radius)

    def interval(ia, ib, ic, ctx):
        da, db, dc = (iv_sub(iv, iv_const(p)) for iv, p in zip((ia, ib, ic), p0))
        dist = iv_norm3(da, db, dc)
        lo = fsub(c0, fmul(dist[1], L))
        hi = fadd(c0, fmul(dist[1], L))
        if R is not None:
            inf_lo = fmax(fmax(iv_abs(da)[0], iv_abs(db)[0]), iv_abs(dc)[0])
            lo = fmax(lo, fsub(inf_lo, R))
        return (lo, hi)

    lines = [
        "const Iv da = iv_sub(a, iv_const({})), db = iv_sub(b, iv_const({})), "
        "dc = iv_sub(c, iv_const({}));".format(*(_literal(p) for p in p0)),
        "const Iv dist = iv_norm3(da, db, dc);",
        f"float lo = sub_rn({_literal(c0)}, mul_rn(dist.hi, {_literal(L)}));",
        f"const float hi = add_rn({_literal(c0)}, mul_rn(dist.hi, {_literal(L)}));",
    ]
    if R is not None:
        lines.append(
            "lo = fmaxf(lo, sub_rn(fmaxf(fmaxf(iv_abs(da).lo, iv_abs(db).lo), iv_abs(dc).lo), "
            f"{_literal(R)}));"
        )
    lines.append("return Iv{lo, hi};")
    interval.anchor, interval.lipschitz, interval.enclosure_radius, interval.c0 = p0, L, R, c0
    return interval, "\n    ".join(lines)


def verify_interval_twin(
    fn: Callable,
    interval: Callable,
    radius: float = 4.0,
    n_boxes: int = 256,
    samples_per_box: int = 64,
    ctx=None,
    seed: int = 0,
    boxes=None,
) -> float:
    """Sampled soundness check of an interval twin (cull.py:144-220 of the
    JAX package): random boxes in local coordinates (or ``boxes = (lo[B, 3],
    hi[B, 3])``), ``fn`` at random points and the 8 corners of each, and the
    twin once over all boxes.  Returns how far the worst sample escapes its
    box's interval (0.0 when every sample is enclosed).  A sampled check can
    find an unsound twin, not prove one sound."""
    if ctx is None:
        ctx = EvalContext()
    rng = np.random.default_rng(seed)
    if boxes is not None:
        lo, hi = (np.asarray(a, np.float64) for a in boxes)
        n_boxes = lo.shape[0]
        size = hi - lo
    else:
        lo = rng.uniform(-radius, radius, size=(n_boxes, 3))
        size = rng.uniform(0.0, radius, size=(n_boxes, 3)) * rng.uniform(0.02, 1.0, size=(n_boxes, 1))
        hi = lo + size
    k = samples_per_box
    pts = lo[:, None, :] + rng.random((n_boxes, k, 3)) * size[:, None, :]
    corners = np.stack(
        [
            np.stack([np.where(i & 1, hi[:, 0], lo[:, 0]), np.where(i & 2, hi[:, 1], lo[:, 1]),
                      np.where(i & 4, hi[:, 2], lo[:, 2])], axis=-1)
            for i in range(8)
        ],
        axis=1,
    )
    pts = np.concatenate([pts, corners], axis=1).astype(np.float32)
    with torch.no_grad():
        vals = fn(torch.from_numpy(pts.reshape(-1, 3)), ctx).reshape(n_boxes, k + 8).double().numpy()
        ivs = [
            (torch.from_numpy(lo[:, i].astype(np.float32)), torch.from_numpy(hi[:, i].astype(np.float32)))
            for i in range(3)
        ]
        tlo, thi = interval(*ivs, ctx)
    tlo = np.broadcast_to(np.asarray(tlo, np.float64), (n_boxes,))
    thi = np.broadcast_to(np.asarray(thi, np.float64), (n_boxes,))
    worst = np.maximum(tlo - vals.min(axis=1), vals.max(axis=1) - thi).max()
    return float(max(worst, 0.0))


# -- the tape's expression tree and its partition (cull.py:307-517) -----------


@dataclasses.dataclass
class Node:
    op: str  # "leaf" | "gizmo" | "min" | "max" | "neg"
    children: tuple = ()
    slot: int = -1  # position in the tape's IMPORT sequence (n_imports: gizmo)
    brush: int = -1
    obj: int = -1
    negated: bool = False  # leaf parity after the NEGATE pushdown


def build_tape_tree(tape) -> Tuple[Optional[Node], int]:
    """Execute the tape symbolically: (root node, number of IMPORTs).  The
    compiler's register machine assigns every register before use, so the
    tree is the exact CSG expression."""
    regs: Dict[int, Node] = {}
    root: Optional[Node] = None
    n_imports = 0
    for opcode, left, right, dest in tape:
        if opcode == OP_IMPORT:
            regs[dest] = Node("leaf", slot=n_imports, brush=left, obj=right)
            n_imports += 1
        elif opcode == OP_MIN:
            regs[dest] = Node("min", (regs[left], regs[right]))
        elif opcode == OP_MAX:
            regs[dest] = Node("max", (regs[left], regs[right]))
        elif opcode == OP_NEGATE:
            regs[dest] = Node("neg", (regs[left],))
        elif opcode == OP_IDENTITY:
            regs[dest] = regs[left]
        elif opcode == OP_EXPORT:
            root = regs[left]
    return root, n_imports


def push_neg(node: Node, neg: bool = False) -> Node:
    """De Morgan pushdown and flattening: an equivalent tree of n-ary min/max
    nodes with every NEGATE absorbed into leaf parity.  A walk with a stack
    of its own, not Python's: a flat scene's tape chains one min an object,
    a tree as deep as the scene is long (a 1,500-object ring)."""
    done: List[Node] = []  # each finished subtree, in the order its walk ends
    stack = [(node, neg, False)]
    while stack:
        n, ng, expanded = stack.pop()
        if n.op in ("leaf", "gizmo"):
            done.append(dataclasses.replace(n, negated=ng != n.negated))
        elif n.op == "neg":
            stack.append((n.children[0], not ng, False))
        elif not expanded:
            stack.append((n, ng, True))
            stack.extend((c, ng, False) for c in reversed(n.children))
        else:
            op = n.op if not ng else ("max" if n.op == "min" else "min")
            kids = done[len(done) - len(n.children):]
            del done[len(done) - len(n.children):]
            flat = []
            for k in kids:
                flat.extend(k.children if k.op == op else (k,))
            done.append(Node(op, tuple(flat)))
    return done[0]


def tree_leaves(node: Node) -> List[Node]:
    """The leaves (brush and gizmo slots) under ``node``, left to right, each
    time it is reached; a walk with its own stack, as :func:`push_neg`'s."""
    out, stack = [], [node]
    while stack:
        n = stack.pop()
        if n.op in ("leaf", "gizmo"):
            out.append(n)
        else:
            stack.extend(reversed(n.children))
    return out


def post_order(root: Node) -> List[Node]:
    """The interior nodes under ``root`` (itself included), each once, every
    node after its children, children left to right: the order a recursive
    walk with a memo visits them in."""
    out, seen, stack = [], set(), [(root, False)]
    while stack:
        n, expanded = stack.pop()
        if n.op in ("leaf", "gizmo") or id(n) in seen:
            continue
        if expanded:
            seen.add(id(n))
            out.append(n)
        else:
            stack.append((n, True))
            stack.extend((c, False) for c in reversed(n.children))
    return out


#: A leaf of at least this cost (FP32 operations of one evaluation: the
#: brush's CUDA body plus its frame transform) gets a branch of its own;
#: cheaper siblings share one.  The JAX package counts the twin's jaxpr
#: equations against 120 (cull.py:421-423); on the shipped designs the two
#: counts give the same groups.
SOLO_COST = 120
#: Leaves without a CUDA operation count (no CUDA body) count as this.
UNKNOWN_COST = 10_000
FRAME_OPS = 3 + 15  # the IMPORT's 3 subtractions and 3x3 matrix-vector product
GIZMO_COST = 30  # the JAX package's gizmo cost (cull.py:481-482)


def leaf_cost(scene: CompiledScene, brush: int) -> int:
    """FP32 operations of one tape slot of ``brush``: its CUDA body and its
    frame transform (none for a brush that ignores its coordinates)."""
    flops = scene.brush_flops[brush] if brush < len(scene.brush_flops) else None
    if flops is None:
        return UNKNOWN_COST
    return flops + (FRAME_OPS if flops else 0)


@dataclasses.dataclass
class CullPlan:
    """The static part of a culler: the pushed-down tree, each n-ary node's
    units (``("always", node)``, ``("sub", node)`` or ``("bucket", group,
    members)``), the groups of IMPORT slots sharing one branch (slot
    ``n_imports`` is the gizmo) and which brushes have an interval twin."""

    root: Node
    units: Dict[int, list]
    groups: Tuple[Tuple[int, ...], ...]
    n_imports: int
    gizmo: bool
    twinned: Tuple[bool, ...]

    @property
    def n_slots(self) -> int:
        return self.n_imports + int(self.gizmo)

    def leaf_twinned(self, node: Node) -> bool:
        return node.op == "gizmo" or self.twinned[node.brush]


def make_cull_plan(scene: CompiledScene, gizmo: bool = False) -> Optional[CullPlan]:
    """The scene's :class:`CullPlan`, or None when its tape has nothing to
    prune (fewer than three slots, a root that is no min/max, or no group)."""
    tape = [tuple(int(v) for v in row) for row in np.asarray(scene.arrays.tape)]
    root, n_imports = build_tape_tree(tape)
    if root is None or n_imports + int(gizmo) < 3:
        return None
    if gizmo:
        root = Node("min", (root, Node("gizmo", slot=n_imports)))
    root = push_neg(root)
    if root.op not in ("min", "max"):
        return None
    twinned = tuple(iv is not None for iv in scene.brush_interval)
    groups: List[tuple] = []
    units: Dict[int, list] = {}

    def cost(node):
        return GIZMO_COST if node.op == "gizmo" else leaf_cost(scene, node.brush)

    # Each n-ary node's units, depth first: a subtree's groups are numbered
    # where it stands among its siblings, a node's bucket after them all.
    stack = [(root, iter(root.children), [], [])]
    while stack:
        node, children, node_units, bucket = stack[-1]
        c = next(children, None)
        if c is None:
            stack.pop()
            if bucket:
                node_units.append(("bucket", len(groups), bucket))
                groups.append(tuple(b.slot for b in bucket))
            units[id(node)] = node_units
        elif c.op not in ("leaf", "gizmo"):
            node_units.append(("sub", c))
            stack.append((c, iter(c.children), [], []))
        elif not (c.op == "gizmo" or twinned[c.brush]):
            node_units.append(("always", c))
        elif cost(c) >= SOLO_COST:
            node_units.append(("bucket", len(groups), [c]))
            groups.append((c.slot,))
        else:
            bucket.append(c)
    if not groups:
        return None
    return CullPlan(root, units, tuple(groups), n_imports, gizmo, twinned)


def array_bank_reader(arrays: SceneArrays):
    """``bank(i) -> (o3, r3, u3, f3)``: an object's frame row as Python floats
    (tape.py:135-146 of the JAX package)."""

    def rows(a):
        return np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a, np.float32)

    pos, right, up, fwd = (rows(a) for a in (arrays.position, arrays.right, arrays.up, arrays.forward))

    def bank(i: int):
        return tuple(tuple(float(v) for v in a[i]) for a in (pos, right, up, fwd))

    return bank


class TapeCuller:
    """``cull(box, bank, ctx) -> (preds, substs)`` (cull.py:453-633 of the
    JAX package): ``box`` is ``((x0, x1), (y0, y1), (z0, z1))``, ``preds[g]``
    says group g must be evaluated, ``substs[k]`` is slot k's substitute
    when its group is skipped.  ``.groups`` and ``.n_slots`` are static."""

    def __init__(self, scene: CompiledScene, plan: CullPlan):
        self.scene, self.plan = scene, plan
        self.groups, self.n_slots = plan.groups, plan.n_slots
        self._intervals = scene.brush_interval

    def __call__(self, box, bank, ctx):
        plan = self.plan
        substs: List = [None] * plan.n_slots
        memo: Dict[int, tuple] = {}

        def node_iv(node):
            """A leaf's interval (made at its first use), or an interior
            node's, which the fold below made before any parent reads it."""
            if id(node) in memo:
                return memo[id(node)]
            if node.op == "gizmo":
                brush_iv = iv_pad(gizmo_interval(*box))
            else:
                twin = self._intervals[node.brush]
                if twin is None:
                    brush_iv = (-BIG, BIG)
                else:
                    brush_iv = iv_pad(twin(*iv_local(box, *bank(node.obj)), ctx))
            substs[node.slot] = brush_iv[0]
            memo[id(node)] = iv_neg(brush_iv) if node.negated else brush_iv
            return memo[id(node)]

        for node in post_order(plan.root):
            fold = iv_min if node.op == "min" else iv_max
            iv = node_iv(node.children[0])
            for c in node.children[1:]:
                iv = fold(iv, node_iv(c))
            memo[id(node)] = iv
        preds: List = [None] * len(self.groups)

        def unit_iv(node, u):
            if u[0] != "bucket":
                return node_iv(u[1])
            fold = iv_min if node.op == "min" else iv_max
            iv = node_iv(u[2][0])
            for m in u[2][1:]:
                iv = fold(iv, node_iv(m))
            return iv

        # Relevance flows top-down; a stack of (node, its relevance).
        stack = [(plan.root, True)]
        while stack:
            node, rel = stack.pop()
            units = plan.units[id(node)]
            uivs = [unit_iv(node, u) for u in units]
            for i, u in enumerate(units):
                if len(units) == 1:
                    rel_u = rel
                else:
                    others = [iv for j, iv in enumerate(uivs) if j != i]
                    if node.op == "min":
                        # unit i can win the min somewhere only if its lower
                        # bound is below the least upper bound of the others
                        bound = others[0][1]
                        for iv in others[1:]:
                            bound = fmin(bound, iv[1])
                        rel_u = rel & (uivs[i][0] < bound)
                    else:
                        bound = others[0][0]
                        for iv in others[1:]:
                            bound = fmax(bound, iv[0])
                        rel_u = rel & (uivs[i][1] > bound)
                if u[0] == "bucket":
                    preds[u[1]] = rel_u
                elif u[0] == "sub":
                    stack.append((u[1], rel_u))
        return preds, substs


def make_tape_culler(scene: CompiledScene, gizmo: bool = False) -> Optional[TapeCuller]:
    """The scene's culler (gizmo slot ``n_imports`` when ``gizmo``), or None
    when the tape has nothing to prune."""
    plan = make_cull_plan(scene, gizmo)
    return None if plan is None else TapeCuller(scene, plan)


def worth_culling(scene: CompiledScene, gizmo: bool = False) -> bool:
    """The JAX package's cost heuristic (cull.py:426-450): a prunable brush
    with a twin costing at least two solo branches.  A necessary condition
    for the cull to pay, not a sufficient one (in open space the nearest,
    hence unprunable, object is often the expensive one)."""
    if make_cull_plan(scene, gizmo) is None:
        return False
    return any(
        iv is not None and leaf_cost(scene, k) >= 2 * SOLO_COST
        for k, iv in enumerate(scene.brush_interval)
    )


def skipped_share(counts) -> float:
    """The share of group evaluations a cull skipped, from the ``counts`` a
    plain culled renderer or grid accumulates (``evals``, ``group_evals``)."""
    return 1.0 - sum(counts["group_evals"]) / (counts["evals"] * len(counts["group_evals"]))


def stack_cull(preds, substs, shape) -> Tuple[torch.Tensor, torch.Tensor]:
    """The culler's lists as ``bool[*shape, G]`` and ``f32[*shape, S]``
    (a predicate or substitute that does not depend on the box broadcasts)."""

    def full(v, dtype):
        t = torch.as_tensor(v, dtype=dtype)
        return t.expand(shape) if t.dim() == 0 else t

    device = next((v.device for v in list(preds) + list(substs) if isinstance(v, torch.Tensor)), "cpu")
    p = torch.stack([full(v, torch.bool).to(device) for v in preds], dim=-1)
    s = torch.stack([full(v, torch.float32).to(device) for v in substs], dim=-1)
    return p, s


def make_culled_sdf(scene: CompiledScene, culler: TapeCuller, field: str = "twin"):
    """``sdf(points f32[N, 3], arrays, preds bool[N, G], substs f32[N, S],
    counts=None) -> f32[N]``: the tape (with the gizmo when the culler has
    it) with each group's brushes evaluated only at the points whose
    predicate holds and every other point of the group's slots given its
    substitute -- the plain version of ``field_sdf_culled``.  ``counts``, a
    dict, accumulates ``evals`` (points) and ``group_evals`` (per group, the
    points that evaluated it)."""
    from .interpreter import brush_bank, eval_context, gizmo_sdf, import_local_coords, make_primary_sdf

    tape = [tuple(int(v) for v in row) for row in np.asarray(scene.arrays.tape)]
    import_slots = [(left, right) for opcode, left, right, _ in tape if opcode == OP_IMPORT]
    plan = culler.plan
    brush_fns = brush_bank(scene, field)
    tape_sdf = make_primary_sdf(scene, gizmo=plan.gizmo, field=field)

    def eval_slot(k, pts, arrays, ctx):
        if k == plan.n_imports:
            return gizmo_sdf(pts)
        brush, obj = import_slots[k]
        return brush_fns[brush](import_local_coords(pts, arrays, obj), ctx)

    def culled_sdf(points, arrays: SceneArrays, preds, substs, counts=None):
        ctx = eval_context(scene, arrays)
        slots = {}
        n_sel = []
        for g, members in enumerate(plan.groups):
            sel = preds[:, g]
            n = int(sel.sum())
            n_sel.append(n)
            for k in members:
                if n == sel.shape[0]:
                    slots[k] = eval_slot(k, points, arrays, ctx)
                    continue
                v = substs[:, k].clone()
                if n:
                    idx = torch.nonzero(sel).squeeze(1)
                    v[idx] = eval_slot(k, points[idx], arrays, ctx)
                slots[k] = v
        if counts is not None:
            counts["evals"] = counts.get("evals", 0) + int(points.shape[0])
            prior = counts.get("group_evals", [0] * len(plan.groups))
            counts["group_evals"] = [a + b for a, b in zip(prior, n_sel)]
        return tape_sdf(points, arrays, slots=slots)

    return culled_sdf
