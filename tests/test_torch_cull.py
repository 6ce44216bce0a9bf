"""The exact per-tile cull (K7, ops/cull.py) against the JAX package's culler,
on the CPU: the static groups, the predicates and substitutes on random
boxes, the culled tape against the full one, and the soundness of every
interval twin on both fields (the exact brush and the baked twin the kernels
evaluate).

The JAX Logo is built from matplotlib's DejaVuSansMono-Bold.ttf, the font of
the port's committed glyph data (as in test_torch_logo.py).
"""

import dataclasses
import os

import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

import designs as jdesigns
from designcsg_tpu.brushes import EvalContext as JEvalContext
from designcsg_tpu.ops.pallas import cull as jcull
from designcsg_tpu.ops.pallas.tape import array_bank_reader as jbank_reader
from designs import library as jlibrary
from designs import logo as jlogo
from designcsg_tpu_torch import brushes as tbrushes
from designcsg_tpu_torch.designs import get_design
from designcsg_tpu_torch.designs import library as tlibrary
from designcsg_tpu_torch.designs import logo as tlogo
from designcsg_tpu_torch.ops import cull
from designcsg_tpu_torch.ops.interpreter import eval_context, make_primary_sdf

FONT = os.path.join(
    os.path.dirname(matplotlib.__file__), "mpl-data", "fonts", "ttf", "DejaVuSansMono-Bold.ttf"
)
DESIGNS = ("design1", "design2", "logo")
# Box corners are drawn in [-R, R]^3 of world space, R about each design's
# extent, so that some boxes hold surface and some lie away from it.
RADIUS = {"design1": 3.0, "design2": 2.0, "logo": 3.5}
# Design2's Hilbert bound (Lipschitz, far field R = 1.3) lets a box skip it
# only far from the sculpture: half of its boxes are drawn below the base.
FAR = {"design2": ((-9.0, -12.0, -9.0), (-3.0, -9.5, -3.0))}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per test process: the suite runs one process per
    worker, and a default-sized thread pool in each oversubscribes the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name in DESIGNS:
        jscene = jlogo.build(font_path=FONT) if name == "logo" else jdesigns.get_design(name)
        out[name] = (jscene, get_design(name))
    return out


def _boxes(name, n=16, seed=3):
    """lo, hi f32[n, 3]: random world boxes, half of them small."""
    rng = np.random.default_rng(seed)
    r = RADIUS[name]
    lo = rng.uniform(-r, r, (n, 3))
    size = rng.uniform(0.05, 1.5, (n, 3)) * np.where(np.arange(n) % 2, 1.0, 0.2)[:, None]
    if name in FAR:
        lo[1::2] = rng.uniform(*FAR[name], (n // 2, 3))
        size[1::2] *= 0.2
    return lo.astype(np.float32), (lo + size).astype(np.float32)


@pytest.mark.parametrize("gizmo", [False, True])
@pytest.mark.parametrize("name", DESIGNS)
def test_groups_match_jax(scenes, name, gizmo):
    """The port's cost-aware partition (Brush.cuda_flops plus the frame
    transform against 120) gives the JAX package's groups (jaxpr size
    against 120)."""
    jscene, tscene = scenes[name]
    ours = cull.make_tape_culler(tscene, gizmo=gizmo)
    ref = jcull.make_tape_culler(jscene, gizmo=gizmo)
    assert ours.groups == ref.groups and ours.n_slots == ref.n_slots
    assert len(ours.groups) >= 2


def _unwidened(tscene):
    """The scene with the JAX package's letter bounds (no F4 widening)."""
    intervals = list(tscene.brush_interval)
    for k, iv in enumerate(intervals):
        if hasattr(iv, "anchors"):
            intervals[k] = tlogo._letter_interval(iv.anchors, widen=0.0)[0]
    return dataclasses.replace(tscene, brush_interval=tuple(intervals))


def _port_cull(tscene, lo, hi):
    culler = cull.make_tape_culler(tscene, gizmo=True)
    preds, substs = culler(
        tuple((torch.from_numpy(lo[:, i]), torch.from_numpy(hi[:, i])) for i in range(3)),
        cull.array_bank_reader(tscene.arrays),
        eval_context(tscene, tscene.arrays.to_torch("cpu")),
    )
    p, s = cull.stack_cull(preds, substs, (len(lo),))
    return p.numpy(), s.numpy()


@pytest.mark.parametrize("name", DESIGNS)
def test_preds_and_substs_match_jax(scenes, name):
    """On 16 random boxes per design (one batched call each), the port's
    predicates equal JAX's and its substitutes lie within 1e-6 relative.
    Logo is compared without the port's widening of the letter bounds (F4);
    with it, the port skips a subset of what JAX skips."""
    jscene, tscene = scenes[name]
    lo, hi = _boxes(name)
    ref = jcull.make_tape_culler(jscene, gizmo=True)
    jpreds, jsubsts = ref(
        tuple((jnp.asarray(lo[:, i]), jnp.asarray(hi[:, i])) for i in range(3)),
        jbank_reader(jscene.arrays),
        JEvalContext(ad=jnp.asarray(jscene.arrays.ad)),
    )
    jp = np.stack([np.broadcast_to(np.asarray(v), (len(lo),)) for v in jpreds], -1)
    js = np.stack([np.broadcast_to(np.asarray(v, np.float32), (len(lo),)) for v in jsubsts], -1)
    p, s = _port_cull(_unwidened(tscene) if name == "logo" else tscene, lo, hi)
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_allclose(s, js, rtol=1e-6, atol=0)
    assert (~jp).any(), "no box prunes a group"
    if name == "logo":
        widened, _ = _port_cull(tscene, lo, hi)
        assert (widened >= jp).all()


@pytest.mark.parametrize("name", DESIGNS)
def test_culled_tape_equals_full_tape(scenes, name):
    """In every box, the culled plain tape (skipped slots given their
    substitutes) equals the full plain tape with the gizmo bit for bit, and
    some box prunes a group."""
    _, tscene = scenes[name]
    culler = cull.make_tape_culler(tscene, gizmo=True)
    culled = cull.make_culled_sdf(tscene, culler, field="twin")
    full = make_primary_sdf(tscene, gizmo=True, field="twin")
    arrays = tscene.arrays.to_torch("cpu")
    bank, ctx = cull.array_bank_reader(arrays), eval_context(tscene, arrays)
    lo, hi = _boxes(name, seed=7)
    rng = np.random.default_rng(11)
    pruned = 0
    for b in range(len(lo)):
        box = tuple((float(lo[b, i]), float(hi[b, i])) for i in range(3))
        box = tuple((torch.tensor([a]), torch.tensor([c])) for a, c in box)
        preds, substs = cull.stack_cull(*culler(box, bank, ctx), (1,))
        pts = torch.from_numpy(rng.uniform(lo[b], hi[b], (64, 3)).astype(np.float32))
        pts[:8] = torch.from_numpy(np.stack(
            [np.where([i & 1, i & 2, i & 4], hi[b], lo[b]) for i in range(8)]).astype(np.float32))
        counts = {}
        got = culled(pts, arrays, preds.expand(64, -1), substs.expand(64, -1), counts)
        torch.testing.assert_close(got, full(pts, arrays), rtol=0, atol=0)
        pruned += int((~preds).sum())
        assert counts["evals"] == 64
    assert pruned > 0, "no box prunes a group"


def _library_twins():
    return [
        ("sphere", tbrushes.sphere_brush_fn, cull.sphere_interval),
        ("cylinder", tbrushes.cylinder_brush_fn, cull.cylinder_interval),
        ("box", tbrushes.box_brush_fn, cull.box_interval),
        ("rounded_box", tlibrary._rounded_box_fn, tlibrary._rounded_box_interval),
        ("torus", tlibrary._torus_fn, tlibrary._torus_interval),
    ]


def test_builtin_and_library_twins_sound():
    """The builtin and library interval twins enclose their brushes on random
    boxes (cull.verify_interval_twin), as JAX's registered twins do."""
    for label, fn, interval in _library_twins():
        worst = cull.verify_interval_twin(fn, interval, radius=2.0, n_boxes=128, samples_per_box=32)
        assert worst <= 1e-5, f"{label}: interval twin violated by {worst}"
    # The library's twins are JAX's formulas: equal bounds on the same boxes.
    lo, hi = _boxes("design2", n=32)
    ivs = tuple((torch.from_numpy(lo[:, i]), torch.from_numpy(hi[:, i])) for i in range(3))
    jivs = tuple((jnp.asarray(lo[:, i]), jnp.asarray(hi[:, i])) for i in range(3))
    for ours, ref in ((tlibrary._rounded_box_interval, jcull.INTERVAL_BRUSHES[jlibrary._rounded_box_fn]),
                      (tlibrary._torus_interval, jcull.INTERVAL_BRUSHES[jlibrary._torus_fn])):
        for a, b in zip(ours(*ivs, None), ref(*jivs, None)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("field", ["exact", "twin"])
@pytest.mark.parametrize("name", DESIGNS)
def test_design_twins_sound(scenes, name, field):
    """Every interval twin a design uses encloses its brush on random boxes
    (tests/test_pallas.py:475-495's sizes) on both fields: the exact brush
    and the twin the kernels evaluate (Logo's baked letters, within the
    widened upper bound, F4)."""
    _, tscene = scenes[name]
    ctx = eval_context(tscene, tscene.arrays.to_torch("cpu"))
    bank = tscene.brush_fns if field == "exact" else tscene.brush_twin
    checked = 0
    for k in sorted({int(b) for b in tscene.arrays.shape_id}):
        interval = tscene.brush_interval[k]
        assert interval is not None and tscene.brush_interval_cuda[k]
        worst = cull.verify_interval_twin(bank[k], interval, radius=3.0, n_boxes=64,
                                          samples_per_box=24, ctx=ctx)
        assert worst <= 1e-5, f"{tscene.brush_names[k]} ({field}): interval twin violated by {worst}"
        checked += 1
    assert checked >= 2


def _anchor_boxes(anchors):
    """Tiny to THICKNESS-sized boxes at each anchor on the plate's mid-plane
    (tests/test_pallas.py:498-536)."""
    centers = np.concatenate([anchors / 2.0, np.full((len(anchors), 1), 1.25 / 2.0)], axis=1)
    halves = (1e-4, tlogo.THICKNESS / 8, tlogo.THICKNESS / 2, tlogo.THICKNESS)
    return (np.concatenate([centers - h for h in halves]), np.concatenate([centers + h for h in halves]))


def _plate_boxes(n=1000, seed=1):
    """Small boxes over a letter's plate in local coordinates, where the baked
    field departs from the exact one."""
    rng = np.random.default_rng(seed)
    c = np.concatenate([rng.uniform(-0.7, 0.7, (n, 2)), rng.uniform(0.55, 0.7, (n, 1))], axis=1)
    h = rng.uniform(0.002, 0.08, (n, 3))
    return c - h, c + h


def test_logo_anchors_match_jax_and_targeted_boxes_pass(scenes):
    """Logo's 12 anchors per letter equal JAX's (``__anchors__``), and boxes
    aimed at every anchor and over the plates pass the fuzz on both fields."""
    jscene, tscene = scenes["logo"]
    ctx = eval_context(tscene, tscene.arrays.to_torch("cpu"))
    letters = sorted({int(b) for b in tscene.arrays.shape_id if tscene.brush_names[int(b)].startswith("letter_")})
    assert len(letters) == 3
    for k in letters:
        ours = tscene.brush_interval[k].anchors
        ref = jcull.INTERVAL_BRUSHES[jscene.brush_fns[k]].__anchors__
        np.testing.assert_array_equal(ours, ref)
        assert ours.shape == (12, 2)
        for fn in (tscene.brush_fns[k], tscene.brush_twin[k]):
            for boxes in (_anchor_boxes(ours), _plate_boxes()):
                worst = cull.verify_interval_twin(fn, tscene.brush_interval[k], samples_per_box=32,
                                                  ctx=ctx, boxes=boxes)
                assert worst <= 1e-5, f"{tscene.brush_names[k]}: targeted violation {worst}"


def test_letter_bound_without_widening_escapes_baked_field(scenes):
    """F4 (ROADMAP.md section 3): the JAX package's letter bound,
    ``max(min_a |p - a| - THICKNESS, 0)``, holds for the exact letter but
    not for the baked twin every kernel evaluates -- near the plates the
    baked field lies above it by more than 1e-3.  The port's bound, widened
    by ``twin_approx``, holds for both (test_logo_anchors_... above)."""
    jscene, tscene = scenes["logo"]
    ctx = eval_context(tscene, tscene.arrays.to_torch("cpu"))
    worst_twin = worst_exact = 0.0
    for k in (5, 6, 7):
        jtwin = jcull.INTERVAL_BRUSHES[jscene.brush_fns[k]]

        def jax_bound(ia, ib, ic, _ctx, jtwin=jtwin):
            lo, hi = jtwin(*((jnp.asarray(a.numpy()), jnp.asarray(b.numpy())) for a, b in (ia, ib, ic)), None)
            return torch.tensor(np.asarray(lo)), torch.tensor(np.asarray(hi))

        unwidened, _ = tlogo._letter_interval(tscene.brush_interval[k].anchors, widen=0.0)
        for bound in (jax_bound, unwidened):
            worst_twin = max(worst_twin, cull.verify_interval_twin(
                tscene.brush_twin[k], bound, samples_per_box=32, ctx=ctx, boxes=_plate_boxes()))
            worst_exact = max(worst_exact, cull.verify_interval_twin(
                tscene.brush_fns[k], bound, samples_per_box=32, ctx=ctx, boxes=_plate_boxes()))
    assert worst_twin > 1e-3
    assert worst_exact <= 1e-5


def test_lipschitz_twin_and_worth_culling_match_jax(scenes):
    """Design2's Hilbert twin (anchor, L = 3, R = 1.3) takes the same c0 as
    JAX's, and the cost heuristic answers as JAX's for every design."""
    jscene, tscene = scenes["design2"]
    hilbert = tscene.brush_interval[5]
    jfn = jscene.brush_fns[5]
    c0 = float(np.asarray(jfn(jnp.asarray([hilbert.anchor], jnp.float32), JEvalContext())).reshape(()))
    assert hilbert.c0 == c0 and hilbert.lipschitz == 3.0
    for name in DESIGNS:
        jscene, tscene = scenes[name]
        for gizmo in (False, True):
            assert cull.worth_culling(tscene, gizmo) == jcull.worth_culling(jscene, gizmo), name


def test_scene_without_prunable_structure_has_no_culler():
    """Fewer than three slots, or no group: no culler (cull.py:467-519)."""
    from designcsg_tpu_torch import api

    c = api.new_design()
    api.draw(api.sphere_brush(), api.Transform.identity(), compiler=c)
    scene = c.commit()
    assert cull.make_tape_culler(scene, gizmo=False) is None
    assert cull.make_tape_culler(scene, gizmo=True) is not None
