"""Logo in the PyTorch port against the JAX package, on the CPU: the committed
glyph data, the compiled scene and its artifacts, the baked tables, the exact
letter brush and its baked twin (the kernels' field), the twin-vs-exact
contract, the gradient through the arbitrary data, the evaluator's field rule
and the dense export on both fields.

The JAX Logo is built from matplotlib's DejaVuSansMono-Bold.ttf, named
explicitly: the font of the port's committed glyph data.  (Its default font
can differ, designs/logo.py:43-58 there.)  The renders and the fit are in
test_torch_logo_render.py and test_torch_logo_fit.py.
"""

import dataclasses
import hashlib
import os

import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

from designcsg_tpu import api as japi
from designcsg_tpu import native as jnative
from designcsg_tpu.compiler import ExportConfig as JExportConfig
from designcsg_tpu.evaluator import BatchEvaluator as JBatchEvaluator
from designcsg_tpu.export import pipeline as jpipeline
from designcsg_tpu.ops.interpreter import make_primary_sdf as jmake_primary_sdf
from designcsg_tpu.ops.pallas import make_pallas_point_eval, make_twin_point_eval
from designcsg_tpu.ops.pallas.brushes_kernel import scene_preludes
from designs import logo as jlogo
from designcsg_tpu_torch import api as tapi
from designcsg_tpu_torch import cli
from designcsg_tpu_torch import native as tnative
from designcsg_tpu_torch.compiler import SCENE_ARRAY_FIELDS, ExportConfig
from designcsg_tpu_torch.designs import get_design
from designcsg_tpu_torch.designs import logo as tlogo
from designcsg_tpu_torch.evaluator import BatchEvaluator
from designcsg_tpu_torch.export.pipeline import export_mesh
from designcsg_tpu_torch.ops.interpreter import eval_context, make_primary_sdf

FONT = os.path.join(
    os.path.dirname(matplotlib.__file__), "mpl-data", "fonts", "ttf", "DejaVuSansMono-Bold.ttf"
)


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
    return jlogo.build(font_path=FONT), get_design("logo")


def _points(seed, n, lo=-3.6, hi=3.6):
    return np.random.default_rng(seed).uniform(lo, hi, (n, 3)).astype(np.float32)


def _plate_points(n, seed=5):
    """Points in world space spread over the three letter plates and around
    them (the plates sit at world radius ~3.1, tests/test_logo.py:216)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-3.3, 3.3, (n, 3))
    axis = rng.integers(0, 3, n)
    pts[np.arange(n), axis] = rng.choice([-1.0, 1.0], n) * rng.uniform(2.7, 3.4, n)
    return pts.astype(np.float32)


def test_glyph_data_matches_jax_extractor():
    from fontTools.ttLib import TTFont

    font = TTFont(FONT)
    committed = tlogo.load_glyphs()
    extracted = tlogo.extract_glyphs(FONT, "CSG")
    for letter in "CSG":
        segments, bits = jlogo._glyph_segments_and_mask(font, letter)
        for ours in (committed[letter], extracted[letter]):
            assert ours[0] == [tuple(map(tuple, s)) for s in segments], letter
            np.testing.assert_array_equal(ours[1], bits)
    with np.load(tlogo.GLYPH_DATA) as z:
        with open(FONT, "rb") as fh:
            assert str(z["font_sha256"]) == hashlib.sha256(fh.read()).hexdigest()
        assert int(z["letter_resolution"]) == jlogo.LETTER_RESOLUTION
    assert [len(committed[ch][0]) for ch in "CSG"] == [18, 28, 22]


def test_unknown_letter_names_the_font_route():
    with pytest.raises(KeyError, match="font_path"):
        tlogo.load_glyphs(letters="CX")


def test_arrays_and_artifacts_equal(scenes, tmp_path):
    jscene, tscene = scenes
    for f in SCENE_ARRAY_FIELDS:
        a, b = getattr(tscene.arrays, f), np.asarray(getattr(jscene.arrays, f))
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), f
    assert tscene.num_registers == jscene.num_registers
    assert tscene.ad_chunks == jscene.ad_chunks
    assert tscene.ad_offset("NUMCURVES_C") == jscene.ad_offset("NUMCURVES_C") > 0
    assert tscene.brush_names[5:] == ("letter_C", "letter_S", "letter_G")
    assert tscene.twin_tolerance == 0.02
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    jc = japi.new_design()
    jlogo.build(compiler=jc, font_path=FONT)
    jc.write_artifacts(str(tmp_path / "jax"))
    tc = tapi.new_design()
    tlogo.build(compiler=tc)
    tc.write_artifacts(str(tmp_path / "torch"))
    for name in ("scene.txt", "buildprocedure.txt", "arbitrary_data.hex"):
        assert (tmp_path / "torch" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name


def test_baked_tables_match_jax(scenes):
    jscene, tscene = scenes
    ref = {name: np.asarray(pf(jscene.arrays)) for name, pf in scene_preludes(jscene)}
    assert [name for name, _ in tscene.extras] == list(ref) == ["logo_0_C", "logo_1_S", "logo_2_G"]
    for name, table in tscene.extras:
        assert table.shape == (4 * tlogo.BAKE_RANK, tlogo.BAKE_RES) and table.dtype == np.float32
        np.testing.assert_allclose(table, ref[name], atol=1e-6)


def test_exact_brush_matches_jax(scenes):
    """The exact tape (the affine-min brush) against the JAX jnp tape: atol
    1e-4, and 1e-5 where |sdf| > 0.01 (the affine min cancels near the
    curve)."""
    jscene, tscene = scenes
    pts = np.concatenate([_points(0, 4096), _plate_points(4096)])
    ours = make_primary_sdf(tscene)(torch.from_numpy(pts.copy())).numpy().copy()
    ref = np.array(jmake_primary_sdf(jscene)(jnp.asarray(pts.copy()), jscene.arrays))
    assert (ref < 0).sum() > 100
    np.testing.assert_allclose(ours, ref, atol=1e-4)
    far = np.abs(ref) > 0.01
    np.testing.assert_allclose(ours[far], ref[far], atol=1e-5)


def test_twin_field_matches_jax_twin_and_kernel(scenes):
    """The port's twin tape (the plain version of every Logo kernel) against
    make_twin_point_eval (atol 2e-5, tests/test_logo.py:255) and against the
    Pallas point kernel in interpret mode on 1,024 points."""
    jscene, tscene = scenes
    pts = np.concatenate([_points(1, 4096), _plate_points(4096, seed=6)])
    ours = make_primary_sdf(tscene, field="twin")(torch.from_numpy(pts.copy())).numpy().copy()
    ref = np.array(make_twin_point_eval(jscene)(jnp.asarray(pts.copy()), jscene.arrays))
    np.testing.assert_allclose(ours, ref, atol=2e-5)
    kernel = np.array(
        make_pallas_point_eval(jscene, interpret=True, sub=8)(jnp.asarray(pts[:1024].copy()), jscene.arrays)
    )
    np.testing.assert_allclose(ours[:1024], kernel, atol=2e-5)


def test_twin_contract_on_port_brushes(scenes):
    """tests/test_logo.py:82-125 on the port's own functions: near the
    surface the twin follows the exact brush within 0.02, no phantom surface
    off the glyph, bounded overshoot outside it."""
    _, tscene = scenes
    ctx = eval_context(tscene, tscene.arrays.to_torch("cpu"))
    rng = np.random.default_rng(7)
    n = 8 * 128 * 4
    pts = np.zeros((n, 3), np.float32)
    pts[:, 0] = rng.uniform(-0.8, 0.8, n)
    pts[:, 1] = rng.uniform(-0.8, 0.8, n)
    pts[:, 2] = rng.uniform(0.5, 0.75, n)  # straddles the letter slab
    v = torch.from_numpy(pts)
    for k in (5, 6, 7):
        exact = tscene.brush_fns[k](v, ctx).numpy()
        approx = tscene.brush_twin[k](v, ctx).numpy()
        band = (exact > 1e-3) & (exact < 0.1)
        assert band.sum() > 200
        assert np.abs(approx - exact)[band].max() < tscene.twin_tolerance
        assert approx[exact >= 0.1].min() > 0.02
        assert (approx - exact)[exact > 0].max() < 0.06


def test_ad_gradients_finite_near_surface(scenes):
    """Gradients of the exact tape reach the curve data in ``ad``: finite and
    nonzero at the 16 sampled points nearest the surface, with the points
    where the SDF is exactly 0 dropped (there the JAX package's gradient is
    NaN, ROADMAP F2, and the port's is 0: see the next test)."""
    _, tscene = scenes
    sdf = make_primary_sdf(tscene)
    arrays = tscene.arrays.to_torch("cpu")
    cand = torch.from_numpy(_points(1, 20000))
    vals = sdf(cand, arrays).numpy()
    order = [i for i in np.argsort(np.abs(vals)) if vals[i] != 0][:16]
    ad = arrays.ad.clone().requires_grad_()
    loss = (sdf(cand[order], dataclasses.replace(arrays, ad=ad)) ** 2).sum()
    (g,) = torch.autograd.grad(loss, ad)
    assert torch.isfinite(g).all() and g.abs().sum() > 0


def test_exact_brush_gradient_is_zero_where_d2_not_positive(scenes):
    """The port's deliberate deviation from the JAX package (ROADMAP F2): at
    a point on a curve sample the exact brush's squared distance is <= 0, and
    ``sqrt(max(d2, 0))`` keeps its value, 0, but takes a 0 gradient where
    JAX's is NaN.  Planted at letter C's own samples, on inside bits, with
    the plate clip inactive (local z 0.6)."""
    _, tscene = scenes
    k = tscene.brush_names.index("letter_C")
    arrays = tscene.arrays.to_torch("cpu")
    ad = arrays.ad
    n = int(ad[tscene.ad_offset("NUMCURVES_C")])
    o = tscene.ad_offset("CURVEDATA_C") + 11 * torch.arange(n)
    t = (torch.arange(tlogo.SUBSEGMENTS, dtype=torch.float32) / tlogo.SUBSEGMENTS)[None, :, None]
    a, b, c = (torch.stack([ad[o + j], ad[o + j + 1]], -1)[:, None] for j in (0, 3, 6))
    samples = ((1 - t) * ((1 - t) * a + t * b) + t * ((1 - t) * b + t * c)).reshape(-1, 2)
    v = torch.cat([samples / 2, torch.full((samples.shape[0], 1), 0.6)], -1)
    brush = tscene.brush_fns[k]
    on_curve = brush(v, eval_context(tscene, arrays)) == 0  # d == 0 exactly: d2 <= 0
    assert on_curve.sum() > 100
    vv = v[on_curve].clone().requires_grad_()
    ad_g = ad.clone().requires_grad_()
    out = brush(vv, eval_context(tscene, dataclasses.replace(arrays, ad=ad_g)))
    assert (out == 0).all()
    g_v, g_ad = torch.autograd.grad(out.sum(), (vv, ad_g))
    assert (g_v == 0).all() and (g_ad == 0).all()


def test_evaluator_field_rule(scenes):
    """The JAX package's rule (evaluator.py:45-100): an approximate-twin
    scene defaults to the exact tape; the kernels' field stays available and
    is reported as baked with its tolerance."""
    _, tscene = scenes
    ev = BatchEvaluator(tscene, device="cpu")
    assert not ev.use_kernels and ev.sdf_field == "tape-exact" and ev.twin_tolerance == 0.0
    baked = BatchEvaluator(tscene, device="cpu", use_kernels=True)
    assert baked.use_kernels and baked.sdf_field == "tape-baked" and baked.twin_tolerance == 0.02
    d1 = BatchEvaluator(get_design("design1"), device="cpu", use_kernels=True)
    assert d1.sdf_field == "tape-exact" and d1.twin_tolerance == 0.0
    pts = _plate_points(2048, seed=9)
    np.testing.assert_array_equal(
        baked.eval_sdf_at_points(pts),
        make_primary_sdf(tscene, field="twin")(torch.from_numpy(pts)).numpy(),
    )


@pytest.fixture(scope="module")
def exports(scenes):
    """Dense exports at grid level 5 (bbox 3.5, 3 refine steps, no
    autodetect): JAX's exact, the port's exact and the port's baked.  Both
    sides run their numpy meshing paths, whose weld numbers vertices in
    sorted key order (the native weld numbers them in order of first
    appearance)."""
    jscene, tscene = scenes
    kw = dict(bounding_box_half_diameter=3.5, grid_level=5, minimum_octree_level=5,
              maximum_octree_level=5, gradient_descent_steps=3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "available", lambda: False)
        mp.setattr(tnative, "available", lambda: False)
        jm, jr = jpipeline.export_mesh(
            jscene, JExportConfig(**kw), evaluator=JBatchEvaluator(jscene, use_pallas=False),
            autodetect=False, strategy="dense",
        )
        exact = export_mesh(tscene, ExportConfig(**kw), device="cpu", autodetect=False,
                            strategy="dense")
        baked = export_mesh(
            tscene, ExportConfig(**kw), evaluator=BatchEvaluator(tscene, device="cpu", use_kernels=True),
            autodetect=False, strategy="dense",
        )
    return (jm, jr), exact, baked


def test_exact_export_matches_jax(scenes, exports):
    """Faces equal JAX's exact export, or differ only in cells with a corner
    where the two exact fields disagree in sign at |sdf| < 1e-4 (the affine
    min's rounding)."""
    jscene, tscene = scenes
    (jm, jr), (tm, tr), _ = exports
    assert tr.stats["sdf_field"] == jr.stats["sdf_field"] == "tape-exact"
    assert "twin_tolerance" not in tr.stats
    assert tm.num_faces > 500
    n = (1 << 5) + 1
    axis = np.linspace(-3.5, 3.5, n)
    lattice = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"), -1).reshape(-1, 3)
    lattice = lattice.astype(np.float32)
    ours = make_primary_sdf(tscene)(torch.from_numpy(lattice.copy())).numpy()
    ref = np.array(jmake_primary_sdf(jscene)(jnp.asarray(lattice.copy()), jscene.arrays))
    flips = (ours < 0) != (ref < 0)
    assert np.all(np.abs(ref[flips]) < 1e-4)
    if not flips.any():
        np.testing.assert_array_equal(tm.faces, jm.faces)
        # After 3 refine steps: an FD normal whose stencil straddles the
        # exact brush's jump at the outline (inside -d, outside d - 0.075)
        # turns one rounding into up to ~1e-3 of a Newton step.
        err = np.abs(tm.vertices - jm.vertices)
        assert err.max() < 2e-3 and (err > 1e-4).mean() < 0.01


def test_baked_export_mesh_rule(scenes, exports):
    """tests/test_logo.py:263-292's mesh-level rule for the export on the
    kernels' field against the exact field."""
    _, tscene = scenes
    _, (me, _), (mb, rb) = exports
    assert rb.stats["sdf_field"] == "tape-baked"
    tol = rb.stats["twin_tolerance"]
    assert tol == pytest.approx(0.02)
    assert me.num_faces > 500 and mb.num_faces > 500
    assert abs(me.num_faces - mb.num_faces) < 0.05 * me.num_faces
    exact = make_primary_sdf(tscene)
    twin = make_primary_sdf(tscene, field="twin")
    resid_b = np.abs(exact(torch.from_numpy(np.asarray(mb.vertices, np.float32))).numpy())
    resid_e = np.abs(twin(torch.from_numpy(np.asarray(me.vertices, np.float32))).numpy())
    assert resid_b.max() < 2 * tol and resid_e.max() < 2 * tol

    def directed(a, b):
        out = np.zeros(len(a))
        for s in range(0, len(a), 2048):
            d2 = ((a[s : s + 2048, None, :] - b[None]) ** 2).sum(-1)
            out[s : s + 2048] = np.sqrt(d2.min(axis=1))
        return out

    va, vb = np.asarray(mb.vertices, np.float64), np.asarray(me.vertices, np.float64)
    d_all = np.concatenate([directed(va, vb), directed(vb, va)])
    cell = 2 * 3.5 / 32
    assert np.percentile(d_all, 99) < 0.5 * cell
    assert d_all.max() < 1.5 * cell


def test_cli_renders_logo_on_the_cpu(tmp_path):
    for flags in ([], ["--fast"]):
        png = str(tmp_path / f"logo{len(flags)}.png")
        cli.main(["render", "logo", "--device", "cpu", "--width", "40", "--height", "30", *flags,
                  "-o", png])
        img = cli.read_png(png)
        assert img.shape == (30, 40, 3)
        assert (img != 255).any(-1).mean() > 0.05  # letters (or the gizmo) in view
