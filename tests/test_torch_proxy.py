"""The proxy march and the compacted renderer of the PyTorch port against the
JAX package, on the CPU: the safety rule ``_has_safe_proxies``, Logo's plate
proxy, the proxy prepass, the compacted frame and ``render_scene``'s route
off the kernels.

The JAX Logo is built from matplotlib's DejaVuSansMono-Bold.ttf, the font of
the port's committed glyph data (tests/test_torch_logo.py).  Both renderers
march the exact letter field, whose values differ between the two libraries
by rounding near the surface (the affine min cancels there: up to 1e-4,
tests/test_torch_logo.py::test_exact_brush_matches_jax), which the FD
normals amplify into shading differences of a few 1e-4 on some letter
pixels.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

import designs as jdesigns
from designcsg_tpu.camera import Camera as JCamera
from designcsg_tpu.config import RenderConfig as JRenderConfig
from designcsg_tpu.ops import raymarch as jraymarch
from designs import logo as jlogo
from designcsg_tpu_torch.camera import Camera
from designcsg_tpu_torch.config import RenderConfig
from designcsg_tpu_torch.designs import get_design
from designcsg_tpu_torch.designs import logo as tlogo
from designcsg_tpu_torch.ops import raymarch
from designcsg_tpu_torch.ops.interpreter import eval_context, import_local_coords
from designcsg_tpu_torch.ops.raymarch import camera_rows, project, ray_directions, to_u8

FONT = os.path.join(
    os.path.dirname(matplotlib.__file__), "mpl-data", "fonts", "ttf", "DejaVuSansMono-Bold.ttf"
)
# JAX's compacted-renderer test (tests/test_raymarch.py:199-207).
SMALL = dict(width=48, height=24, max_steps=96, march_overrelax=1.6)


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


def _negate_last_letter(scene):
    """Logo with its last letter negated in the tape (a NEGATE of the
    letter's register right after its IMPORT): the union takes the letter's
    complement, so its proxy sits at negative parity."""
    tape = np.asarray(scene.arrays.tape)
    row = max(i for i, r in enumerate(tape) if r[0] == 0)
    dest = tape[row, 3]
    tape = np.insert(tape, row + 1, [4, dest, 0, dest], axis=0).astype(np.int32)
    return dataclasses.replace(scene, arrays=dataclasses.replace(scene.arrays, tape=tape))


def test_has_safe_proxies_matches_jax(scenes):
    jlogo_scene, tlogo_scene = scenes
    pairs = [
        (jdesigns.get_design("design1"), get_design("design1")),
        (jdesigns.get_design("design2"), get_design("design2")),
        (jlogo_scene, tlogo_scene),
        (_negate_last_letter(jlogo_scene), _negate_last_letter(tlogo_scene)),
    ]
    got = [raymarch._has_safe_proxies(t) for _, t in pairs]
    assert got == [jraymarch._has_safe_proxies(j) for j, _ in pairs]
    assert got == [False, False, True, False]


def test_plate_proxy_bounds_both_letter_fields(scenes):
    """The plate proxy at or below the exact and the baked letter on 2^14
    seeded points around each letter's plate."""
    _, scene = scenes
    arrays = scene.arrays.to_torch("cpu")
    ctx = eval_context(scene, arrays)
    pts = torch.from_numpy(np.random.default_rng(3).uniform(-3.6, 3.6, (1 << 14, 3)).astype(np.float32))
    letters = [(int(b), i) for i, b in enumerate(scene.arrays.shape_id)
               if getattr(scene.brush_fns[int(b)], "__proxy_fn__", None) is not None]
    assert len(letters) == 3
    for brush, obj in letters:
        local = import_local_coords(pts, arrays, obj)
        proxy = tlogo.plate_proxy(local, ctx)
        exact = scene.brush_fns[brush](local, ctx)
        baked = scene.brush_twin[brush](local, ctx)
        assert bool((proxy <= exact).all()) and bool((proxy <= baked).all())
        assert float((proxy < exact - 0.1).float().mean()) > 0.01  # a bound, not the field


def test_proxy_prepass_matches_jax(scenes):
    """The prepass's ``miss`` equal to JAX's on every ray of a 48x24 Logo
    frame, and ``t0`` within 1e-4 on the rest."""
    jscene, tscene = scenes
    config = RenderConfig(width=48, height=24)
    rows = camera_rows(*Camera.initial().as_arrays())
    rays = project(ray_directions(config), *torch.from_numpy(rows[1:])).reshape(-1, 3)
    t0, miss = raymarch.make_proxy_prepass(tscene, config)(
        torch.from_numpy(rows[0]), rays, tscene.arrays.to_torch("cpu"))
    jt0, jmiss = jraymarch.make_proxy_prepass(jscene, JRenderConfig(width=48, height=24))(
        jnp.asarray(rows[0]), jnp.asarray(rays.numpy()), jscene.arrays)
    jt0, jmiss = np.asarray(jt0), np.asarray(jmiss)
    assert 0.05 < jmiss.mean() < 0.95
    np.testing.assert_array_equal(miss.numpy(), jmiss)
    np.testing.assert_allclose(t0.numpy()[~jmiss], jt0[~jmiss], atol=1e-4)


def test_compacted_frame_matches_jax_and_exact_renderer(scenes):
    """The compacted frame at 48x24, 96 steps, omega 1.6:

    * against JAX's compacted frame (the same algorithm on the same field)
      by the port's render rule, max|d| < 1e-3 and the share of |d| > 1e-4
      under 2% (measured on the CPU: max 4.0e-4, 1.8% of pixels, letter
      pixels; the field's rounding, see the module docstring);
    * against the port's own make_renderer(field="exact") by JAX's
      compacted-against-plain rule (tests/test_raymarch.py:202-207): hit
      masks differ on < 0.5% of pixels, < 3% of pixels off by more than 8
      in u8 (measured: 0 and 0.26%)."""
    jscene, tscene = scenes
    config = RenderConfig(**SMALL)
    arrays = tscene.arrays.to_torch("cpu")
    cam = Camera.initial().as_arrays()
    render = raymarch.make_compacted_renderer(tscene, config)
    ours = render(arrays, *cam)
    assert 0 < render.survivors < config.width * config.height
    ref = np.asarray(jraymarch.make_compacted_renderer(jscene, JRenderConfig(**SMALL))(
        jscene.arrays, *(jnp.asarray(a) for a in JCamera.initial().as_arrays())))
    diff = np.abs(ours.numpy() - ref)
    assert (ref != 1.0).any(-1).mean() > 0.05  # letters and gizmo in view
    assert diff.max() < 1e-3
    assert (diff > 1e-4).any(-1).mean() < 0.02

    plain = raymarch.make_renderer(tscene, config, field="exact")(arrays, *cam)
    img_c, img_p = to_u8(ours).numpy().astype(int), to_u8(plain).numpy().astype(int)
    hit_c, hit_p = (img_c < 250).any(-1), (img_p < 250).any(-1)
    assert (hit_c != hit_p).mean() < 5e-3
    assert (np.abs(img_c - img_p).max(-1) > 8).mean() < 0.03


def test_render_scene_routes_proxy_scenes(scenes, monkeypatch):
    """Off the kernels, Logo renders through the compacted renderer, and
    with ``march_proxy=False`` through make_renderer on the exact field
    (raymarch.py:633-651 of the JAX package), each frame bit-equal to the
    frame of its renderer called directly."""
    _, scene = scenes
    calls = []
    for name in ("make_compacted_renderer", "make_renderer"):
        built = getattr(raymarch, name)

        def spy(*args, _built=built, _name=name, **kwargs):
            calls.append((_name, kwargs.get("field")))
            return _built(*args, **kwargs)

        monkeypatch.setattr(raymarch, name, spy)
    config = RenderConfig(width=24, height=16, max_steps=64)
    compacted = raymarch.render_scene(scene, config=config, device="cpu")
    assert calls == [("make_compacted_renderer", None)]
    calls.clear()
    exact = raymarch.render_scene(scene, config=dataclasses.replace(config, march_proxy=False),
                                  device="cpu")
    assert calls == [("make_renderer", "exact")]
    monkeypatch.undo()
    arrays, cam = scene.arrays.to_torch("cpu"), Camera.initial().as_arrays()
    assert torch.equal(compacted, raymarch.make_compacted_renderer(scene, config)(arrays, *cam))
    assert torch.equal(exact, raymarch.make_renderer(scene, config, field="exact")(arrays, *cam))


def test_two_phase_march_matches_jax(scenes):
    """make_march with ``march_proxy=True`` (the two-phase march,
    raymarch.py:184-216 of the JAX package) on the exact field: the same
    hit set as JAX's on a 24x16 frame at 64 steps, hit distances within
    1e-4, and every hit of the one-phase march kept within 2*sdf_epsilon."""
    jscene, tscene = scenes
    kw = dict(width=24, height=16, max_steps=64, march_proxy=True)
    config = RenderConfig(**kw)
    rows = camera_rows(*Camera.initial().as_arrays())
    rays = project(ray_directions(config), *torch.from_numpy(rows[1:]))
    arrays = tscene.arrays.to_torch("cpu")
    d = raymarch.make_march(tscene, config, field="exact")(torch.from_numpy(rows[0]), rays, arrays)
    jd = np.asarray(jax.jit(jraymarch.make_march(jscene, JRenderConfig(**kw, use_pallas_march=False)))(
        jnp.asarray(rows[0]), jnp.asarray(rays.numpy()), jscene.arrays))
    assert (jd > 0).sum() > 20
    np.testing.assert_array_equal(d.numpy() > 0, jd > 0)
    np.testing.assert_allclose(d.numpy()[jd > 0], jd[jd > 0], atol=1e-4)
    one = raymarch.make_march(tscene, dataclasses.replace(config, march_proxy=None), field="exact")(
        torch.from_numpy(rows[0]), rays, arrays)
    hit = one > 0
    assert bool((d[hit] > 0).all())  # hit-preserving (the prepass may also finish rays
    # that the one-phase march leaves out of steps)
    assert float((one - d).abs()[hit].max()) < 2 * config.sdf_epsilon
