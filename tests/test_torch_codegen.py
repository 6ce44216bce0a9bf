"""Host build of the generated CUDA scene code.

Every per-point function the kernels inline (brushes, the unrolled tape, the
gizmo, shading, the per-pixel march, the cone prepass's per-ray march, the
fit's per-ray march with its closest approach) is
``HD``: plain inline C++ under a host compiler.  Here Design1's and Design2's
generated sources are compiled with g++ beside a tiny C harness
(csrc/host_harness.cpp), loaded with ctypes and held against the plain
PyTorch versions — the one check of the generated arithmetic that runs
without a card.  Logo's sources carry K6 (csrc/table.cuh) inside every one
of these functions, so its host build runs K6's own C++ here.  All host-build
cases stay in this file (one xdist worker).
"""

import ctypes
import dataclasses
import shutil
import subprocess

import numpy as np
import pytest
import torch

from designcsg_tpu_torch import api
from designcsg_tpu_torch.camera import Camera
from designcsg_tpu_torch.config import RenderConfig
from designcsg_tpu_torch.designs import get_design
from designcsg_tpu_torch.evaluator import BatchEvaluator
from designcsg_tpu_torch.ops import cull
from designcsg_tpu_torch.ops.cuda.build import csrc
from designcsg_tpu_torch.ops.cuda.sdf_kernel import make_grid_eval
from designcsg_tpu_torch.ops.cuda.tape import cull_chain_ops, cull_mode, scene_source, sdf_kernel_source
from designcsg_tpu_torch.ops.interpreter import eval_context, make_normal_fn, make_primary_sdf
from designcsg_tpu_torch.ops.raymarch import (
    camera_rows,
    coarse_ray_uv,
    hoisted_boxes,
    make_cone_march,
    make_march,
    make_renderer,
    project,
    ray_directions,
)
from designcsg_tpu_torch.ops.table import plane_sample

_P = ctypes.c_void_p
RENDER = RenderConfig(width=128, height=32, max_steps=80)
# The fast viewport at a size F = 5 divides: over-relaxed, cone prepass.
FAST = RenderConfig(width=160, height=120, max_steps=96, march_overrelax=1.6,
                    march_hierarchical=True)
# The fit's ray march: no gizmo, tests/test_pallas.py:143's size.
FIT = RenderConfig(width=128, height=32, max_steps=80, gizmo=False)
# Logo's renderer at tests/test_logo.py:172's size.
LOGO_RENDER = RenderConfig(width=32, height=32, max_steps=48)
# The culled renderer (K7) at 64x48: 16x2 warp tiles, 4 by 24 of them.
CULL = RenderConfig(width=64, height=48, max_steps=80, march_cull=True)
CULL_DYNAMIC = RenderConfig(width=64, height=48, max_steps=80, march_cull="dynamic")
# Logo close up and head on with a short march range, where the hoisted
# cull leaves groups out (from the orbited cameras it leaves none out).
CULL_NEAR = RenderConfig(width=64, height=48, max_steps=80, max_distance=8.0, march_cull=True)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per test process: the suite runs one process per
    worker, and a default-sized thread pool in each oversubscribes the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """{(design, kind): ctypes library} built in parallel from each design's
    generated source: "sdf" (the k2 field), "gizmo" (Design1's k1 field with
    the exact-march renderer), "fast" (the k1 field with the over-relaxed
    renderer and the cone march) and "fit" (the field without the gizmo and
    the exact march of the fit's ray-march kernel)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler (g++) to build the generated source")
    scenes = {name: get_design(name) for name in ("design1", "design2", "logo")}
    builds = {
        ("design1", "sdf"): scene_source(scenes["design1"]),
        ("design1", "gizmo"): "#define HOST_RENDER\n" + scene_source(scenes["design1"], RENDER),
        ("design1", "fast"): "#define HOST_RENDER\n" + scene_source(scenes["design1"], FAST),
        ("design2", "sdf"): scene_source(scenes["design2"]),
        ("design2", "fast"): "#define HOST_RENDER\n" + scene_source(scenes["design2"], FAST),
        ("design1", "fit"): "#define HOST_RENDER\n" + scene_source(scenes["design1"], FIT),
        ("design2", "fit"): "#define HOST_RENDER\n" + scene_source(scenes["design2"], FIT),
        ("logo", "sdf"): scene_source(scenes["logo"]),
        ("logo", "render"): "#define HOST_RENDER\n" + scene_source(scenes["logo"], LOGO_RENDER),
        ("logo", "fit"): "#define HOST_RENDER\n" + scene_source(scenes["logo"], FIT),
        # K7: the point/grid unit's cull (no gizmo) and the culled renderers.
        ("design1", "sdf_cull"): scene_source(scenes["design1"], cull=1),
        ("design2", "sdf_cull"): scene_source(scenes["design2"], cull=1),
        ("logo", "sdf_cull"): scene_source(scenes["logo"], cull=1),
        ("design1", "cull"): "#define HOST_RENDER\n" + scene_source(scenes["design1"], CULL, cull=1),
        ("logo", "cull"): "#define HOST_RENDER\n" + scene_source(scenes["logo"], CULL, cull=1),
        ("design2", "cull_dynamic"): "#define HOST_RENDER\n"
        + scene_source(scenes["design2"], CULL_DYNAMIC, cull=cull_mode(CULL_DYNAMIC)),
        ("design1", "render64"): "#define HOST_RENDER\n"
        + scene_source(scenes["design1"], dataclasses.replace(CULL, march_cull=None)),
        ("design2", "render64"): "#define HOST_RENDER\n"
        + scene_source(scenes["design2"], dataclasses.replace(CULL, march_cull=None)),
        ("logo", "cull_near"): "#define HOST_RENDER\n" + scene_source(scenes["logo"], CULL_NEAR, cull=1),
        ("logo", "render_near"): "#define HOST_RENDER\n"
        + scene_source(scenes["logo"], dataclasses.replace(CULL_NEAR, march_cull=None)),
    }
    out = tmp_path_factory.mktemp("host_build")
    running = {}
    for (name, kind), text in builds.items():
        src = out / f"{name}_{kind}.cpp"
        src.write_text(text + "\n" + csrc("host_harness.cpp"))
        so = out / f"{name}_{kind}.so"
        cmd = [gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-o", str(so), str(src)]
        running[(name, kind)] = (subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True), so)
    libs = {}
    for key, (proc, so) in running.items():
        _, err = proc.communicate()
        assert proc.returncode == 0, err
        lib = ctypes.CDLL(str(so))
        lib.host_point_eval.argtypes = [_P, _P, ctypes.c_longlong, _P, _P, _P]
        lib.host_point_eval_fd.argtypes = [_P, _P, _P, ctypes.c_longlong, _P, _P, _P]
        lib.host_plane_sample.argtypes = [_P, ctypes.c_longlong, _P, _P, _P]
        if "cull" in key[1]:
            lib.host_cull_tile.argtypes = [_P] * 6
        if "cull" in key[1] and not key[1].startswith("sdf"):
            lib.host_hoisted_box.argtypes = [_P] + [ctypes.c_int] * 4 + [_P] * 2
        if key[1] == "sdf_cull":
            lib.host_grid_eval_cull.argtypes = [_P] + [ctypes.c_int] * 3 + [ctypes.c_float] * 5 + [_P] * 3
        if not key[1].startswith("sdf"):
            lib.host_render.argtypes = [_P, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P]
            lib.host_cone_march.argtypes = [_P, ctypes.c_longlong, _P, _P, _P, _P, _P]
            lib.host_ray_march.argtypes = [_P, _P, ctypes.c_longlong, _P, _P, _P, _P, _P]
        libs[key] = lib
    return scenes, libs


def _bank(arrays):
    """The interleaved per-object bank a kernel keeps in shared memory."""
    return np.ascontiguousarray(
        np.concatenate([arrays.position, arrays.right, arrays.up, arrays.forward], axis=1),
        np.float32,
    )


def _extras(scene):
    """The scene's extra tables as the kernels get them (None without)."""
    flat, _ = scene.device_extras("cpu")
    return None if flat is None else flat.numpy()


def _ptr(a):
    return None if a is None else a.ctypes.data


def _point_eval(lib, scene, pts):
    out = np.empty(len(pts), np.float32)
    bank, ad = _bank(scene.arrays), scene.arrays.ad
    lib.host_point_eval(pts.ctypes.data, out.ctypes.data, len(pts), bank.ctypes.data, ad.ctypes.data,
                        _ptr(_extras(scene)))
    return out


def _render(lib, scene, config, cam_arrays, t0=None):
    cam = np.ascontiguousarray(camera_rows(*cam_arrays), np.float32)
    img = np.empty((config.height, config.width, 3), np.float32)
    t0 = None if t0 is None else np.ascontiguousarray(t0, np.float32)
    lib.host_render(
        img.ctypes.data, config.height, config.width, cam.ctypes.data,
        _bank(scene.arrays).ctypes.data, scene.arrays.ad.ctypes.data,
        _ptr(_extras(scene)), _ptr(t0),
    )
    return img


def _assert_render_close(img, ref):
    # The rule of tests/test_pallas.py:115-116,133-134.
    diff = np.abs(img - ref)
    assert diff.max() < 1e-3
    assert (diff > 1e-4).mean() < 0.01


def _coarse_rays(config, cam_arrays):
    rows = camera_rows(*cam_arrays)
    frame = torch.from_numpy(rows[1:])
    return rows[0], project(torch.from_numpy(coarse_ray_uv(config)), *frame)


@pytest.mark.parametrize("gizmo", [False, True])
def test_generated_tape_matches_plain(host_libs, gizmo):
    scenes, libs = host_libs
    scene = scenes["design1"]
    pts = np.random.default_rng(0).uniform(-6, 6, (4096, 3)).astype(np.float32)
    out = _point_eval(libs[("design1", "gizmo" if gizmo else "sdf")], scene, pts)
    ref = make_primary_sdf(scene, gizmo=gizmo)(torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_generated_design2_tape_matches_plain(host_libs):
    scenes, libs = host_libs
    scene = scenes["design2"]
    pts = np.random.default_rng(1).uniform(-2.5, 2.5, (4096, 3)).astype(np.float32)
    for kind, gizmo in (("sdf", False), ("fast", True)):
        out = _point_eval(libs[("design2", kind)], scene, pts)
        ref = make_primary_sdf(scene, gizmo=gizmo)(torch.from_numpy(pts)).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-5)


def test_generated_render_pixel_matches_plain(host_libs):
    scenes, libs = host_libs
    scene = scenes["design1"]
    cam_arrays = Camera.initial().as_arrays()
    img = _render(libs[("design1", "gizmo")], scene, RENDER, cam_arrays)
    ref = make_renderer(scene, RENDER)(scene.arrays.to_torch("cpu"), *cam_arrays).numpy()
    _assert_render_close(img, ref)


@pytest.mark.parametrize("name", ["design1", "design2"])
def test_generated_overrelaxed_render_matches_plain(host_libs, name):
    scenes, libs = host_libs
    scene = scenes[name]
    cam_arrays = Camera.initial().as_arrays()
    img = _render(libs[(name, "fast")], scene, FAST, cam_arrays)
    ref = make_renderer(scene, FAST)(scene.arrays.to_torch("cpu"), *cam_arrays).numpy()
    _assert_render_close(img, ref)


@pytest.mark.parametrize("name", ["design1", "design2"])
def test_generated_cone_and_t0_render_match_plain(host_libs, name):
    """The per-ray cone march on the block-centre rays, then the per-pixel
    over-relaxed march from the resulting t0 plane."""
    scenes, libs = host_libs
    scene, lib = scenes[name], libs[(name, "fast")]
    cam_arrays = Camera.initial().orbit(0.3, -0.2).as_arrays()
    o_proj, rays = _coarse_rays(FAST, cam_arrays)
    arrays = scene.arrays.to_torch("cpu")
    ref = make_cone_march(scene, FAST)(arrays, o_proj, rays).numpy()
    rays = np.ascontiguousarray(rays.numpy())
    t_safe = np.empty(rays.shape[:-1], np.float32)
    lib.host_cone_march(
        t_safe.ctypes.data, t_safe.size, rays.ctypes.data, np.ascontiguousarray(o_proj).ctypes.data,
        _bank(scene.arrays).ctypes.data, scene.arrays.ad.ctypes.data, _ptr(_extras(scene)),
    )
    far = FAST.max_distance
    assert ((t_safe > far) == (ref > far)).mean() >= 0.99
    both = (t_safe <= far) & (ref <= far)
    assert np.abs(t_safe - ref)[both].max() <= 1e-4
    assert (ref > 0).any() and (ref < far).any()

    f = FAST.hierarchical_factor
    t0 = np.repeat(np.repeat(ref, f, axis=0), f, axis=1)
    img = _render(lib, scene, FAST, cam_arrays, t0)
    plain = make_renderer(scene, FAST)(arrays, *cam_arrays, t0=torch.from_numpy(t0)).numpy()
    _assert_render_close(img, plain)


@pytest.mark.parametrize("kind", ["fit", "fast"])
@pytest.mark.parametrize("name", ["design1", "design2"])
def test_generated_ray_march_matches_plain(host_libs, name, kind):
    """The per-ray march with closest approach (``march_ray_closest``: exact
    without the gizmo, and over-relaxed with it) against the plain
    ``make_march(return_closest=True)`` on the same rays: identical hit sets,
    d and vmin within 1e-5 (tests/test_pallas.py:153-156)."""
    scenes, libs = host_libs
    scene, config = scenes[name], FIT if kind == "fit" else FAST
    rows = camera_rows(*Camera.initial().orbit(0.2, -0.1).as_arrays())
    rays = project(ray_directions(config), *torch.from_numpy(rows[1:]))
    d_ref, vmin_ref = make_march(scene, config)(
        torch.from_numpy(rows[0]), rays, scene.arrays.to_torch("cpu"), return_closest=True)
    rays = np.ascontiguousarray(rays.numpy())
    d = np.empty(rays.shape[:-1], np.float32)
    vmin = np.empty(rays.shape, np.float32)
    libs[(name, kind)].host_ray_march(
        d.ctypes.data, vmin.ctypes.data, d.size, rays.ctypes.data,
        np.ascontiguousarray(rows[0]).ctypes.data, _bank(scene.arrays).ctypes.data,
        scene.arrays.ad.ctypes.data, _ptr(_extras(scene)),
    )
    d_ref, vmin_ref = d_ref.numpy(), vmin_ref.numpy()
    assert ((d > 0) == (d_ref > 0)).all()
    assert (d_ref > 0).any() and (d_ref < 0).any()
    np.testing.assert_allclose(d, d_ref, atol=1e-5)
    np.testing.assert_allclose(vmin, vmin_ref, atol=1e-5)


def test_generated_logo_k6_matches_plain_twin(host_libs):
    """K6 on the host: Logo's generated tape (three letters, each sampling its
    baked planes through ``plane_sample``) against the plain twin tape within
    1e-6, and away from the exact brush where the twin differs from it."""
    scenes, libs = host_libs
    scene = scenes["logo"]
    rng = np.random.default_rng(2)
    pts = rng.uniform(-3.4, 3.4, (8192, 3))
    axis = rng.integers(0, 3, len(pts))
    pts[np.arange(len(pts)), axis] = rng.choice([-1.0, 1.0], len(pts)) * rng.uniform(2.8, 3.3, len(pts))
    pts = pts.astype(np.float32)
    out = _point_eval(libs[("logo", "sdf")], scene, pts)
    ref = make_primary_sdf(scene, field="twin")(torch.from_numpy(pts)).numpy()
    exact = make_primary_sdf(scene)(torch.from_numpy(pts)).numpy()
    assert (ref < 0).sum() > 100
    np.testing.assert_allclose(out, ref, atol=1e-6)
    assert np.abs(out - exact).max() > 1e-3


def test_host_plane_sample_bit_equal_to_plain(host_libs):
    """K6's C++ (csrc/table.cuh ``plane_sample``, every product and sum
    rounded on its own) against ops/table.py's plain version on each
    letter's planes: the same bits."""
    scenes, libs = host_libs
    rng = np.random.default_rng(6)
    gx, gy = rng.uniform(-1.0, 128.0, (2, 65536)).astype(np.float32)
    for name, planes in scenes["logo"].derived_extras:
        planes = np.ascontiguousarray(planes, np.float32)
        out = np.empty(len(gx), np.float32)
        libs[("logo", "sdf")].host_plane_sample(out.ctypes.data, len(gx), planes.ctypes.data,
                                                gx.ctypes.data, gy.ctypes.data)
        ref = plane_sample(torch.from_numpy(planes), torch.from_numpy(gx), torch.from_numpy(gy))
        np.testing.assert_array_equal(out, ref.numpy(), err_msg=name)


# The host units of each design without and with the gizmo in their field.
FIELD_UNITS = {("design1", False): "sdf", ("design1", True): "gizmo", ("design2", False): "sdf",
               ("design2", True): "fast", ("logo", False): "sdf", ("logo", True): "render"}


@pytest.mark.parametrize("gizmo", [False, True])
@pytest.mark.parametrize("name", ["design1", "design2", "logo"])
def test_host_point_eval_fd_matches_point_eval_and_normal(host_libs, name, gizmo):
    """K1's FD form on the host (csrc/common.cuh ``sdf_fd_normal``): the SDF
    and normal equal, bit for bit, the host point evaluation composed with
    the plain FD glue (ops/interpreter.py ``make_normal_fn``), and the plain
    tape composed with the same glue within 1e-6 and 1e-4 (PyTorch's float32
    square root on the CPU, inside the brushes, can be an ulp off C's; the
    normal divides field differences by 0.01)."""
    scenes, libs = host_libs
    scene, lib = scenes[name], libs[(name, FIELD_UNITS[(name, gizmo)])]
    half = 3.4 if name == "logo" else 6.0
    pts = np.random.default_rng(7).uniform(-half, half, (4096, 3)).astype(np.float32)
    pts[:64, 1] = -0.0  # the glue's +0 turns -0 into +0; so must the kernel's
    out, normal = np.empty(len(pts), np.float32), np.empty((len(pts), 3), np.float32)
    bank, ex = _bank(scene.arrays), _extras(scene)
    lib.host_point_eval_fd(pts.ctypes.data, out.ctypes.data, normal.ctypes.data, len(pts),
                           bank.ctypes.data, scene.arrays.ad.ctypes.data, _ptr(ex))

    def host_point_eval(p, arrays=None):
        return torch.from_numpy(_point_eval(lib, scene, np.ascontiguousarray(p.numpy())))

    tpts = torch.from_numpy(pts)
    np.testing.assert_array_equal(out, host_point_eval(tpts).numpy())
    np.testing.assert_array_equal(normal, make_normal_fn(host_point_eval)(tpts).numpy())
    plain = make_primary_sdf(scene, gizmo=gizmo, field="twin")
    np.testing.assert_allclose(out, plain(tpts).numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(normal, make_normal_fn(plain)(tpts).numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(normal, axis=1), 1.0, atol=1e-5)


def test_host_fd_normal_of_a_flat_field_is_zero(host_libs):
    """Far from the part every brush passes the empty brush's 64, so the
    field is flat and its six differences are 0: K1's FD form and the plain
    glue both give a zero normal there, as OpenCL's normalize does, where
    g / |g| would be NaN, and a refine step leaves the point where it is."""
    scenes, libs = host_libs
    scene, lib = scenes["design1"], libs[("design1", "sdf")]
    pts = np.random.default_rng(9).uniform(900.0, 1000.0, (64, 3)).astype(np.float32)
    out, normal = np.empty(len(pts), np.float32), np.empty((len(pts), 3), np.float32)
    bank, ex = _bank(scene.arrays), _extras(scene)
    lib.host_point_eval_fd(pts.ctypes.data, out.ctypes.data, normal.ctypes.data, len(pts),
                           bank.ctypes.data, scene.arrays.ad.ctypes.data, _ptr(ex))
    assert (out == 64.0).all() and (normal == 0.0).all()
    plain = make_normal_fn(make_primary_sdf(scene))(torch.from_numpy(pts)).numpy()
    assert (plain == 0.0).all()
    ev = BatchEvaluator(scene, device="cpu", use_kernels=True)
    np.testing.assert_array_equal(ev.refine_on_device(pts, steps=2), pts)


@pytest.mark.parametrize("name", ["design1", "logo"])
def test_refine_through_fd_wrapper_equals_point_and_normal_loop(host_libs, name):
    """``BatchEvaluator.refine_on_device`` on the kernels' field takes K1's
    FD form (one launch per chunk and step on the card); on the CPU its
    plain version equals the loop it replaced, a point evaluation and an FD
    normal per step, bit for bit."""
    scenes, _ = host_libs
    scene = scenes[name]
    half = 3.4 if name == "logo" else 6.0
    v = np.random.default_rng(8).uniform(-half, half, (3000, 3)).astype(np.float32)
    ev = BatchEvaluator(scene, device="cpu", use_kernels=True, chunk_size=1024)
    got = ev.refine_on_device(v, steps=3)
    sdf = make_primary_sdf(scene, field="twin")
    normal = make_normal_fn(sdf)
    arrays = scene.arrays.to_torch("cpu")
    ref = np.empty_like(v)
    for start in range(0, len(v), 1024):
        p = torch.from_numpy(v[start : start + 1024])
        for _ in range(3):
            p = p - 1.0 * normal(p, arrays) * sdf(p, arrays)[:, None]
        ref[start : start + len(p)] = p.numpy()
    np.testing.assert_array_equal(got, ref)
    assert ev.sdf_eval_count == 3 * len(v) * 7
    assert np.abs(got - v).max() > 1e-3


def test_generated_logo_render_matches_plain(host_libs):
    """The per-pixel march, normal and shading on the baked field at 32x32
    against the plain renderer: the same hit pixels, the render rule."""
    scenes, libs = host_libs
    scene = scenes["logo"]
    cam_arrays = Camera.initial().as_arrays()
    img = _render(libs[("logo", "render")], scene, LOGO_RENDER, cam_arrays)
    ref = make_renderer(scene, LOGO_RENDER)(scene.arrays.to_torch("cpu"), *cam_arrays).numpy()
    np.testing.assert_array_equal((img != 1.0).any(-1), (ref != 1.0).any(-1))
    assert (ref != 1.0).any(-1).mean() > 0.05
    _assert_render_close(img, ref)


def test_generated_logo_ray_march_matches_plain(host_libs):
    """K4's per-ray march on Logo's baked field: identical hit sets, d and
    vmin within 1e-5 of the plain march."""
    test_generated_ray_march_matches_plain(host_libs, "logo", "fit")


def test_kernel_source_is_self_contained():
    """The translation units hold only repo sources and the generated tape:
    no include beyond the C/CUDA runtime headers."""
    src = sdf_kernel_source(get_design("design1"))
    includes = {line.split()[1] for line in src.splitlines() if line.startswith("#include")}
    assert includes == {"<math.h>", "<stdint.h>", "<cuda_runtime.h>"}
    assert "field_sdf" in src and "brush_5" in src and "brush_6" in src


def test_brush_without_cuda_source_raises():
    c = api.new_design()
    custom = c.define_brush(lambda v, ctx: torch.sum(v, dim=-1), name="custom")
    api.draw(custom, api.Transform.identity(), compiler=c)
    with pytest.raises(NotImplementedError, match="custom"):
        sdf_kernel_source(c.commit())


@pytest.mark.parametrize("gizmo", [False, True])
@pytest.mark.parametrize("name", ["design1", "design2", "logo"])
def test_generated_cull_tile_matches_plain_culler(host_libs, name, gizmo):
    """K7's chain on the host (``cull_tile``, generated from the cull plan over
    csrc/interval.cuh) against the plain culler on 64 boxes: the same
    predicate bits and the same substitutes, bit for bit."""
    scenes, libs = host_libs
    scene = scenes[name]
    kind = "sdf_cull" if not gizmo else "cull_dynamic" if name == "design2" else "cull"
    lib = libs[(name, kind)]
    culler = cull.make_tape_culler(scene, gizmo=gizmo)
    rng = np.random.default_rng(5)
    lo = rng.uniform(-4, 4, (64, 3)).astype(np.float32)
    hi = (lo + rng.uniform(0.01, 2.0, (64, 3)) * rng.choice([0.05, 1.0], (64, 1))).astype(np.float32)
    p, s = cull.stack_cull(*culler(
        tuple((torch.from_numpy(lo[:, i]), torch.from_numpy(hi[:, i])) for i in range(3)),
        cull.array_bank_reader(scene.arrays), eval_context(scene, scene.arrays.to_torch("cpu"))), (64,))
    bank, ad, ex = _bank(scene.arrays), scene.arrays.ad, _extras(scene)
    for b in range(64):
        box = np.ascontiguousarray(np.stack([lo[b], hi[b]], -1).reshape(6), np.float32)
        preds = np.zeros(1, np.uint32)
        substs = np.zeros(culler.n_slots, np.float32)
        lib.host_cull_tile(box.ctypes.data, bank.ctypes.data, ad.ctypes.data, _ptr(ex),
                           preds.ctypes.data, substs.ctypes.data)
        bits = [(int(preds[0]) >> g) & 1 for g in range(len(culler.groups))]
        np.testing.assert_array_equal(bits, p[b].numpy().astype(int))
        np.testing.assert_array_equal(substs, s[b].numpy())
    assert (~p).any() or name == "design2"


@pytest.mark.parametrize("name", ["design1", "design2", "logo"])
def test_generated_culled_grid_matches_plain(host_libs, name):
    """K3's culled grid on the host, tile by tile, against the plain culled
    grid (the same tiles, predicates and substitutes; within 1e-6, since
    PyTorch's float32 square root on the CPU can be an ulp off C's), and the
    plain culled grid equal to the unculled one (the cull is exact)."""
    scenes, libs = host_libs
    scene = scenes[name]
    lo, cell, z0, nz, ny, nx = np.full(3, -3.5, np.float32), np.float32(7.0 / 48), 4.0, 19, 33, 70
    out = np.empty((nz, ny, nx), np.float32)
    libs[(name, "sdf_cull")].host_grid_eval_cull(
        out.ctypes.data, nz, ny, nx, *(float(v) for v in lo), float(cell), z0,
        _bank(scene.arrays).ctypes.data, scene.arrays.ad.ctypes.data, _ptr(_extras(scene)))
    arrays = scene.arrays.to_torch("cpu")
    counts = {}
    plain = make_grid_eval(scene, cull=True).plain(arrays, lo, cell, z0, nz, ny, nx, counts=counts)
    np.testing.assert_allclose(out, plain.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(plain.numpy(),
                                  make_grid_eval(scene).plain(arrays, lo, cell, z0, nz, ny, nx).numpy())
    assert counts["chains"] == 3 * 5 * 3 and counts["evals"] == nz * ny * nx


@pytest.mark.parametrize("name,kind,unculled,config", [
    ("design1", "cull", "render64", CULL),
    ("design2", "cull_dynamic", "render64", CULL_DYNAMIC),
    ("logo", "cull_near", "render_near", CULL_NEAR),
])
def test_generated_culled_render_matches_unculled(host_libs, name, kind, unculled, config):
    """The culled renderer on the host (warp by warp, lock step and
    reductions emulated) equals the host's unculled render at 64x48 bit for
    bit, and its plain version (Design1 hoisted, Design2 dynamic, and Logo
    hoisted close up, where the plain version skips over a tenth of the
    group evaluations)."""
    scenes, libs = host_libs
    scene = scenes[name]
    if name == "logo":
        cam_arrays = Camera.initial(apply_default_orbit=False).zoom(6.0).as_arrays()
    else:
        cam_arrays = Camera.initial().orbit(0.3, -0.2).as_arrays()
    img = _render(libs[(name, kind)], scene, config, cam_arrays)
    ref = _render(libs[(name, unculled)], scene, config, cam_arrays)
    np.testing.assert_array_equal(img, ref)
    counts = {}
    plain = make_renderer(scene, config)(scene.arrays.to_torch("cpu"), *cam_arrays,
                                         cull_counts=counts).numpy()
    _assert_render_close(img, plain)
    assert (ref != 1.0).any(-1).mean() > 0.05
    if name == "logo":
        assert cull.skipped_share(counts) > 0.1


@pytest.mark.parametrize("hierarchical", [False, True])
def test_generated_hoisted_box_matches_plain(host_libs, hierarchical):
    """The culled renderer's hoisted box (march.cuh hoisted_box, over the
    warp's shuffled spans) equals the plain version's (raymarch.hoisted_boxes,
    whose boxes hold every point the render evaluates) bit for bit, in every
    tile of Logo's close-up frame, from the camera and from a t0 plane."""
    scenes, libs = host_libs
    config = dataclasses.replace(CULL_NEAR, march_hierarchical=hierarchical)
    cam_arrays = Camera.initial(apply_default_orbit=False).zoom(6.0).as_arrays()
    rows = torch.from_numpy(camera_rows(*cam_arrays))
    r_proj = project(ray_directions(config), *rows[1:])
    t0 = None
    if hierarchical:
        t0 = torch.from_numpy(np.random.default_rng(2).uniform(0.0, 4.0, (config.height, config.width))
                              .astype(np.float32))
    box, _, n_tiles = hoisted_boxes(config, rows[0], r_proj, t0)
    cam = np.ascontiguousarray(rows.numpy(), np.float32)
    t0_np = None if t0 is None else np.ascontiguousarray(t0.numpy())
    got = np.empty((n_tiles, 6), np.float32)
    for tile in range(n_tiles):
        x0, y0 = 16 * (tile % (config.width // 16)), 2 * (tile // (config.width // 16))
        libs[("logo", "cull_near")].host_hoisted_box(got[tile].ctypes.data, x0, y0, config.height,
                                                    config.width, cam.ctypes.data, _ptr(t0_np))
    want = torch.stack([b for iv in box for b in iv], -1).numpy()
    np.testing.assert_array_equal(got, want)


def test_cull_chain_ops_counted_from_generated_code():
    """The chain's FP32 operations, counted from the generated ``cull_tile``
    and interval bodies: more than a leaf's frame interval (54) per twinned
    leaf, and the gizmo adds its interval (115) and a pad (7)."""
    scene = get_design("design1")
    ops, with_gizmo = cull_chain_ops(scene, False), cull_chain_ops(scene, True)
    assert ops > 11 * (54 + 7)
    assert with_gizmo - ops >= 115 + 7
