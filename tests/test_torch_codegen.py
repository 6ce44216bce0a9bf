"""Host build of the generated CUDA scene code.

Every per-point function the kernels inline (brushes, the unrolled tape, the
gizmo, shading, the per-pixel march, the cone prepass's per-ray march, the
fit's per-ray march with its closest approach) is
``HD``: plain inline C++ under a host compiler.  Here Design1's and Design2's
generated sources are compiled with g++ beside a tiny C harness
(csrc/host_harness.cpp), loaded with ctypes and held against the plain
PyTorch versions — the one check of the generated arithmetic that runs
without a card.  All host-build cases stay in this file (one xdist worker).
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from designcsg_tpu_torch import api
from designcsg_tpu_torch.camera import Camera
from designcsg_tpu_torch.config import RenderConfig
from designcsg_tpu_torch.designs import get_design
from designcsg_tpu_torch.ops.cuda.build import csrc
from designcsg_tpu_torch.ops.cuda.tape import scene_source, sdf_kernel_source
from designcsg_tpu_torch.ops.interpreter import make_primary_sdf
from designcsg_tpu_torch.ops.raymarch import (
    camera_rows,
    coarse_ray_uv,
    make_cone_march,
    make_march,
    make_renderer,
    project,
    ray_directions,
)

_P = ctypes.c_void_p
RENDER = RenderConfig(width=128, height=32, max_steps=80)
# The fast viewport at a size F = 5 divides: over-relaxed, cone prepass.
FAST = RenderConfig(width=160, height=120, max_steps=96, march_overrelax=1.6,
                    march_hierarchical=True)
# The fit's ray march: no gizmo, tests/test_pallas.py:143's size.
FIT = RenderConfig(width=128, height=32, max_steps=80, gizmo=False)


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
    scenes = {name: get_design(name) for name in ("design1", "design2")}
    builds = {
        ("design1", "sdf"): scene_source(scenes["design1"]),
        ("design1", "gizmo"): "#define HOST_RENDER\n" + scene_source(scenes["design1"], RENDER),
        ("design1", "fast"): "#define HOST_RENDER\n" + scene_source(scenes["design1"], FAST),
        ("design2", "sdf"): scene_source(scenes["design2"]),
        ("design2", "fast"): "#define HOST_RENDER\n" + scene_source(scenes["design2"], FAST),
        ("design1", "fit"): "#define HOST_RENDER\n" + scene_source(scenes["design1"], FIT),
        ("design2", "fit"): "#define HOST_RENDER\n" + scene_source(scenes["design2"], FIT),
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
        lib.host_point_eval.argtypes = [_P, _P, ctypes.c_longlong, _P, _P]
        if key[1] != "sdf":
            lib.host_render.argtypes = [_P, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P]
            lib.host_cone_march.argtypes = [_P, ctypes.c_longlong, _P, _P, _P, _P]
            lib.host_ray_march.argtypes = [_P, _P, ctypes.c_longlong, _P, _P, _P, _P]
        libs[key] = lib
    return scenes, libs


def _bank(arrays):
    """The interleaved per-object bank a kernel keeps in shared memory."""
    return np.ascontiguousarray(
        np.concatenate([arrays.position, arrays.right, arrays.up, arrays.forward], axis=1),
        np.float32,
    )


def _point_eval(lib, scene, pts):
    out = np.empty(len(pts), np.float32)
    bank, ad = _bank(scene.arrays), scene.arrays.ad
    lib.host_point_eval(pts.ctypes.data, out.ctypes.data, len(pts), bank.ctypes.data, ad.ctypes.data)
    return out


def _render(lib, scene, config, cam_arrays, t0=None):
    cam = np.ascontiguousarray(camera_rows(*cam_arrays), np.float32)
    img = np.empty((config.height, config.width, 3), np.float32)
    t0 = None if t0 is None else np.ascontiguousarray(t0, np.float32)
    lib.host_render(
        img.ctypes.data, config.height, config.width, cam.ctypes.data,
        _bank(scene.arrays).ctypes.data, scene.arrays.ad.ctypes.data,
        None if t0 is None else t0.ctypes.data,
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
        _bank(scene.arrays).ctypes.data, scene.arrays.ad.ctypes.data,
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
        scene.arrays.ad.ctypes.data,
    )
    d_ref, vmin_ref = d_ref.numpy(), vmin_ref.numpy()
    assert ((d > 0) == (d_ref > 0)).all()
    assert (d_ref > 0).any() and (d_ref < 0).any()
    np.testing.assert_allclose(d, d_ref, atol=1e-5)
    np.testing.assert_allclose(vmin, vmin_ref, atol=1e-5)


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
