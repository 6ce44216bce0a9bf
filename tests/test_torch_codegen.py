"""Host build of the generated CUDA scene code.

Every per-point function the kernels inline (brushes, the unrolled tape, the
gizmo, shading, the per-pixel march) is ``HD``: plain inline C++ under a host
compiler.  Here Design1's generated source is compiled with g++ beside a tiny
C harness (csrc/host_harness.cpp), loaded with ctypes and held against the
plain PyTorch versions — the one check of the generated arithmetic that runs
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
from designcsg_tpu_torch.ops.raymarch import camera_rows, make_renderer

_P = ctypes.c_void_p
RENDER = RenderConfig(width=128, height=32, max_steps=80)


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """{gizmo: ctypes library} built from Design1's generated source, the
    gizmo=True one with the renderer pieces."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler (g++) to build the generated source")
    scene = get_design("design1")
    out = tmp_path_factory.mktemp("host_build")
    libs = {}
    for gizmo in (False, True):
        if gizmo:
            text = "#define HOST_RENDER\n" + scene_source(scene, render_config=RENDER)
        else:
            text = scene_source(scene)
        src = out / f"scene_{gizmo}.cpp"
        src.write_text(text + "\n" + csrc("host_harness.cpp"))
        so = out / f"scene_{gizmo}.so"
        res = subprocess.run(
            [gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-o", str(so), str(src)],
            capture_output=True, text=True,
        )
        assert res.returncode == 0, res.stderr
        lib = ctypes.CDLL(str(so))
        lib.host_point_eval.argtypes = [_P, _P, ctypes.c_longlong, _P, _P]
        if gizmo:
            lib.host_render.argtypes = [_P, ctypes.c_int, ctypes.c_int, _P, _P, _P]
        libs[gizmo] = lib
    return scene, libs


def _bank(arrays):
    """The interleaved per-object bank a kernel keeps in shared memory."""
    return np.ascontiguousarray(
        np.concatenate([arrays.position, arrays.right, arrays.up, arrays.forward], axis=1),
        np.float32,
    )


@pytest.mark.parametrize("gizmo", [False, True])
def test_generated_tape_matches_plain(host_libs, gizmo):
    scene, libs = host_libs
    pts = np.random.default_rng(0).uniform(-6, 6, (4096, 3)).astype(np.float32)
    out = np.empty(4096, np.float32)
    bank, ad = _bank(scene.arrays), scene.arrays.ad
    libs[gizmo].host_point_eval(pts.ctypes.data, out.ctypes.data, 4096, bank.ctypes.data, ad.ctypes.data)
    ref = make_primary_sdf(scene, gizmo=gizmo)(torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_generated_render_pixel_matches_plain(host_libs):
    scene, libs = host_libs
    cam_arrays = Camera.initial().as_arrays()
    cam = np.ascontiguousarray(camera_rows(*cam_arrays), np.float32)
    img = np.empty((RENDER.height, RENDER.width, 3), np.float32)
    libs[True].host_render(
        img.ctypes.data, RENDER.height, RENDER.width, cam.ctypes.data,
        _bank(scene.arrays).ctypes.data, scene.arrays.ad.ctypes.data,
    )
    ref = make_renderer(scene, RENDER)(scene.arrays.to_torch("cpu"), *cam_arrays).numpy()
    diff = np.abs(img - ref)
    assert diff.max() < 1e-3
    assert (diff > 1e-4).mean() < 0.01


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
