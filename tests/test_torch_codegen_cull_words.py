"""Host build of the point and grid unit with the k1 gizmo (the gizmo option
of K1 and K3), and of the cull of a scene with more than 32 cull groups.

The gizmo unit's field is the tape min-ed with the axis gizmo; its culled
grid gives the gizmo a cull slot of its own (cull.py:347 of the JAX package).
The cull's predicate mask has one bit per group in as many 32-bit words as
the groups need: the synthetic scene here has 89 groups, so groups 32-88 live
in the second and third words.  Built with g++ beside csrc/host_harness.cpp, as
tests/test_torch_codegen.py builds the other units.
"""

import ctypes
import dataclasses
import shutil
import subprocess

import numpy as np
import pytest
import torch

from designcsg_tpu_torch.camera import Camera
from designcsg_tpu_torch.config import RenderConfig
from designcsg_tpu_torch.designs import get_design
from designcsg_tpu_torch.ops import cull
from designcsg_tpu_torch.ops.cuda.build import csrc
from designcsg_tpu_torch.ops.cuda.sdf_kernel import make_grid_eval, make_point_eval
from designcsg_tpu_torch.ops.cuda.tape import cull_words, scene_source
from designcsg_tpu_torch.ops.interpreter import eval_context
from designcsg_tpu_torch.ops.raymarch import camera_rows, make_renderer
from torch_scenes import many_groups_scene


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per test process: the suite runs one process per
    worker, and a default-sized thread pool in each oversubscribes the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_P = ctypes.c_void_p
CULL = RenderConfig(width=64, height=48, max_steps=80, march_cull=True)
CULL_DYNAMIC = dataclasses.replace(CULL, march_cull="dynamic")


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """{(scene, kind): ctypes library}: "gizmo" (the point/grid unit of the k1
    field, culled grid included) of each design; for the many-group scene
    "sdf" (the point/grid unit), "cull" and "cull_dynamic" (the culled
    renderers) and "render" (the unculled renderer)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler (g++) to build the generated source")
    scenes = {name: get_design(name) for name in ("design1", "design2", "logo")}
    scenes["many"] = many_groups_scene()
    render = "#define HOST_RENDER\n"
    builds = {(name, "gizmo"): scene_source(scenes[name], cull=1, gizmo=True)
              for name in ("design1", "design2", "logo")}
    builds.update({
        ("many", "sdf"): scene_source(scenes["many"], cull=1),
        ("many", "cull"): render + scene_source(scenes["many"], CULL, cull=1),
        ("many", "cull_dynamic"): render + scene_source(scenes["many"], CULL_DYNAMIC, cull=2),
        ("many", "render"): render + scene_source(scenes["many"],
                                                  dataclasses.replace(CULL, march_cull=None)),
    })
    out = tmp_path_factory.mktemp("host_build_words")
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
        if key[1] != "render":
            lib.host_cull_tile.argtypes = [_P] * 6
        if key[1] in ("gizmo", "sdf"):
            lib.host_grid_eval_cull.argtypes = ([_P] + [ctypes.c_int] * 3 + [ctypes.c_float] * 5
                                                + [_P] * 3)
        else:
            lib.host_render.argtypes = [_P, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P]
        libs[key] = lib
    return scenes, libs


def _bank(arrays):
    return np.ascontiguousarray(
        np.concatenate([arrays.position, arrays.right, arrays.up, arrays.forward], axis=1),
        np.float32,
    )


def _extras(scene):
    flat, _ = scene.device_extras("cpu")
    return None if flat is None else flat.numpy().ctypes.data


def _point_eval(lib, scene, pts):
    out = np.empty(len(pts), np.float32)
    bank = _bank(scene.arrays)
    lib.host_point_eval(pts.ctypes.data, out.ctypes.data, len(pts), bank.ctypes.data,
                        scene.arrays.ad.ctypes.data, _extras(scene))
    return out


def _grid_cull(lib, scene, lo, cell, z0, nz, ny, nx):
    out = np.empty((nz, ny, nx), np.float32)
    flat, _ = scene.device_extras("cpu")
    ex = None if flat is None else flat.numpy()
    bank = _bank(scene.arrays)
    lib.host_grid_eval_cull(out.ctypes.data, nz, ny, nx, *(float(v) for v in lo), float(cell),
                            float(z0), bank.ctypes.data, scene.arrays.ad.ctypes.data,
                            None if ex is None else ex.ctypes.data)
    return out


def _lattice(lo, cell, z0, nz, ny, nx):
    """f32[nz*ny*nx, 3] lattice points ``lo + cell * (x, y, z0 + z)``, each a
    float32 product then a float32 sum, as the kernels round them."""
    lo, cell = np.asarray(lo, np.float32), np.float32(cell)
    x = lo[0] + cell * np.arange(nx, dtype=np.float32)
    y = lo[1] + cell * np.arange(ny, dtype=np.float32)
    z = lo[2] + cell * (np.float32(z0) + np.arange(nz, dtype=np.float32))
    g = np.meshgrid(z, y, x, indexing="ij")
    return np.ascontiguousarray(np.stack([g[2], g[1], g[0]], -1).reshape(-1, 3), np.float32)


def _render(lib, scene, config, cam_arrays):
    cam = np.ascontiguousarray(camera_rows(*cam_arrays), np.float32)
    img = np.empty((config.height, config.width, 3), np.float32)
    lib.host_render(img.ctypes.data, config.height, config.width, cam.ctypes.data,
                    _bank(scene.arrays).ctypes.data, scene.arrays.ad.ctypes.data, None, None)
    return img


def _close(got, ref):
    """The point and grid kernels' rule against their plain versions:
    ``|d| <= 1e-5 + 1e-6 |ref|``."""
    return bool(np.all(np.abs(got - ref) <= 1e-5 + 1e-6 * np.abs(ref)))


@pytest.mark.parametrize("name", ["design1", "design2", "logo"])
def test_gizmo_point_unit_matches_plain(host_libs, name):
    """K1 with the gizmo on the host against ``make_point_eval(gizmo=True)``'s
    plain version (``make_primary_sdf(gizmo=True, field="twin")``), on random
    points and on points along the gizmo's three axes."""
    scenes, libs = host_libs
    scene = scenes[name]
    rng = np.random.default_rng(11)
    axes = np.zeros((3, 256, 3), np.float32)
    for k in range(3):
        axes[k, :, k] = np.linspace(-0.5, 5.5, 256)
    axes += rng.normal(scale=0.05, size=axes.shape).astype(np.float32)
    pts = np.concatenate([rng.uniform(-4, 6, (2048, 3)).astype(np.float32), axes.reshape(-1, 3)])
    got = _point_eval(libs[(name, "gizmo")], scene, pts)
    plain = make_point_eval(scene, gizmo=True).plain(torch.from_numpy(pts), scene.arrays.to_torch("cpu"))
    assert _close(got, plain.numpy())
    # The gizmo is the field along its axes, away from the part.
    far = np.linalg.norm(pts[2048:], axis=1) > 3.5
    unculled = make_point_eval(scene).plain(torch.from_numpy(pts), scene.arrays.to_torch("cpu"))
    assert (plain.numpy()[2048:][far] < unculled.numpy()[2048:][far]).any()


@pytest.mark.parametrize("name", ["design1", "design2", "logo"])
def test_gizmo_culled_grid_matches_plain(host_libs, name):
    """K3's culled grid with the gizmo (its own cull slot) on the host, tile
    by tile, against the plain culled gizmo grid (within 1e-6, PyTorch's
    float32 square root on the CPU can be an ulp off C's), the plain culled
    grid equal to the unculled one, and the host's culled grid equal bit
    for bit to the host's own point unit on the same lattice."""
    scenes, libs = host_libs
    scene = scenes[name]
    lib = libs[(name, "gizmo")]
    lo, cell, z0, nz, ny, nx = np.full(3, -1.5, np.float32), np.float32(6.5 / 48), 2.0, 17, 41, 70
    got = _grid_cull(lib, scene, lo, cell, z0, nz, ny, nx)
    arrays = scene.arrays.to_torch("cpu")
    grid = make_grid_eval(scene, gizmo=True, cull=True)
    assert grid.culler.plan.gizmo
    plain = grid.plain(arrays, lo, cell, z0, nz, ny, nx).numpy()
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        plain, make_grid_eval(scene, gizmo=True).plain(arrays, lo, cell, z0, nz, ny, nx).numpy())
    pts = _lattice(lo, cell, z0, nz, ny, nx)
    np.testing.assert_array_equal(got.reshape(-1), _point_eval(lib, scene, pts))


def test_many_groups_need_more_words(host_libs):
    """89 groups: the plan has them all, the mask three words, and the
    generated chain writes and the culled tape reads the last one."""
    scenes, _ = host_libs
    plan = cull.make_cull_plan(scenes["many"], False)
    assert len(plan.groups) == 89 and cull_words(plan) == 3
    source = scene_source(scenes["many"], cull=1)
    assert "constexpr int N_CULL_WORDS = 3;" in source
    assert "preds.w[2] |=" in source and f"if (preds.w[2] & {1 << (88 - 64)}u)" in source


def test_many_groups_cull_tile_matches_plain_culler(host_libs):
    """The chain on the host against the plain culler on 64 boxes: every
    group's predicate bit (past 32 too) and every substitute, bit for bit;
    groups of both words are culled in some box and kept in another."""
    scenes, libs = host_libs
    scene = scenes["many"]
    culler = cull.make_tape_culler(scene, gizmo=False)
    rng = np.random.default_rng(4)
    lo = rng.uniform(-6, 5, (64, 3)).astype(np.float32)
    hi = (lo + rng.uniform(0.05, 2.5, (64, 3))).astype(np.float32)
    p, s = cull.stack_cull(*culler(
        tuple((torch.from_numpy(lo[:, i]), torch.from_numpy(hi[:, i])) for i in range(3)),
        cull.array_bank_reader(scene.arrays), eval_context(scene, scene.arrays.to_torch("cpu"))),
        (64,))
    bank = _bank(scene.arrays)
    n_groups = len(culler.groups)
    got = np.zeros((64, n_groups), bool)
    for b in range(64):
        box = np.ascontiguousarray(np.stack([lo[b], hi[b]], -1).reshape(6), np.float32)
        words = np.zeros(3, np.uint32)
        substs = np.zeros(culler.n_slots, np.float32)
        libs[("many", "sdf")].host_cull_tile(box.ctypes.data, bank.ctypes.data,
                                            scene.arrays.ad.ctypes.data, None,
                                            words.ctypes.data, substs.ctypes.data)
        got[b] = [(int(words[g >> 5]) >> (g & 31)) & 1 for g in range(n_groups)]
        np.testing.assert_array_equal(substs, s[b].numpy())
    np.testing.assert_array_equal(got, p.numpy())
    high = got[:, 32:]
    assert high.any() and not high.all()


def test_many_groups_culled_grid_equals_unculled(host_libs):
    """The culled grid of the 89-group scene on the host equals, bit for
    bit, the host's unculled point unit on the same lattice, and its plain
    version skips groups past 32."""
    scenes, libs = host_libs
    scene = scenes["many"]
    lib = libs[("many", "sdf")]
    lo, cell, z0, nz, ny, nx = np.array([-6.0, -2.5, -1.0], np.float32), np.float32(0.125), 0.0, 16, 40, 96
    got = _grid_cull(lib, scene, lo, cell, z0, nz, ny, nx)
    np.testing.assert_array_equal(got.reshape(-1), _point_eval(lib, scene, _lattice(lo, cell, z0, nz, ny, nx)))
    counts = {}
    arrays = scene.arrays.to_torch("cpu")
    plain = make_grid_eval(scene, cull=True).plain(arrays, lo, cell, z0, nz, ny, nx, counts=counts)
    np.testing.assert_allclose(got, plain.numpy(), rtol=0, atol=1e-6)
    assert (got < 0).any() and (got > 0).any()
    skipped = [counts["evals"] - n for n in counts["group_evals"]]
    assert min(skipped[32:]) > 0


@pytest.mark.parametrize("kind", ["cull", "cull_dynamic"])
def test_many_groups_culled_render_equals_unculled(host_libs, kind):
    """The 89-group scene's culled renderers on the host (hoisted; dynamic,
    the warp's lock step emulated) equal the host's unculled renderer bit
    for bit at 64x48, and the plain culled renderer within the renderer
    rule."""
    scenes, libs = host_libs
    scene = scenes["many"]
    config = CULL if kind == "cull" else CULL_DYNAMIC
    cam_arrays = Camera.initial(apply_default_orbit=False).zoom(2.0).as_arrays()
    img = _render(libs[("many", kind)], scene, config, cam_arrays)
    ref = _render(libs[("many", "render")], scene, config, cam_arrays)
    np.testing.assert_array_equal(img, ref)
    counts = {}
    plain = make_renderer(scene, config)(scene.arrays.to_torch("cpu"), *cam_arrays,
                                         cull_counts=counts).numpy()
    diff = np.abs(img - plain)
    assert diff.max() < 1e-3 and (diff > 1e-4).mean() < 0.01
    assert cull.skipped_share(counts) > 0.1
    assert (np.abs(ref - ref[0, 0]).sum(-1) > 0).mean() > 0.05
