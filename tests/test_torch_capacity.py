"""Scene capacity of the port (tests/test_capacity.py's gates, on the port),
and the rings past the card's former static limits.

The rings are the JAX package's ``_ring_scene`` (tests/test_capacity.py) for
JAX, and its copy on the port's API (tests/torch_scenes.py ``ring_scene``)
for the port: n spheres on a ring, a flat scene of n + 1 objects whose tape
chains one min an object.  The JAX package is imported inside the tests
that compare with it, so that the ``cuda`` case also runs on a card's
machine without JAX (``-m cuda --noconftest``).

* The 127-ring (256 commands, the reference's budget) renders at 48x32 on
  the CPU, held to JAX's ``make_renderer`` by the renderer's rule, and
  exports with ``strategy="active"`` in both packages.
* The 512-ring: the port's staged tape equals its dynamic tape and JAX's
  dynamic tape within 2e-5; ``supports_scene`` accepts it and every unit's
  source generates.
* The 1,100- and 1,500-rings: every kernel's source generates.  The
  point/grid unit makes no cull plan unless asked, and the plan's walks keep
  their own stacks (P8); a bank past 48 KB of shared or 64 KB of constant
  memory lies in global memory (P9, ops/cuda/tape.py bank_placement).
* On the host harness (g++): the 512-ring's point unit and the called
  tape's against the plain field, the 1,100-ring's culled grid bit-equal to
  its unculled grid.
* On a card (``cuda``): K1, K3, K2, K5 and K4 of the 512- and 1,500-rings,
  and of a long tape without runs whose functions are called (``HD_CALL``),
  against their plain versions, with nvcc's seconds printed.
"""

import ctypes
import shutil
import subprocess
import time

import numpy as np
import pytest
import torch

from designcsg_tpu_torch.camera import Camera
from designcsg_tpu_torch.compiler import ExportConfig
from designcsg_tpu_torch.config import RenderConfig
from designcsg_tpu_torch.export.pipeline import export_mesh
from designcsg_tpu_torch.ops.cuda import build as kbuild
from designcsg_tpu_torch.ops.cuda.brushes_kernel import supports_scene
from designcsg_tpu_torch.ops.cuda.build import csrc
from designcsg_tpu_torch.ops.cuda.march_kernel import (
    make_cuda_cone_march,
    make_cuda_ray_march,
    make_cuda_renderer,
)
from designcsg_tpu_torch.ops.cuda.sdf_kernel import make_grid_eval, make_point_eval
from designcsg_tpu_torch.ops.cuda.tape import (
    cone_kernel_source,
    march_kernel_source,
    ray_march_kernel_source,
    scene_source,
    sdf_kernel_source,
    tape_qualifier,
    unit_bank,
)
from designcsg_tpu_torch.ops.interpreter import make_dynamic_primary_sdf, make_primary_sdf
from designcsg_tpu_torch.ops.raymarch import (
    camera_rows,
    coarse_ray_uv,
    project,
    ray_directions,
    render_scene,
)
from torch_scenes import many_groups_scene, ring_scene

_P = ctypes.c_void_p
# tests/test_capacity.py's render and export.
RING_RENDER = dict(width=48, height=32, max_steps=32)
RING_EXPORT = dict(bounding_box_half_diameter=10.0, grid_level=4, gradient_descent_steps=2)
EXACT = RenderConfig(**RING_RENDER)
FAST = RenderConfig(width=240, height=160, max_steps=32, march_overrelax=1.6,
                    march_hierarchical=True)
FIT = RenderConfig(differentiable=True, soft_silhouette_bandwidth=0.02, gizmo=False,
                   **RING_RENDER)
# The culled grid's slab on the host: tiles of 8 z, 8 y and 32 x, some cut,
# across the ring's spheres (radius 1 about (7.5 cos a, 0, 7.5 sin a): the
# compiler's frames scale the design by 5).
HOST_SLAB = (9, 33, 65)
# A long tape without runs (dented boxes: box, sphere, negate, max, min per
# part), past TAPE_INLINE_MAX_SLOTS: its functions are called (HD_CALL).
CALLED_PARTS = 100


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per test process: the suite runs one process per
    worker, and a default-sized thread pool in each oversubscribes the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bank(arrays):
    """The interleaved per-object bank (csrc/common.cuh BANK_STRIDE)."""
    return np.ascontiguousarray(
        np.concatenate([arrays.position, arrays.right, arrays.up, arrays.forward], axis=1),
        np.float32)


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """The host builds (g++), started first so that they overlap the JAX
    work: the 512-ring's point/grid unit and its renderer, the point/grid
    unit of CALLED_PARTS dented boxes (its tape called), and the
    1,100-ring's unit with its culled grid (these two at -O1: the same IEEE
    operations, a third of -O2's build time on the 1,100-ring's unit)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler (g++) to build the generated source")
    out = tmp_path_factory.mktemp("ring_host")
    builds = {512: (scene_source(ring_scene(512)), "-O2"),
              "512 render": ("#define HOST_RENDER\n" + scene_source(ring_scene(512), EXACT), "-O2"),
              1100: (scene_source(ring_scene(1100), cull=1), "-O1"),
              "parts": (scene_source(many_groups_scene(CALLED_PARTS)), "-O1")}
    running = {}
    for n, (text, opt) in builds.items():
        src, so = out / f"ring{n}.cpp".replace(" ", "_"), out / f"ring{n}.so".replace(" ", "_")
        src.write_text(text + "\n" + csrc("host_harness.cpp"))
        cmd = [gxx, "-std=c++17", opt, "-shared", "-fPIC", "-o", str(so), str(src)]
        running[n] = (subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True), so)

    libs = {}

    def finish():
        for n, (proc, so) in list(running.items()):
            del running[n]
            _, err = proc.communicate()
            assert proc.returncode == 0, err
            lib = ctypes.CDLL(str(so))
            if n == "512 render":
                lib.host_render.argtypes = [_P, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P]
                libs[n] = lib
                continue
            lib.host_point_eval.argtypes = [_P, _P, ctypes.c_longlong, _P, _P, _P]
            for fn in ("host_grid_eval", "host_grid_eval_cull"):
                if hasattr(lib, fn):
                    getattr(lib, fn).argtypes = [_P] + [ctypes.c_int] * 3 + [ctypes.c_float] * 5 + [_P] * 3
            libs[n] = lib
        return libs

    return finish


@pytest.fixture(scope="module")
def ring127_jax():
    """JAX's 127-ring frame at 48x32 and its active export's triangles."""
    import jax

    from designcsg_tpu.camera import Camera as JCamera
    from designcsg_tpu.compiler import ExportConfig as JExportConfig
    from designcsg_tpu.config import RenderConfig as JRenderConfig
    from designcsg_tpu.export.pipeline import export_mesh as j_export_mesh
    from designcsg_tpu.ops.interpreter import as_device_arrays
    from designcsg_tpu.ops.raymarch import make_renderer as j_make_renderer
    from test_capacity import _ring_scene

    scene = _ring_scene(127)
    render = jax.jit(j_make_renderer(scene, JRenderConfig(**RING_RENDER)))
    img = np.asarray(render(as_device_arrays(scene.arrays), *JCamera.initial().as_arrays()))
    _, report = j_export_mesh(scene, JExportConfig(**RING_EXPORT), autodetect=False, strategy="active")
    return img, report.num_triangles


def test_reference_command_capacity_renders_and_exports(host_libs, ring127_jax):
    scene = ring_scene(127)
    assert scene.num_objects == 128  # the root's empty brush and 127 spheres
    assert scene.num_build_steps == 256
    img = render_scene(scene, config=EXACT, device="cpu").numpy()
    assert (img < 0.99).any()  # something rendered
    ref, jax_triangles = ring127_jax
    diff = np.abs(img - ref)
    # The renderer's rule (tests/test_pallas.py:115-116).
    assert diff.max() < 1e-3 and (diff > 1e-4).mean() < 0.01
    _, report = export_mesh(scene, ExportConfig(**RING_EXPORT), autodetect=False, strategy="active",
                            device="cpu")
    assert report.num_triangles > 0 and jax_triangles > 0
    assert report.num_triangles == jax_triangles


def test_512_objects_commit_and_evaluate():
    scene = ring_scene(512)
    assert scene.num_objects == 513
    assert scene.num_build_steps == 2 * 512 + 2
    pts = np.random.default_rng(0).uniform(-8, 8, (512, 3)).astype(np.float32)
    arrays = scene.arrays.to_torch("cpu")
    staged = make_primary_sdf(scene)(torch.from_numpy(pts), arrays).numpy()
    dynamic = make_dynamic_primary_sdf(scene)(torch.from_numpy(pts), arrays).numpy()
    from designcsg_tpu.ops.interpreter import as_device_arrays, make_dynamic_primary_sdf as j_dynamic
    from test_capacity import _ring_scene

    jscene = _ring_scene(512)
    ref = np.asarray(j_dynamic(jscene)(pts, as_device_arrays(jscene.arrays)))
    np.testing.assert_allclose(dynamic, staged, atol=2e-5)
    np.testing.assert_allclose(staged, ref, atol=2e-5)


def _sources(scene):
    """Every unit a card would build for the scene, generated:
    {label: source}."""
    return {
        "sdf": sdf_kernel_source(scene),
        "sdf gizmo": sdf_kernel_source(scene, gizmo=True),
        "sdf cull": sdf_kernel_source(scene, cull=True),
        "march": march_kernel_source(scene, EXACT),
        "march fast": march_kernel_source(scene, FAST),
        "march cull": march_kernel_source(scene, RenderConfig(**RING_RENDER, march_cull=True)),
        "march cull dynamic": march_kernel_source(
            scene, RenderConfig(**RING_RENDER, march_cull="dynamic")),
        "cone": cone_kernel_source(scene, FAST),
        "ray_march": ray_march_kernel_source(scene, FIT),
    }


def test_512_objects_supported_and_every_source_generates():
    """The 512-ring's banks fit the static homes: the renderer's constant
    bank (513 objects of 1,365), the others' shared banks (24.6 KB)."""
    scene = ring_scene(512)
    assert supports_scene(scene) and supports_scene(scene, cull=True, gizmo=True)
    t0 = time.time()
    sources = _sources(scene)
    assert time.time() - t0 < 120.0  # tests/test_capacity.py:33
    banks = {label: unit_bank(src) for label, src in sources.items()}
    assert banks == {"sdf": "shared", "sdf gizmo": "shared", "sdf cull": "shared",
                     "march": "constant", "march fast": "constant", "march cull": "shared",
                     "march cull dynamic": "constant", "cone": "shared", "ray_march": "shared"}
    assert "#define CULL_MODE 0" in sources["sdf"] and "HD void cull_tile(" not in sources["sdf"]
    assert "GRID_CULL_LANES" in sources["sdf cull"]


@pytest.mark.parametrize("n", [1100, 1500])
def test_rings_past_the_static_limits_generate(n):
    """Before the repairs the 1,100-ring's point unit raised RecursionError
    (the cull plan's walks, P8) and the 1,400-ring's renderer ValueError (a
    constant bank of more than 1,365 objects, P9a); past 1,024 objects a
    shared bank would pass 48 KB (P9b).  Now every source generates, and
    each bank lies where it fits: constant memory for the renderer up to
    1,365 objects, global memory above the static limits."""
    scene = ring_scene(n)
    assert supports_scene(scene) and supports_scene(scene, cull=True)
    sources = _sources(scene)
    constant = "constant" if n <= 1365 else "global"
    assert {label: unit_bank(src) for label, src in sources.items()} == {
        "sdf": "global", "sdf gizmo": "global", "sdf cull": "global", "march": constant,
        "march fast": constant, "march cull": "global", "march cull dynamic": constant,
        "cone": "global", "ray_march": "global"}
    for label, src in sources.items():
        assert f"constexpr int N_OBJ = {n + 1};" in src, label
    # The tape, the shading and the culled field run the ring as loops.
    assert f"for (int i = 0; i < {n - 16}; ++i)" in sources["sdf"]  # past 16 hoisted slots
    assert "(preds.w[0] & 1u) ? brush_2_at(" in sources["sdf cull"]
    assert f"for (int obj = 1; obj < {n + 1}; ++obj)" in sources["march"]


def test_host_ring512_point_unit_matches_plain(host_libs):
    lib = host_libs()[512]
    scene = ring_scene(512)
    pts = (np.random.default_rng(1).uniform(-9, 9, (4096, 3)) * [1.0, 0.2, 1.0]).astype(np.float32)
    out = np.empty(len(pts), np.float32)
    bank, ad = _bank(scene.arrays), np.ascontiguousarray(scene.arrays.ad, np.float32)
    lib.host_point_eval(pts.ctypes.data, out.ctypes.data, len(pts), bank.ctypes.data,
                        ad.ctypes.data, None)
    plain = make_primary_sdf(scene, field="twin")(torch.from_numpy(pts), scene.arrays.to_torch("cpu"))
    np.testing.assert_allclose(out, plain.numpy(), rtol=0, atol=1e-6)


def test_host_ring512_tape_and_shading_loops_match_plain(host_libs):
    """The 512-ring's tape and shading run as loops over the ring's objects
    (tape.TAPE_LOOP_MIN_RUN): its point unit is held above, and its frame
    on the host against the plain renderer by the renderer's rule."""
    scene = ring_scene(512)
    src = scene_source(scene, EXACT)
    assert "for (int i = 0; i < 512; ++i)" in src and "for (int obj = 1; obj < 513; ++obj)" in src
    lib = host_libs()["512 render"]
    cam = Camera.initial().as_arrays()
    rows = np.ascontiguousarray(camera_rows(*cam), np.float32)
    img = np.empty((EXACT.height, EXACT.width, 3), np.float32)
    bank, ad = _bank(scene.arrays), np.ascontiguousarray(scene.arrays.ad, np.float32)
    lib.host_render(img.ctypes.data, EXACT.height, EXACT.width, rows.ctypes.data, bank.ctypes.data,
                    ad.ctypes.data, None, None)
    ref = make_cuda_renderer(scene, EXACT).plain(scene.arrays.to_torch("cpu"), *cam).numpy()
    diff = np.abs(img - ref)
    assert (ref < 0.99).any()
    assert diff.max() < 1e-3 and (diff > 1e-4).mean() < 0.01


def test_long_tapes_loop_or_are_called():
    """A flat ring's tape and shading are loops, inlined at each call site;
    a long tape without runs (200 dented boxes: box, sphere, negate, max,
    min per part) is one called body (``HD_CALL``), so that nvcc compiles
    it once and not at each of K2's or K1-FD's call sites."""
    ring = ring_scene(1500)
    assert tape_qualifier(ring) == "HD"
    assert "HD float field_sdf(" in sdf_kernel_source(ring)
    parts = many_groups_scene(200)
    assert tape_qualifier(parts) == "HD_CALL"
    src = march_kernel_source(parts, EXACT)
    assert "HD_CALL float field_sdf(" in src and "HD_CALL Rgb scene_shade(" in src
    body = src[src.index("HD_CALL float field_sdf("):]
    assert "for (" not in body[:body.index("return result;")]


def test_host_called_tape_matches_plain(host_libs):
    """The point unit of CALLED_PARTS dented boxes, whose tape is one called
    function (``HD_CALL``), against the plain field."""
    scene = many_groups_scene(CALLED_PARTS)
    assert tape_qualifier(scene) == "HD_CALL"
    lib = host_libs()["parts"]
    pts = (np.random.default_rng(3).uniform(-1, 1, (4096, 3)) * [28.0, 40.0, 8.0]
           + [0.0, 15.0, 0.0]).astype(np.float32)
    out = np.empty(len(pts), np.float32)
    bank, ad = _bank(scene.arrays), np.ascontiguousarray(scene.arrays.ad, np.float32)
    lib.host_point_eval(pts.ctypes.data, out.ctypes.data, len(pts), bank.ctypes.data,
                        ad.ctypes.data, None)
    plain = make_primary_sdf(scene, field="twin")(torch.from_numpy(pts), scene.arrays.to_torch("cpu"))
    assert (plain.numpy() < 0).any()
    np.testing.assert_allclose(out, plain.numpy(), rtol=0, atol=1e-6)


def test_host_ring1100_culled_grid_bit_equal_to_unculled(host_libs):
    """The 1,100-ring's culled grid (its chain on 1,101 slots, P8's scene) on
    the host, tile by tile, against the unculled grid: the same bits."""
    lib = host_libs()[1100]
    scene = ring_scene(1100)
    nz, ny, nx = HOST_SLAB
    bank, ad = _bank(scene.arrays), np.ascontiguousarray(scene.arrays.ad, np.float32)
    grids = {}
    for fn in ("host_grid_eval", "host_grid_eval_cull"):
        out = np.empty((nz, ny, nx), np.float32)
        getattr(lib, fn)(out.ctypes.data, nz, ny, nx, 6.0, -1.5, -1.0, 1.0 / 16, 0.0,
                         bank.ctypes.data, ad.ctypes.data, None)
        grids[fn] = out
    assert (grids["host_grid_eval"] < 0).any() and (grids["host_grid_eval"] > 0).any()
    np.testing.assert_array_equal(grids["host_grid_eval_cull"].view(np.uint32),
                                  grids["host_grid_eval"].view(np.uint32))


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode; plain versions are "
                    "tested above and in test_torch_kernels.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [512, 1500, "parts"])
def test_cuda_ring_kernels_match_plain(cuda_device, n):
    """K1 (and its FD form), K3, K2, K5 and K4 of a ring (or of CALLED_PARTS
    dented boxes, whose tape is called) on the card against their plain
    versions, by the rules of tests/test_torch_cuda.py (1e-5 + 1e-6|ref| on
    fields, the renderer's rule on frames, the same hit sets on the fit's
    march); prints each unit's nvcc seconds and bank."""
    scene = many_groups_scene(CALLED_PARTS) if n == "parts" else ring_scene(n)
    units = {label: (label.split()[0], src) for label, src in _sources(scene).items()
             if label in ("sdf", "march", "cone", "ray_march")}
    units["sdf_fd"] = ("sdf_fd", units["sdf"][1])
    kbuild.build(units)
    print({label: (kbuild.BUILD_SECONDS.get(label), unit_bank(src))
           for label, (_, src) in units.items()})
    a = scene.arrays.to_torch(cuda_device)
    pts = np.random.default_rng(2).uniform(-9, 9, (1 << 14, 3)) * [1.0, 0.2, 1.0]
    pts = torch.from_numpy(pts.astype(np.float32)).to(cuda_device)
    pe, ge = make_point_eval(scene), make_grid_eval(scene)
    grid = (a, np.array([-8.5, -8.5, -1.0], np.float32), np.float32(17.0 / 64), 0.0, 33, 65)
    (s, nrm), (s_ref, nrm_ref) = pe.fd(pts, a), pe.fd.plain(pts, a)
    for got, ref in ((pe(pts, a), pe.plain(pts, a)), (s, s_ref), (nrm, nrm_ref),
                     (ge(*grid), ge.plain(*grid))):
        assert bool(((got - ref).abs() <= 1e-5 + 1e-6 * ref.abs()).all())
    cam = Camera.initial().as_arrays()
    render = make_cuda_renderer(scene, EXACT)
    diff = (render(a, *cam) - render.plain(a, *cam)).abs()
    assert float(diff.max()) < 1e-3 and float((diff > 1e-4).float().mean()) < 0.01
    rows = camera_rows(*cam)
    frame = torch.as_tensor(rows[1:], device=cuda_device)
    o = torch.as_tensor(rows[0], device=cuda_device)
    rays = project(torch.from_numpy(coarse_ray_uv(FAST)).to(cuda_device), *frame)
    cone = make_cuda_cone_march(scene, FAST)
    t, t_ref = cone(a, o, rays), cone.plain(a, o, rays)
    far = FAST.max_distance
    assert float(((t > far) == (t_ref > far)).float().mean()) >= 0.99
    march = make_cuda_ray_march(scene, FIT)
    r_fit = project(ray_directions(FIT, cuda_device), *frame)
    (d, vmin), (d_ref, vmin_ref) = march(a, o, r_fit), march.plain(a, o, r_fit)
    assert torch.equal(d > 0, d_ref > 0)
    assert float((d - d_ref).abs().max()) <= 1e-5 and float((vmin - vmin_ref).abs().max()) <= 1e-5
