"""CUDA kernels of the port against their plain versions, on the card.

Marked ``cuda``; each test takes the ``cuda_device`` fixture, which skips when
no CUDA device is present.  Run on a machine with a card:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -o addopts="" -p no:cacheprovider
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from designcsg_tpu_torch.camera import Camera
from designcsg_tpu_torch.config import RenderConfig
from designcsg_tpu_torch.designs import get_design
from designcsg_tpu_torch.evaluator import BatchEvaluator
from designcsg_tpu_torch.export.pipeline import export_mesh
from designcsg_tpu_torch.ops.cull import skipped_share
from designcsg_tpu_torch.ops.cuda import build as kbuild
from designcsg_tpu_torch.ops.cuda.march_kernel import (
    make_cuda_cone_march,
    make_cuda_hierarchical_renderer,
    make_cuda_ray_march,
    make_cuda_renderer,
)
from designcsg_tpu_torch.ops.cuda.sdf_kernel import make_grid_eval, make_point_eval
from designcsg_tpu_torch.ops.raymarch import (
    camera_rows,
    coarse_ray_uv,
    compose_hierarchical,
    make_cone_march,
    make_hierarchical_renderer,
    make_renderer,
    make_scene_renderer,
    project,
    ray_directions,
)
from designcsg_tpu_torch.parallel.fit import make_fit_harness
from torch_scenes import custom_brush_scene, many_groups_scene

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per test process: the suite runs one process per
    worker, and a default-sized thread pool in each oversubscribes the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode; plain versions are "
                    "tested in test_torch_kernels.py)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def design1(cuda_device):
    scene = get_design("design1")
    return scene, scene.arrays.to_torch(cuda_device)


def _close(got, ref):
    # Point/grid kernels: FMA contraction against separately rounded torch ops.
    return bool(((got - ref).abs() <= 1e-5 + 1e-6 * ref.abs()).all())


def test_point_eval_kernel(design1, cuda_device):
    scene, arrays = design1
    pe = make_point_eval(scene)
    pts = torch.from_numpy(np.random.default_rng(0).uniform(-6, 6, (100_003, 3)).astype(np.float32))
    pts = pts.to(cuda_device)
    before = kbuild.LAUNCHES["point_eval"]
    got = pe(pts, arrays)
    torch.cuda.synchronize()
    assert kbuild.LAUNCHES["point_eval"] == before + 1
    assert _close(got, pe.plain(pts, arrays))


def test_grid_eval_kernel(design1, cuda_device):
    scene, arrays = design1
    ge = make_grid_eval(scene)
    lo = np.array([-4.0, -3.0, -2.5], np.float32)
    got = ge(arrays, lo, np.float32(0.05), np.float32(7.0), 9, 70, 130)
    torch.cuda.synchronize()
    assert got.shape == (9, 70, 130)
    assert _close(got, ge.plain(arrays, lo, np.float32(0.05), np.float32(7.0), 9, 70, 130))


@pytest.mark.parametrize("size", [(128, 32), (640, 480)])
def test_renderer_kernel(design1, size):
    scene, arrays = design1
    config = RenderConfig(width=size[0], height=size[1])
    render = make_cuda_renderer(scene, config)
    cam = Camera.initial().orbit(0.2, -0.1).as_arrays()
    got = render(arrays, *cam)
    diff = (got - render.plain(arrays, *cam)).abs()
    assert diff.max() < 1e-3
    assert (diff > 1e-4).float().mean() < 0.01


def test_wrappers_refuse_bad_input(design1, cuda_device):
    scene, arrays = design1
    pe = make_point_eval(scene)
    with pytest.raises(ValueError):
        pe(torch.zeros((4, 3), dtype=torch.float64, device=cuda_device), arrays)
    with pytest.raises(ValueError):
        pe(torch.zeros((4, 3), device=cuda_device), scene.arrays.to_torch("cpu"))


def test_small_export_matches_cpu(cuda_device):
    scene = get_design("design1")
    cfg = dataclasses.replace(scene.export_config, grid_level=5, gradient_descent_steps=5)
    kw = dict(export_config=cfg, autodetect_resolution=32, strategy="dense")
    m_dev, r_dev = export_mesh(scene, device="cuda", **kw)
    m_cpu, r_cpu = export_mesh(scene, device="cpu", **kw)
    assert r_dev.stats["sdf_field"] == "cuda-exact"
    np.testing.assert_allclose(r_dev.bounding_box_center, r_cpu.bounding_box_center, atol=1e-5)
    assert m_dev.num_faces == m_cpu.num_faces > 0
    assert BatchEvaluator(scene).eval_sdf_at_points(np.zeros((1, 3)))[0] < 0


@pytest.fixture(scope="module")
def design2(cuda_device):
    scene = get_design("design2")
    return scene, scene.arrays.to_torch(cuda_device)


def _render_close(got, ref):
    # The rule of tests/test_pallas.py:115-116,133-134.
    diff = (got - ref).abs()
    return float(diff.max()) < 1e-3 and float((diff > 1e-4).float().mean()) < 0.01


def test_design2_point_eval_kernel(design2, cuda_device):
    scene, arrays = design2
    pe = make_point_eval(scene)
    pts = torch.from_numpy(np.random.default_rng(0).uniform(-2.5, 2.5, (65_537, 3)).astype(np.float32))
    pts = pts.to(cuda_device)
    assert _close(pe(pts, arrays), pe.plain(pts, arrays))


@pytest.mark.parametrize("name", ["design1", "design2"])
def test_cone_kernel(name, design1, design2):
    scene, arrays = design1 if name == "design1" else design2
    config = RenderConfig(march_overrelax=1.6, march_hierarchical=True)
    cone = make_cuda_cone_march(scene, config)
    rows = camera_rows(*Camera.initial().orbit(0.2, -0.1).as_arrays())
    rays = project(torch.from_numpy(coarse_ray_uv(config)), *torch.from_numpy(rows[1:]))
    rays = rays.to(arrays.ad.device)
    before = kbuild.LAUNCHES["cone_march"]
    got = cone(arrays, rows[0], rays)
    torch.cuda.synchronize()
    assert kbuild.LAUNCHES["cone_march"] == before + 1
    ref = cone.plain(arrays, rows[0], rays)
    far = config.max_distance
    assert float(((got > far) == (ref > far)).float().mean()) >= 0.99
    both = (got <= far) & (ref <= far)
    assert float((got - ref).abs()[both].max()) <= 1e-4


@pytest.mark.parametrize("name", ["design1", "design2"])
@pytest.mark.parametrize("hierarchical", [False, True])
def test_fast_renderer_kernels(name, hierarchical, design1, design2):
    scene, arrays = design1 if name == "design1" else design2
    config = RenderConfig(march_overrelax=1.6, march_hierarchical=hierarchical)
    factory = make_cuda_hierarchical_renderer if hierarchical else make_cuda_renderer
    render = factory(scene, config)
    cam = Camera.initial().orbit(0.2, -0.1).as_arrays()
    kinds = ("cone_march", "renderer_t0") if hierarchical else ("renderer_overrelax",)
    before = {k: kbuild.LAUNCHES[k] for k in kinds}
    got = render(arrays, *cam)
    torch.cuda.synchronize()
    assert all(kbuild.LAUNCHES[k] == before[k] + 1 for k in kinds)
    assert _render_close(got, render.plain(arrays, *cam))


FIT = RenderConfig(differentiable=True, soft_silhouette_bandwidth=0.02, gizmo=False)


@pytest.mark.parametrize("omega", [1.0, 1.6])
@pytest.mark.parametrize("name", ["design1", "design2"])
def test_ray_march_kernel(name, omega, design1, design2):
    """The fit's ray march at 640x480 against its plain version on the same
    rays: identical hit sets, d and vmin within 1e-5
    (tests/test_pallas.py:153-156)."""
    scene, arrays = design1 if name == "design1" else design2
    config = dataclasses.replace(FIT, march_overrelax=omega)
    ray_march = make_cuda_ray_march(scene, config)
    rows = camera_rows(*Camera.initial().orbit(0.2, -0.1).as_arrays())
    rays = project(ray_directions(config, arrays.ad.device),
                   *torch.as_tensor(rows[1:], device=arrays.ad.device))
    before = kbuild.LAUNCHES["ray_march"]
    d, vmin = ray_march(arrays, rows[0], rays)
    torch.cuda.synchronize()
    assert kbuild.LAUNCHES["ray_march"] == before + 1
    d_ref, vmin_ref = ray_march.plain(arrays, rows[0], rays)
    assert torch.equal(d > 0, d_ref > 0)
    assert float((d - d_ref).abs().max()) <= 1e-5
    assert float((vmin - vmin_ref).abs().max()) <= 1e-5


def test_fit_step_kernel_matches_plain_march(design1):
    """One geometric fit step's loss and position gradient with the kernel
    march against the same step with the plain march, on the card: loss rtol
    1e-5, gradient atol 1e-5 (tests/test_pallas.py:223-226)."""
    scene, _ = design1
    cam = Camera.initial().as_arrays()
    start = np.asarray(scene.arrays.position).copy()
    start[1:, 0] += 0.05
    out = {}
    for name, config in (("kernel", FIT), ("plain", dataclasses.replace(FIT, use_pallas_march=False))):
        harness = make_fit_harness(scene, config)
        target = harness.render_target(scene.arrays, *cam)
        params = harness.init({"position": start}).params
        before = kbuild.LAUNCHES["ray_march"]
        loss = harness.loss_fn(params, target, *cam)
        loss.backward()
        launched = kbuild.LAUNCHES["ray_march"] - before
        assert launched == (1 if name == "kernel" else 0)
        out[name] = (loss.item(), params["position"].grad)
    assert abs(out["kernel"][0] - out["plain"][0]) <= 1e-5 * abs(out["plain"][0])
    assert float((out["kernel"][1] - out["plain"][1]).abs().max()) <= 1e-5
    assert float(out["kernel"][1].abs().max()) > 0


@pytest.fixture(scope="module")
def logo(cuda_device):
    scene = get_design("logo")
    return scene, scene.arrays.to_torch(cuda_device)


def test_logo_point_and_grid_kernels(logo, cuda_device):
    """K1 and K3 on Logo's baked field (K6 inside) against the plain twin."""
    scene, arrays = logo
    pe, ge = make_point_eval(scene), make_grid_eval(scene)
    pts = torch.from_numpy(np.random.default_rng(0).uniform(-3.5, 3.5, (65_537, 3)).astype(np.float32))
    pts = pts.to(cuda_device)
    before = kbuild.LAUNCHES["point_eval"]
    got = pe(pts, arrays)
    torch.cuda.synchronize()
    assert kbuild.LAUNCHES["point_eval"] == before + 1
    assert _close(got, pe.plain(pts, arrays))
    lo = np.full(3, -3.5, np.float32)
    grid = (arrays, lo, np.float32(7.0 / 128), np.float32(10.0), 9, 129)
    assert _close(ge(*grid), ge.plain(*grid))


@pytest.mark.parametrize("mode", ["exact", "overrelax", "hierarchical"])
def test_logo_renderer_kernels(logo, mode):
    scene, arrays = logo
    config = RenderConfig(width=160, height=120, march_overrelax=1.0 if mode == "exact" else 1.6,
                          march_hierarchical=mode == "hierarchical")
    factory = make_cuda_hierarchical_renderer if mode == "hierarchical" else make_cuda_renderer
    render = factory(scene, config)
    cam = Camera.initial().orbit(0.2, -0.1).as_arrays()
    got = render(arrays, *cam)
    assert _render_close(got, render.plain(arrays, *cam))


def test_logo_ray_march_kernel(logo):
    scene, arrays = logo
    config = dataclasses.replace(FIT, width=160, height=120)
    ray_march = make_cuda_ray_march(scene, config)
    rows = camera_rows(*Camera.initial().as_arrays())
    rays = project(ray_directions(config, arrays.ad.device),
                   *torch.as_tensor(rows[1:], device=arrays.ad.device))
    d, vmin = ray_march(arrays, rows[0], rays)
    d_ref, vmin_ref = ray_march.plain(arrays, rows[0], rays)
    assert torch.equal(d > 0, d_ref > 0) and bool((d > 0).any())
    assert float((d - d_ref).abs().max()) <= 1e-5
    assert float((vmin - vmin_ref).abs().max()) <= 1e-5


def test_logo_evaluator_fields_on_card(logo):
    """The JAX package's rule on the card: Logo defaults to the exact tape
    (plain PyTorch, no kernel), the baked field rides K1; Design1 rides K1."""
    scene, _ = logo
    pts = np.random.default_rng(1).uniform(-3.5, 3.5, (4096, 3)).astype(np.float32)
    before = kbuild.LAUNCHES["point_eval"]
    exact = BatchEvaluator(scene)
    assert not exact.use_kernels and exact.sdf_field == "tape-exact"
    vals = exact.eval_sdf_at_points(pts)
    assert kbuild.LAUNCHES["point_eval"] == before
    baked = BatchEvaluator(scene, use_kernels=True)
    assert baked.sdf_field == "cuda-baked" and baked.twin_tolerance == 0.02
    twin = baked.eval_sdf_at_points(pts)
    assert kbuild.LAUNCHES["point_eval"] == before + 1
    band = (vals > 1e-3) & (vals < 0.1)
    assert np.abs(twin - vals)[band].max() < 0.02
    assert BatchEvaluator(get_design("design1")).sdf_field == "cuda-exact"


def test_logo_cli_export_reports_field(tmp_path, capsys, cuda_device):
    from designcsg_tpu_torch import cli

    for field, expect in (("baked", "cuda-baked"), ("exact", "tape-exact")):
        cli.main(["export", "logo", "--sdf-field", field, "--grid-level", "5",
                  "--stl", str(tmp_path / f"logo_{field}.stl")])
        assert f"(sdf field: {expect})" in capsys.readouterr().out


@pytest.mark.parametrize("cull", [True, "dynamic"])
@pytest.mark.parametrize("mode", ["exact", "overrelax", "hierarchical"])
@pytest.mark.parametrize("name", ["design1", "design2", "logo"])
def test_culled_renderer_kernels(name, mode, cull, cuda_device):
    """K7 inside K2: the culled renderer (hoisted or dynamic; exact,
    over-relaxed, or from the cone's t0 plane) equals the unculled kernel bit
    for bit (both -fmad=false) and follows its plain version by the render
    rule; each frame launches the culled kernel once."""
    scene = get_design(name)
    arrays = scene.arrays.to_torch(cuda_device)
    base = RenderConfig(width=160, height=120, march_overrelax=1.0 if mode == "exact" else 1.6,
                        march_hierarchical=mode == "hierarchical")
    config = dataclasses.replace(base, march_cull=cull)
    factory = make_cuda_hierarchical_renderer if mode == "hierarchical" else make_cuda_renderer
    cam = Camera.initial().orbit(0.2, -0.1).as_arrays()
    kernel = ("renderer_t0" if mode == "hierarchical" else "renderer_overrelax" if mode == "overrelax"
              else "renderer") + ("_cull_dynamic" if cull == "dynamic" else "_cull")
    before = kbuild.LAUNCHES[kernel]
    render = factory(scene, config)
    got = render(arrays, *cam)
    torch.cuda.synchronize()
    assert kbuild.LAUNCHES[kernel] == before + 1
    assert torch.equal(got, factory(scene, base)(arrays, *cam))
    assert _render_close(got, render.plain(arrays, *cam))


@pytest.mark.parametrize("mode", ["exact", "overrelax", "hierarchical"])
def test_hoisted_cull_prunes_near_view_kernel(mode, cuda_device):
    """Logo close up and head on with a short march range (max_distance 8),
    where the hoisted cull's view-cone boxes leave groups out: the culled
    kernel equals the unculled kernel bit for bit, and its plain version,
    which gives the same frame, skips over a tenth of the group
    evaluations."""
    scene = get_design("logo")
    arrays = scene.arrays.to_torch(cuda_device)
    base = RenderConfig(width=160, height=120, max_distance=8.0,
                        march_overrelax=1.0 if mode == "exact" else 1.6,
                        march_hierarchical=mode == "hierarchical")
    config = dataclasses.replace(base, march_cull=True)
    factory = make_cuda_hierarchical_renderer if mode == "hierarchical" else make_cuda_renderer
    cam = Camera.initial(apply_default_orbit=False).zoom(6.0).as_arrays()
    got = factory(scene, config)(arrays, *cam)
    ref = factory(scene, base)(arrays, *cam)
    assert torch.equal(got, ref)
    assert float((ref != 1.0).any(-1).float().mean()) > 0.2
    counts = {}
    plain = functools.partial(make_renderer(scene, config), cull_counts=counts)
    if mode == "hierarchical":
        plain = compose_hierarchical(config, make_cone_march(scene, config), plain)
    assert _render_close(got, plain(arrays, *cam))
    assert skipped_share(counts) > 0.1


@pytest.mark.parametrize("name", ["design1", "design2", "logo"])
def test_culled_grid_kernel(name, cuda_device):
    """K7 inside K3: the culled grid kernel against the unculled kernel and
    its plain version, within K3's 1e-5 + 1e-6|ref|, with a ragged edge."""
    scene = get_design(name)
    arrays = scene.arrays.to_torch(cuda_device)
    grid = (arrays, np.full(3, -3.5, np.float32), np.float32(7.0 / 100), np.float32(20.0), 19, 101, 77)
    culled = make_grid_eval(scene, cull=True)
    before = kbuild.LAUNCHES["grid_eval_cull"]
    got = culled(*grid)
    torch.cuda.synchronize()
    assert kbuild.LAUNCHES["grid_eval_cull"] == before + 1
    assert _close(got, make_grid_eval(scene)(*grid))
    assert _close(got, culled.plain(*grid))


@pytest.mark.parametrize("name", ["design1", "design2", "logo"])
def test_gizmo_point_and_grid_kernels(name, cuda_device):
    """K1 and K3 with the gizmo (a library of their own, counted apart)
    against their plain versions on the card, and the culled gizmo grid
    against the unculled one."""
    scene = get_design(name)
    arrays = scene.arrays.to_torch(cuda_device)
    pts = torch.from_numpy(np.random.default_rng(9).uniform(-4, 6, (5000, 3)).astype(np.float32)).to(cuda_device)
    pe = make_point_eval(scene, gizmo=True)
    before = kbuild.LAUNCHES["point_eval_gizmo"]
    assert _close(pe(pts, arrays), pe.plain(pts, arrays))
    assert kbuild.LAUNCHES["point_eval_gizmo"] == before + 1
    grid = (arrays, np.full(3, -1.5, np.float32), np.float32(6.5 / 64), np.float32(3.0), 19, 65, 70)
    ge = make_grid_eval(scene, gizmo=True)
    got = ge(*grid)
    assert _close(got, ge.plain(*grid))
    # The culled unit contracts its own FMAs: K3's rule, not bit equality.
    assert _close(make_grid_eval(scene, gizmo=True, cull=True)(*grid), got)


@pytest.mark.parametrize("cull", [True, "dynamic"])
def test_many_group_cull_kernels(cull, cuda_device):
    """89 cull groups (three mask words): the culled grid and renderer on
    the card equal the unculled kernels bit for bit."""
    scene = many_groups_scene()
    arrays = scene.arrays.to_torch(cuda_device)
    grid = (arrays, np.array([-6.0, -2.5, -1.0], np.float32), np.float32(0.0625), np.float32(0.0), 33, 80, 192)
    assert torch.equal(make_grid_eval(scene, cull=True)(*grid), make_grid_eval(scene)(*grid))
    base = RenderConfig(width=320, height=240)
    cam = Camera.initial(apply_default_orbit=False).zoom(2.0).as_arrays()
    got = make_cuda_renderer(scene, dataclasses.replace(base, march_cull=cull))(arrays, *cam)
    assert torch.equal(got, make_cuda_renderer(scene, base)(arrays, *cam))


def test_active_and_compact_exports_on_card(cuda_device):
    """The active and compact strategies on the card give the dense
    strategy's triangles, with the native mesh ops."""
    scene = get_design("design1")
    cfg = dataclasses.replace(scene.export_config, grid_level=7, gradient_descent_steps=0)
    meshes = {s: export_mesh(scene, cfg, strategy=s, autodetect_resolution=64)
              for s in ("dense", "active", "compact")}
    soups = {s: np.sort(m.triangle_soup().reshape(-1, 9), axis=0) for s, (m, _) in meshes.items()}
    np.testing.assert_array_equal(soups["active"], soups["dense"])
    np.testing.assert_allclose(soups["compact"], soups["dense"], atol=1e-5)
    assert all(r.stats["native"] and r.stats["sdf_field"] == "cuda-exact" for _, r in meshes.values())


def test_scene_without_cuda_bodies_runs_on_card(cuda_device):
    """P3: a define_brush(fn)-only scene evaluates and renders on the card
    through the plain tape."""
    scene = custom_brush_scene()
    ev = BatchEvaluator(scene)
    assert ev.sdf_field == "tape-exact"
    assert np.isfinite(ev.eval_sdf_at_points(np.zeros((4, 3), np.float32))).all()
    render = make_scene_renderer(scene, RenderConfig(width=64, height=48), cuda_device)
    assert render.engine == "tape"
    assert torch.isfinite(render(scene.arrays.to_torch(cuda_device), *Camera.initial().as_arrays())).all()


@pytest.mark.parametrize("gizmo", [False, True])
@pytest.mark.parametrize("name", ["design1", "design2", "logo"])
def test_point_eval_fd_kernel(name, gizmo, cuda_device):
    """K1's FD form (one launch: the SDF and its FD normal) against its plain
    version, the plain SDF composed with the plain FD glue: both within
    1e-5 + 1e-6|ref| (the unit builds without FMA contraction), and the
    normals of unit length."""
    scene = get_design(name)
    arrays = scene.arrays.to_torch(cuda_device)
    half = 3.5 if name == "logo" else 6.0
    pts = torch.from_numpy(np.random.default_rng(11).uniform(-half, half, (70_001, 3))
                           .astype(np.float32)).to(cuda_device)
    fd = make_point_eval(scene, gizmo=gizmo).fd
    before = kbuild.LAUNCHES[fd.kernel]
    sdf, normal = fd(pts, arrays)
    torch.cuda.synchronize()
    assert kbuild.LAUNCHES[fd.kernel] == before + 1
    sdf_ref, normal_ref = fd.plain(pts, arrays)
    assert _close(sdf, sdf_ref) and _close(normal, normal_ref)
    assert float((normal.norm(dim=1) - 1.0).abs().max()) <= 1e-5


def test_refine_makes_one_fd_launch_per_chunk_and_step(design1, cuda_device):
    """The export's refine on the card: one K1 launch (its FD form) per chunk
    and step, none of the single-point kernel, and the vertices of the same
    loop on the plain tape on the card (point evaluations and the plain FD
    glue) within 1e-5."""
    scene, _ = design1
    v = np.random.default_rng(12).uniform(-3.0, 3.0, (5000, 3)).astype(np.float32)
    ev = BatchEvaluator(scene, chunk_size=2048)
    before = dict(kbuild.LAUNCHES)
    got = ev.refine_on_device(v, steps=4)
    launched = {k: kbuild.LAUNCHES[k] - before.get(k, 0) for k in ("point_eval", "point_eval_fd")}
    assert launched == {"point_eval": 0, "point_eval_fd": 3 * 4}
    ref = BatchEvaluator(scene, use_kernels=False, chunk_size=2048).refine_on_device(v, 4)
    assert np.abs(got - ref).max() <= 1e-5


def test_logo_planes_and_cone_on_card(logo, cuda_device):
    """K6's planes against the rank sum they expand, both plain on the card
    (atol 1e-6), and K5 on Logo's baked field against its plain version."""
    from designcsg_tpu_torch.ops.table import packed_rank_sample, plane_sample

    scene, arrays = logo
    _, tables = scene.device_extras(cuda_device)
    g = torch.from_numpy(np.random.default_rng(13).uniform(-1, 128, (2, 1 << 18)).astype(np.float32))
    gx, gy = g.to(cuda_device)
    for name, _ in scene.extras:
        got = plane_sample(tables[f"{name}_planes"], gx, gy)
        assert float((got - packed_rank_sample(tables[name], gx, gy)).abs().max()) <= 1e-6
    config = RenderConfig(march_overrelax=1.6, march_hierarchical=True)
    cone = make_cuda_cone_march(scene, config)
    rows = camera_rows(*Camera.initial().as_arrays())
    rays = project(torch.from_numpy(coarse_ray_uv(config)), *torch.from_numpy(rows[1:])).to(cuda_device)
    got, ref = cone(arrays, rows[0], rays), cone.plain(arrays, rows[0], rays)
    far = config.max_distance
    assert float(((got > far) == (ref > far)).float().mean()) >= 0.99
    both = (got <= far) & (ref <= far)
    assert float((got - ref).abs()[both].max()) <= 1e-4


# K4 redesigned: the bank in constant memory where tables make the shared
# build reload it, the origin read on the card.  Every ray runs the per-ray
# march's step from its own state, so the kernel gives its plain version's
# bits.
K4_SHAPES = {"640x480": (640, 480), "64x48": (64, 48), "1000 rays": None}


def _k4_rays(config, shape, device):
    rows = camera_rows(*Camera.initial().orbit(0.2, -0.1).as_arrays())
    if shape is None:  # a batch that is not a multiple of a warp, spread over the view
        dirs = ray_directions(dataclasses.replace(config, width=40, height=25), device).reshape(-1, 3)
        return rows, project(dirs, *torch.as_tensor(rows[1:], device=device)).contiguous()
    cfg = dataclasses.replace(config, width=shape[0], height=shape[1])
    return rows, project(ray_directions(cfg, device), *torch.as_tensor(rows[1:], device=device))


@pytest.mark.parametrize("shape", list(K4_SHAPES))
@pytest.mark.parametrize("omega", [1.0, 1.6])
@pytest.mark.parametrize("name", ["design1", "design2", "logo"])
def test_ray_march_kernel_bit_equal(name, omega, shape, cuda_device):
    """K4 against its plain version on every design, both march modes, at
    the fit's 640x480, `cli fit`'s 64x48 and 1000 rays: identical hit sets,
    d and vmin bit for bit; the origin passed as a CUDA tensor."""
    scene = get_design(name)
    arrays = scene.arrays.to_torch(cuda_device)
    config = dataclasses.replace(FIT, march_overrelax=omega)
    ray_march = make_cuda_ray_march(scene, config)
    rows, rays = _k4_rays(config, K4_SHAPES[shape], cuda_device)
    d, vmin = ray_march(arrays, torch.as_tensor(rows[0], device=cuda_device), rays)
    d_ref, vmin_ref = ray_march.plain(arrays, rows[0], rays)
    assert torch.equal(d > 0, d_ref > 0) and bool((d > 0).any())
    assert torch.equal(d, d_ref) and torch.equal(vmin, vmin_ref)


@pytest.mark.parametrize("name", ["design1", "design2", "logo"])
def test_ray_march_kernel_repeats(name, cuda_device):
    """Two K4 launches in a row give the same bits, each counted once (the
    constant bank is refilled for each)."""
    scene = get_design(name)
    arrays = scene.arrays.to_torch(cuda_device)
    ray_march = make_cuda_ray_march(scene, FIT)
    rows, rays = _k4_rays(FIT, (640, 480), cuda_device)
    before = kbuild.LAUNCHES["ray_march"]
    first = ray_march(arrays, rows[0], rays)
    second = ray_march(arrays, rows[0], rays)
    torch.cuda.synchronize()
    assert kbuild.LAUNCHES["ray_march"] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_constant_bank_unit_keeps_one_stream(cuda_device):
    """Logo's K4 unit keeps its bank in constant memory: a launch on another
    stream than its first raises (the two would race on the bank), and the
    first stream goes on working."""
    scene = get_design("logo")
    arrays = scene.arrays.to_torch(cuda_device)
    ray_march = make_cuda_ray_march(scene, FIT)
    rows, rays = _k4_rays(FIT, (64, 48), cuda_device)
    first = ray_march(arrays, rows[0], rays)
    with torch.cuda.stream(torch.cuda.Stream(cuda_device)):
        with pytest.raises(RuntimeError, match="one stream"):
            ray_march(arrays, rows[0], rays)
    assert all(torch.equal(a, b) for a, b in zip(first, ray_march(arrays, rows[0], rays)))


@pytest.mark.parametrize("name,launches", [("design1", 3), ("logo", 3)])
def test_fit_steps_launch_ray_march_once_each(name, launches, cuda_device):
    """K4's launches on the fit's path are unchanged: one for the target,
    one per Adam step (path D's 11 and path F's 8 in chip_smoke.py)."""
    scene = get_design(name)
    harness = make_fit_harness(scene, FIT)
    cam = Camera.initial().as_arrays()
    start = np.asarray(scene.arrays.position).copy()
    start[1:, 0] += 0.05
    before = kbuild.LAUNCHES["ray_march"]
    target = harness.render_target(scene.arrays, *cam)
    state = harness.init({"position": start})
    for _ in range(launches - 1):
        state, loss = harness.step_fn(state, target, *cam)
    torch.cuda.synchronize()
    assert kbuild.LAUNCHES["ray_march"] - before == launches
    assert bool(torch.isfinite(loss))


@pytest.mark.parametrize("cull", [True, "dynamic"])
@pytest.mark.parametrize("name", ["design1", "design2", "logo"])
def test_culled_renderer_lane_chain_full_frame(name, cull, cuda_device):
    """K2's culled renderer on the lane chain at the viewport's 640x480,
    from the camera and from the cone's t0 plane: every frame bit-equal to
    the unculled kernel's."""
    scene = get_design(name)
    arrays = scene.arrays.to_torch(cuda_device)
    cam = Camera.initial().as_arrays()
    for base, factory in ((RenderConfig(), make_cuda_renderer),
                          (RenderConfig(march_overrelax=1.6, march_hierarchical=True),
                           make_cuda_hierarchical_renderer)):
        got = factory(scene, dataclasses.replace(base, march_cull=cull))(arrays, *cam)
        assert torch.equal(got, factory(scene, base)(arrays, *cam))


@pytest.mark.parametrize("name", ["design1", "design2", "logo"])
def test_dynamic_cull_held_box_counts(name, cuda_device):
    """The dynamic culled kernel built with its counters (CULL_STATS) gives
    the same frame, as many evaluations as its plain version counts, and
    fewer chains: the held box serves steps the per-step cull would chain."""
    scene = get_design(name)
    arrays = scene.arrays.to_torch(cuda_device)
    config = RenderConfig(width=160, height=120, march_cull="dynamic")
    cam = Camera.initial().orbit(0.2, -0.1).as_arrays()
    render = make_cuda_renderer(scene, config)
    frame, counts = make_cuda_renderer(scene, config, cull_stats=True)(arrays, *cam)
    assert torch.equal(frame, render(arrays, *cam))
    plain_counts = {}
    render.plain(arrays, *cam, cull_counts=plain_counts)
    assert counts["evals"] == plain_counts["evals"]
    assert 0 < counts["chains"] < plain_counts["chains"]
    assert counts["group_evals"] <= counts["evals"] * len(plain_counts["group_evals"])


@functools.lru_cache(maxsize=None)
def _scene_on_card(name):
    scene = get_design(name)
    return scene, scene.arrays.to_torch("cuda")


@pytest.mark.parametrize("shape", [(1, 5, 3), (17, 33, 70), (33, 257, 257)])
@pytest.mark.parametrize("name", ["design1", "design2", "logo"])
def test_grid_kernel_columns_every_form(name, shape, cuda_device):
    """K3 on lattice columns, at slabs whose planes and z ranges are ragged:
    every form within the grid rule of its plain version, each culled grid
    bit-equal to its unculled grid, and one launch each."""
    scene, arrays = _scene_on_card(name)
    nz, ny, nx = shape
    grid = (arrays, np.full(3, -3.5, np.float32), np.float32(7.0 / 256), 100.0, nz, ny, nx)
    for gizmo in (False, True):
        plain_grid = make_grid_eval(scene, gizmo=gizmo)
        culled = make_grid_eval(scene, gizmo=gizmo, cull=True)
        before = dict(kbuild.LAUNCHES)
        got, got_cull = plain_grid(*grid), culled(*grid)
        torch.cuda.synchronize()
        for kernel in (plain_grid.kernel, culled.kernel):
            assert kbuild.LAUNCHES[kernel] == before.get(kernel, 0) + 1
        assert got.shape == shape and _close(got, plain_grid.plain(*grid))
        assert torch.equal(got_cull, got)


@pytest.mark.parametrize("warps", [None, 0, 1, 2, 4, 8])
@pytest.mark.parametrize("name", ["design1", "design2", "logo"])
def test_cone_kernel_split_bit_equal(name, warps, cuda_device, monkeypatch):
    """K5 split across S warps a block (None: tape.cone_warps' choice; 0: one
    thread a ray) gives the plain version's t_safe bit for bit on the
    640x480 frame's block rays and on a batch that leaves its last block
    part empty, with the origin read on the card."""
    from designcsg_tpu_torch.ops.cuda import march_kernel as mk, tape

    scene, arrays = _scene_on_card(name)
    config = RenderConfig(march_overrelax=1.6, march_hierarchical=True)
    if warps is not None:
        monkeypatch.setattr(mk, "cone_kernel_source",
                            lambda s, c: tape.cone_kernel_source(s, c, warps=warps))
    cone = make_cuda_cone_march(scene, config)
    rows = camera_rows(*Camera.initial().orbit(0.2, -0.1).as_arrays())
    rays = project(torch.from_numpy(coarse_ray_uv(config)), *torch.from_numpy(rows[1:])).to(cuda_device)
    o = torch.as_tensor(rows[0], device=cuda_device)
    for batch in (rays, rays.reshape(-1, 3)[:1000].contiguous()):
        got = cone(arrays, o, batch)
        assert torch.equal(got, cone.plain(arrays, rows[0], batch))


@pytest.mark.parametrize("n, warps", [(44, 4), (66, 0)])
def test_cone_kernel_large_scene(n, warps, cuda_device):
    """K5 on scenes of 133 and 199 objects: the first splits across four
    warps (40 KB of shared memory), the second, past the 48 KB a kernel may
    declare with the split's slot buffers, builds one thread a ray; both
    give the plain version's t_safe bit for bit, and a hierarchical frame
    of the larger renders through it."""
    from designcsg_tpu_torch.ops.cuda.tape import cone_warps

    scene = many_groups_scene(n)
    arrays = scene.arrays.to_torch(cuda_device)
    config = RenderConfig(width=160, height=120, march_overrelax=1.6, march_hierarchical=True)
    assert cone_warps(scene, config.gizmo) == warps
    cone = make_cuda_cone_march(scene, config)
    cam = Camera.initial().orbit(0.2, -0.1).as_arrays()
    rows = camera_rows(*cam)
    rays = project(torch.from_numpy(coarse_ray_uv(config)), *torch.from_numpy(rows[1:])).to(cuda_device)
    got = cone(arrays, torch.as_tensor(rows[0], device=cuda_device), rays)
    assert torch.equal(got, cone.plain(arrays, rows[0], rays))
    assert bool((got < config.max_distance).any())
    before = kbuild.LAUNCHES["cone_march"]
    frame = make_cuda_hierarchical_renderer(scene, config)(arrays, *cam)
    torch.cuda.synchronize()
    assert kbuild.LAUNCHES["cone_march"] == before + 1
    assert frame.shape == (120, 160, 3) and bool(torch.isfinite(frame).all())


def test_cone_and_hierarchical_frame_do_not_synchronize(design1, cuda_device):
    """With the origin on the card the cone launch makes no host
    synchronization, and neither does a hierarchical frame, whose camera
    rows go up through pinned memory (torch's sync debug mode raises on
    one)."""
    scene, arrays = design1
    config = RenderConfig(march_overrelax=1.6, march_hierarchical=True)
    cone = make_cuda_cone_march(scene, config)
    render = make_cuda_hierarchical_renderer(scene, config)
    cam = Camera.initial().as_arrays()
    rows = camera_rows(*cam)
    rays = project(torch.from_numpy(coarse_ray_uv(config)), *torch.from_numpy(rows[1:])).to(cuda_device)
    o = torch.as_tensor(rows[0], device=cuda_device)
    ref = cone(arrays, o, rays), render(arrays, *cam)  # builds outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = cone(arrays, o, rays), render(arrays, *cam)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


# -- slice 10: the shells, the compacted renderer, analytic normals and the
# dynamic tape on the card (chip_smoke.py phase 8H at the full size).

D1_SCRIPT = "from designcsg_tpu_torch.designs import design1\n\n\ndef build():\n    return design1.build()\n"


def test_studio_on_the_card(cuda_device, tmp_path):
    """A StudioSession on the card renders through the CUDA renderer: the
    exact mode launches K2 once a frame, the fast mode the cone kernel and
    K2 from its t0 plane; the export runs the grid kernel and K1's FD
    form."""
    from designcsg_tpu_torch.studio import StudioSession, Workspace

    ws = Workspace(str(tmp_path / "ws"))
    session = StudioSession(ws, width=160, height=120)
    ws.write("d1", D1_SCRIPT)
    assert session.run_design("d1") and session.engine == "cuda"
    session.set_render_mode(exact=True)
    before = dict(kbuild.LAUNCHES)
    assert session.render().shape == (120, 160, 3)
    assert kbuild.LAUNCHES["renderer"] == before.get("renderer", 0) + 1
    session.set_render_mode(exact=False)
    session.render()
    assert kbuild.LAUNCHES["cone_march"] == before.get("cone_march", 0) + 1
    assert kbuild.LAUNCHES["renderer_t0"] == before.get("renderer_t0", 0) + 1
    assert session.start_export(str(tmp_path / "d1.stl"), grid_level=5)
    session._export_thread.join(300)
    status = session.export_status
    assert status["state"] == "done" and status["fraction"] == 1.0 and status["triangles"] > 0
    assert kbuild.LAUNCHES["point_eval_fd"] > before.get("point_eval_fd", 0)


def test_orbit_frames_and_trace_on_the_card(design1, cuda_device, tmp_path):
    """orbit_frames on the card equals render_scene from each camera bit for
    bit, and profile_trace's Chrome trace names K2's kernel."""
    import json
    import os

    from designcsg_tpu_torch.observability import TRACE_FILE, profile_trace
    from designcsg_tpu_torch.ops.raymarch import render_scene
    from designcsg_tpu_torch.viewer import orbit_frames

    scene, _ = design1
    config = RenderConfig(width=160, height=120)
    frames = orbit_frames(scene, n_frames=2, config=config)
    cam = Camera.initial()
    for frame in frames:
        assert np.array_equal(frame, render_scene(scene, camera=cam, config=config).cpu().numpy())
        cam.orbit(np.pi, 0.0)
    with profile_trace(str(tmp_path)):
        render_scene(scene, config=config)
    with open(os.path.join(str(tmp_path), TRACE_FILE)) as f:
        assert any("render_kernel" in e.get("name", "") for e in json.load(f)["traceEvents"])


def test_frame_spans_share_the_device_trace_clock(design1, cuda_device):
    """Under the benchmark's profiler (its CUDA activity alone) 640x480
    Design1 frames record ``viewer.frame``, ``viewer.render`` and
    ``copy.d2h`` (so torch's private profiler flag that observability.py
    reads holds on this torch).  Moved onto the profiler's clock
    (benchmark/program.py), the spans hold what the profiler saw, within
    20 us: every device-to-host copy on the card and the runtime's
    ``cudaMemcpyAsync`` that issued it lie inside a ``copy.d2h`` span, and
    each ``viewer.render`` holds the frame's two launches (the bank's fill
    and K2)."""
    import time
    import types

    from benchmark import program
    from benchmark import trace as tracing
    from designcsg_tpu_torch import observability
    from designcsg_tpu_torch.viewer import _make_render_fn

    scene, _ = design1
    run = _make_render_fn(scene, RenderConfig(width=640, height=480), cuda_device)
    cam = Camera.initial()
    run(cam)
    observability.clear_spans()
    raw = []
    with tracing.traced(cuda_device) as capture:
        for _ in range(20):
            a = time.perf_counter()
            run(cam)
            b = time.perf_counter()
            raw.append(("benchmark.frame", int(a * 1e9), int(b * 1e9)))
            cam.orbit(0.01, 0.0)
    ctx = types.SimpleNamespace(window={"spans": raw}, trace=tracing.reduce(capture, raw))
    spans = program.spans(ctx)
    assert program.roots(spans, "viewer.frame") == 20
    renders = [s for _, s in program.named(spans, "viewer.render")]
    copies = [s for i, s in program.named(spans, "copy.d2h")
              if program.under(spans, i, "viewer.frame")]
    assert len(renders) == 20 and len(copies) == 20
    assert all(s.value == 640 * 480 * 3 * 4 for s in copies)
    lo, hi = ctx.trace.window

    def misfit(records, within):
        return max(min(max(0, s.start - a, b - s.end) for s in within) for a, b in records)

    dtoh = [(a, b) for _, a, b in ctx.trace.device_ops("Memcpy DtoH")]
    memcpy = [(a, b) for n, a, b in ctx.trace.host if n == "cudaMemcpyAsync" and lo <= a < hi]
    launches = [(a, b) for n, a, b in ctx.trace.host if n == "cudaLaunchKernel"]
    inside = [sum(1 for a, b in launches if r.start - 20_000 <= a and b <= r.end + 20_000)
              for r in renders]
    assert len(dtoh) == 20 and len(memcpy) == 20 and inside == [2] * 20
    worst = {"Memcpy DtoH": misfit(dtoh, copies), "cudaMemcpyAsync": misfit(memcpy, copies)}
    print(f"largest misfit outside copy.d2h, ns: {worst}; shift {program.shift(ctx)} ns, "
          f"the clocks' offset {program.host_offset()} ns")
    assert max(worst.values()) <= 20_000


def test_compacted_renderer_on_the_card(cuda_device):
    """Logo's compacted frame on the card against make_renderer on the exact
    field by the JAX package's rule (tests/test_raymarch.py:202-207)."""
    from designcsg_tpu_torch.ops.raymarch import make_compacted_renderer, to_u8

    scene = get_design("logo")
    arrays = scene.arrays.to_torch(cuda_device)
    config = RenderConfig(width=96, height=72)
    cam = Camera.initial().as_arrays()
    img_c = to_u8(make_compacted_renderer(scene, config)(arrays, *cam)).int()
    img_p = to_u8(make_renderer(scene, config, field="exact")(arrays, *cam)).int()
    hit_c, hit_p = (img_c < 250).any(-1), (img_p < 250).any(-1)
    assert float((hit_c != hit_p).float().mean()) < 5e-3
    assert float(((img_c - img_p).abs().amax(-1) > 8).float().mean()) < 0.03


def test_analytic_normals_and_dynamic_tape_on_the_card(design1, cuda_device):
    """Analytic normals of the plain tape on the card within 1e-5 of the
    CPU's; the dynamic tape bit-equal to the staged tape on the card."""
    from designcsg_tpu_torch.ops.interpreter import make_dynamic_primary_sdf, make_primary_sdf

    scene, arrays = design1
    pts = np.random.default_rng(5).uniform(-4, 4, (1 << 16, 3)).astype(np.float32)
    card = BatchEvaluator(scene, use_kernels=False, normal_mode="analytic").eval_normal_at_points(pts)
    cpu = BatchEvaluator(scene, device="cpu", normal_mode="analytic").eval_normal_at_points(pts)
    assert np.abs(card - cpu).max() <= 1e-5
    t = torch.from_numpy(pts).to(cuda_device)
    for name in ("design1", "design2"):
        sc = get_design(name)
        a = sc.arrays.to_torch(cuda_device)
        assert torch.equal(make_dynamic_primary_sdf(sc)(t, a), make_primary_sdf(sc)(t, a))


def test_bench_headline_cells_on_the_card(design1, cuda_device):
    """``cli bench``'s Design1 headline cells at 640x480 on the card: the
    over-relaxed frame (K2) and the hierarchical frame (K5, then K2 from its
    t0 plane) each launched once a frame, the warm frames against their
    plain versions, and the payload's form."""
    from designcsg_tpu_torch import bench

    scene, arrays = design1
    kbuild.LAUNCHES.clear()
    fast = bench.render_cell(scene, bench.OVERRELAX, 2, "cuda")
    hier = bench.render_cell(scene, bench.HIERARCHICAL, 2, "cuda")
    counted = dict(kbuild.LAUNCHES)
    frames = 1 + bench.TRIALS * 2
    assert fast["engine"] == hier["engine"] == "cuda"
    assert counted == {"renderer_overrelax": frames, "cone_march": frames, "renderer_t0": frames}
    cam = Camera.initial().as_arrays()
    for cell, config in ((fast, bench.OVERRELAX), (hier, bench.HIERARCHICAL)):
        assert cell["frame"].shape == (480, 640, 3) and cell["seconds"] > 0
        plain = (make_hierarchical_renderer if config.march_hierarchical else make_renderer)(
            scene, config)(arrays, *cam)
        diff = (cell["frame"] - plain).abs()
        assert diff.max() < 1e-3 and (diff > 1e-4).float().mean() < 0.01
    mode = "hierarchical+overrelax1.6" if hier["rays_per_s"] > fast["rays_per_s"] else "overrelax1.6"
    out = bench.payload(max(fast["rays_per_s"], hier["rays_per_s"]), mode, fast["rays_per_s"])
    assert list(out) == ["metric", "value", "unit", "vs_baseline", "baseline_note",
                         "exact_k1_rays_per_s"]
    assert out["metric"] == f"design1_sphere_trace_rays_per_s_chip[{mode}]" and out["value"] > 0
