"""CUDA kernels of the port against their plain versions, on the card.

Marked ``cuda``; each test takes the ``cuda_device`` fixture, which skips when
no CUDA device is present.  Run on a machine with a card:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -o addopts="" -p no:cacheprovider
"""

import dataclasses

import numpy as np
import pytest
import torch

from designcsg_tpu_torch.camera import Camera
from designcsg_tpu_torch.config import RenderConfig
from designcsg_tpu_torch.designs import get_design
from designcsg_tpu_torch.evaluator import BatchEvaluator
from designcsg_tpu_torch.export.pipeline import export_mesh
from designcsg_tpu_torch.ops.cuda import build as kbuild
from designcsg_tpu_torch.ops.cuda.march_kernel import (
    make_cuda_cone_march,
    make_cuda_hierarchical_renderer,
    make_cuda_ray_march,
    make_cuda_renderer,
)
from designcsg_tpu_torch.ops.cuda.sdf_kernel import make_grid_eval, make_point_eval
from designcsg_tpu_torch.ops.raymarch import camera_rows, coarse_ray_uv, project, ray_directions
from designcsg_tpu_torch.parallel.fit import make_fit_harness

pytestmark = pytest.mark.cuda


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
