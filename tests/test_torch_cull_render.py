"""The culled renderer and grid (K7 inside K2 and K3) on the CPU: their plain
versions against the unculled ones and against the JAX package's culled
Pallas kernels in interpret mode, at tests/test_pallas.py's sizes and
tolerances (:344-367 hoisted, :445-472 dynamic).
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import designs as jdesigns
from designcsg_tpu.camera import Camera as JCamera
from designcsg_tpu.config import RenderConfig as JRenderConfig
from designcsg_tpu.ops.interpreter import as_device_arrays
from designcsg_tpu.ops.pallas.march_kernel import make_pallas_renderer
from designcsg_tpu.ops.pallas.sdf_kernel import make_grid_eval as jmake_grid_eval
from designcsg_tpu_torch.camera import Camera
from designcsg_tpu_torch.config import RenderConfig
from designcsg_tpu_torch.designs import get_design
from designcsg_tpu_torch.ops.cull import skipped_share
from designcsg_tpu_torch.ops.cuda.march_kernel import make_cuda_hierarchical_renderer, make_cuda_renderer
from designcsg_tpu_torch.ops.cuda.sdf_kernel import make_grid_eval
from designcsg_tpu_torch.ops.raymarch import (
    camera_rows,
    compose_hierarchical,
    hoisted_boxes,
    make_cone_march,
    make_march,
    make_renderer,
    project,
    ray_directions,
    warp_tiles,
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
    return {name: get_design(name) for name in ("design1", "design2", "logo")}


def _jax_render(name, config, camera):
    scene = jdesigns.get_design(name)
    cam = [jnp.asarray(a) for a in camera.as_arrays()]
    return np.asarray(make_pallas_renderer(scene, config, interpret=True)(as_device_arrays(scene.arrays), *cam))


def _near_camera():
    """Logo close up and head on (the camera at z = -4): with a short march
    range (max_distance 8) the hoisted cull's view-cone boxes leave groups
    out there; from the orbited cameras they leave none out."""
    return Camera.initial(apply_default_orbit=False).zoom(6.0)


@pytest.mark.parametrize(
    "name,cull,omega,hierarchical,near",
    [
        ("design1", True, 1.0, False, False),
        ("design1", "dynamic", 1.6, False, False),
        ("design2", "dynamic", 1.0, False, False),
        ("design2", True, 1.6, True, False),
        ("logo", "dynamic", 1.6, True, False),
        ("logo", True, 1.0, False, True),
        ("logo", True, 1.6, False, True),
        ("logo", True, 1.6, True, True),
    ],
)
def test_plain_culled_renderer_equals_unculled(scenes, name, cull, omega, hierarchical, near):
    """At 80x40 (5 warp tiles by 20; F = 5 divides it): the culled renderer's
    plain version (hoisted or dynamic; exact, over-relaxed or from the cone's
    t0 plane) equals the unculled one bit for bit.  The dynamic cull skips
    some group evaluations (none on Design2), and the hoisted one over a
    tenth of them in Logo's close-up, where a box too small would show."""
    scene = scenes[name]
    base = RenderConfig(width=80, height=40, max_steps=96, march_overrelax=omega,
                        march_hierarchical=hierarchical, **({"max_distance": 8.0} if near else {}))
    config = dataclasses.replace(base, march_cull=cull)
    make = make_cuda_hierarchical_renderer if hierarchical else make_cuda_renderer
    cam = (_near_camera() if near else Camera.initial().orbit(0.2, -0.1)).as_arrays()
    arrays = scene.arrays.to_torch("cpu")
    ref = make(scene, base)(arrays, *cam)
    torch.testing.assert_close(make(scene, config)(arrays, *cam), ref, rtol=0, atol=0)
    assert (ref != 1.0).any(-1).float().mean() > (0.2 if near else 0.05)
    counts = {}
    render = functools.partial(make_renderer(scene, config), cull_counts=counts)
    if hierarchical:
        render = compose_hierarchical(config, make_cone_march(scene, config), render)
    torch.testing.assert_close(render(arrays, *cam), ref, rtol=0, atol=0)
    assert counts["evals"] > 0
    if near:
        assert skipped_share(counts) > 0.1
    elif cull == "dynamic" and name != "design2":
        assert skipped_share(counts) > 0.0


@pytest.mark.parametrize("omega,hierarchical", [(1.0, False), (1.6, True)])
def test_hoisted_box_holds_the_shaded_points(scenes, omega, hierarchical):
    """The cull is exact only inside a tile's hoisted box, so the box must
    hold every point the tile's rays evaluate: Logo close up at 80x40, each
    ray's start o + t0*r, and each hit point with its six FD probes (a ray
    that stops at its t0 plane puts probes N_EPS past the box's face)."""
    scene = scenes["logo"]
    config = RenderConfig(width=80, height=40, max_steps=96, max_distance=8.0, march_overrelax=omega,
                          march_hierarchical=hierarchical, march_cull=True)
    cam = _near_camera().as_arrays()
    arrays = scene.arrays.to_torch("cpu")
    rows = torch.from_numpy(camera_rows(*cam))
    r_proj = project(ray_directions(config), *rows[1:])
    t0 = None
    if hierarchical:
        planes = []
        compose_hierarchical(config, make_cone_march(scene, config),
                             lambda *args: planes.append(args[5]))(arrays, *cam)
        t0 = planes[0]
    d = make_march(scene, config)(rows[0], r_proj, arrays, t0=t0).reshape(-1)
    box, tiles, _ = hoisted_boxes(config, rows[0], r_proj, t0)
    r = r_proj.reshape(-1, 3)
    start = rows[0] + (0.0 if t0 is None else t0.reshape(-1, 1)) * r
    hit = d > 0.0
    p = rows[0] + d[:, None] * r
    eps = torch.eye(3) * np.float32(config.normal_epsilon)
    points = [(start, torch.ones_like(hit))] + [(p + s * e, hit) for e in eps for s in (1.0, -1.0)]
    assert hit.float().mean() > 0.2
    for q, rays in points:
        for i, (lo, hi) in enumerate(box):
            assert ((q[:, i] >= lo[tiles]) & (q[:, i] <= hi[tiles]))[rays].all()


def test_warp_tiles_are_the_kernels():
    """A tile is a 16x2 patch of the kernel's 16x8 blocks."""
    tiles, n = warp_tiles(RenderConfig(width=40, height=6))
    assert n == 3 * 3
    assert tiles[0, :16].unique().tolist() == [0] and tiles[1, :16].unique().tolist() == [0]
    assert tiles[2, 16] == 4 and tiles[5, 39] == 8


def test_plain_hoisted_cull_matches_jax_kernel(scenes):
    """Design1, hoisted cull, 128x8 and 32 steps: the port's plain culled
    renderer against make_pallas_renderer(march_cull=True) in interpret
    mode, by tests/test_pallas.py:364-367's rule."""
    config = RenderConfig(width=128, height=8, max_steps=32, march_cull=True)
    ours = make_cuda_renderer(scenes["design1"], config)(
        scenes["design1"].arrays.to_torch("cpu"), *Camera.initial().as_arrays()).numpy()
    ref = _jax_render("design1", JRenderConfig(width=128, height=8, max_steps=32, march_cull=True,
                                               march_unroll=2), JCamera.initial())
    diff = np.abs(ours - ref)
    assert diff.max() < 2e-4
    assert (diff > 2e-4).sum() == 0


def test_plain_dynamic_cull_matches_jax_kernel(scenes):
    """Design2, dynamic cull, 32x32 and 64 steps: against
    make_pallas_renderer(march_cull="dynamic") in interpret mode, by
    tests/test_pallas.py:471-472's rule."""
    config = RenderConfig(width=32, height=32, max_steps=64, march_cull="dynamic")
    ours = make_cuda_renderer(scenes["design2"], config)(
        scenes["design2"].arrays.to_torch("cpu"), *Camera.initial().as_arrays()).numpy()
    ref = _jax_render("design2", JRenderConfig(width=32, height=32, max_steps=64, march_cull="dynamic",
                                               march_unroll=1), JCamera.initial())
    diff = np.abs(ours - ref)
    assert diff.max() < 2e-3
    assert (diff > 2e-4).mean() < 0.02


def test_plain_culled_grid_matches_jax_kernel(scenes):
    """Design2's culled grid on a 16x40x150 slab (tiles of 8x8x32 here,
    16x32x128 in JAX's kernel) against make_grid_eval(cull=True) in
    interpret mode within K1/K3's 1e-5 + 1e-6|ref|, and equal to the
    unculled plain grid."""
    scene = scenes["design2"]
    lo, cell, z0 = np.full(3, -1.5, np.float32), np.float32(3.0 / 64), 10.0
    arrays = scene.arrays.to_torch("cpu")
    counts = {}
    ours = make_grid_eval(scene, cull=True).plain(arrays, lo, cell, z0, 16, 40, 150, counts=counts).numpy()
    jscene = jdesigns.get_design("design2")
    ref = np.asarray(jmake_grid_eval(jscene, interpret=True, cull=True)(
        jscene.arrays, jnp.asarray(lo), jnp.float32(cell), jnp.float32(z0), slab=16, ny=40, nx=150))
    assert (np.abs(ours - ref) <= 1e-5 + 1e-6 * np.abs(ref)).all()
    np.testing.assert_array_equal(ours, make_grid_eval(scene).plain(arrays, lo, cell, z0, 16, 40, 150).numpy())
    assert counts["chains"] == 2 * 5 * 5
