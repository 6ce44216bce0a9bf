"""The fast viewport's plain versions against the JAX package, on the CPU:
the over-relaxed march, the cone prepass (JAX's Pallas kernel in interpret
mode), the hierarchical renderer, and the port's own rules for ``t0`` and the
prepass's safety.

The port's wrappers take their plain versions for CPU tensors, so these
tests call them as the port's callers do; the CUDA kernels are held against
the same plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).  Design2 is held by its SDF and golden image
(tests/test_torch_design2.py): every JAX entry point jitted over its
unrolled tape costs 10-60 s of XLA:CPU compilation."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import designs
from designcsg_tpu.camera import Camera as JCamera
from designcsg_tpu.config import RenderConfig as JRenderConfig
from designcsg_tpu.ops.pallas.march_kernel import make_hierarchical_renderer as j_hierarchical
from designcsg_tpu.ops.pallas.march_kernel import make_pallas_cone_march
from designcsg_tpu.ops.raymarch import make_renderer as j_make_renderer
from designcsg_tpu_torch.camera import Camera
from designcsg_tpu_torch.compiler import SCENE_ARRAY_FIELDS, scene_arrays_from_numpy
from designcsg_tpu_torch.config import RenderConfig
from designcsg_tpu_torch.designs import get_design
from designcsg_tpu_torch.ops.cuda import build as kbuild
from designcsg_tpu_torch.ops.cuda.march_kernel import (
    make_cuda_cone_march,
    make_cuda_hierarchical_renderer,
    make_cuda_renderer,
)
from designcsg_tpu_torch.ops.interpreter import make_primary_sdf
from designcsg_tpu_torch.ops.raymarch import (
    camera_rows,
    coarse_ray_uv,
    cone_slope,
    make_march,
    project,
    ray_directions,
    render_scene,
)

# 160x160 is the smallest viewport the JAX package tests F = 5 blocks at;
# 96 steps resolve every Design1 ray at this camera (tests/test_pallas.py:229-237).
HIER = dict(width=160, height=160, max_steps=96)


@pytest.fixture(scope="module")
def scenes():
    jscene = designs.get_design("design1")
    arrays = scene_arrays_from_numpy(
        {f: np.asarray(getattr(jscene.arrays, f)) for f in SCENE_ARRAY_FIELDS}
    )
    return jscene, get_design("design1"), arrays.to_torch("cpu")


@pytest.fixture(scope="module")
def coarse(scenes):
    """The 32x32 block-centre rays of the 160x160 viewport (formed as the
    port forms them) and the JAX cone kernel's t_safe on them, in interpret
    mode."""
    jscene, _, _ = scenes
    config = RenderConfig(**HIER)
    rows = camera_rows(*Camera.initial().as_arrays())
    rays = project(torch.from_numpy(coarse_ray_uv(config)), *torch.from_numpy(rows[1:]))
    assert tuple(rays.shape) == (32, 32, 3)
    jcone = make_pallas_cone_march(
        jscene, JRenderConfig(**HIER), cone_slope=cone_slope(config), interpret=True
    )
    ref = np.array(jcone(jscene.arrays, jnp.asarray(rows[0]), jnp.asarray(rays.numpy())))
    return config, rows[0], rays, ref


@pytest.fixture(scope="module", params=[1.0, 1.6], ids=["exact", "overrelax1.6"])
def jax_hierarchical(scenes, request):
    """(omega, the JAX hierarchical renderer's 160x160 image in interpret
    mode)."""
    jscene, _, _ = scenes
    cam = [jnp.asarray(a) for a in JCamera.initial().as_arrays()]
    config = JRenderConfig(march_overrelax=request.param, march_hierarchical=True, **HIER)
    render = j_hierarchical(jscene, config, interpret=True)
    return request.param, np.array(render(jscene.arrays, *cam))


def test_overrelaxed_renderer_matches_jax(scenes):
    jscene, tscene, arrays = scenes
    kw = dict(width=128, height=32, max_steps=80, march_overrelax=1.6)
    cam = JCamera.initial().as_arrays()
    ref = np.array(jax.jit(j_make_renderer(jscene, JRenderConfig(**kw)))(jscene.arrays, *cam))
    before = dict(kbuild.LAUNCHES)
    ours = make_cuda_renderer(tscene, RenderConfig(**kw))(arrays, *Camera.initial().as_arrays())
    assert dict(kbuild.LAUNCHES) == before  # the CPU path launches nothing
    diff = np.abs(ours.numpy() - ref)
    # The rule of tests/test_pallas.py:133-134.
    assert diff.max() < 1e-3
    assert (diff > 1e-4).mean() < 0.01


def test_overrelaxed_march_takes_fewer_steps(scenes):
    """Nearly the same hit set as the exact march, most hits at the same
    point (to about sdf_epsilon; a relaxed step may land on another face at
    a crease), and fewer SDF evaluations."""
    _, tscene, arrays = scenes
    config = RenderConfig(width=128, height=32, max_steps=256)
    rows = torch.from_numpy(camera_rows(*Camera.initial().as_arrays()))
    rays = project(ray_directions(config), *rows[1:])
    d1, n1 = make_march(tscene, config)(rows[0], rays, arrays, return_steps=True)
    fast = dataclasses.replace(config, march_overrelax=1.6)
    d2, n2 = make_march(tscene, fast)(rows[0], rays, arrays, return_steps=True)
    assert ((d1 > 0) != (d2 > 0)).float().mean() < 0.002
    both = (d1 > 0) & (d2 > 0)
    assert ((d1 - d2)[both].abs() < 0.02).float().mean() > 0.99
    assert int(n2.sum()) < 0.9 * int(n1.sum())


def test_cone_march_matches_jax(scenes, coarse):
    _, tscene, arrays = scenes
    config, o_proj, rays, ref = coarse
    ours = make_cuda_cone_march(tscene, config)(arrays, o_proj, rays).numpy()
    far = config.max_distance
    # Equal hit/miss handoffs on >= 99% of rays, |dt| <= 1e-4 on the rest.
    assert ((ours > far) == (ref > far)).mean() >= 0.99
    both = (ours <= far) & (ref <= far)
    assert both.any() and (ref > far).any()
    assert np.abs(ours - ref)[both].max() <= 1e-4


def test_cone_strict_keeps_the_last_segment(scenes, coarse):
    """strict: a ray that leaves the scene hands back its last committed
    point instead of the far parameter; every other ray is unchanged."""
    _, tscene, arrays = scenes
    config, o_proj, rays, _ = coarse
    loose = make_cuda_cone_march(tscene, config)(arrays, o_proj, rays)
    strict = make_cuda_cone_march(tscene, dataclasses.replace(config, cone_strict=True))(
        arrays, o_proj, rays
    )
    out = loose > config.max_distance
    assert out.any()
    assert torch.equal(strict[~out], loose[~out])
    assert bool((strict[out] <= config.max_distance).all())


def test_cone_t_safe_is_safe(scenes):
    """The port's safety property (tests/test_pallas.py:279-341): the SDF is
    >= sdf_epsilon at the start point of every covered fine ray that has not
    left the scene."""
    _, tscene, arrays = scenes
    config = RenderConfig(**HIER)
    f = config.hierarchical_factor
    rows = camera_rows(*Camera.initial().orbit(0.4, 0.3).as_arrays())
    frame = torch.from_numpy(rows[1:])
    t_safe = make_cuda_cone_march(tscene, config)(
        arrays, rows[0], project(torch.from_numpy(coarse_ray_uv(config)), *frame)
    )
    t0 = t_safe.repeat_interleave(f, dim=0).repeat_interleave(f, dim=1)
    starts = torch.from_numpy(rows[0]) + t0[..., None] * project(ray_directions(config), *frame)
    vals = make_primary_sdf(tscene, gizmo=True)(starts, arrays)
    inside = t0 < config.max_distance
    assert (t0 > 0).any() and inside.any()
    assert float(vals[inside].min()) >= config.sdf_epsilon - 1e-6


def test_t0_plane_semantics(scenes):
    """A start past max_distance is a miss before the first step; a ray that
    stops at its start t0 > 0 has d = t0 and is shaded."""
    _, tscene, arrays = scenes
    config = RenderConfig(width=16, height=8, max_steps=64)
    rows = torch.from_numpy(camera_rows(*Camera.initial().as_arrays()))
    rays = project(ray_directions(config), *rows[1:])
    march = make_march(tscene, config)
    d = march(rows[0], rays, arrays)
    assert bool((d > 0).any())
    far = torch.full(d.shape, config.max_distance + 1.0)
    assert bool((march(rows[0], rays, arrays, t0=far) == -1.0).all())
    # Restart every hit ray from its own hit: it stops at once, d = t0.
    t0 = torch.where(d > 0, d, torch.zeros_like(d))
    d2, steps = march(rows[0], rays, arrays, t0=t0, return_steps=True)
    assert torch.equal(t0, torch.where(d > 0, d, torch.zeros_like(d)))  # the caller's plane is kept
    assert torch.equal(d2[d > 0], d[d > 0]) and bool((steps[d > 0] == 1).all())


def test_hierarchical_renderer_matches_jax(scenes, jax_hierarchical):
    """The plain hierarchical renderer against the JAX package's (interpret
    mode), exact and over-relaxed, with tests/test_pallas.py:266-276's
    rules."""
    _, tscene, arrays = scenes
    omega, ref = jax_hierarchical
    config = RenderConfig(march_overrelax=omega, march_hierarchical=True, **HIER)
    before = dict(kbuild.LAUNCHES)
    ours = render_scene(tscene, config=config, arrays=arrays, device="cpu").numpy()
    assert dict(kbuild.LAUNCHES) == before
    miss = np.array(config.miss_color)
    ours_hit = np.any(ours != miss, axis=-1)
    ref_hit = np.any(ref != miss, axis=-1)
    assert (ours_hit != ref_hit).mean() < 0.002
    both = ours_hit & ref_hit
    diff = np.abs(ours - ref).max(axis=-1)
    assert np.median(diff[both]) < 1e-4
    assert (diff[both] > 0.05).mean() < 0.01


def test_hierarchical_wrapper_is_its_plain_version_on_cpu(scenes):
    _, tscene, arrays = scenes
    config = RenderConfig(width=40, height=30, max_steps=64, march_overrelax=1.6,
                          march_hierarchical=True)
    cam = Camera.initial().as_arrays()
    render = make_cuda_hierarchical_renderer(tscene, config)
    assert torch.equal(render(arrays, *cam), render.plain(arrays, *cam))
    with pytest.raises(AssertionError, match="divide"):
        make_cuda_hierarchical_renderer(tscene, dataclasses.replace(config, width=42))
