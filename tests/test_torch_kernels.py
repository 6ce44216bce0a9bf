"""Plain versions of the port's three kernels against the JAX package's Pallas
kernels (interpret mode) and the JAX renderer, on the CPU.

On a CPU tensor each kernel wrapper runs its plain version, so these tests
call the wrappers exactly as the port's callers do.  The CUDA kernels
themselves are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import designs
from designcsg_tpu.camera import Camera as JCamera
from designcsg_tpu.config import RenderConfig as JRenderConfig
from designcsg_tpu.ops.pallas.sdf_kernel import make_grid_eval as j_grid_eval
from designcsg_tpu.ops.pallas.sdf_kernel import make_pallas_point_eval
from designcsg_tpu.ops.raymarch import make_renderer as j_make_renderer
from designcsg_tpu_torch.camera import Camera
from designcsg_tpu_torch.compiler import SCENE_ARRAY_FIELDS, scene_arrays_from_numpy
from designcsg_tpu_torch.config import RenderConfig
from designcsg_tpu_torch.designs import get_design
from designcsg_tpu_torch.ops.cuda import build as kbuild
from designcsg_tpu_torch.ops.cuda.march_kernel import make_cuda_renderer
from designcsg_tpu_torch.ops.cuda.sdf_kernel import make_grid_eval, make_point_eval
from designcsg_tpu_torch.ops.raymarch import render_scene, to_u8

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "design1_160x120.npy")


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
    jscene = designs.get_design("design1")
    arrays = scene_arrays_from_numpy(
        {f: np.asarray(getattr(jscene.arrays, f)) for f in SCENE_ARRAY_FIELDS}
    )
    return jscene, get_design("design1"), arrays.to_torch("cpu")


def test_point_eval_plain_matches_pallas(scenes):
    jscene, tscene, arrays = scenes
    # Not a tile multiple: exercises the Pallas padding.
    pts = np.random.default_rng(0).uniform(-6, 6, (3000, 3)).astype(np.float32)
    ref = np.asarray(
        make_pallas_point_eval(jscene, interpret=True, sub=8)(jnp.asarray(pts), jscene.arrays)
    )
    before = dict(kbuild.LAUNCHES)
    ours = make_point_eval(tscene)(torch.from_numpy(pts), arrays)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5)
    assert dict(kbuild.LAUNCHES) == before  # the CPU path launches nothing


def test_grid_eval_plain_matches_pallas(scenes):
    jscene, tscene, arrays = scenes
    lo = np.full(3, -4.0, np.float32)
    cell, z0, slab, ny, nx = np.float32(8.0 / 32), np.float32(13.0), 3, 33, 40
    ref = np.asarray(
        j_grid_eval(jscene, interpret=True)(jscene.arrays, jnp.asarray(lo), cell, z0, slab, ny, nx)
    )
    ours = make_grid_eval(tscene)(arrays, lo, cell, z0, slab, ny, nx)
    assert tuple(ours.shape) == (slab, ny, nx)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5)


def test_renderer_plain_matches_jax_renderer(scenes):
    jscene, tscene, arrays = scenes
    kw = dict(width=128, height=32, max_steps=80)
    cam = JCamera.initial().as_arrays()
    ref = np.asarray(jax.jit(j_make_renderer(jscene, JRenderConfig(**kw)))(jscene.arrays, *cam))
    ours = make_cuda_renderer(tscene, RenderConfig(**kw))(arrays, *Camera.initial().as_arrays())
    diff = np.abs(ours.numpy() - ref)
    # The rule of tests/test_pallas.py:115-116.
    assert diff.max() < 1e-3
    assert (diff > 1e-4).mean() < 0.01


def test_render_scene_matches_golden():
    img = to_u8(render_scene(get_design("design1"), config=RenderConfig(width=160, height=120),
                             device="cpu"))
    diff = np.abs(img.numpy().astype(int) - np.load(GOLDEN).astype(int))
    # The rule of tests/test_library.py:61-64.
    assert (diff.max(axis=-1) > 2).mean() < 0.002
