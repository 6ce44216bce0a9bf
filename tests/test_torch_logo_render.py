"""Logo's renders in the PyTorch port against the JAX package's Pallas
kernels in interpret mode, on the CPU: the plain fused renderer (K2's plain
version, on the baked twin field) and the plain ray march of the fit (K4's).

The JAX kernels run with ``march_unroll`` 2 and 1 instead of their default 8:
the unroll only groups masked march steps (the result is the same), while
interpret mode's cost grows with it (the 32x32 render took 252 s at 8).
"""

import os

import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

from designcsg_tpu.camera import Camera as JCamera
from designcsg_tpu.config import RenderConfig as JRenderConfig
from designcsg_tpu.ops import raymarch as jraymarch
from designcsg_tpu.ops.pallas.march_kernel import make_pallas_renderer
from designs import logo as jlogo
from designcsg_tpu_torch.camera import Camera
from designcsg_tpu_torch.config import RenderConfig
from designcsg_tpu_torch.designs import get_design
from designcsg_tpu_torch.ops.cuda.march_kernel import make_cuda_ray_march, make_cuda_renderer
from designcsg_tpu_torch.ops.raymarch import camera_rows, project, ray_directions

FONT = os.path.join(
    os.path.dirname(matplotlib.__file__), "mpl-data", "fonts", "ttf", "DejaVuSansMono-Bold.ttf"
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
    return jlogo.build(font_path=FONT), get_design("logo")


def test_plain_render_matches_jax_kernel(scenes):
    """The port's plain renderer against make_pallas_renderer at 32x32 and 48
    steps, by the port's render rule (tests/test_pallas.py:115-116,133-134):
    max|d| < 1e-3, under 1% of pixels above 1e-4."""
    jscene, tscene = scenes
    config = RenderConfig(width=32, height=32, max_steps=48)
    cam = Camera.initial().as_arrays()
    render = make_cuda_renderer(tscene, config)  # on CPU tensors: its plain version
    ours = render(tscene.arrays.to_torch("cpu"), *cam).numpy()
    jcfg = JRenderConfig(width=32, height=32, max_steps=48, march_unroll=2)
    ref = np.asarray(
        make_pallas_renderer(jscene, jcfg, interpret=True)(
            jscene.arrays, *(jnp.asarray(a) for a in JCamera.initial().as_arrays())
        )
    )
    assert (ours != 1.0).any(-1).mean() > 0.05  # letters and gizmo in view
    diff = np.abs(ours - ref)
    assert diff.max() < 1e-3
    assert (diff > 1e-4).mean() < 0.01


def test_plain_ray_march_matches_jax_kernel(scenes):
    """K4's plain version against the JAX package's K4
    (``use_pallas_march=True``, interpret mode) at 24x16 and 40 steps with
    the fit's config: identical hit sets, d and vmin within 1e-5
    (tests/test_pallas.py:153-156)."""
    jscene, tscene = scenes
    kw = dict(width=24, height=16, max_steps=40, gizmo=False, differentiable=True,
              soft_silhouette_bandwidth=0.02)
    config = RenderConfig(**kw)
    rows = camera_rows(*Camera.initial().as_arrays())
    rays = project(ray_directions(config), *torch.from_numpy(rows[1:]))
    d, vmin = make_cuda_ray_march(tscene, config)(tscene.arrays.to_torch("cpu"), rows[0], rays)
    jcfg = JRenderConfig(**kw, use_pallas_march=True, march_unroll=1)
    d_ref, vmin_ref = jraymarch.make_march(jscene, jcfg)(
        jnp.asarray(rows[0]), jnp.asarray(rays.numpy()), jscene.arrays, return_closest=True
    )
    d, vmin = d.numpy(), vmin.numpy()
    d_ref, vmin_ref = np.asarray(d_ref), np.asarray(vmin_ref)
    assert (d_ref > 0).sum() > 20 and (d_ref < 0).any()
    np.testing.assert_array_equal(d > 0, d_ref > 0)
    np.testing.assert_allclose(d, d_ref, atol=1e-5)
    np.testing.assert_allclose(vmin, vmin_ref, atol=1e-5)
