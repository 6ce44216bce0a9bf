"""Logo's differentiable fit in the PyTorch port against the JAX package, on
the CPU: one geometric fit step's loss and position gradient for
``fit_field`` exact and twin against JAX's harness marching with its Pallas
ray-march kernel (interpret mode, ``march_unroll=1``: the same steps, at a
fraction of interpret mode's cost), and the agreement of the two fields'
gradients (tests/test_logo.py:295-345)."""

import os

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import optax
import pytest
import torch

from designcsg_tpu.camera import Camera as JCamera
from designcsg_tpu.config import RenderConfig as JRenderConfig
from designcsg_tpu.parallel.fit import make_fit_harness as jmake_fit_harness
from designs import logo as jlogo
from designcsg_tpu_torch.camera import Camera
from designcsg_tpu_torch.config import RenderConfig
from designcsg_tpu_torch.designs import get_design
from designcsg_tpu_torch.parallel.fit import make_fit_harness

FONT = os.path.join(
    os.path.dirname(matplotlib.__file__), "mpl-data", "fonts", "ttf", "DejaVuSansMono-Bold.ttf"
)
FIT = dict(width=24, height=16, max_steps=40, differentiable=True, soft_silhouette_bandwidth=0.02,
           gizmo=False)


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


def _start(scene, column=1, shift=0.05):
    start = np.asarray(scene.arrays.position).copy()
    start[column:, 0] += shift
    return start


@pytest.mark.parametrize("field", ["exact", "twin"])
def test_fit_step_matches_jax_kernel_harness(scenes, field):
    """The loss and position gradient of one geometric step (bench.py's
    start, positions [1:, 0] + 0.05) against ``jax.value_and_grad`` of the
    JAX harness's loss on the same target: loss rtol 1e-4, gradient within
    1e-3 of its norm."""
    jscene, tscene = scenes
    cam = Camera.initial().as_arrays()
    harness = make_fit_harness(tscene, RenderConfig(**FIT, fit_field=field), device="cpu")
    target = harness.render_target(tscene.arrays, *cam)
    params = harness.init({"position": _start(tscene)}).params
    loss = harness.loss_fn(params, target, *cam)
    loss.backward()
    grad = params["position"].grad.numpy()

    jcfg = JRenderConfig(**FIT, fit_field=field, use_pallas_march=True, march_unroll=1)
    jh = jmake_fit_harness(jscene, jcfg, optimizer=optax.adam(1e-2), use_mesh=False)
    jtarget = tuple(jnp.asarray(t.numpy()) for t in target)
    jcam = [jnp.asarray(a) for a in JCamera.initial().as_arrays()]
    jloss, jgrad = jax.value_and_grad(lambda p: jh.loss_fn(p, jtarget, *jcam))(
        {"position": jnp.asarray(_start(jscene))}
    )
    jgrad = np.asarray(jgrad["position"])
    assert float(jloss) > 0 and np.abs(jgrad).max() > 0
    assert abs(float(loss) - float(jloss)) <= 1e-4 * abs(float(jloss))
    assert np.abs(grad - jgrad).max() <= 1e-3 * np.linalg.norm(jgrad)


def test_exact_and_twin_gradients_agree(scenes):
    """Both fields fit the same exact target: losses within the twin's
    tolerance scale and position gradients pointing the same way
    (cos > 0.9), tests/test_logo.py:295-345 on the port."""
    _, tscene = scenes
    cam = Camera.initial().as_arrays()
    losses, grads, target = {}, {}, None
    for field in ("exact", "twin"):
        h = make_fit_harness(tscene, RenderConfig(**FIT, fit_field=field), device="cpu")
        if target is None:
            target = h.render_target(tscene.arrays, *cam)
        params = h.init({"position": _start(tscene, column=2, shift=0.04)}).params
        loss = h.loss_fn(params, target, *cam)
        loss.backward()
        losses[field] = float(loss)
        grads[field] = params["position"].grad.numpy().ravel()
    assert losses["twin"] == pytest.approx(losses["exact"], rel=0.5, abs=1e-4)
    ge, gt = grads["exact"], grads["twin"]
    cos = float(ge @ gt / (np.linalg.norm(ge) * np.linalg.norm(gt) + 1e-30))
    assert cos > 0.9, (cos, losses)

