"""The port's plain SDF (ops/interpreter.py) against the JAX interpreter on the
same seeded points and the same scene arrays."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import designs
from designcsg_tpu.ops import interpreter as jinterp
from designcsg_tpu_torch.compiler import SCENE_ARRAY_FIELDS, scene_arrays_from_numpy
from designcsg_tpu_torch.designs import get_design
from designcsg_tpu_torch.ops import interpreter as tinterp


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
    tscene = get_design("design1")
    # Feed the port the JAX package's own arrays: identical "weights".
    arrays = scene_arrays_from_numpy(
        {f: np.asarray(getattr(jscene.arrays, f)) for f in SCENE_ARRAY_FIELDS}
    )
    return jscene, tscene, arrays


def _copy(arrays):
    return scene_arrays_from_numpy({f: getattr(arrays, f) for f in SCENE_ARRAY_FIELDS})


def _points(n=4096, seed=0, half=6.0):
    return np.random.default_rng(seed).uniform(-half, half, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("gizmo", [False, True])
def test_primary_sdf_matches_jax(scenes, gizmo):
    jscene, tscene, arrays = scenes
    # Each framework gets its own copy of the points and of the banks, and
    # each result is copied out at once, so no buffer is shared between JAX
    # (which may alias a numpy array on the CPU) and torch.
    ours = tinterp.make_primary_sdf(tscene, gizmo=gizmo)(
        torch.from_numpy(_points()), _copy(arrays).to_torch("cpu")
    ).numpy().copy()
    jarrays = jscene.arrays.replace(**{f: np.array(getattr(arrays, f)) for f in SCENE_ARRAY_FIELDS})
    ref = np.array(jinterp.make_primary_sdf(jscene, gizmo=gizmo)(jnp.asarray(_points()), jarrays))
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_fd_normals_match_jax(scenes):
    jscene, tscene, arrays = scenes
    # Points near the surface, where normals are well defined.
    pts = _points(seed=1, half=3.5)
    jn = jinterp.make_normal_fn(jinterp.make_primary_sdf(jscene), mode="fd")
    tn = tinterp.make_normal_fn(tinterp.make_primary_sdf(tscene), mode="fd")
    ref = np.asarray(jn(jnp.asarray(pts), jscene.arrays))
    ours = tn(torch.from_numpy(pts), arrays.to_torch("cpu")).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-4)
    with pytest.raises(ValueError, match="normal mode"):
        tinterp.make_normal_fn(tinterp.make_primary_sdf(tscene), mode="sobel")


def test_brute_force_and_gizmo_match_jax(scenes):
    jscene, tscene, arrays = scenes
    pts = _points(seed=2)
    ref = np.asarray(jinterp.brute_force_min_sdf(jscene, jnp.asarray(pts)))
    ours = tinterp.brute_force_min_sdf(tscene, torch.from_numpy(pts), arrays.to_torch("cpu"))
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5)
    gz = np.asarray(jinterp.gizmo_sdf(jnp.asarray(pts)))
    np.testing.assert_allclose(tinterp.gizmo_sdf(torch.from_numpy(pts)).numpy(), gz, atol=1e-6)
