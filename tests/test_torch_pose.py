"""Pose-space scene compile of the port (designcsg_tpu_torch/pose.py and the
torch transform chain) against the JAX package's designcsg_tpu/pose.py and
transforms.py with ``xp=jnp``, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import designs
from designcsg_tpu import transforms as jtf
from designcsg_tpu.ops.interpreter import make_primary_sdf as j_make_primary_sdf
from designcsg_tpu.pose import make_pose_to_arrays as j_make_pose_to_arrays
from designcsg_tpu.pose import pose_params as j_pose_params
from designcsg_tpu_torch import transforms as ttf
from designcsg_tpu_torch.designs import get_design
from designcsg_tpu_torch.ops.interpreter import make_primary_sdf
from designcsg_tpu_torch.pose import make_pose_to_arrays, pose_param_to_arrays, pose_params

POSE_KEYS = ("position", "yaw", "pitch", "roll", "scale")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per test process: the suite runs one process per
    worker, and a default-sized thread pool in each oversubscribes the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", ["design1", "design2"])
def test_pose_params_equal_jax(name):
    ours, ref = pose_params(get_design(name)), j_pose_params(designs.get_design(name))
    assert set(ours) == set(ref) == set(POSE_KEYS)
    for key in POSE_KEYS:
        assert ours[key].dtype == np.float64
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)


@pytest.mark.parametrize("name", ["design1", "design2"])
def test_pose_to_arrays_reproduces_banks(name):
    """tests/test_pose.py:29's round trip, for the port."""
    scene = get_design(name)
    arrays = make_pose_to_arrays(scene)(pose_params(scene))
    for bank in ("position", "right", "up", "forward"):
        got = getattr(arrays, bank)
        assert got.dtype == torch.float32 and got.is_contiguous()
        np.testing.assert_allclose(got.numpy(), getattr(scene.arrays, bank), atol=2e-6,
                                   err_msg=f"{name}.{bank}")
    assert torch.equal(arrays.tape, torch.as_tensor(scene.arrays.tape))


@pytest.mark.parametrize("seed", range(3))
def test_torch_transform_chain_matches_jnp(seed):
    """initial_t (and the chain under it) on a batch against the JAX
    package's transforms with xp=jnp, one object at a time."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(5, 3)).astype(np.float32)
    yaw, pitch, roll = rng.uniform(-np.pi, np.pi, (3, 5)).astype(np.float32)
    scale = rng.uniform(0.2, 3.0, (5, 3)).astype(np.float32)
    ours = ttf.initial_t(*(torch.from_numpy(a) for a in (pos, yaw, pitch, roll, scale))).numpy()
    recip = ttf.reciprocal_vector_t(torch.from_numpy(pos)).numpy()
    for i in range(5):
        ref = jtf.initial(jnp.asarray(pos[i]), jnp.asarray(yaw[i]), jnp.asarray(pitch[i]),
                          jnp.asarray(roll[i]), jnp.asarray(scale[i]), xp=jnp)
        np.testing.assert_allclose(ours[i], np.asarray(ref), atol=2e-6)
        np.testing.assert_allclose(recip[i], np.asarray(jtf.reciprocal_vector(pos[i], xp=jnp)),
                                   rtol=1e-6)


def test_pose_gradients_match_jax_grad():
    """tests/test_pose.py:45's loss, ``sum(sdf(pts, pose_to_arrays(p))**2)``
    over 128 points: the gradient reaches every degree of freedom of the
    non-root objects and equals ``jax.grad`` within 1e-4 of the largest
    component over all leaves (float32 sums of 128 terms, ~10 ops deep).
    The scale is global because Design1's yaw gradients are rounding noise
    (~1e-7): every object is symmetric under its own yaw."""
    tscene, jscene = get_design("design1"), designs.get_design("design1")
    params = {k: v.astype(np.float32) for k, v in pose_params(tscene).items()}
    pts = np.random.default_rng(0).uniform(-1.5, 1.5, (128, 3)).astype(np.float32)

    leaves = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    sdf, to_arrays = make_primary_sdf(tscene), pose_param_to_arrays(tscene)
    torch.sum(sdf(torch.from_numpy(pts), to_arrays(leaves)) ** 2).backward()

    j_sdf, j_to_arrays = j_make_primary_sdf(jscene), j_make_pose_to_arrays(jscene)
    grads = jax.grad(lambda p: jnp.sum(j_sdf(jnp.asarray(pts), j_to_arrays(p)) ** 2))(
        {k: jnp.asarray(v) for k, v in params.items()})
    scale = max(float(np.abs(np.asarray(g)).max()) for g in grads.values())
    assert scale > 0.1
    for key in POSE_KEYS:
        ours, ref = leaves[key].grad.numpy(), np.asarray(grads[key])
        assert np.isfinite(ours).all() and np.abs(ours[1:]).sum() > 0, key
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4 * scale, err_msg=key)
