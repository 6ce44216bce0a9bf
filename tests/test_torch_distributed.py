"""The port's multi-process fit: two OS processes on one gloo world
(tests/test_distributed.py's layout, each process its own host of a (2, 1)
("host", "chip") mesh), and the mesh half of the multi-view pose fit
(tests/test_pose.py:236-258).

A module fixture starts the two ranks of tests/torch_parallel_worker.py's
``w2`` suite on 127.0.0.1 and, while they run, computes the JAX package's
steps on two of conftest's 8 virtual devices.  Both ranks must end with the
same replicated state; the sharded step must match each rank's
single-process step (loss rtol 1e-5, the JAX test's) and JAX's on a
2-device mesh (tests/test_torch_fit.py's rule: loss rtol 1e-4, parameters
atol 2e-6); the pose step's loss must equal the single-process loss within
1e-6 (the JAX test's) and JAX's within rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import designs
from designcsg_tpu import api as japi
from designcsg_tpu.api import Transform as JTransform
from designcsg_tpu.camera import Camera as JCamera
from designcsg_tpu.config import RenderConfig as JRenderConfig
from designcsg_tpu.parallel.fit import make_fit_harness as j_make_fit_harness
from designcsg_tpu.parallel.mesh import make_mesh as j_make_mesh
from designcsg_tpu.pose import make_pose_to_arrays as j_make_pose_to_arrays
from designcsg_tpu.pose import pose_params as j_pose_params
from test_torch_parallel import finish_world, start_world

FIT = dict(differentiable=True, soft_silhouette_bandwidth=0.02, gizmo=False)


def j_two_object_scene():
    c = japi.new_design()
    japi.draw(japi.sphere_brush(c), JTransform.initial((0.0, 0.0, 0.0), 0.0, 0.0, 0.0, 1.2), compiler=c)
    japi.draw(japi.box_brush(c), JTransform.initial((0.6, 0.0, 0.0), 0.0, 0.0, 0.0, 0.5), compiler=c)
    return japi.commit(c)


def jax_results():
    """JAX's sharded fit step of the two-object scene and the first
    multi-view pose step, each on a 2-device mesh."""
    out = {}
    cam = JCamera.initial().as_arrays()
    scene = j_two_object_scene()
    h = j_make_fit_harness(scene, JRenderConfig(width=32, height=16, max_steps=32, **FIT),
                           mesh=j_make_mesh(n_devices=2))
    start = np.asarray(scene.arrays.position).copy()
    start[1, 0] += 0.2
    target = h.render_target(scene.arrays, *cam)
    state, loss = h.step_fn(h.init({"position": jnp.asarray(start)}), target, *cam)
    out["fit_loss"], out["fit_params"] = float(loss), np.asarray(state.params["position"])

    design1 = designs.get_design("design1")
    config = JRenderConfig(width=48, height=36, max_steps=96, **FIT)
    true_pose = {k: jnp.asarray(v, jnp.float32) for k, v in j_pose_params(design1).items()}
    full_to_arrays = j_make_pose_to_arrays(design1)

    def param_to_arrays(p):
        pose = dict(true_pose)
        pos = true_pose["position"]
        pos = pos.at[1, 0].set(p["sphere_pos"][0]).at[1, 1].set(p["sphere_pos"][1])
        pos = pos.at[2, 0].set(p["box_pos"][0]).at[2, 2].set(p["box_pos"][1])
        pose["position"] = pos
        pose["yaw"] = true_pose["yaw"].at[2].set(p["box_yaw"])
        pose["scale"] = true_pose["scale"].at[1].set(p["sphere_scale"] * jnp.ones(3, jnp.float32))
        return full_to_arrays(pose)

    h = j_make_fit_harness(design1, config, param_to_arrays=param_to_arrays,
                           optimizer=optax.adam(3e-2), mesh=j_make_mesh(n_devices=2))
    cams = [JCamera.initial(), JCamera.initial().orbit(1.1, 0.0), JCamera.initial().orbit(-0.7, 0.6)]
    arrays = jax.tree_util.tree_map(jnp.asarray, design1.arrays)
    views = [(h.target_fn(arrays, *c.as_arrays()),) + tuple(c.as_arrays()) for c in cams]
    tp = np.asarray(true_pose["position"])
    start = {"sphere_pos": jnp.asarray(np.array([tp[1, 0], tp[1, 1]]) + [0.15, -0.12], jnp.float32),
             "box_pos": jnp.asarray(np.array([tp[2, 0], tp[2, 2]]) + [-0.15, 0.1], jnp.float32),
             "box_yaw": jnp.float32(float(true_pose["yaw"][2]) + 0.2),
             "sphere_scale": jnp.float32(float(true_pose["scale"][1][0]) * 0.85)}
    _, loss = h.multi_step_fn(h.init(start), *h.stack_views(views))
    out["pose_loss"] = float(loss)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("world")
    procs = start_world("w2", 2, out_dir, local_world_size=1)
    try:
        results = {"jax": jax_results()}
    finally:
        results["ranks"] = finish_world(procs, "w2", out_dir)
    return results


def test_two_process_fit_step(runs):
    ranks = runs["ranks"]
    for r in ranks:
        assert int(r["process_count"]) == 2
        assert tuple(r["mesh_shape"]) == (2, 1)
        np.testing.assert_allclose(float(r["fit_loss"]), float(r["fit_loss_single"]), rtol=1e-5)
        np.testing.assert_allclose(r["fit_grad"], r["fit_grad_single"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(float(r["fit_loss"]), runs["jax"]["fit_loss"], rtol=1e-4)
        np.testing.assert_allclose(r["fit_params"], runs["jax"]["fit_params"], rtol=0, atol=2e-6)
    # Both processes hold the identical replicated state.
    assert float(ranks[0]["fit_loss"]) == float(ranks[1]["fit_loss"])
    np.testing.assert_allclose(ranks[0]["fit_params"], ranks[1]["fit_params"], atol=0)


def test_mesh_multi_view_pose_step_matches_single(runs):
    """The first multi-view pose step (three cameras, tests/test_pose.py's
    start) on a 2-rank mesh: the loss of the single-process step within
    1e-6, JAX's on a 2-device mesh within rtol 1e-4, and the same pose on
    both ranks."""
    ranks = runs["ranks"]
    for r in ranks:
        assert abs(float(r["pose_loss_mesh"]) - float(r["pose_loss_single"])) < 1e-6
        np.testing.assert_allclose(float(r["pose_loss_mesh"]), runs["jax"]["pose_loss"], rtol=1e-4)
    np.testing.assert_array_equal(ranks[0]["pose_params_mesh"], ranks[1]["pose_params_mesh"])
