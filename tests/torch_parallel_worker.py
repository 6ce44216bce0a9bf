"""One rank of a gloo world for the port's multi-device tests
(tests/test_torch_parallel.py, tests/test_torch_distributed.py).

Every rank runs the same checks (SPMD) on the CPU and writes what it got to
``<out_dir>/<suite>_rank<rank>.npz``; rank 0 also writes the port's
single-process results of the same calls, which the tests hold the sharded
ones against.  Imports only torch, numpy and the port.

Usage: python torch_parallel_worker.py <suite> <rank> <world> <port> <out_dir>
"""

import dataclasses
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from designcsg_tpu_torch import api  # noqa: E402
from designcsg_tpu_torch.api import Transform  # noqa: E402
from designcsg_tpu_torch.camera import Camera  # noqa: E402
from designcsg_tpu_torch.compiler import ExportConfig  # noqa: E402
from designcsg_tpu_torch.config import RenderConfig  # noqa: E402
from designcsg_tpu_torch.designs import get_design  # noqa: E402
from designcsg_tpu_torch.evaluator import BatchEvaluator  # noqa: E402
from designcsg_tpu_torch.export import active as active_module  # noqa: E402
from designcsg_tpu_torch.export.active import extract_surface_active  # noqa: E402
from designcsg_tpu_torch.export.pipeline import export_mesh  # noqa: E402
from designcsg_tpu_torch.ops.cuda.sdf_kernel import lattice_points, make_grid_eval  # noqa: E402
from designcsg_tpu_torch.ops.interpreter import make_primary_sdf  # noqa: E402
from designcsg_tpu_torch.ops.raymarch import render_scene  # noqa: E402
from designcsg_tpu_torch.parallel.export import make_sharded_corner_provider  # noqa: E402
from designcsg_tpu_torch.parallel.fit import make_fit_harness  # noqa: E402
from designcsg_tpu_torch.parallel.mesh import (  # noqa: E402
    initialize_distributed,
    make_mesh,
    make_mesh_2d,
    mesh_rank,
)
from designcsg_tpu_torch.parallel.render import make_sharded_renderer, shard_pointwise  # noqa: E402
from designcsg_tpu_torch.pose import make_pose_to_arrays, pose_params  # noqa: E402

CAM = Camera.initial().as_arrays()
# tests/test_parallel.py's sizes.
RENDER = dict(width=64, max_steps=96)
FIT = dict(max_steps=128, differentiable=True, soft_silhouette_bandwidth=0.02, gizmo=False)
CORNER_RES, CORNER_HALF = 16, 4.0
# tests/test_torch_active.py's offset box (no lattice corner on a face).
ACTIVE_CENTER = np.array([0.0371, -0.0287, 0.0113])


def render_cases(out, mesh, rank, key, heights):
    """The sharded frame of each height (and rank 0: the unsharded one)."""
    d1 = get_design("design1")
    for h in heights:
        config = RenderConfig(height=h, **RENDER)
        out[f"{key}{h}"] = make_sharded_renderer(d1, config, mesh)(d1.arrays, *CAM).numpy()
        if rank == 0:
            out[f"{key}{h}_single"] = render_scene(d1, config=config, device="cpu").numpy()


def lattice_ref(scene, res, half):
    """The exact tape on the whole corner lattice of ``center 0 ± half``."""
    lo = np.full(3, -half, np.float32)
    pts = lattice_points(lo, np.float32(2.0 * half / res), 0.0, res + 1, res + 1, res + 1, "cpu")
    return make_primary_sdf(scene)(pts.reshape(-1, 3), scene.arrays.to_torch("cpu")).reshape(
        (res + 1,) * 3).numpy()


def fit_step(out, key, scene, config, start, mesh, single: bool, loss="geometric"):
    """One step of the sharded harness (loss, parameters after, gradient),
    and with ``single`` the same step unsharded."""
    harnesses = [("", make_fit_harness(scene, config, mesh=mesh, loss=loss))]
    if single:
        harnesses.append(("_single", make_fit_harness(scene, config, loss=loss, device="cpu")))
    for suffix, h in harnesses:
        target = h.render_target(scene.arrays, *CAM)
        state = h.init({"position": start})
        state, value = h.step_fn(state, target, *CAM)
        p = state.params["position"]
        out[f"{key}_loss{suffix}"] = np.float64(value)
        out[f"{key}_params{suffix}"] = p.detach().numpy()
        out[f"{key}_grad{suffix}"] = p.grad.numpy()


def suite_w3(out, rank, out_dir):
    """3 ranks, a 1-D mesh: the renders (48 rows, and 32 and 40, padded),
    the pointwise and evaluator shards, the corner provider, the fit steps,
    the fit's recovery and the sharded exports."""
    mesh = make_mesh(device="cpu")
    out["mesh_size"] = np.int64(mesh.size())
    out["mesh_index"] = np.int64(mesh_rank(mesh)[0])
    d1 = get_design("design1")
    arrays = d1.arrays.to_torch("cpu")
    render_cases(out, mesh, rank, "render", (48, 32, 40))

    sdf = make_primary_sdf(d1)
    # Not divisible by 3: the padding shows.
    pts = torch.from_numpy(np.random.default_rng(0).uniform(-5, 5, (1003, 3)).astype(np.float32))
    out["pointwise"] = shard_pointwise(sdf, mesh)(pts, arrays).numpy()
    epts = np.random.default_rng(1).uniform(-5, 5, (5000, 3)).astype(np.float32)
    out["evaluator"] = BatchEvaluator(d1, chunk_size=2048, sharded=True,
                                      device="cpu").eval_sdf_at_points(epts)
    # The kernels' field (K1 and its FD form; their plain versions here).
    kpts = np.random.default_rng(7).uniform(-6, 6, (501, 3)).astype(np.float32)
    ev = BatchEvaluator(d1, sharded=True, use_kernels=True, device="cpu")
    out["kernel_evaluator_sdf"] = ev.eval_sdf_at_points(kpts)
    out["kernel_evaluator_normal"] = ev.eval_normal_at_points(kpts[:40])
    for use_kernels in (False, True):
        provider = make_sharded_corner_provider(d1, np.zeros(3), CORNER_HALF, CORNER_RES, mesh,
                                                use_kernels=use_kernels)
        out[f"corners_kernels{int(use_kernels)}"] = provider(0, CORNER_RES)
    if rank == 0:
        out["pointwise_single"] = sdf(pts, arrays).numpy()
        ref = BatchEvaluator(d1, use_kernels=False, device="cpu")
        out["evaluator_single"] = ref.eval_sdf_at_points(epts)
        out["kernel_evaluator_sdf_single"] = ref.eval_sdf_at_points(kpts)
        out["kernel_evaluator_normal_single"] = ref.eval_normal_at_points(kpts[:40])
        out["corners_kernels0_single"] = lattice_ref(d1, CORNER_RES, CORNER_HALF)
        lo = np.full(3, -CORNER_HALF, np.float32)
        out["corners_kernels1_single"] = make_grid_eval(d1)(
            arrays, lo, np.float32(2 * CORNER_HALF / CORNER_RES), 0.0, CORNER_RES + 1,
            CORNER_RES + 1).numpy()

    # tests/test_parallel.py::test_fit_gradients_are_synchronized: rgb at
    # 32x24 against a zero target.
    config = RenderConfig(width=32, height=24, max_steps=48, differentiable=True)
    h = make_fit_harness(d1, config, loss="rgb", mesh=mesh)
    state = h.init({"position": np.asarray(d1.arrays.position)})
    state, value = h.step_fn(state, h.shard_target(torch.zeros(24, 32, 3)), *CAM)
    out["sync_loss"] = np.float64(value)
    out["sync_params"] = state.params["position"].detach().numpy()
    # One geometric step (the perturbed start of test_fit_recovers_translation).
    start = np.asarray(d1.arrays.position).copy()
    start[1, 0] += 0.6
    fit_step(out, "step", d1, RenderConfig(width=32, height=24, **FIT), start, mesh, rank == 0)
    # The recovery, cut to tests/test_torch_fit.py's: the box pulled back
    # along x and z in 40 steps at 48x36.
    config = RenderConfig(width=48, height=36, **dict(FIT, max_steps=96))
    base = d1.arrays.to_torch("cpu")
    truth = base.position[2].clone()

    def param_to_arrays(params):
        position = torch.cat([base.position[:2], params["box"][None], base.position[3:]])
        return dataclasses.replace(base, position=position)

    h = make_fit_harness(d1, config, param_to_arrays=param_to_arrays, mesh=mesh,
                         optimizer=lambda ps: torch.optim.Adam(ps, lr=1e-2))
    target = h.render_target(d1.arrays, *CAM)
    state = h.init({"box": truth.numpy() + np.array([0.1, 0.0, -0.1], np.float32)})
    out["recover_err0"] = np.float64((state.params["box"].detach() - truth).abs().max())
    out["recover_loss0"] = np.float64(h.loss_fn(state.params, target, *CAM))
    for _ in range(40):
        state, value = h.step_fn(state, target, *CAM)
    out["recover_err"] = np.float64((state.params["box"].detach() - truth).abs().max())
    out["recover_loss"] = np.float64(value)

    ev = BatchEvaluator(d1, device="cpu")
    kw = dict(slab_cells=16, use_native=False)
    m = extract_surface_active(ev, ACTIVE_CENTER, 2.0, 32, device_mesh=mesh, **kw)
    out["active_vertices"], out["active_faces"] = m.vertices, m.faces
    cfg = ExportConfig(bounding_box_half_diameter=2.0, grid_level=5, gradient_descent_steps=2)
    m, _ = export_mesh(d1, cfg, autodetect=False, strategy="compact", device="cpu", sharded=True)
    out["compact_vertices"], out["compact_faces"] = m.vertices, m.faces
    if rank == 0:
        m = extract_surface_active(ev, ACTIVE_CENTER, 2.0, 32, **kw)
        out["active_vertices_single"], out["active_faces_single"] = m.vertices, m.faces
        m, _ = export_mesh(d1, cfg, autodetect=False, strategy="compact", device="cpu")
        out["compact_vertices_single"], out["compact_faces_single"] = m.vertices, m.faces

    # Resume on one host: the sharded active export three times into one
    # resume directory (rank 0 alone writes it), the third run after rank 0
    # dropped the pre-refinement mesh, so that it resumes slab by slab.
    resume = os.path.join(out_dir, "resume")
    calls = []
    make_provider = active_module.make_slab_provider

    def counting_provider(*args, **kwargs):
        provider = make_provider(*args, **kwargs)

        def counted(*a):
            calls[-1] += 1
            return provider(*a)

        return counted

    active_module.make_slab_provider = counting_provider
    for run in range(3):
        calls.append(0)
        m, _ = export_mesh(d1, cfg, autodetect=False, strategy="active", slab_cells=16, device="cpu",
                           sharded=True, resume_dir=resume)
        out[f"resume{run}_vertices"], out[f"resume{run}_faces"] = m.vertices, m.faces
        dist.barrier()
        if run == 0:
            out["resume_files"] = np.asarray(sorted(os.listdir(resume)))
        if run == 1 and rank == 0:
            for name in os.listdir(resume):
                if name.startswith("extract_"):
                    os.remove(os.path.join(resume, name))
        dist.barrier()
    active_module.make_slab_provider = make_provider
    out["resume_slab_evaluations"] = np.asarray(calls)
    if rank == 0:
        m, _ = export_mesh(d1, cfg, autodetect=False, strategy="active", slab_cells=16, device="cpu")
        out["resume_vertices_single"], out["resume_faces_single"] = m.vertices, m.faces


def suite_w4(out, rank, out_dir):
    """4 ranks as a 2x2 ("host", "chip") mesh beside the 1-D mesh of the
    same ranks: renders, the fit step and the corner provider."""
    mesh1 = make_mesh(device="cpu")
    mesh2 = make_mesh_2d(hosts=2, device="cpu")
    out["mesh2_shape"] = np.asarray(mesh2.shape)
    out["mesh2_names"] = np.asarray(mesh2.mesh_dim_names)
    d1 = get_design("design1")
    render_cases(out, mesh2, rank, "render2d_", (48, 30))
    render_cases(out, mesh1, rank, "render1d_", (48,))
    start = np.asarray(d1.arrays.position).copy()
    start[1, 0] += 0.3
    config = RenderConfig(width=32, height=16, **dict(FIT, max_steps=64))
    for key, mesh in (("fit1d", mesh1), ("fit2d", mesh2)):
        fit_step(out, key, d1, config, start, mesh, rank == 0 and key == "fit1d")
    provider = make_sharded_corner_provider(d1, np.zeros(3), CORNER_HALF, CORNER_RES, mesh2,
                                            use_kernels=False)
    out["corners2d"] = provider(0, CORNER_RES)
    if rank == 0:
        out["corners2d_single"] = lattice_ref(d1, CORNER_RES, CORNER_HALF)


def two_object_scene():
    """tests/distributed_worker.py's scene: a sphere and a box."""
    c = api.new_design()
    api.draw(api.sphere_brush(c), Transform.initial((0.0, 0.0, 0.0), 0.0, 0.0, 0.0, 1.2), compiler=c)
    api.draw(api.box_brush(c), Transform.initial((0.6, 0.0, 0.0), 0.0, 0.0, 0.0, 0.5), compiler=c)
    return api.commit(c)


def pose_views(scene, harness):
    """tests/test_pose.py:150-200's multi-view pose fit: its parameters
    (sphere x, y and scale; box x, z and yaw), three cameras and targets."""
    true_pose = {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in pose_params(scene).items()}
    tp = true_pose["position"].numpy()
    truth = {"sphere_pos": np.array([tp[1, 0], tp[1, 1]]), "box_pos": np.array([tp[2, 0], tp[2, 2]]),
             "box_yaw": float(true_pose["yaw"][2]), "sphere_scale": float(true_pose["scale"][1][0])}
    start = {"sphere_pos": truth["sphere_pos"] + np.array([0.15, -0.12]),
             "box_pos": truth["box_pos"] + np.array([-0.15, 0.1]),
             "box_yaw": np.float32(truth["box_yaw"] + 0.2),
             "sphere_scale": np.float32(truth["sphere_scale"] * 0.85)}
    cams = [Camera.initial(), Camera.initial().orbit(1.1, 0.0), Camera.initial().orbit(-0.7, 0.6)]
    arrays = scene.arrays.to_torch("cpu")
    views = [(harness.target_fn(arrays, *c.as_arrays()),) + tuple(c.as_arrays()) for c in cams]
    return true_pose, start, views


def pose_param_to_arrays(scene, true_pose):
    full_to_arrays = make_pose_to_arrays(scene)

    def param_to_arrays(p):
        pose = dict(true_pose)
        pos = true_pose["position"].clone()
        pos = torch.cat([pos[:1], torch.stack([p["sphere_pos"][0], p["sphere_pos"][1], pos[1, 2]])[None],
                         torch.stack([p["box_pos"][0], pos[2, 1], p["box_pos"][1]])[None], pos[3:]])
        pose["position"] = pos
        pose["yaw"] = torch.cat([true_pose["yaw"][:2], p["box_yaw"].reshape(1), true_pose["yaw"][3:]])
        scale = p["sphere_scale"] * torch.ones(3)
        pose["scale"] = torch.cat([true_pose["scale"][:1], scale[None], true_pose["scale"][2:]])
        return full_to_arrays(pose)

    return param_to_arrays


def suite_w2(out, rank, out_dir):
    """2 ranks, each its own host (tests/test_distributed.py's layout,
    ``LOCAL_WORLD_SIZE`` 1): the two-process fit step and the mesh half of
    the multi-view pose step (tests/test_pose.py:236-258)."""
    scene = two_object_scene()
    config = RenderConfig(width=32, height=16, **dict(FIT, max_steps=32))
    start = np.asarray(scene.arrays.position).copy()
    start[1, 0] += 0.2
    mesh = make_mesh_2d(device="cpu")
    out["mesh_shape"] = np.asarray(mesh.shape)
    out["process_count"] = np.int64(dist.get_world_size())
    fit_step(out, "fit", scene, config, start, mesh, True)

    d1 = get_design("design1")
    config = RenderConfig(width=48, height=36, **dict(FIT, max_steps=96))
    single = make_fit_harness(d1, config, device="cpu")
    true_pose, start, views = pose_views(d1, single)
    param_to_arrays = pose_param_to_arrays(d1, true_pose)
    opt = lambda ps: torch.optim.Adam(ps, lr=3e-2)  # noqa: E731
    h_single = make_fit_harness(d1, config, param_to_arrays=param_to_arrays, optimizer=opt,
                                device="cpu")
    h_mesh = make_fit_harness(d1, config, param_to_arrays=param_to_arrays, optimizer=opt,
                              mesh=make_mesh(device="cpu"))
    _, loss = h_single.multi_step_fn(h_single.init(start), *h_single.stack_views(views))
    out["pose_loss_single"] = np.float64(loss)
    state, loss = h_mesh.multi_step_fn(h_mesh.init(start), *h_mesh.stack_views(views))
    out["pose_loss_mesh"] = np.float64(loss)
    out["pose_params_mesh"] = np.concatenate(
        [np.asarray(state.params[k].detach()).reshape(-1) for k in sorted(state.params)])


SUITES = {"w2": suite_w2, "w3": suite_w3, "w4": suite_w4}


def main():
    suite, rank, world, port, out_dir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    initialize_distributed(backend="gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                           world_size=world)
    out = {}
    SUITES[suite](out, rank, out_dir)
    np.savez(os.path.join(out_dir, f"{suite}_rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
