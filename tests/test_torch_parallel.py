"""The port's multi-device layer (designcsg_tpu_torch/parallel) on gloo
worlds on the CPU, one test per test of tests/test_parallel.py, plus
tests/test_active.py's sharded extraction.

A module fixture starts two worlds of tests/torch_parallel_worker.py on
127.0.0.1 (3 ranks on a 1-D mesh: 48 rows, and 32 and 40 so that the
padding shows; 4 ranks as a 2x2 ("host", "chip") mesh beside the 1-D mesh of
the same ranks), each rank writing what it got to ``tmp_path``, and while
they run computes the JAX package's sharded results at the same device
count on conftest's 8 virtual devices (``make_mesh(n_devices=n)``).  Each
test holds the port's sharded results against the port's single-process
ones (written by rank 0: bit-equal where the JAX test asks 1e-6 or closer,
the same canonical triangles, the fit's loss within rtol 1e-5 and its
gradients within atol 1e-5) and against JAX under the tolerance of the
port's single-device parity test of the same function (the renderer's rule
of tests/test_torch_kernels.py, 1e-5 on SDF values, the fit's rtol 1e-4 on
the loss and atol 2e-6 on the parameters after a step, 1e-5 on the
vertices of one triangle set).
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import designs
from designcsg_tpu.camera import Camera as JCamera
from designcsg_tpu.config import RenderConfig as JRenderConfig
from designcsg_tpu.evaluator import BatchEvaluator as JBatchEvaluator
from designcsg_tpu.export import active as jactive
from designcsg_tpu.ops.interpreter import make_primary_sdf as j_make_primary_sdf
from designcsg_tpu.parallel.export import make_sharded_corner_provider as j_corner_provider
from designcsg_tpu.parallel.fit import make_fit_harness as j_make_fit_harness
from designcsg_tpu.parallel.mesh import make_mesh as j_make_mesh
from designcsg_tpu.parallel.render import make_sharded_renderer as j_sharded_renderer
from designcsg_tpu.parallel.render import shard_pointwise as j_shard_pointwise

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_parallel_worker.py")
WORLDS = {"w3": 3, "w4": 4}
RENDER = dict(width=64, max_steps=96)
FIT = dict(max_steps=128, differentiable=True, soft_silhouette_bandwidth=0.02, gizmo=False)
ACTIVE_CENTER = np.array([0.0371, -0.0287, 0.0113])


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def start_world(suite: str, world: int, out_dir, local_world_size: int):
    """The ranks of one gloo world, started (not waited for)."""
    env = dict(os.environ, LOCAL_WORLD_SIZE=str(local_world_size))
    env.pop("XLA_FLAGS", None)
    port = str(free_port())
    return [subprocess.Popen([sys.executable, WORKER, suite, str(r), str(world), port, str(out_dir)],
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(world)]


def finish_world(procs, suite: str, out_dir):
    """Each rank's results, after every rank exited 0."""
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(out.decode(errors="replace"))
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"{suite} rank {r} failed:\n{log[-4000:]}"
    return [dict(np.load(os.path.join(out_dir, f"{suite}_rank{r}.npz"))) for r in range(len(procs))]


def jax_results(design1):
    """The JAX package's sharded results at the worlds' device counts."""
    cam = JCamera.initial().as_arrays()
    out = {}
    for n, h in ((3, 48), (3, 32), (3, 40), (4, 48), (4, 30)):
        render = jax.jit(j_sharded_renderer(design1, JRenderConfig(height=h, **RENDER),
                                            j_make_mesh(n_devices=n)))
        out[f"render{n}_{h}"] = np.asarray(render(design1.arrays, *cam))
    arrays = jax.tree_util.tree_map(jnp.asarray, design1.arrays)
    pts = jnp.asarray(np.random.default_rng(0).uniform(-5, 5, (1003, 3)), jnp.float32)
    sdf = j_make_primary_sdf(design1)
    out["pointwise"] = np.asarray(jax.jit(j_shard_pointwise(sdf, j_make_mesh(n_devices=3)))(pts, arrays))
    epts = np.random.default_rng(1).uniform(-5, 5, (5000, 3)).astype(np.float32)
    out["evaluator"] = JBatchEvaluator(design1, chunk_size=2048, sharded=True).eval_sdf_at_points(epts)
    for n in (3, 4):
        out[f"corners{n}"] = j_corner_provider(design1, np.zeros(3), 4.0, 16, mesh=j_make_mesh(n_devices=n),
                                               use_pallas=False)(0, 16)
    for n, key, h in ((3, "step", 24), (4, "fit", 16)):
        config = JRenderConfig(width=32, height=h, **dict(FIT, max_steps=128 if n == 3 else 64))
        harness = j_make_fit_harness(design1, config, mesh=j_make_mesh(n_devices=n))
        start = np.asarray(design1.arrays.position).copy()
        start[1, 0] += 0.6 if n == 3 else 0.3
        target = harness.render_target(design1.arrays, *cam)
        state, loss = harness.step_fn(harness.init({"position": jnp.asarray(start)}), target, *cam)
        out[f"{key}_loss"] = float(loss)
        out[f"{key}_params"] = np.asarray(state.params["position"])
    jev = JBatchEvaluator(design1)
    out["active"] = jactive.extract_surface_active(jev, ACTIVE_CENTER, 2.0, 32, slab_cells=16,
                                                   use_native=False, device_mesh=j_make_mesh(n_devices=3))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"w3": [rank results], "w4": [...], "jax": {...}}: both worlds run
    while the parent computes the JAX package's results."""
    out_dir = tmp_path_factory.mktemp("worlds")
    procs = {suite: start_world(suite, n, out_dir, n) for suite, n in WORLDS.items()}
    try:
        results = {"jax": jax_results(designs.get_design("design1"))}
    finally:
        for suite in WORLDS:
            results[suite] = finish_world(procs[suite], suite, out_dir)
    return results


def check_render_rule(got, ref):
    """tests/test_torch_kernels.py's renderer parity rule
    (tests/test_pallas.py:115-116)."""
    diff = np.abs(got - ref)
    assert diff.max() < 1e-3
    assert (diff > 1e-4).mean() < 0.01


def same_on_every_rank(ranks, key):
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key], ranks[0][key])


def test_mesh_has_n_devices(runs):
    ranks = runs["w3"]
    assert [int(r["mesh_size"]) for r in ranks] == [3, 3, 3]
    assert sorted(int(r["mesh_index"]) for r in ranks) == [0, 1, 2]
    assert j_make_mesh(n_devices=3).devices.size == 3


def test_sharded_render_matches_single_device(runs):
    ranks = runs["w3"]
    same_on_every_rank(ranks, "render48")
    np.testing.assert_array_equal(ranks[0]["render48"], ranks[0]["render48_single"])
    check_render_rule(ranks[0]["render48"], runs["jax"]["render3_48"])


@pytest.mark.parametrize("suite, height", [("w3", 32), ("w3", 40), ("w4", 30)])
def test_sharded_render_pads_odd_device_counts(runs, suite, height):
    """Rows that do not divide by the ranks (32 and 40 over 3, 30 over 4):
    pad-and-slice, bitwise equal to the single-process frame."""
    ranks, key = runs[suite], ("render" if suite == "w3" else "render2d_") + str(height)
    got = ranks[0][key]
    assert got.shape == (height, 64, 3)
    same_on_every_rank(ranks, key)
    np.testing.assert_array_equal(got, ranks[0][f"{key}_single"])
    check_render_rule(got, runs["jax"][f"render{WORLDS[suite]}_{height}"])


def test_shard_pointwise_matches_and_pads(runs):
    ranks = runs["w3"]
    same_on_every_rank(ranks, "pointwise")
    np.testing.assert_array_equal(ranks[0]["pointwise"], ranks[0]["pointwise_single"])
    np.testing.assert_allclose(ranks[0]["pointwise"], runs["jax"]["pointwise"], atol=1e-5)


def test_sharded_evaluator(runs):
    ranks = runs["w3"]
    same_on_every_rank(ranks, "evaluator")
    np.testing.assert_array_equal(ranks[0]["evaluator"], ranks[0]["evaluator_single"])
    np.testing.assert_allclose(ranks[0]["evaluator"], runs["jax"]["evaluator"], atol=1e-5)


def test_fit_recovers_translation(runs):
    """The box moved by 0.1 along x and z, pulled back over 3 ranks' rows in
    40 steps at 48x36 (tests/test_torch_fit.py's recovery: the error falls
    below a fifth, the loss below a tenth); every rank ends with the same
    parameters."""
    for r in runs["w3"]:
        assert float(r["recover_err"]) < 0.2 * float(r["recover_err0"])
        assert float(r["recover_loss"]) < 0.1 * float(r["recover_loss0"])
        assert float(r["recover_err"]) == float(runs["w3"][0]["recover_err"])


def test_sharded_corner_provider_matches_direct(runs):
    """The slab's rows over 3 ranks reproduce the single-process lattice:
    the exact tape's, and the grid kernel's field (K3's plain version)."""
    ranks = runs["w3"]
    for key in ("corners_kernels0", "corners_kernels1"):
        assert ranks[0][key].shape == (17, 17, 17)
        same_on_every_rank(ranks, key)
        np.testing.assert_array_equal(ranks[0][key], ranks[0][f"{key}_single"])
    np.testing.assert_allclose(ranks[0]["corners_kernels0"], runs["jax"]["corners3"], atol=1e-5)


def test_mesh_2d(runs):
    r = runs["w4"][0]
    assert tuple(r["mesh2_shape"]) == (2, 2)
    assert tuple(r["mesh2_names"]) == ("host", "chip")


def test_fit_gradients_are_synchronized(runs):
    """An rgb step over 3 ranks' rows against a zero target: a finite loss,
    parameters that moved, identical on every rank (atol 0); and the
    geometric step against the single-process step (loss rtol 1e-5,
    gradients atol 1e-5) and JAX's on a 3-device mesh."""
    ranks = runs["w3"]
    r = ranks[0]
    assert np.isfinite(float(r["sync_loss"]))
    same_on_every_rank(ranks, "sync_params")
    start = np.asarray(designs.get_design("design1").arrays.position)
    assert np.abs(r["sync_params"] - start).sum() > 0
    same_on_every_rank(ranks, "step_params")
    np.testing.assert_allclose(float(r["step_loss"]), float(r["step_loss_single"]), rtol=1e-5)
    np.testing.assert_allclose(r["step_grad"], r["step_grad_single"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(r["step_loss"]), runs["jax"]["step_loss"], rtol=1e-4)
    np.testing.assert_allclose(r["step_params"], runs["jax"]["step_params"], rtol=0, atol=2e-6)


def test_2d_mesh_render_matches_1d(runs):
    ranks = runs["w4"]
    same_on_every_rank(ranks, "render2d_48")
    np.testing.assert_array_equal(ranks[0]["render2d_48"], ranks[0]["render1d_48"])
    np.testing.assert_array_equal(ranks[0]["render2d_48"], ranks[0]["render2d_48_single"])
    check_render_rule(ranks[0]["render2d_48"], runs["jax"]["render4_48"])


def test_2d_mesh_fit_step_matches_1d(runs):
    """Loss and parameters after a step on the 2x2 mesh equal the 1-D
    mesh's (rtol 1e-6, atol 1e-7, the JAX test's), the single process's,
    and JAX's on a 4-device mesh."""
    ranks = runs["w4"]
    r = ranks[0]
    same_on_every_rank(ranks, "fit2d_params")
    np.testing.assert_allclose(float(r["fit2d_loss"]), float(r["fit1d_loss"]), rtol=1e-6)
    np.testing.assert_allclose(r["fit2d_params"], r["fit1d_params"], atol=1e-7)
    np.testing.assert_allclose(float(r["fit1d_loss"]), float(r["fit1d_loss_single"]), rtol=1e-5)
    np.testing.assert_allclose(r["fit1d_grad"], r["fit1d_grad_single"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(r["fit2d_loss"]), runs["jax"]["fit_loss"], rtol=1e-4)
    np.testing.assert_allclose(r["fit2d_params"], runs["jax"]["fit_params"], rtol=0, atol=2e-6)


def test_2d_mesh_corner_provider_matches_direct(runs):
    ranks = runs["w4"]
    same_on_every_rank(ranks, "corners2d")
    np.testing.assert_allclose(ranks[0]["corners2d"], ranks[0]["corners2d_single"], atol=1e-6)
    np.testing.assert_allclose(ranks[0]["corners2d"], runs["jax"]["corners4"], atol=1e-5)


def test_sharded_pallas_point_eval_matches(runs):
    """The kernels' evaluator (K1 and its FD form; their plain versions on
    the CPU) sharded over 3 ranks against the unsharded exact tape, by the
    JAX test's tolerances (2e-6 on the SDF, 2e-4 on normals)."""
    ranks = runs["w3"]
    r = ranks[0]
    for key, atol in (("kernel_evaluator_sdf", 2e-6), ("kernel_evaluator_normal", 2e-4)):
        same_on_every_rank(ranks, key)
        np.testing.assert_allclose(r[key], r[f"{key}_single"], atol=atol)


def keyed_faces(faces):
    """Faces rotated to start at their least vertex index (winding kept),
    rows sorted (tests/test_torch_active.py): equal for two meshes of one
    triangle set welded by lattice key (the numpy weld)."""
    k = np.argmin(faces, axis=1)
    rolled = np.stack([faces[np.arange(len(faces)), (k + i) % 3] for i in range(3)], 1)
    return rolled[np.lexsort(rolled.T[::-1])]


def test_sharded_active_matches_single_device(runs):
    """tests/test_active.py's sharded extraction, over 3 ranks: the same
    triangles as one process, bit for bit (and as JAX's on 3 devices, its
    vertices within 1e-5, tests/test_torch_active.py's rule); the sharded
    ``compact`` export through ``export_mesh`` too."""
    ranks = runs["w3"]
    r = ranks[0]
    for kind in ("active", "compact"):
        for part in ("vertices", "faces"):
            same_on_every_rank(ranks, f"{kind}_{part}")
            np.testing.assert_array_equal(r[f"{kind}_{part}"], r[f"{kind}_{part}_single"])
        assert len(r[f"{kind}_faces"]) > 0
    jm = runs["jax"]["active"]
    np.testing.assert_array_equal(keyed_faces(r["active_faces"]), keyed_faces(jm.faces))
    np.testing.assert_allclose(r["active_vertices"], jm.vertices, rtol=0, atol=1e-5)


def test_sharded_export_resumes_from_one_writer(runs):
    """``export_mesh(sharded=True, resume_dir=...)`` on 3 ranks of one host:
    rank 0 alone writes the resume files (the pre-refinement mesh and one
    shard per slab, no temporary left), and a run that resumes from the
    mesh, and one that resumes slab by slab, give every rank the triangles
    of the one-process export, bit for bit."""
    ranks = runs["w3"]
    r = ranks[0]
    same_on_every_rank(ranks, "resume_files")
    files = [str(f) for f in r["resume_files"]]
    assert len(files) == 3 and all(f.endswith(".npz") and ".tmp" not in f for f in files)
    assert sum(f.startswith("extract_") for f in files) == 1
    assert sum(f.startswith("slab_") for f in files) == 2
    assert len(r["resume_faces_single"]) > 0
    # The first run evaluates both slabs; the resumed runs none.
    same_on_every_rank(ranks, "resume_slab_evaluations")
    np.testing.assert_array_equal(r["resume_slab_evaluations"], [2, 0, 0])
    for run in range(3):
        for part in ("vertices", "faces"):
            same_on_every_rank(ranks, f"resume{run}_{part}")
            np.testing.assert_array_equal(r[f"resume{run}_{part}"], r[f"resume_{part}_single"])


def test_make_mesh_without_a_group_is_a_world_of_one():
    """``make_mesh()`` with no process group builds a world of one on an
    in-process store: one device needs no launcher."""
    import torch.distributed as dist

    from designcsg_tpu_torch.parallel.mesh import make_mesh, mesh_rank, replicated, row_sharded

    assert not dist.is_initialized()
    try:
        mesh = make_mesh(device="cpu")
        assert dist.get_world_size() == 1 and mesh_rank(mesh) == (0, 1)
        assert mesh.mesh_dim_names == ("rays",)
        assert len(replicated(mesh)) == 1 and row_sharded(mesh)[0].is_shard(0)
        x = torch.arange(5.0)
        from designcsg_tpu_torch.parallel.render import shard_pointwise

        assert torch.equal(shard_pointwise(lambda p, a: p * 2, mesh)(x, None), x * 2)
    finally:
        dist.destroy_process_group()
