"""The plain reference against the program's plain route at a tiny size
(a test may import the program; the reference may not)."""

import numpy as np
import pytest
import torch

from benchmark.drivers import cameras
from benchmark.reference import design1, geometry, mesh, render

DESIGNS = {"design1": design1}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_scene(name, rotation=None):
    from designcsg_tpu_torch import api
    from designcsg_tpu_torch.designs import design_module

    compiler = api.new_design()
    if rotation is not None:
        root = np.eye(4)
        root[:3, :3] = rotation
        compiler.root.apply_transform(root)
    return design_module(name).build(compiler=compiler)


@pytest.mark.parametrize("name", sorted(DESIGNS))
@pytest.mark.parametrize("turn", [None, 5, 17])
def test_field_matches_the_programs_tape(name, turn):
    from designcsg_tpu_torch.ops.interpreter import make_primary_sdf

    rotation = None if turn is None else geometry.axis_rotations()[turn]
    points = torch.rand(4096, 3, generator=torch.Generator().manual_seed(3)) * 12.0 - 6.0
    ref = DESIGNS[name].design(rotation).field(points)
    got = make_primary_sdf(port_scene(name, rotation))(points)
    assert torch.allclose(ref, got, atol=2e-6, rtol=0)


def test_flop_counts_are_the_programs():
    assert render.field_flops(design1.design(), gizmo=False) == 269


@pytest.mark.parametrize("name", sorted(DESIGNS))
def test_frame_matches_the_programs_plain_renderer(name):
    from designcsg_tpu_torch.config import RenderConfig
    from designcsg_tpu_torch.ops.raymarch import make_renderer

    params = {"cycle": 720, "degrees_per_frame": 0.5, "elevation_deg": 30.0,
              "elevation_swings": 3, "zoom": 0.1, "zoom_swings": 2}
    pose = cameras.view(101, params)
    scene = port_scene(name)
    frame = make_renderer(scene, RenderConfig(width=40, height=30), field="exact")(
        scene.arrays.to_torch("cpu"), *pose)
    ref, evals, hits = render.render(DESIGNS[name].design(), pose, 40, 30)
    gap = (frame - ref).abs().amax(-1)
    assert hits > 0 and evals > 40 * 30
    assert float((gap > 1e-3).float().mean()) <= 0.01


def test_camera_path_is_the_programs_orbit():
    from designcsg_tpu_torch.camera import Camera

    params = {"cycle": 720, "degrees_per_frame": 0.5, "elevation_deg": 30.0,
              "elevation_swings": 3, "zoom": 0.0, "zoom_swings": 2}
    for k in (0, 77, 300):
        cam = Camera.initial()
        da = np.radians(0.5) * k
        db = np.radians(30.0) * np.sin(2 * np.pi * 3 * k / 720)
        cam.orbit(da, db)
        for a, b in zip(cameras.view(k, params), cam.as_arrays()):
            np.testing.assert_allclose(a, b, atol=1e-6)
    # Every seed asks for the same views, from another start.
    a, b = cameras.path(1, params), cameras.path(2**31 + 11, params)
    keys = lambda p: sorted(tuple(np.concatenate(v).round(5)) for v in p)  # noqa: E731
    assert keys(a) == keys(b)


def test_axis_rotations():
    rs = geometry.axis_rotations()
    assert len(rs) == 24 and len({r.tobytes() for r in rs}) == 24
    for r in rs:
        np.testing.assert_allclose(r @ r.T, np.eye(3))
        assert np.linalg.det(r) == pytest.approx(1.0)


def test_stl_reader_reads_the_programs_writer(tmp_path):
    from designcsg_tpu_torch.export.writers import write_stl
    from designcsg_tpu_torch.ops.marching_cubes import Mesh

    vertices = np.random.default_rng(0).normal(size=(30, 3)).astype(np.float32)
    faces = np.arange(30).reshape(10, 3)
    write_stl(str(tmp_path / "m.stl"), Mesh(vertices=vertices, faces=faces))
    np.testing.assert_array_equal(mesh.read_stl(str(tmp_path / "m.stl")), vertices[faces])


def test_volume_of_a_cube_and_of_design1():
    t = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]],
                 np.float64)
    quads = [(0, 3, 2, 1), (4, 5, 6, 7), (0, 1, 5, 4), (2, 3, 7, 6), (1, 2, 6, 5), (0, 4, 7, 3)]
    tris = np.array([[t[a], t[b], t[c]] for q in quads for a, b, c in ((q[0], q[1], q[2]), (q[0], q[2], q[3]))])
    assert mesh.volume(tris) == pytest.approx(1.0)
    # Design1 (a box of side 4.75 and a sphere of radius 3.125 in world
    # units, less its corners): the jittered count agrees with a finer one.
    d = design1.design()
    coarse = mesh.design_volume(d, [-5] * 3, [5] * 3, 48, seed=1, device="cpu")
    fine = mesh.design_volume(d, [-5] * 3, [5] * 3, 96, seed=2, device="cpu")
    assert coarse == pytest.approx(fine, rel=0.01)
    assert 4.0 / 3.0 * np.pi * 3.125 ** 3 * 0.5 < fine < 4.75 ** 3 + 4.0 / 3.0 * np.pi * 3.125 ** 3


def test_bfloat16_control_moves_vertices_off_the_surface():
    d = design1.design()
    p = np.array([[3.125 * np.cos(a), 0.3, 3.125 * np.sin(a)] for a in np.linspace(0.3, 1.2, 16)],
                 np.float32)
    p = mesh.project_bf16(d, p, 0, "cpu")  # the points in bfloat16
    assert np.abs(mesh.field_at(d, p, "cpu")).max() > 1e-4
