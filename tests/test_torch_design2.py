"""Design2 and the prefab library in the PyTorch port against the JAX package:
compiled arrays and reference artifacts equal, the SDF on seeded points, the
plain render against the golden image, the prefab brushes, and the Lipschitz
estimate the fast march modes check."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import designs
from designcsg_tpu import api as japi
from designcsg_tpu.ops import interpreter as jinterp
from designcsg_tpu.ops import raymarch as jraymarch
from designcsg_tpu_torch import api as tapi
from designcsg_tpu_torch.compiler import SCENE_ARRAY_FIELDS, scene_arrays_from_numpy
from designcsg_tpu_torch.config import RenderConfig
from designcsg_tpu_torch.designs import design2 as tdesign2
from designcsg_tpu_torch.designs import get_design
from designcsg_tpu_torch.designs import library as tlibrary
from designcsg_tpu_torch.ops import interpreter as tinterp
from designcsg_tpu_torch.ops import raymarch as traymarch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "goldens", "design2_160x120.npy")


@pytest.fixture(scope="module")
def scenes():
    return designs.get_design("design2"), get_design("design2")


def test_design2_arrays_bit_equal(scenes):
    jscene, tscene = scenes
    for f in SCENE_ARRAY_FIELDS:
        a, b = getattr(tscene.arrays, f), np.asarray(getattr(jscene.arrays, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    assert tscene.num_registers == jscene.num_registers
    assert tscene.export_config.to_lines() == jscene.export_config.to_lines()
    assert tscene.brush_names[5:] == ("hilbert", "hilbert_base")
    assert all(tscene.brush_cuda)


def test_design2_tape_flops(scenes):
    """The bound's operation count: the Hilbert body counted as it is
    generated (8 quadrants of 83 operations, 7 connectors of 14), the base
    (14), each through an 18-operation frame transform, and two MINs (the
    empty root import costs nothing)."""
    _, tscene = scenes
    assert tscene.brush_flops[5:] == (8 * 83 + 7 * 14, 14)
    sys.path.insert(0, REPO)
    import chip_smoke

    assert chip_smoke.tape_ops(tscene) == (762 + 18) + (14 + 18) + 2


def test_hilbert_cuda_body_is_straight_line():
    body, flops = tdesign2.hilbert_cuda()
    assert body.count("quadrant (") == 8 and body.count("connector (") == 7
    assert "*" not in body.replace("3.0f *", "")  # no products with 0/+-1
    assert flops == 762


def test_write_artifacts_byte_equal(tmp_path):
    from designs import design2 as jdesign2

    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    jc = japi.new_design()
    jdesign2.build(compiler=jc)
    jc.write_artifacts(str(tmp_path / "jax"))
    tc = tapi.new_design()
    tdesign2.build(compiler=tc)
    tc.write_artifacts(str(tmp_path / "torch"))
    names = ["scene.txt", "buildprocedure.txt", "arbitrary_data.hex", "exportConfig.txt"]
    for name in names:
        assert (tmp_path / "torch" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name


@pytest.mark.parametrize("gizmo", [False, True])
def test_primary_sdf_matches_jax(scenes, gizmo):
    jscene, tscene = scenes
    pts = np.random.default_rng(0).uniform(-2.5, 2.5, (4096, 3)).astype(np.float32)
    arrays = scene_arrays_from_numpy(
        {f: np.asarray(getattr(jscene.arrays, f)) for f in SCENE_ARRAY_FIELDS}
    )
    ours = tinterp.make_primary_sdf(tscene, gizmo=gizmo)(
        torch.from_numpy(pts.copy()), arrays.to_torch("cpu")
    ).numpy().copy()
    ref = np.array(jinterp.make_primary_sdf(jscene, gizmo=gizmo)(jnp.asarray(pts.copy()), jscene.arrays))
    assert (ref < 0).mean() > 0.01  # the seeded box reaches inside the sculpture
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_render_matches_golden(scenes):
    _, tscene = scenes
    img = traymarch.to_u8(
        traymarch.render_scene(tscene, config=RenderConfig(width=160, height=120), device="cpu")
    )
    diff = np.abs(img.numpy().astype(int) - np.load(GOLDEN).astype(int))
    # The rule of tests/test_library.py:61-64.
    assert (diff.max(axis=-1) > 2).mean() < 0.002


def _prefab_scenes(kind):
    """The same prefab scene built by both packages."""
    from designs import library as jlibrary

    out = []
    for api, library in ((japi, jlibrary), (tapi, tlibrary)):
        c = api.new_design()
        if kind == "ring_of_torus":
            c.root.add_child(library.ring_of(library.torus(compiler=c), count=6, radius=1.5, compiler=c))
        elif kind == "capsule":
            c.root.add_child(library.capsule([0.0, -1.0, 0.2], [0.3, 1.0, 0.0], thickness=0.5, compiler=c))
        else:
            c.root.add_child(library.rounded_box(compiler=c, transform=api.Transform.initial(
                position=[0.1, 0.2, 0.0], yaw=0.3, pitch=0.2, roll=0.1, scale=[1.0, 1.5, 0.8])))
        out.append(c.commit())
    return out


@pytest.mark.parametrize("kind", ["ring_of_torus", "capsule", "rounded_box"])
def test_library_prefab_sdf_matches_jax(kind):
    jscene, tscene = _prefab_scenes(kind)
    for f in SCENE_ARRAY_FIELDS:
        assert getattr(tscene.arrays, f).tobytes() == np.asarray(getattr(jscene.arrays, f)).tobytes(), f
    assert all(tscene.brush_cuda[i] for i in tscene.arrays.shape_id)
    pts = np.random.default_rng(3).uniform(-10, 10, (4096, 3)).astype(np.float32)
    ours = tinterp.make_primary_sdf(tscene)(torch.from_numpy(pts.copy())).numpy().copy()
    ref = np.array(jinterp.make_primary_sdf(jscene)(jnp.asarray(pts.copy()), jscene.arrays))
    assert (ref < 0).any()
    np.testing.assert_allclose(ours, ref, atol=1e-5)


@pytest.mark.parametrize("name", ["design1", "design2"])
def test_lipschitz_estimate_matches_jax(name):
    ours = traymarch.check_scene_lipschitz(get_design(name), samples=1024)
    ref = jraymarch.check_scene_lipschitz(designs.get_design(name), samples=1024)
    assert abs(ours - ref) <= 1e-5 * max(1.0, ref)
