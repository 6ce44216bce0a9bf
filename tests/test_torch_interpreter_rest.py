"""Analytic normals and the dynamic (runtime-tape) interpreter of the PyTorch
port against the JAX package, on the CPU, with each package's own build of
Design1 and Design2 (their banks are bit-equal, test_torch_compiler.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import designs
from designcsg_tpu.config import RenderConfig as JRenderConfig
from designcsg_tpu.evaluator import BatchEvaluator as JBatchEvaluator
from designcsg_tpu.ops import interpreter as jinterp
from designcsg_tpu.ops import raymarch as jraymarch
from designcsg_tpu_torch.config import RenderConfig
from designcsg_tpu_torch.designs import get_design
from designcsg_tpu_torch.evaluator import BatchEvaluator
from designcsg_tpu_torch.ops import interpreter as tinterp
from designcsg_tpu_torch.ops.raymarch import render_scene

DESIGNS = ("design1", "design2")


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
    return {name: (designs.get_design(name), get_design(name)) for name in DESIGNS}


def _near_surface(scene, n=4096, seed=0, band=0.05):
    """``n`` seeded points within ``band`` of the scene's surface."""
    half = scene.export_config.bounding_box_half_diameter / 2.0
    pts = np.random.default_rng(seed).uniform(-half, half, (64 * n, 3)).astype(np.float32)
    d = tinterp.make_primary_sdf(scene)(torch.from_numpy(pts)).numpy()
    pts = pts[np.abs(d) < band]
    assert len(pts) >= n
    return pts[:n]


@pytest.mark.parametrize("name", DESIGNS)
def test_analytic_normals_match_jax(scenes, name):
    """make_normal_fn(mode="analytic") against JAX's ``vmap(grad)`` on 4096
    seeded points near the surface: within 1e-5 on >= 99.9% of them and all
    within 2e-3 (JAX's analytic-against-FD tolerance,
    tests/test_interpreter.py:114-123).  The two libraries may route a
    gradient differently where a min/max ties or a brush has a kink (a
    box's edge); measured on the CPU: every point within 1e-5 on both
    designs, the largest difference 1.2e-7."""
    jscene, tscene = scenes[name]
    pts = _near_surface(tscene)
    ours = tinterp.make_normal_fn(tinterp.make_primary_sdf(tscene), mode="analytic")(
        torch.from_numpy(pts), tscene.arrays.to_torch("cpu")).numpy()
    ref = np.asarray(jax.jit(jinterp.make_normal_fn(jinterp.make_primary_sdf(jscene), mode="analytic"))(
        jnp.asarray(pts), jscene.arrays))
    err = np.abs(ours - ref).max(-1)
    assert (err <= 1e-5).mean() >= 0.999, (err <= 1e-5).mean()
    assert err.max() < 2e-3
    np.testing.assert_allclose(np.linalg.norm(ours, axis=-1), 1.0, atol=1e-5)


def test_analytic_normals_in_the_evaluator(scenes):
    """BatchEvaluator(normal_mode="analytic") on the exact tape: the
    interpreter's analytic normals, JAX's evaluator's within 1e-5 on
    >= 99.9% of the points, one tape evaluation a normal
    (evaluator.py:145-149 of the JAX package)."""
    jscene, tscene = scenes["design1"]
    pts = _near_surface(tscene, n=1024, seed=1)
    ev = BatchEvaluator(tscene, device="cpu", normal_mode="analytic")
    got = ev.eval_normal_at_points(pts)
    assert ev.sdf_eval_count == len(pts)
    ref = JBatchEvaluator(jscene, normal_mode="analytic").eval_normal_at_points(pts)
    assert (np.abs(got - ref).max(-1) <= 1e-5).mean() >= 0.999
    fd = BatchEvaluator(tscene, device="cpu").eval_normal_at_points(pts)
    # FD's offset of 0.005 averages across edges; elsewhere the two agree.
    assert (np.abs(got - fd).max(-1) < 2e-3).mean() > 0.9


def test_analytic_frame_matches_jax(scenes):
    """A 64x48 frame with ``normal_mode="analytic"`` against JAX's
    render_scene by the port's render rule: max|d| < 1e-3, under 1% of
    pixels above 1e-4."""
    jscene, tscene = scenes["design1"]
    kw = dict(width=64, height=48, max_steps=128, normal_mode="analytic")
    ours = render_scene(tscene, config=RenderConfig(**kw), device="cpu").numpy()
    ref = np.asarray(jraymarch.render_scene(jscene, config=JRenderConfig(**kw)))
    fd = render_scene(tscene, config=RenderConfig(**{**kw, "normal_mode": "fd"}), device="cpu").numpy()
    assert (ref != 1.0).any(-1).mean() > 0.1
    assert np.abs(ours - fd).max() > 1e-3  # the normals changed
    diff = np.abs(ours - ref)
    assert diff.max() < 1e-3
    assert (diff > 1e-4).any(-1).mean() < 0.01


@pytest.mark.parametrize("name", DESIGNS)
def test_dynamic_tape_matches_staged_and_jax(scenes, name):
    """make_dynamic_primary_sdf bit-equal to the staged tape, and within
    1e-5 + 1e-6|ref| of JAX's make_dynamic_primary_sdf, with and without
    the gizmo."""
    jscene, tscene = scenes[name]
    pts = np.random.default_rng(2).uniform(-6, 6, (4096, 3)).astype(np.float32)
    arrays = tscene.arrays.to_torch("cpu")
    for gizmo in (False, True):
        dyn = tinterp.make_dynamic_primary_sdf(tscene, gizmo=gizmo)(torch.from_numpy(pts), arrays)
        staged = tinterp.make_primary_sdf(tscene, gizmo=gizmo)(torch.from_numpy(pts), arrays)
        assert torch.equal(dyn, staged)
        ref = np.asarray(jinterp.make_dynamic_primary_sdf(jscene, gizmo=gizmo)(
            jnp.asarray(pts), jscene.arrays))
        assert np.all(np.abs(dyn.numpy() - ref) <= 1e-5 + 1e-6 * np.abs(ref))


def test_dynamic_tape_follows_the_tape_passed_at_call_time(scenes):
    """An edited tape in the arrays passed at call time changes the result
    without a rebuild: Design1 with its root's first MIN turned into a MAX
    equals the staged tape of the edited scene bit for bit and JAX's
    dynamic interpreter within 1e-5 + 1e-6|ref|; the scene's own tape gives
    the first result back.  Out-of-range opcodes and operands clip as in
    JAX."""
    jscene, tscene = scenes["design1"]
    tape = np.array(tscene.arrays.tape)
    row = int(np.nonzero(tape[:, 0] == 2)[0][0])
    tape[row, 0] = 3
    edited = dataclasses.replace(tscene.arrays, tape=tape)
    pts = torch.from_numpy(np.random.default_rng(3).uniform(-6, 6, (4096, 3)).astype(np.float32))
    sdf = tinterp.make_dynamic_primary_sdf(tscene)
    before = sdf(pts)
    after = sdf(pts, edited.to_torch("cpu"))
    assert not torch.equal(before, after)
    staged = tinterp.make_primary_sdf(dataclasses.replace(tscene, arrays=edited))(pts)
    assert torch.equal(after, staged)
    ref = np.asarray(jinterp.make_dynamic_primary_sdf(jscene)(
        jnp.asarray(pts.numpy()), jscene.arrays.replace(tape=jnp.asarray(tape))))
    assert np.all(np.abs(after.numpy() - ref) <= 1e-5 + 1e-6 * np.abs(ref))
    assert torch.equal(sdf(pts, tscene.arrays.to_torch("cpu")), before)
    # Clipping: opcode 9 -> IDENTITY (5), register operands clip to the file.
    wild = np.array(tscene.arrays.tape)
    wild[row, 0], wild[row, 2] = 9, 1000
    wild_arrays = dataclasses.replace(tscene.arrays, tape=wild)
    ours = sdf(pts, wild_arrays.to_torch("cpu")).numpy()
    ref = np.asarray(jinterp.make_dynamic_primary_sdf(jscene)(
        jnp.asarray(pts.numpy()), jscene.arrays.replace(tape=jnp.asarray(wild))))
    assert np.all(np.abs(ours - ref) <= 1e-5 + 1e-6 * np.abs(ref))


def test_dynamic_tape_is_differentiable(scenes):
    """Gradients reach the banks through the dense register file, equal to
    the staged tape's."""
    _, tscene = scenes["design1"]
    pts = torch.from_numpy(np.random.default_rng(4).uniform(-4, 4, (512, 3)).astype(np.float32))
    grads = []
    for make in (tinterp.make_dynamic_primary_sdf, tinterp.make_primary_sdf):
        arrays = tscene.arrays.to_torch("cpu")
        arrays.position.requires_grad_(True)
        make(tscene)(pts, arrays).sum().backward()
        grads.append(arrays.position.grad)
    assert torch.equal(grads[0], grads[1]) and float(grads[0].abs().sum()) > 0
