"""The differentiable fit of the port against the JAX package, on the CPU: the
plain version of the fit's ray-march kernel (against JAX's jnp march and its
Pallas kernel in interpret mode), the implicit-function-theorem march, the
geometric and soft-silhouette renderers (values and gradients against
``jax.value_and_grad``), the fit harness's steps against optax's Adam, the
state crossing from JAX, checkpoints, and a short recovery.

On CPU tensors the ray-march wrapper takes its plain version, so these tests
call the port as its callers do; the CUDA kernel is held against the same
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).  Both
frameworks get the same rays, formed by the port and handed over as numpy,
except in the harness tests, where each forms its own from the camera as a
user's call does."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import designs
from designcsg_tpu.camera import Camera as JCamera
from designcsg_tpu.config import RenderConfig as JRenderConfig
from designcsg_tpu.ops import raymarch as jrm
from designcsg_tpu.ops.interpreter import make_primary_sdf as j_make_primary_sdf
from designcsg_tpu.ops.pallas.march_kernel import make_pallas_ray_march
from designcsg_tpu.parallel.fit import make_fit_harness as j_make_fit_harness
from designcsg_tpu_torch.camera import Camera
from designcsg_tpu_torch.config import RenderConfig
from designcsg_tpu_torch.designs import get_design
from designcsg_tpu_torch.ops import raymarch as trm
from designcsg_tpu_torch.ops.cuda import build as kbuild
from designcsg_tpu_torch.ops.cuda.march_kernel import make_cuda_ray_march
from designcsg_tpu_torch.parallel.fit import (
    fit_state_from_numpy,
    load_checkpoint,
    make_fit_harness,
    save_checkpoint,
)

# tests/test_pallas.py:137-156's size for the march; the fit's own config
# (cli fit's step budget) at 64x48 for gradients and steps.
MARCH = dict(width=128, height=32, max_steps=80, gizmo=False)
FIT = dict(width=64, height=48, max_steps=128, differentiable=True,
           soft_silhouette_bandwidth=0.02, gizmo=False)


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
    return designs.get_design("design1"), get_design("design1")


def _rays(config, cam):
    """(o_proj f32[3], r_proj f32[H, W, 3]) as numpy, formed by the port."""
    rows = trm.camera_rows(*cam.as_arrays())
    rays = trm.project(trm.ray_directions(config), *torch.from_numpy(rows[1:]))
    return rows[0], rays.numpy()


def _start(scene):
    start = np.asarray(scene.arrays.position).copy()
    start[1:, 0] += 0.05  # bench.py's fit start (bench.py:300-305)
    return start


@pytest.mark.parametrize("omega", [1.0, 1.6])
def test_plain_ray_march_matches_jax(scenes, omega):
    """Identical hit sets and ``d`` within 1e-5 (tests/test_pallas.py:
    153-156).  The closest approach is an argmin over the march's steps: where
    two steps' values tie within rounding, the two frameworks may keep
    different points, so ``vmin`` is held within 1e-5 except on such rays,
    where the SDF at both points must agree within 1e-6 (the value the soft
    silhouette reads)."""
    jscene, tscene = scenes
    kw = dict(MARCH, march_overrelax=omega)
    o, r = _rays(RenderConfig(**kw), Camera.initial())
    before = kbuild.LAUNCHES["ray_march"]
    d, vmin = make_cuda_ray_march(tscene, RenderConfig(**kw))(
        tscene.arrays.to_torch("cpu"), o, torch.from_numpy(r))
    assert kbuild.LAUNCHES["ray_march"] == before  # the plain version: no launch
    assert not d.requires_grad and d.shape == (32, 128) and vmin.shape == (32, 128, 3)
    d, vmin = d.numpy(), vmin.numpy()
    refs = {"jnp": jrm.make_march(jscene, JRenderConfig(**kw))(
        jnp.asarray(o), jnp.asarray(r), jscene.arrays, return_closest=True)}
    if omega == 1.0:  # the JAX kernel has plain stepping only
        refs["pallas"] = make_pallas_ray_march(jscene, JRenderConfig(**kw), interpret=True)(
            jscene.arrays, jnp.asarray(o), jnp.asarray(r))
    sdf = j_make_primary_sdf(jscene)
    for name, (d_j, vmin_j) in refs.items():
        d_j, vmin_j = np.asarray(d_j), np.asarray(vmin_j)
        assert ((d > 0) == (d_j > 0)).all(), name
        assert (d > 0).sum() > 1000, name
        np.testing.assert_allclose(d, d_j, atol=1e-5, err_msg=name)
        off = np.abs(vmin - vmin_j).max(-1) > 1e-5
        assert off.sum() <= 2, (name, off.sum())
        if off.any():
            s_t = np.asarray(sdf(jnp.asarray(vmin[off]), jscene.arrays))
            s_j = np.asarray(sdf(jnp.asarray(vmin_j[off]), jscene.arrays))
            np.testing.assert_allclose(s_t, s_j, atol=1e-6, err_msg=name)


def _value_and_grad_t(fn, arrays, position):
    p = torch.tensor(position, requires_grad=True)
    value = fn(dataclasses.replace(arrays, position=p))
    value.backward()
    return value.item(), p.grad.numpy()


def _value_and_grad_j(fn, arrays, position):
    value, grad = jax.value_and_grad(lambda p: fn(arrays.replace(position=p)))(
        jnp.asarray(position))
    return float(value), np.asarray(grad)


@pytest.mark.parametrize("which", ["march", "geometry", "ray_renderer"])
def test_differentiable_renders_match_jax_value_and_grad(scenes, which):
    """Design1 at 64x48 from the fit's perturbed start: a random weighting
    of each output, its value and its gradient with respect to every object
    position against ``jax.value_and_grad``.  Both marches hit the same rays
    (checked first), so no ray is dropped.  Tolerances: values rtol 2e-5
    (sums of ~3000 terms in another order); gradients within 1e-4 of the
    largest gradient component for depth and alpha, whose reattachment
    divides by the SDF's slope along the ray (small on grazing rays), and
    1e-3 for RGB, whose FD normals divide tape differences by 2e-4."""
    jscene, tscene = scenes
    config, jconfig = RenderConfig(**FIT), JRenderConfig(**FIT)
    cam = Camera.initial()
    o, r = _rays(config, cam)
    rows = trm.camera_rows(*cam.as_arrays())
    rng = np.random.default_rng(0)
    w = rng.normal(size=(48, 64)).astype(np.float32)
    w3 = rng.normal(size=(48, 64, 3)).astype(np.float32)
    ot, rt, wt, w3t = (torch.from_numpy(a) for a in (o, r, w, w3))
    oj, rj = jnp.asarray(o), jnp.asarray(r)
    base = tscene.arrays.to_torch("cpu")
    start = _start(tscene)

    d_t = trm.make_differentiable_march(tscene, config)(
        ot, rt, dataclasses.replace(base, position=torch.from_numpy(start))).detach().numpy()
    d_j = np.asarray(jrm.make_differentiable_march(jscene, jconfig)(
        oj, rj, jscene.arrays.replace(position=jnp.asarray(start))))
    assert ((d_t > 0) == (d_j > 0)).all()  # 0 rays differ
    assert (d_t > 0).sum() > 300

    if which == "march":
        tm = trm.make_differentiable_march(tscene, config)
        jm = jrm.make_differentiable_march(jscene, jconfig)
        fn_t = lambda a: (wt * tm(ot, rt, a)).sum()  # noqa: E731
        fn_j = lambda a: (w * jm(oj, rj, a)).sum()  # noqa: E731
        rel = 1e-4
    elif which == "geometry":
        tg = trm.make_geometry_renderer(tscene, config)
        jg = jrm.make_geometry_renderer(jscene, jconfig)
        fn_t = lambda a: sum((wt * x).sum() for x in tg(a, ot, rt))  # noqa: E731
        fn_j = lambda a: sum((w * x).sum() for x in jg(a, oj, rj))  # noqa: E731
        rel = 1e-4
    else:
        tr = trm.make_ray_renderer(tscene, config)
        jr = jrm.make_ray_renderer(jscene, jconfig)
        frame_t, frame_j = torch.from_numpy(rows[1:]), jnp.asarray(rows[1:])
        fn_t = lambda a: (w3t * tr(a, ot, rt, *frame_t)).sum()  # noqa: E731
        fn_j = lambda a: (w3 * jr(a, oj, rj, *frame_j)).sum()  # noqa: E731
        rel = 1e-3
    v_t, g_t = _value_and_grad_t(fn_t, base, start)
    v_j, g_j = _value_and_grad_j(fn_j, jscene.arrays, start)
    np.testing.assert_allclose(v_t, v_j, rtol=2e-5)
    assert np.abs(g_j).max() > 1.0
    np.testing.assert_allclose(g_t, g_j, rtol=0, atol=rel * np.abs(g_j).max())


def test_ift_depth_value_is_the_march_bit_for_bit(scenes):
    """The reattached depth equals the detached march's d exactly."""
    _, tscene = scenes
    config = RenderConfig(**FIT)
    o, r = _rays(config, Camera.initial())
    arrays = tscene.arrays.to_torch("cpu")
    arrays = dataclasses.replace(arrays, position=arrays.position.clone().requires_grad_())
    d0, _ = make_cuda_ray_march(tscene, config)(arrays, o, torch.from_numpy(r))
    d = trm.make_differentiable_march(tscene, config)(
        torch.from_numpy(o), torch.from_numpy(r), arrays)
    assert d.requires_grad
    assert torch.equal(d.detach(), d0)


def _harnesses(jscene, tscene, loss):
    kw = dict(use_mesh=False, loss=loss)
    jh = j_make_fit_harness(jscene, JRenderConfig(**FIT), optimizer=optax.adam(1e-2), **kw)
    th = make_fit_harness(tscene, RenderConfig(**FIT), device="cpu", **kw)
    return jh, th


def _check_step(jh, th, j_state, t_state, j_loss, t_loss):
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-4)
    # Adam's first steps move each parameter by about lr * sign(g): the
    # rounding of torch.optim.Adam against optax, and of each framework's
    # gradient, leaves ~1e-6 on parameters of order 1.
    np.testing.assert_allclose(t_state.params["position"].detach().numpy(),
                               np.asarray(j_state.params["position"]), rtol=0, atol=2e-6)
    assert t_state.step == int(j_state.step)


@pytest.mark.parametrize("loss", ["geometric", "rgb"])
def test_step_fn_matches_jax(scenes, loss):
    """One ``step_fn`` from the perturbed start against JAX's harness with
    ``optax.adam(1e-2)``; each renders its own target."""
    jscene, tscene = scenes
    jh, th = _harnesses(jscene, tscene, loss)
    cam = Camera.initial().as_arrays()
    jt = jh.render_target(jscene.arrays, *cam)
    tt = th.render_target(tscene.arrays, *cam)
    for a, b in zip(jax.tree_util.tree_leaves(jt), tt if loss == "geometric" else (tt,)):
        assert not b.requires_grad
        diff = np.abs(b.numpy() - np.asarray(a))
        if loss == "geometric":
            assert diff.max() < 2e-5
        else:  # the renderer's rule (tests/test_pallas.py:115-116)
            assert diff.max() < 1e-3 and (diff > 1e-4).mean() < 0.01
    start = _start(tscene)
    j_state, j_loss = jh.step_fn(jh.init({"position": jnp.asarray(start)}), jt, *cam)
    t_state, t_loss = th.step_fn(th.init({"position": start}), tt, *cam)
    assert float(t_loss) > 0
    _check_step(jh, th, j_state, t_state, j_loss, t_loss)


def test_multi_step_fn_matches_jax(scenes):
    """One ``multi_step_fn`` over two views (the per-view geometric losses
    sum) against JAX's."""
    jscene, tscene = scenes
    jh, th = _harnesses(jscene, tscene, "geometric")
    cams = [Camera.initial(), Camera.initial().orbit(1.1, 0.0)]
    jcams = [JCamera.initial(), JCamera.initial().orbit(1.1, 0.0)]
    jviews = [(jh.target_fn(jax.tree_util.tree_map(jnp.asarray, jscene.arrays), *c.as_arrays()),)
              + tuple(c.as_arrays()) for c in jcams]
    tviews = [(th.render_target(tscene.arrays, *c.as_arrays()),) + tuple(c.as_arrays())
              for c in cams]
    start = _start(tscene)
    j_state, j_loss = jh.multi_step_fn(jh.init({"position": jnp.asarray(start)}),
                                       *jh.stack_views(jviews))
    stacked = th.stack_views(tviews)
    assert stacked[0][0].shape == (2, 48, 64) and stacked[1].shape == (2, 3)
    t_state, t_loss = th.multi_step_fn(th.init({"position": start}), *stacked)
    _check_step(jh, th, j_state, t_state, j_loss, t_loss)


def test_fit_state_from_numpy_continues_the_jax_fit(scenes):
    """JAX's state after one step, carried across: the port's next step
    equals JAX's next step."""
    jscene, tscene = scenes
    jh, th = _harnesses(jscene, tscene, "geometric")
    cam = Camera.initial().as_arrays()
    jt = jh.render_target(jscene.arrays, *cam)
    tt = th.render_target(tscene.arrays, *cam)
    j_state, _ = jh.step_fn(jh.init({"position": jnp.asarray(_start(tscene))}), jt, *cam)
    adam_state = j_state.opt_state[0]
    t_state = fit_state_from_numpy(
        {"position": np.asarray(j_state.params["position"])},
        {"position": np.asarray(adam_state.mu["position"])},
        {"position": np.asarray(adam_state.nu["position"])},
        int(adam_state.count), device="cpu",
    )
    assert t_state.step == 1
    j_state, j_loss = jh.step_fn(j_state, jt, *cam)
    t_state, t_loss = th.step_fn(t_state, tt, *cam)
    _check_step(jh, th, j_state, t_state, j_loss, t_loss)


def test_checkpoint_round_trip(scenes, tmp_path):
    """A state saved and loaded takes the same next step as the original."""
    _, tscene = scenes
    h = make_fit_harness(tscene, RenderConfig(**FIT), device="cpu")
    cam = Camera.initial().as_arrays()
    target = h.render_target(tscene.arrays, *cam)
    state, _ = h.step_fn(h.init({"position": _start(tscene)}), target, *cam)
    save_checkpoint(str(tmp_path / "fit.ckpt"), state)
    back = load_checkpoint(str(tmp_path / "fit.ckpt"), device="cpu")
    assert back.step == state.step == 1
    assert torch.equal(back.params["position"], state.params["position"])
    a, _ = h.step_fn(state, target, *cam)
    b, _ = h.step_fn(back, target, *cam)
    assert torch.equal(a.params["position"], b.params["position"])


def test_harness_refuses_a_mesh_and_bad_arguments(scenes):
    _, tscene = scenes
    with pytest.raises(TypeError, match="DeviceMesh"):
        make_fit_harness(tscene, RenderConfig(**FIT), mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="loss"):
        make_fit_harness(tscene, RenderConfig(**FIT), loss="l1", device="cpu")
    with pytest.raises(ValueError, match="fit_field"):
        make_fit_harness(tscene, RenderConfig(**dict(FIT, fit_field="bogus")), device="cpu")


def test_fit_recovers_a_translation(scenes):
    """The box (object 2) moved by 0.1 along x and z is pulled back by the
    geometric loss in 40 Adam steps at 48x36, with every other bank fixed."""
    _, tscene = scenes
    config = RenderConfig(**dict(FIT, width=48, height=36, max_steps=96))
    base = tscene.arrays.to_torch("cpu")
    truth = base.position[2].clone()

    def param_to_arrays(params):
        position = torch.cat([base.position[:2], params["box"][None], base.position[3:]])
        return dataclasses.replace(base, position=position)

    h = make_fit_harness(tscene, config, param_to_arrays=param_to_arrays,
                         optimizer=lambda ps: torch.optim.Adam(ps, lr=1e-2), device="cpu")
    cam = Camera.initial().as_arrays()
    target = h.render_target(tscene.arrays, *cam)
    state = h.init({"box": truth.numpy() + np.array([0.1, 0.0, -0.1], np.float32)})
    err0 = float((state.params["box"] - truth).abs().max())
    for _ in range(40):
        state, loss = h.step_fn(state, target, *cam)
    err = float((state.params["box"].detach() - truth).abs().max())
    assert err < 0.2 * err0, (err0, err, float(loss))
