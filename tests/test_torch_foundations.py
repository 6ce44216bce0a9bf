"""Foundations of the PyTorch port against the JAX package: constants, config,
transform algebra and camera arrays must be equal."""

import dataclasses

import numpy as np
import pytest
import torch

from designcsg_tpu import camera as jcamera
from designcsg_tpu import config as jconfig
from designcsg_tpu import constants as jconstants
from designcsg_tpu import transforms as jtf
from designcsg_tpu_torch import camera as tcamera
from designcsg_tpu_torch import config as tconfig
from designcsg_tpu_torch import constants as tconstants
from designcsg_tpu_torch import transforms as ttf


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per test process: the suite runs one process per
    worker, and a default-sized thread pool in each oversubscribes the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_constants_equal():
    names = [n for n in dir(jconstants) if n.isupper()]
    assert names
    for name in names:
        assert getattr(tconstants, name) == getattr(jconstants, name), name


def test_render_config_fields_and_defaults_equal():
    jf = [(f.name, f.default) for f in dataclasses.fields(jconfig.RenderConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tconfig.RenderConfig)]
    assert tf == jf


@pytest.mark.parametrize(
    "knob",
    [
        dict(normal_mode="analytic"),
        dict(march_proxy=True),
    ],
)
def test_unported_knobs_raise_naming_roadmap(knob):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tconfig.RenderConfig(**knob)


@pytest.mark.parametrize("knob", [dict(march_cull="dynamic"), dict(march_cull=True)])
def test_cull_knobs_build(knob):
    """The exact per-tile cull (K7) is ported: both modes build, and the
    renderer kernel's source takes the mode (1 hoisted, 2 dynamic)."""
    from designcsg_tpu_torch.ops.cuda.tape import cull_mode

    config = tconfig.RenderConfig(**knob)
    assert config.march_cull == knob["march_cull"]
    assert cull_mode(config) == (2 if knob["march_cull"] == "dynamic" else 1)


@pytest.mark.parametrize(
    "knob",
    [
        dict(differentiable=True),
        dict(soft_silhouette_bandwidth=0.02),
        dict(differentiable=True, soft_silhouette_bandwidth=0.02, gizmo=False, fit_field="twin"),
    ],
)
def test_differentiable_knobs_build(knob):
    config = tconfig.RenderConfig(**knob)
    assert all(getattr(config, k) == v for k, v in knob.items())


def test_unknown_fit_field_raises():
    from designcsg_tpu_torch.designs import get_design
    from designcsg_tpu_torch.ops.raymarch import make_geometry_renderer

    config = tconfig.RenderConfig(differentiable=True, fit_field="bogus")
    with pytest.raises(ValueError, match="fit_field"):
        make_geometry_renderer(get_design("design1"), config)


def test_fast_viewport_knobs_build():
    config = tconfig.RenderConfig(march_overrelax=1.6, march_hierarchical=True,
                                  hierarchical_factor=5, cone_strict=True, cone_safety=1.5)
    assert config.march_overrelax == 1.6 and config.march_hierarchical


@pytest.mark.parametrize("seed", range(4))
def test_transforms_equal(seed):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=3)
    yaw, pitch, roll = rng.uniform(-np.pi, np.pi, 3)
    scale = rng.uniform(0.2, 3.0, 3)
    for name, args in [
        ("initial", (pos, yaw, pitch, roll, scale)),
        ("rotation", (yaw, pitch, roll)),
        ("translation", (pos,)),
        ("scaling", (scale,)),
        ("scaling", (float(scale[0]),)),
        ("eulerX", (pitch,)),
        ("eulerY", (yaw,)),
        ("eulerZ", (roll,)),
        ("reciprocal_vector", (pos,)),
        ("normalized", (pos,)),
        ("axes", (pos, scale, pos * 2)),
        ("homogenize", (pos,)),
        ("to_homogenous", (pos,)),
    ]:
        ours = getattr(ttf.Transform, name)(*args)
        ref = getattr(jtf.Transform, name)(*args)
        np.testing.assert_array_equal(ours, ref, err_msg=name)
    np.testing.assert_array_equal(ttf.identity(), jtf.identity())


@pytest.mark.parametrize("orbit", [None, (0.3, -0.2), (-1.1, 0.7)])
def test_camera_arrays_equal(orbit):
    t, j = tcamera.Camera.initial(), jcamera.Camera.initial()
    if orbit is not None:
        t.orbit(*orbit).zoom(1.5)
        j.orbit(*orbit).zoom(1.5)
    for ours, ref in zip(t.as_arrays(), j.as_arrays()):
        assert ours.dtype == np.float32
        np.testing.assert_array_equal(ours, ref)
