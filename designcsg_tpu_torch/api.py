"""User-facing design API.

Mirrors the reference's script-style facade (DesignCSG.py): a module-level
"current" compiler plus convenience CSG helpers.  Design scripts look like::

    from designcsg_tpu_torch.api import *

    new_design()
    draw(sphere_brush(), Transform.initial(position=[0,0,0], yaw=0, pitch=0,
                                           roll=0, scale=[1.25]*3))
    scene = commit()

Unlike the reference singleton, ``new_design()`` resets the current compiler,
so tests and multi-design processes work.  Every helper also takes an explicit
:class:`SceneCompiler` through the ``compiler=`` keyword.  A brush defined here
takes a torch function and, to run on the card, a CUDA body (see brushes.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from . import scene as _scene
from . import transforms
from . import brushes as _b
from .compiler import CompiledScene, SceneCompiler
from .ops import cull as _cull

Transform = transforms.Transform
PI = np.pi

_current: Optional[SceneCompiler] = None
_sphere = None
_cylinder = None
_box = None


def new_design() -> SceneCompiler:
    """Start a fresh design; registers the builtin sphere/cylinder/box brushes
    at bank indices 2/3/4 exactly as the reference facade does on import
    (DesignCSG.py:8-22)."""
    global _current, _sphere, _cylinder, _box
    _current = SceneCompiler()
    _sphere = _current.define_brush(
        _b.sphere_brush_fn, name="sphere", cuda=_b.SPHERE_CUDA, cuda_flops=7,
        interval=_cull.sphere_interval, interval_cuda=_cull.SPHERE_INTERVAL_CUDA,
    )
    _cylinder = _current.define_brush(
        _b.cylinder_brush_fn, name="cylinder", cuda=_b.CYLINDER_CUDA, cuda_flops=8,
        interval=_cull.cylinder_interval, interval_cuda=_cull.CYLINDER_INTERVAL_CUDA,
    )
    _box = _current.define_brush(
        _b.box_brush_fn, name="box", cuda=_b.BOX_CUDA, cuda_flops=8,
        interval=_cull.box_interval, interval_cuda=_cull.BOX_INTERVAL_CUDA,
    )
    return _current


def current() -> SceneCompiler:
    global _current
    if _current is None:
        new_design()
    return _current


def _c(compiler: Optional[SceneCompiler]) -> SceneCompiler:
    return compiler if compiler is not None else current()


def sphere_brush(compiler=None):
    c = _c(compiler)
    return _sphere if compiler is None else c.brushes[2]


def cylinder_brush(compiler=None):
    c = _c(compiler)
    return _cylinder if compiler is None else c.brushes[3]


def box_brush(compiler=None):
    c = _c(compiler)
    return _box if compiler is None else c.brushes[4]


def define_brush(fn, name="", cuda=None, cuda_flops=None, twin=None, twin_approx=None,
                 extras=None, interval=None, interval_cuda=None, compiler=None):
    return _c(compiler).define_brush(fn, name=name, cuda=cuda, cuda_flops=cuda_flops,
                                     twin=twin, twin_approx=twin_approx, extras=extras,
                                     interval=interval, interval_cuda=interval_cuda)


def define_material(fn, name="", cuda=None, compiler=None):
    return _c(compiler).define_material(fn, name=name, cuda=cuda)


def addArbitraryData(name, data, compiler=None):
    return _c(compiler).add_arbitrary_data(name, data)


add_arbitrary_data = addArbitraryData


def commit(compiler=None, **kwargs) -> CompiledScene:
    return _c(compiler).commit(**kwargs)


def setExportConfig(compiler=None, **kwargs):
    return _c(compiler).set_export_config(**kwargs)


set_export_config = setExportConfig


def Component(brush, transform=None, material=None, subtractive=False, compiler=None):
    c = _c(compiler)
    return _scene.Component(
        brush=brush,
        material=material if material is not None else c.default_material(),
        transform=transform if transform is not None else Transform.identity(),
        subtractive=subtractive,
    )


def draw(brush, tf, compiler=None):
    """Add an additive leaf under the root (DesignCSG.py:33-34)."""
    c = _c(compiler)
    c.root.add_child(
        _scene.Component(brush=brush, material=c.default_material(), transform=tf)
    )


def erase(brush, tf, compiler=None):
    """Add a subtractive leaf under the root (DesignCSG.py:36-37)."""
    c = _c(compiler)
    c.root.add_child(
        _scene.Component(
            brush=brush, material=c.default_material(), transform=tf, subtractive=True
        )
    )


drawBrush = draw
eraseBrush = erase


def _capsule_component(A, B, T, compiler):
    """Capsule built from a scaled cylinder with two counter-scaled sphere
    children (DesignCSG.py:45-102)."""
    c = _c(compiler)
    A = np.asarray(A, dtype=np.float64)
    B = np.asarray(B, dtype=np.float64)
    D = B - A
    d = float(np.linalg.norm(D))
    cyl = _scene.Component(
        brush=cylinder_brush(compiler),
        material=c.default_material(),
        transform=Transform.initial(
            position=np.zeros(3), yaw=0, pitch=0, roll=0, scale=np.array([T, d, T])
        ),
    )
    for y in (0.5, -0.5):
        cyl.add_child(
            _scene.Component(
                brush=sphere_brush(compiler),
                material=c.default_material(),
                transform=Transform.initial(
                    position=np.array([0.0, y, 0.0]),
                    yaw=0,
                    pitch=0,
                    roll=0,
                    scale=np.array([1.0, T / d, 1.0]),
                ),
            )
        )
    nD = D / d
    a = np.arctan2(nD[2], nD[0])
    b = np.arcsin(nD[1])
    pose = Transform.initial(
        position=(A + B) / 2.0,
        yaw=np.pi / 2 - a,
        pitch=b - np.pi / 2,
        roll=0,
        scale=np.ones(3),
    )
    return cyl, pose


def draw_capsule(A, B, T=1, compiler=None):
    c = _c(compiler)
    cyl, pose = _capsule_component(A, B, T, compiler)
    c.root.add_child(cyl.fabricate(transform=pose))


def cut_capsule(A, B, T=1, compiler=None):
    c = _c(compiler)
    cyl, pose = _capsule_component(A, B, T, compiler)
    c.root.add_child(cyl.fabricate(transform=pose, subtractive=True))


def draw_box(origin, diameter, compiler=None):
    c = _c(compiler)
    c.root.add_child(
        _scene.Component(
            brush=box_brush(compiler),
            material=c.default_material(),
            transform=Transform.initial(
                position=np.asarray(origin, dtype=np.float64),
                yaw=0,
                pitch=0,
                roll=0,
                scale=float(diameter) * np.ones(3),
            ),
        )
    )


def drawComponent(component, transform=None, compiler=None):
    c = _c(compiler)
    c.root.add_child(
        component.fabricate(
            transform=transform if transform is not None else Transform.identity()
        )
    )


def eraseComponent(component, transform=None, compiler=None):
    c = _c(compiler)
    c.root.add_child(
        component.fabricate(
            transform=transform if transform is not None else Transform.identity(),
            subtractive=True,
        )
    )


def _group(components, transform, subtractive, intersection, compiler):
    c = _c(compiler)
    cls = _scene.IntersectionComponent if intersection else _scene.Component
    root = cls(
        brush=c.void_brush() if intersection else c.null_brush(),
        material=c.default_material(),
        transform=transform if transform is not None else Transform.identity(),
        subtractive=subtractive,
    )
    for component in components:
        root.add_child(component)
    c.root.add_child(root)
    return root


def drawUnion(*components, transform=None, compiler=None):
    """Union via a null-brush parent (DesignCSG.py:184-188)."""
    return _group(components, transform, False, False, compiler)


def eraseUnion(*components, transform=None, compiler=None):
    return _group(components, transform, True, False, compiler)


def drawIntersection(*components, transform=None, compiler=None):
    """Intersection via an IntersectionComponent (DesignCSG.py:194-198)."""
    return _group(components, transform, False, True, compiler)


def eraseIntersection(*components, transform=None, compiler=None):
    return _group(components, transform, True, True, compiler)
