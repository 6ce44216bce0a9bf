"""Scene compiler: CSG tree -> flat tape + object banks (the IR).

The reference hands its IR between processes as four files — scene.cl,
scene.txt, buildprocedure.txt, arbitrary_data.hex (scenecompiler.py:466-582).
Here the IR is an in-memory :class:`CompiledScene`: the numeric banks
(:class:`SceneArrays`, host numpy; ``to_torch`` moves them to a device) plus the
brush and material banks, each entry a torch function and a CUDA body.
``write_artifacts`` still emits the reference's text formats.

The tape and banks are data, the brush bank is code: the plain SDF unrolls the
tape in Python (ops/interpreter.py), and the CUDA kernels are generated from the
tape and the brush bodies (ops/cuda/tape.py) — the same move as the reference's
runtime OpenCL source concatenation (DesignCSG.cpp:545-546).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import brushes as _brushes
from . import scene as _scene
from .ops import cull as _cull
from . import transforms as tf
from .constants import (
    ARBITRARY_DATA_POINTS,
    INITIAL_SCALE,
    MAX_BUILD_STEPS,
    MAX_OBJECTS,
    STACK_MEMORY_PER_PIXEL,
)


@dataclasses.dataclass
class ExportConfig:
    """Per-design export quality knobs (reference exportConfig.txt, 9 lines:
    DesignCSG.py:205-237 / DesignCSG.cpp:815-835).

    ``bounding_box_half_diameter`` is in *world* units (the reference writes
    ``5.0*boundingBoxHalfDiameter``, DesignCSG.py:225).  The octree knobs drive
    the adaptive strategy; ``cache_subdivision`` / ``queries_before_gc`` /
    ``queries_before_free`` only round-trip through exportConfig.txt.
    """

    bounding_box_half_diameter: float = 10.0  # world units (already x5)
    minimum_octree_level: int = 5
    maximum_octree_level: int = 7
    grid_level: int = 8
    complex_surface_threshold: float = np.pi / 4.0
    gradient_descent_steps: int = 50
    cache_subdivision: int = 16
    queries_before_gc: int = 64
    queries_before_free: int = 1024

    def to_lines(self) -> str:
        return "".join(str(v) + "\n" for v in dataclasses.astuple(self))


#: Field order of SceneArrays (the JAX package's pytree leaf order).
SCENE_ARRAY_FIELDS = (
    "shape_id", "material_id", "position", "right", "up", "forward", "tape", "ad",
)
_FIELD_DTYPES = dict(
    shape_id=np.int32, material_id=np.int32, position=np.float32,
    right=np.float32, up=np.float32, forward=np.float32, tape=np.int32,
    ad=np.float32,
)


@dataclasses.dataclass
class SceneArrays:
    """The numeric banks of a compiled scene — this system's "weights".

    Row layout matches scene.txt: per object, position plus *reciprocal*
    propagated frame axes; SDF local coords are
    ``((v-p)@r, (v-p)@u, (v-p)@f)``.  The compiler fills the fields with numpy
    arrays; :meth:`to_torch` gives the same banks as tensors on a device.
    """

    shape_id: np.ndarray  # i32[N]
    material_id: np.ndarray  # i32[N]
    position: np.ndarray  # f32[N, 3]
    right: np.ndarray  # f32[N, 3] (reciprocal axes)
    up: np.ndarray  # f32[N, 3]
    forward: np.ndarray  # f32[N, 3]
    tape: np.ndarray  # i32[T, 4] (opcode, left, right, dest)
    ad: np.ndarray  # f32[ARBITRARY_DATA_POINTS]

    def fields(self):
        return tuple(getattr(self, f) for f in SCENE_ARRAY_FIELDS)

    def to_torch(self, device) -> "SceneArrays":
        """The same banks as torch tensors on ``device``."""
        return SceneArrays(*(torch.as_tensor(a, device=device) for a in self.fields()))

    def detach(self) -> "SceneArrays":
        """The same banks cut from the autograd graph (the JAX package's
        ``tree_map(stop_gradient, arrays)``)."""
        return SceneArrays(
            *(a.detach() if isinstance(a, torch.Tensor) else a for a in self.fields())
        )

    def content_digest(self) -> bytes:
        """Digest of every bank, each framed by dtype and shape."""
        h = hashlib.sha256()
        for leaf in self.fields():
            if isinstance(leaf, torch.Tensor):
                leaf = leaf.cpu().numpy()
            arr = np.ascontiguousarray(np.asarray(leaf))
            h.update(arr.dtype.str.encode())
            h.update(np.asarray(arr.shape, np.int64).tobytes())
            h.update(arr.tobytes())
        return h.digest()


def scene_arrays_from_numpy(d: dict) -> SceneArrays:
    """Build a :class:`SceneArrays` from numpy arrays keyed by field name —
    e.g. the fields of the JAX package's ``SceneArrays`` — with each field's
    dtype enforced and the bytes copied unchanged."""
    missing = [f for f in SCENE_ARRAY_FIELDS if f not in d]
    if missing:
        raise KeyError(f"missing SceneArrays fields {missing}")
    return SceneArrays(
        **{
            f: np.array(np.asarray(d[f]), dtype=_FIELD_DTYPES[f], copy=True)
            for f in SCENE_ARRAY_FIELDS
        }
    )


@dataclasses.dataclass
class CompiledScene:
    """Arrays + static function banks; the unit every evaluator consumes."""

    arrays: SceneArrays
    brush_fns: Tuple[Callable, ...]
    material_fns: Tuple[Callable, ...]
    num_registers: int
    export_config: Optional[ExportConfig] = None
    ad_chunks: Tuple[Tuple[str, int, int], ...] = ()  # (name, start, length)
    #: CUDA bodies per bank index (None where a brush has none: such a scene
    #: runs on the CPU only, and the code generator raises for it).
    brush_cuda: Tuple[Optional[str], ...] = ()
    material_cuda: Tuple[Optional[str], ...] = ()
    brush_names: Tuple[str, ...] = ()
    brush_flops: Tuple[Optional[int], ...] = ()
    #: The field each brush's CUDA body computes (``Brush.twin``; the brush's
    #: own function where its body is exact), per bank index.
    brush_twin: Tuple[Callable, ...] = ()
    #: The largest ``twin_approx`` of the scene's brushes: 0.0 when every
    #: twin is exact, else the near-surface tolerance of the kernels' field.
    twin_tolerance: float = 0.0
    #: ``(name, f32 table)`` of every brush's extras, in bank order, names
    #: unique: scene constants that the kernels read through one pointer.
    extras: Tuple[Tuple[str, np.ndarray], ...] = ()
    #: ``(name, f32 table)`` of every brush's derived extras (tables computed
    #: from its extras in the form its CUDA body reads), after the extras
    #: in the kernels' concatenation.
    derived_extras: Tuple[Tuple[str, np.ndarray], ...] = ()
    #: Interval twins per bank index (``Brush.interval``, ``interval_cuda``):
    #: None where a brush has none, and the cull never skips it.
    brush_interval: Tuple[Optional[Callable], ...] = ()
    brush_interval_cuda: Tuple[Optional[str], ...] = ()
    _device_extras: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @property
    def num_objects(self) -> int:
        return int(self.arrays.shape_id.shape[0])

    def ad_offset(self, name: str) -> int:
        """Start offset of a named arbitrary-data chunk (the reference's
        ``#define AD_<name> <start>``, scenecompiler.py:469-473)."""
        for cname, start, _ in self.ad_chunks:
            if cname == name:
                return start
        raise KeyError(f"no arbitrary-data chunk named {name!r}")

    def extras_offsets(self) -> Dict[str, int]:
        """Float offset of each extra table (derived ones after the others)
        in their concatenation; each starts on a 16-byte boundary, so the
        kernels may read a table in float4s."""
        offsets, at = {}, 0
        for name, table in self.extras + self.derived_extras:
            offsets[name] = at
            at += -(-table.size // 4) * 4
        return offsets

    def device_extras(self, device) -> Tuple[Optional[torch.Tensor], Dict[str, torch.Tensor]]:
        """The extras and derived extras on ``device``, uploaded once per
        device: the f32 concatenation the kernels read (None for a scene
        without extras) and ``{name: table}``, views into it, for the plain
        versions."""
        device = torch.device(device)
        key = str(device)
        every = self.extras + self.derived_extras
        if key not in self._device_extras:
            if not every:
                self._device_extras[key] = (None, {})
            else:
                offsets = self.extras_offsets()
                name, last = every[-1]
                host = np.zeros(offsets[name] + last.size, np.float32)
                for name, t in every:
                    host[offsets[name] : offsets[name] + t.size] = np.asarray(t, np.float32).reshape(-1)
                flat = torch.from_numpy(host).to(device)
                tables = {
                    name: flat[offsets[name] : offsets[name] + t.size].view(t.shape)
                    for name, t in every
                }
                self._device_extras[key] = (flat, tables)
        return self._device_extras[key]


@dataclasses.dataclass
class ArbitraryDataChunk:
    name: str
    start: int
    data: Sequence[float]


class SceneCompiler:
    """Builds the CSG tree and compiles it (scenecompiler.py:408-594)."""

    def __init__(self):
        self.ad_counter = 0
        self.ad: List[ArbitraryDataChunk] = []
        self.brushes: List[_brushes.Brush] = []
        self.materials: List[_brushes.Material] = []
        self.empty_brush = self.define_brush(
            _brushes.empty_brush_fn, name="empty", cuda=_brushes.EMPTY_CUDA, cuda_flops=0,
            interval=_cull.empty_interval, interval_cuda=_cull.EMPTY_INTERVAL_CUDA,
        )
        self.space_brush = self.define_brush(
            _brushes.space_brush_fn, name="space", cuda=_brushes.SPACE_CUDA, cuda_flops=0,
            interval=_cull.space_interval, interval_cuda=_cull.SPACE_INTERVAL_CUDA,
        )
        self.abs_normals = self.define_material(
            _brushes.abs_normals_fn, name="abs_normals",
            cuda=_brushes.ABS_NORMALS_CUDA,
        )
        self.basic_lighting = self.define_material(
            _brushes.basic_lighting_fn, name="basic_lighting",
            cuda=_brushes.BASIC_LIGHTING_CUDA,
        )
        self.root = _scene.Component(
            brush=self.null_brush(),
            material=self.default_material(),
            transform=tf.scaling(np.array([INITIAL_SCALE] * 3)),
        )
        self.export_config: Optional[ExportConfig] = None

    # -- registries --------------------------------------------------------

    def define_brush(
        self,
        fn: Callable,
        name: str = "",
        cuda: Optional[str] = None,
        cuda_flops: Optional[int] = None,
        twin: Optional[Callable] = None,
        twin_approx: Optional[float] = None,
        extras: Optional[dict] = None,
        interval: Optional[Callable] = None,
        interval_cuda: Optional[str] = None,
        derived_extras: Optional[dict] = None,
    ) -> _brushes.Brush:
        brush = _brushes.Brush(
            fn=fn, bank_index=len(self.brushes), name=name, cuda=cuda, cuda_flops=cuda_flops,
            twin=twin, twin_approx=twin_approx, extras=dict(extras or {}),
            derived_extras=dict(derived_extras or {}),
            interval=interval, interval_cuda=interval_cuda,
        )
        self.brushes.append(brush)
        return brush

    def define_material(
        self, fn: Callable, name: str = "", cuda: Optional[str] = None
    ) -> _brushes.Material:
        material = _brushes.Material(
            fn=fn, bank_index=len(self.materials), name=name, cuda=cuda
        )
        self.materials.append(material)
        return material

    def null_brush(self) -> _brushes.Brush:
        return self.empty_brush

    def void_brush(self) -> _brushes.Brush:
        return self.space_brush

    def default_material(self) -> _brushes.Material:
        return self.basic_lighting

    def add_arbitrary_data(self, name: str, data: Sequence[float]) -> int:
        """Register a float chunk addressable from brushes as
        ``ad[start + offset]``; returns the start offset."""
        start = self.ad_counter
        self.ad_counter += len(data)
        if self.ad_counter > ARBITRARY_DATA_POINTS:
            raise ValueError(
                f"arbitrary data overflow: {self.ad_counter} > {ARBITRARY_DATA_POINTS}"
            )
        self.ad.append(ArbitraryDataChunk(name, start, data))
        return start

    addArbitraryData = add_arbitrary_data

    def set_export_config(self, **kwargs) -> ExportConfig:
        """Reference ``setExportConfig`` semantics (DesignCSG.py:205-237): the
        half-diameter argument is in design units and is scaled by
        INITIAL_SCALE into world units."""
        if "boundingBoxHalfDiameter" in kwargs:
            kwargs["bounding_box_half_diameter"] = INITIAL_SCALE * kwargs.pop(
                "boundingBoxHalfDiameter"
            )
        alias = {
            "minimumOctreeLevel": "minimum_octree_level",
            "maximumOctreeLevel": "maximum_octree_level",
            "gridLevel": "grid_level",
            "complexSurfaceThreshold": "complex_surface_threshold",
            "gradientDescentSteps": "gradient_descent_steps",
            "cacheSubdivision": "cache_subdivision",
            "queriesBeforeGC": "queries_before_gc",
            "queriesBeforeFree": "queries_before_free",
        }
        for old, new in alias.items():
            if old in kwargs:
                kwargs[new] = kwargs.pop(old)
        kwargs.pop("meshSubdivisionLevel", None)
        kwargs.pop("maxPoolSize", None)
        self.export_config = ExportConfig(**kwargs)
        return self.export_config

    # -- compilation -------------------------------------------------------

    def commit(self, strict_capacity: bool = False) -> CompiledScene:
        """Flatten the tree, allocate registers, emit the tape, and bundle the
        banks (scenecompiler.py:466-582, minus file IO)."""
        unrolled = self.root.get_unrolled_components()
        for index, component in enumerate(unrolled):
            component.unrolled_index = index
            component.propogate_transforms()

        n = len(unrolled)
        shape_id = np.zeros((n,), dtype=np.int32)
        material_id = np.zeros((n,), dtype=np.int32)
        frames = np.zeros((4, n, 3), dtype=np.float64)  # position, right, up, fwd
        for i, component in enumerate(unrolled):
            shape_id[i] = component.brush.bank_index
            material_id[i] = component.material.bank_index
            frames[0, i] = component.position()
            frames[1, i] = tf.reciprocal_vector(component.right())
            frames[2, i] = tf.reciprocal_vector(component.up())
            frames[3, i] = tf.reciprocal_vector(component.forward())

        allocator = _scene.Allocator()
        for component in unrolled:
            if component.children:
                component.variable = allocator.allocate()
        if self.root.variable is None:
            raise ValueError("empty scene: the root has no children")
        export_variable = self.root.variable
        allocator.allocate_scratch()

        commands = self.root.get_commands(allocator)
        commands.append(
            _scene.Command("EXPORT", export_variable, _scene.NULL_ARG, _scene.NULL_ARG)
        )
        tape = np.asarray([c.as_tuple() for c in commands], dtype=np.int32)

        ad = np.zeros((ARBITRARY_DATA_POINTS,), dtype=np.float32)
        for chunk in self.ad:
            data = np.asarray(chunk.data, dtype=np.float32)
            ad[chunk.start : chunk.start + len(data)] = data

        if strict_capacity:
            if n > MAX_OBJECTS:
                raise ValueError(f"{n} objects > MAX_OBJECTS={MAX_OBJECTS}")
            if len(commands) > MAX_BUILD_STEPS:
                raise ValueError(
                    f"{len(commands)} commands > MAX_BUILD_STEPS={MAX_BUILD_STEPS}"
                )
            if allocator.num_registers > STACK_MEMORY_PER_PIXEL:
                raise ValueError(
                    f"{allocator.num_registers} registers > "
                    f"STACK_MEMORY_PER_PIXEL={STACK_MEMORY_PER_PIXEL}"
                )

        extras, derived = {}, {}
        for brush in self.brushes:
            for tables, own in ((extras, brush.extras), (derived, brush.derived_extras)):
                for name, table in own.items():
                    if not name.isidentifier():
                        raise ValueError(f"extras name {name!r} must be a C identifier")
                    if (name in extras or name in derived) and tables.get(name) is not table:
                        raise ValueError(
                            f"duplicate extras name {name!r}: names must be unique per scene"
                        )
                    tables[name] = table
        approx = [b.twin_approx for b in self.brushes if b.twin_approx is not None]

        position, right, up, forward = frames.astype(np.float32)
        arrays = SceneArrays(
            shape_id=shape_id,
            material_id=material_id,
            position=position,
            right=right,
            up=up,
            forward=forward,
            tape=tape,
            ad=ad,
        )
        return CompiledScene(
            arrays=arrays,
            brush_fns=tuple(b.fn for b in self.brushes),
            material_fns=tuple(m.fn for m in self.materials),
            num_registers=allocator.num_registers,
            export_config=self.export_config,
            ad_chunks=tuple((c.name, c.start, len(c.data)) for c in self.ad),
            brush_cuda=tuple(b.cuda for b in self.brushes),
            material_cuda=tuple(m.cuda for m in self.materials),
            brush_names=tuple(b.name for b in self.brushes),
            brush_flops=tuple(b.cuda_flops for b in self.brushes),
            brush_twin=tuple(b.twin for b in self.brushes),
            twin_tolerance=float(max(approx, default=0.0)),
            extras=tuple((name, np.asarray(t, np.float32)) for name, t in extras.items()),
            derived_extras=tuple((name, np.asarray(t, np.float32)) for name, t in derived.items()),
            brush_interval=tuple(b.interval for b in self.brushes),
            brush_interval_cuda=tuple(b.interval_cuda for b in self.brushes),
        )

    # -- reference-format artifact emission --------------------------------

    def write_artifacts(self, directory: str = ".") -> CompiledScene:
        """Emit scene.txt / buildprocedure.txt / arbitrary_data.hex /
        exportConfig.txt in the reference's exact formats
        (scenecompiler.py:533-580, DesignCSG.py:221-237)."""
        compiled = self.commit()
        unrolled = self.root.get_unrolled_components()

        scene_txt = ""
        for component in unrolled:
            scene_txt += (
                "{:d} {:d} " + "{:.6f} " * 3 + "{:.6f} " * 8 + "{:.6f}\n"
            ).format(
                component.brush.bank_index,
                component.material.bank_index,
                *list(component.position()),
                *list(tf.reciprocal_vector(component.right())),
                *list(tf.reciprocal_vector(component.up())),
                *list(tf.reciprocal_vector(component.forward())),
            )
        with open(os.path.join(directory, "scene.txt"), "w") as fl:
            fl.write(scene_txt)

        lines = ["{} {} {} {}".format(*[int(x) for x in row]) for row in compiled.arrays.tape]
        with open(os.path.join(directory, "buildprocedure.txt"), "w") as fl:
            fl.write("\n".join(lines))

        with open(os.path.join(directory, "arbitrary_data.hex"), "wb") as fl:
            fl.write(np.asarray(compiled.arrays.ad, dtype="<f4").tobytes())

        if self.export_config is not None:
            with open(os.path.join(directory, "exportConfig.txt"), "w") as fl:
                fl.write(self.export_config.to_lines())
        return compiled
