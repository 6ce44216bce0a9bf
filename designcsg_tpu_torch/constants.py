"""Numeric constants shared across the framework.

These mirror the reference semantics so that renders/evals are allclose to the
OpenCL kernels (reference: k1.cl:1-12, DrawPane.h:14-18,
scenecompiler.py:10-11). They are defaults; every entry is overridable through
the config dataclasses in `designcsg_tpu_torch.config`.
"""

# March / SDF semantics (k1.cl:1-12)
MAX_STEPS = 512
MAX_DISTANCE = 64.0
SDF_EPSILON = 0.005
NORMAL_EPSILON = 0.005
AXES_RADIUS = 0.015
AXES_SHADE_RADIUS = 0.025  # gizmo color attribution uses a wider radius (k1.cl:338)
TOLERANCE_FACTOR_MARCHSTEP = 0.85
TOLERANCE_FACTOR_MATERIAL = 2.0
IFOV = 1.0

# Scene capacity (DrawPane.h:14-18).  These are *parity* capacities: the
# framework has no hard limits, but loaders/writers pad or validate to these.
MAX_OBJECTS = 512
MAX_BUILD_STEPS = 256
STACK_MEMORY_PER_PIXEL = 64
ARBITRARY_DATA_POINTS = 131072

# Root scale applied by the scene compiler (scenecompiler.py:10,436): world
# coordinates are INITIAL_SCALE x design coordinates.
INITIAL_SCALE = 5.0

# Viewport geometry (DrawPane.h:95, k1.cl:506-528)
VIEWPORT_W = 640
VIEWPORT_H = 480

# Camera (DrawPane.h:67-73)
IZOOM = 10.0

# Background color for shaded-but-unmatched points (k1.cl:377)
BACKGROUND_RGB = (239.0 / 255.0, 66.0 / 255.0, 245.0 / 255.0)

# Tape opcodes (scenecompiler.py:25-32 / k1.cl:14-19)
OP_IMPORT = 0
OP_EXPORT = 1
OP_MIN = 2
OP_MAX = 3
OP_NEGATE = 4
OP_IDENTITY = 5

OPCODE_NAMES = {
    OP_IMPORT: "IMPORT",
    OP_EXPORT: "EXPORT",
    OP_MIN: "MIN",
    OP_MAX: "MAX",
    OP_NEGATE: "NEGATE",
    OP_IDENTITY: "IDENTITY",
}
OPCODE_VALUES = {v: k for k, v in OPCODE_NAMES.items()}
