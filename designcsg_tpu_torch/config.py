"""Render configuration.

Every field and default of the JAX package's ``RenderConfig`` is kept, so a
config written for one package reads the same in the other.  Knobs whose
machinery this package does not have yet raise ``NotImplementedError`` at
construction, naming the ROADMAP.md item that brings them; nothing silently
falls back to another march mode.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from . import constants as C


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Viewport semantics of kernel k1 (k1.cl:1-12,480-580)."""

    width: int = C.VIEWPORT_W
    height: int = C.VIEWPORT_H
    max_steps: int = C.MAX_STEPS
    max_distance: float = C.MAX_DISTANCE
    sdf_epsilon: float = C.SDF_EPSILON
    normal_epsilon: float = C.NORMAL_EPSILON
    march_tolerance: float = C.TOLERANCE_FACTOR_MARCHSTEP
    material_tolerance: float = C.TOLERANCE_FACTOR_MATERIAL
    ifov: float = C.IFOV
    gizmo: bool = True  # the k1-only axis gizmo; turn off for k2 semantics
    normal_mode: str = "fd"  # "fd" (reference parity) | "analytic"
    background: Tuple[float, float, float] = C.BACKGROUND_RGB
    miss_color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    differentiable: bool = False
    soft_silhouette_bandwidth: float = 0.0
    fit_field: str = "exact"
    march_overrelax: float = 1.0
    # Engine selection of the JAX package (its Pallas ray-march kernel).  Here
    # only False is read: the differentiable renders then march with the plain
    # version of the fit's ray-march kernel on every device, as the JAX
    # package then takes its jnp march (ops/raymarch.py fit_ray_march).
    use_pallas_march: Optional[bool] = None
    march_hierarchical: bool = False
    hierarchical_factor: int = 5
    cone_strict: bool = False
    cone_safety: float = 1.2
    # The exact per-tile cull (K7, ops/cull.py) in the fused renderer:
    # True (any true value but "dynamic") culls once per tile over its view
    # cone, "dynamic" at every march step over the tile's live rays.  As in
    # the JAX package, the differentiable renders, the fit's ray march (K4)
    # and the cone prepass (K5) have no cull and ignore it.
    march_cull: Optional[bool] = None
    march_proxy: Optional[bool] = None
    # TPU loop-unroll knob of the JAX kernel; the CUDA renderer marches each
    # ray in its own thread, so there is nothing to unroll.
    march_unroll: int = 8

    def __post_init__(self):
        unported = [
            (self.march_proxy is True, "march_proxy=True", "queue 1, item 10"),
            (self.normal_mode != "fd", f"normal_mode={self.normal_mode!r}",
             "queue 1, item 4"),
        ]
        for active, knob, item in unported:
            if active:
                raise NotImplementedError(
                    f"RenderConfig({knob}) is not ported yet (ROADMAP.md {item})"
                )
