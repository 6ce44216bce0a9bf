"""Fused k1 viewport renderer: CUDA kernel and its plain version.

Counterpart of the JAX package's ops/pallas/march_kernel.py
``make_pallas_renderer`` (exact march; no ``t0`` input, no cull).  Kernel
source: csrc/march_kernel.cu + csrc/march.cuh plus the scene code generated
by ops/cuda/tape.py.  The plain version is ops/raymarch.py's
:func:`make_renderer`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from ...compiler import CompiledScene, SceneArrays
from ...config import RenderConfig
from ..raymarch import camera_rows, make_renderer
from .build import bank_pointers, check_launch, load, on_cuda, ptr, stream_handle
from .tape import march_kernel_source

_P = ctypes.c_void_p


def make_cuda_renderer(
    scene: CompiledScene, config: Optional[RenderConfig] = None, fmad: bool = False
):
    """``render(arrays, campos, rgt, upp, fwd) -> f32[H, W, 3]`` on the device
    of ``arrays``: the fused kernel on a CUDA device, the plain renderer on
    the CPU.  ``render.plain`` is the plain version.  ``fmad=True`` takes a
    build of the kernel with nvcc's default FMA contraction (library
    ``march_fma``) instead of the ``-fmad=false`` one; chip_smoke.py times
    both."""
    config = config or RenderConfig()
    plain = make_renderer(scene, config)
    libs = {}

    def render(arrays: SceneArrays, campos, rgt, upp, fwd) -> torch.Tensor:
        if not on_cuda(arrays.ad):
            return plain(arrays, campos, rgt, upp, fwd)
        device = arrays.ad.device
        if "lib" not in libs:
            lib = load("march_fma" if fmad else "march", march_kernel_source(scene, config))
            lib.launch_render.argtypes = [_P, ctypes.c_int, ctypes.c_int] + [_P] * 7
            lib.launch_render.restype = ctypes.c_int
            libs["lib"] = lib
        cam = np.ascontiguousarray(camera_rows(campos, rgt, upp, fwd), np.float32)
        out = torch.empty((config.height, config.width, 3), dtype=torch.float32, device=device)
        rc = libs["lib"].launch_render(
            ptr(out), config.height, config.width, _P(cam.ctypes.data),
            *bank_pointers(arrays, device), stream_handle(device),
        )
        check_launch("renderer", rc)
        return out

    render.plain = plain
    return render
