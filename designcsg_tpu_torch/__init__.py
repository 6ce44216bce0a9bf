"""designcsg_tpu_torch — the PyTorch/CUDA port of designcsg_tpu.

Same module layout as the JAX package.  Plain PyTorch versions of every
computation run on any device; on a CUDA device the SDF point evaluation and
the SDF grid evaluation (each also with the k1 gizmo), the k1 viewport
renderer (exact and over-relaxed march, optional start plane, optional exact
interval cull), the cone prepass of the hierarchical viewport and the
differentiable fit's ray march run as CUDA kernels generated per scene
(ops/cuda), for every scene whose brushes and materials have CUDA bodies.
The export's host stages run in native code (native/).  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another one.  Raises when no card is there, rather than running on the
    CPU unasked."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path"
        )
    return device
