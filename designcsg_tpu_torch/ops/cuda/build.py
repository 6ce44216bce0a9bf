"""Build generated kernel sources with nvcc and load them with ctypes.

Each translation unit is written to ``build/torch_kernels/<name>_<sha>.cu``
(keyed by the sha256 of its text and flags) and compiled by nvcc for ``sm_90a`` into a
shared library with a plain C interface.  A library already on disk for the
same text is reused.  Several sources build in parallel, one nvcc each.
Nothing is built at import: the first launch on the card builds what it needs.

``LAUNCHES`` counts kernel launches by kernel name; each wrapper adds one
where it launches its kernel, and nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Tuple

import torch

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Flags for some kernels only.  The renderer, the cone prepass and the fit's
# ray march round every product and sum on their own (no FMA contraction), as
# their plain versions do: a sphere trace is chaotic at creases, where one ulp decides the step a
# ray stops at, and with contraction a 640x480 Design1 frame had a pixel
# 1.16e-3 off its plain version on an H100 (PERF.md).  The point and grid
# kernels keep contraction, and so does ``march_fma``, the same renderer
# source built with contraction so that chip_smoke.py can time both.
EXTRA_FLAGS = {
    "march": ("-fmad=false",), "cone": ("-fmad=false",), "ray_march": ("-fmad=false",),
}

LAUNCHES: collections.Counter = collections.Counter()
_LOADED: Dict[str, ctypes.CDLL] = {}


def csrc(name: str) -> str:
    return (CSRC_DIR / name).read_text()


def nvcc() -> str:
    for path in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")


def _flags(name: str):
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def _stem(name: str, source: str) -> Path:
    key = "\n".join((*_flags(name), source))
    return BUILD_DIR / f"{name}_{hashlib.sha256(key.encode()).hexdigest()[:16]}"


def build(units: Dict[str, Tuple[str, str]]) -> Dict[str, str]:
    """Compile each ``label -> (name, source)`` not yet on disk, all at once
    (``name`` picks the library's flags, ``EXTRA_FLAGS``); returns ``label ->
    nvcc output`` (the ``-Xptxas -v`` register/spill report).  Raises with
    the compiler's output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for label, (name, source) in units.items():
        stem = _stem(name, source)
        if stem.with_suffix(".so").exists() or stem in running:
            continue
        cu = stem.with_suffix(".cu")
        cu.write_text(source)
        tmp = f"{stem}.{os.getpid()}.so.tmp"
        cmd = [nvcc(), *_flags(name), "-o", tmp, str(cu)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[stem] = (label, proc, tmp)
    failures = []
    for stem, (label, proc, tmp) in running.items():
        out, _ = proc.communicate()
        stem.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {label} ({stem}.cu):\n{out}")
        else:
            os.replace(tmp, stem.with_suffix(".so"))
    if failures:
        raise RuntimeError("\n".join(failures))
    logs = {}
    for label, (name, source) in units.items():
        log = _stem(name, source).with_suffix(".log")
        logs[label] = log.read_text() if log.exists() else ""
    return logs


def load(name: str, source: str) -> ctypes.CDLL:
    """The built library of ``source`` (building it first if needed)."""
    so = str(_stem(name, source).with_suffix(".so"))
    if so not in _LOADED:
        build({name: (name, source)})
        _LOADED[so] = ctypes.CDLL(so)
    return _LOADED[so]


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_launch(kernel: str, rc: int) -> None:
    """Raise for a nonzero cudaError_t from a launcher, else count the launch."""
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed with CUDA error {rc}")
    LAUNCHES[kernel] += 1


def require_cuda_f32(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous float32 tensor on {device}, got "
            f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
        )


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (take the plain version); raises for any other device."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def bank_pointers(arrays, device: torch.device):
    """Pointers to a SceneArrays' object banks and arbitrary data, in the
    launchers' argument order, after checking each lies on ``device``."""
    names = ("position", "right", "up", "forward", "ad")
    for name in names:
        require_cuda_f32(f"arrays.{name}", getattr(arrays, name), device)
    return [ptr(getattr(arrays, name)) for name in names]
