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
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Flags for some kernels only.  The renderer, the cone prepass and the fit's
# ray march round every product and sum on their own (no FMA contraction), as
# their plain versions do (decision P1): a sphere trace is chaotic at
# creases, where one ulp decides the step a ray stops at, and with
# contraction a 640x480 Design1 frame had a pixel 1.16e-3 off its plain
# version on an H100 (PERF.md).  The point and grid kernels keep
# contraction.  K1's FD form is the point unit's source built without
# contraction (``sdf_fd``): its normal divides differences of the field by
# 2 * 0.005, and where the gradient is small a contracted field, within 1e-6
# of the plain one, moved Design2's normals by up to 0.019 on an H100
# (PERF.md); built so, it gives its plain version's bits.
# ``NO_FMA_CONTRACTION`` tells the source (csrc/common.cuh ``madd``), whose
# sums written out would otherwise fuse.
NO_CONTRACTION = ("-fmad=false", "-DNO_FMA_CONTRACTION")
EXTRA_FLAGS = {
    "march": NO_CONTRACTION, "cone": NO_CONTRACTION, "ray_march": NO_CONTRACTION,
    "sdf_fd": NO_CONTRACTION,
}

LAUNCHES: collections.Counter = collections.Counter()
# Wall seconds of each unit's nvcc run in this process, by its build label.
BUILD_SECONDS: Dict[str, float] = {}
# Loaded libraries by (path, card): a unit's constant bank and its stream
# are per card (``stream_handle``).
_LOADED: Dict[Tuple[str, Optional[int]], ctypes.CDLL] = {}


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
    nvcc output`` (the ``-Xptxas -v`` register/spill report).  Each
    compile's wall seconds go to ``BUILD_SECONDS[label]``.  Raises with the
    compiler's output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for label, (name, source) in units.items():
        stem = _stem(name, source)
        if stem.with_suffix(".so").exists() or stem in running:
            continue
        cu = stem.with_suffix(".cu")
        cu.write_text(source)
        tmp = f"{stem}.{os.getpid()}.so.tmp"
        log = open(f"{stem}.{os.getpid()}.log.tmp", "w")
        cmd = [nvcc(), *_flags(name), "-o", tmp, str(cu)]
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, text=True)
        running[stem] = (label, proc, tmp, log, time.time())
    failures = []
    while running:
        for stem, (label, proc, tmp, log, start) in list(running.items()):
            if proc.poll() is None:
                continue
            BUILD_SECONDS[label] = time.time() - start
            log.close()
            os.replace(log.name, stem.with_suffix(".log"))
            if proc.returncode != 0:
                failures.append(f"nvcc failed for {label} ({stem}.cu):\n"
                                f"{stem.with_suffix('.log').read_text()}")
            else:
                os.replace(tmp, stem.with_suffix(".so"))
            del running[stem]
        time.sleep(0.05)
    if failures:
        raise RuntimeError("\n".join(failures))
    logs = {}
    for label, (name, source) in units.items():
        log = _stem(name, source).with_suffix(".log")
        logs[label] = log.read_text() if log.exists() else ""
    return logs


def load(name: str, source: str, device: Optional[torch.device] = None) -> ctypes.CDLL:
    """The built library of ``source`` (building it first if needed), for
    launches on ``device``.  ``bank`` on it is its object bank's placement
    (csrc/common.cuh, ops/cuda/tape.py bank_placement); ``global_bank`` says
    whether that bank is module-global state of the unit (a constant bank):
    see :func:`stream_handle`.  Each card gets a library object of its own,
    whose ``bank_stream`` is that card's."""
    from .tape import unit_bank

    so = str(_stem(name, source).with_suffix(".so"))
    key = (so, None if device is None else device.index)
    if key not in _LOADED:
        build({name: (name, source)})
        lib = ctypes.CDLL(so)
        lib.bank = unit_bank(source)
        lib.global_bank = lib.bank == "constant"
        lib.bank_stream = None
        _LOADED[key] = lib
    return _LOADED[key]


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_handle(device: torch.device, lib: ctypes.CDLL) -> ctypes.c_void_p:
    """The handle of the current stream of ``device``, for a launch of
    ``lib``'s kernel.  A library whose object bank is module-global state
    (``lib.global_bank``) fills it before each launch, so its launches must
    be ordered: all on the stream of its first launch, none captured into a
    CUDA graph.  Raises otherwise."""
    stream = torch.cuda.current_stream(device).cuda_stream
    if lib.global_bank:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("a kernel with a constant-memory object bank cannot be captured "
                               "into a CUDA graph: each launch refills the bank")
        if lib.bank_stream is None:
            lib.bank_stream = stream
        elif lib.bank_stream != stream:
            raise RuntimeError("a kernel with a constant-memory object bank launches on one "
                               "stream only (the stream of its first launch): two streams would "
                               "race on its bank")
    return ctypes.c_void_p(stream)


def check_call(what: str, rc: int) -> None:
    """Raise for a nonzero cudaError_t from a library's host function."""
    if rc != 0:
        raise RuntimeError(f"{what} failed with CUDA error {rc}")


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


def bank_pointers(scene, arrays, device: torch.device):
    """Pointers to a SceneArrays' object banks and arbitrary data, then to
    the scene's extra tables (null for a scene without; uploaded to
    ``device`` once, CompiledScene.device_extras), in the launchers'
    argument order, after checking each lies on ``device``."""
    names = ("position", "right", "up", "forward", "ad")
    for name in names:
        require_cuda_f32(f"arrays.{name}", getattr(arrays, name), device)
    extras, _ = scene.device_extras(device)
    if extras is not None:
        require_cuda_f32("scene extras", extras, device)
    return [ptr(getattr(arrays, name)) for name in names] + [
        None if extras is None else ptr(extras)
    ]


def scene_args(scene, arrays, device: torch.device, lib: ctypes.CDLL) -> Tuple[List, object]:
    """The launchers' trailing arguments (csrc/common.cuh SCENE_PARAMS): the
    bank pointers (:func:`bank_pointers`), the launch's interleaved bank
    buffer where ``lib`` reads its bank from global memory (null
    otherwise), the card's index and the stream (:func:`stream_handle`);
    then the buffer, which the caller keeps until the launch is enqueued.
    The buffer is freed to PyTorch's allocator on the launch's stream, so
    its memory is reused only after the kernel."""
    from .tape import BANK_STRIDE

    args = bank_pointers(scene, arrays, device)
    buf = None
    if lib.bank == "global":
        buf = torch.empty(scene.num_objects * BANK_STRIDE, dtype=torch.float32, device=device)
    return args + [None if buf is None else ptr(buf), device.index,
                   stream_handle(device, lib)], buf
