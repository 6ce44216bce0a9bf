"""Logging, timing and profiling (observability.py of the JAX package).

The reference's observability is a mutexed GUI console, redirected stdout
and a 100 ms monitor thread rendering export state, elapsed time and memory
(DesignCSG.cpp:300-310,575-601,839-1025).  Library equivalents: the
package's logger, the span recorder (:class:`span`, :class:`StageTimer`,
:func:`to_device`, :func:`to_host`), a ``torch.profiler`` trace context
writing a Chrome trace, and :class:`ExportMonitor`, a progress renderer for
terminals.

Spans time the program's layers on ``time.perf_counter_ns``, the clock the
benchmark's harness puts on the profiler's (benchmark/program.py).  Every
span is timed, and it is kept in :func:`spans` only while a torch profiler
runs: the viewer's ``viewer.frame`` (``viewer.render``, ``copy.d2h``), the
export's ``export.mesh`` (its stages, the adaptive extract's
``extract.level`` and ``extract.mesh_ops``), the evaluator's
``evaluator.<entry>`` calls and every ``copy.h2d``/``copy.d2h`` with the
bytes it moved.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.autograd import profiler as _profiler

logger = logging.getLogger("designcsg_tpu_torch")

#: The file :func:`profile_trace` writes in its directory.
TRACE_FILE = "trace.json"
#: Seconds the profiling window stays open before and after the block, on
#: an idle card: the profiler keeps only device records whose timestamps
#: fall inside the window on the host's clock, and the card's clock can
#: lie a few milliseconds off it, so a launch at either edge would be lost.
TRACE_MARGIN_S = 0.05


def configure_logging(level=logging.INFO, path: Optional[str] = None):
    """Console and optional file logging (the reference's debug console and
    consolelog.txt channels)."""
    logger.setLevel(level)
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(fmt)
    logger.addHandler(handler)
    if path:
        fh = logging.FileHandler(path)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


#: ``(name, start_ns, end_ns, parent, value)``: ``parent`` is the index of
#: the enclosing recorded span on the same thread (-1 for a root), ``value``
#: a count (a copy's bytes) or None; ``end_ns`` is None while it is open.
Span = Tuple[str, int, Optional[int], int, Optional[int]]

_SPANS: List[Span] = []
_LOCK = threading.Lock()
_OPEN = threading.local()
_generation = 0  # bumped by clear_spans, so spans open across it drop out


def _open_stack() -> list:
    """This thread's open recorded spans, ``(generation, index)``."""
    try:
        return _OPEN.stack
    except AttributeError:
        _OPEN.stack = []
        return _OPEN.stack


def spans() -> List[Span]:
    """The spans recorded while a torch profiler ran, in the order they
    opened (a parent before its children)."""
    return _SPANS


def clear_spans():
    global _generation
    with _LOCK:
        _SPANS.clear()
        _generation += 1


class span:
    """``with span(name, value=None) as s:`` times the block on
    ``time.perf_counter_ns`` (``s.seconds``) and, when a torch profiler is
    running as it opens, records it in :func:`spans`.  ``value`` (settable
    inside the block) is a count, such as a copy's bytes."""

    __slots__ = ("name", "value", "start_ns", "end_ns", "_index", "_generation")

    def __init__(self, name: str, value: Optional[int] = None):
        self.name, self.value = name, value

    def __enter__(self) -> "span":
        self._index = -1
        if _profiler._is_profiler_enabled:
            stack = _open_stack()
            with _LOCK:
                while stack and stack[-1][0] != _generation:
                    stack.pop()
                parent = stack[-1][1] if stack else -1
                self._index, self._generation = len(_SPANS), _generation
                _SPANS.append((self.name, 0, None, parent, None))
            stack.append((self._generation, self._index))
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self._index >= 0:
            stack = _open_stack()
            if stack and stack[-1] == (self._generation, self._index):
                stack.pop()
            with _LOCK:
                if self._generation == _generation:
                    parent = _SPANS[self._index][3]
                    _SPANS[self._index] = (self.name, self.start_ns, self.end_ns, parent,
                                           self.value)
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


def _nbytes(x) -> int:
    return x.nelement() * x.element_size() if isinstance(x, torch.Tensor) else np.asarray(x).nbytes


def _device_of(x) -> torch.device:
    return x.device if isinstance(x, torch.Tensor) else torch.device("cpu")


def to_device(array, device) -> torch.Tensor:
    """``torch.as_tensor(array, device=device)`` inside a ``copy.h2d`` span
    whose value is the bytes that cross to another device (0 when the
    array is already there, as on the CPU)."""
    device = torch.device(device)
    moved = _nbytes(array) if _device_of(array).type != device.type else 0
    with span("copy.h2d", moved):
        return torch.as_tensor(array, device=device)


def to_host(tensor: torch.Tensor) -> np.ndarray:
    """``tensor.cpu().numpy()`` inside a ``copy.d2h`` span whose value is
    the bytes that leave the device (0 for a tensor on the CPU)."""
    moved = _nbytes(tensor) if tensor.device.type != "cpu" else 0
    with span("copy.d2h", moved):
        return tensor.cpu().numpy()


class _Stage(span):
    __slots__ = ("_stages",)

    def __init__(self, name: str, stages: Dict[str, float]):
        super().__init__(name)
        self._stages = stages

    def __exit__(self, *exc):
        super().__exit__(*exc)
        key = self.name.rpartition(".")[2]
        self._stages[key] = self._stages.get(key, 0.0) + self.seconds
        return False


@dataclass
class StageTimer:
    """Accumulates seconds per named stage; renders a report table.  Each
    stage is a :class:`span` of its name, and its seconds add to
    ``stages`` under the name's last dotted part (``export.extract`` adds
    to ``stages["extract"]``)."""

    stages: Dict[str, float] = field(default_factory=dict)

    def stage(self, name: str) -> span:
        return _Stage(name, self.stages)

    def report(self) -> str:
        total = sum(self.stages.values())
        lines = [f"{'stage':<24s}{'seconds':>10s}{'share':>8s}"]
        for name, secs in self.stages.items():
            share = 100.0 * secs / total if total else 0.0
            lines.append(f"{name:<24s}{secs:>10.2f}{share:>7.1f}%")
        lines.append(f"{'total':<24s}{total:>10.2f}")
        return "\n".join(lines)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (the CPU, and the card's
    kernels when one is present) and write a Chrome trace to
    ``<log_dir>/trace.json`` (open it in Perfetto or chrome://tracing).
    On the card the window opens ``TRACE_MARGIN_S`` before the block, on
    an idle card, and closes that long after the block's work has
    finished.  The recorded :func:`spans` are emptied as it opens.  Yields
    the profiler."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    clear_spans()
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        if cuda:
            time.sleep(TRACE_MARGIN_S)
        yield prof
        if cuda:
            torch.cuda.synchronize()
            time.sleep(TRACE_MARGIN_S)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class ExportMonitor:
    """Terminal progress renderer for export_mesh's progress callback: the
    reference's monitor thread (stage, elapsed time, memory and the
    per-level triangle histogram, DesignCSG.cpp:839-1025) without the
    thread.  export_mesh calls it inline and shares its telemetry dict
    through :meth:`attach_stats`."""

    def __init__(self, out=sys.stderr, min_interval: float = 0.25):
        self._out = out
        self._t0 = time.time()
        self._last = 0.0
        self._min_interval = min_interval
        self._stats: Optional[dict] = None

    def attach_stats(self, stats: dict):
        """export_mesh hands over its live telemetry dict (the extractors
        fill it as slabs and levels complete)."""
        self._stats = stats

    @staticmethod
    def _rss_mb() -> Optional[float]:
        """Resident set size in MB from /proc/self/statm (the reference's
        monitor shows process memory, DesignCSG.cpp:852-894)."""
        try:
            with open("/proc/self/statm") as f:
                rss_pages = int(f.read().split()[1])
            return rss_pages * os.sysconf("SC_PAGE_SIZE") / 1e6
        except (OSError, ValueError, IndexError):
            return None

    def _mem_suffix(self) -> str:
        rss = self._rss_mb()
        return f" rss {rss:6.0f}MB" if rss is not None else ""

    def _count_suffix(self) -> str:
        if not self._stats:
            return ""
        for key, unit in (("level_triangles", "tris"), ("slab_triangles", "tris"),
                          ("slab_cells_active", "cells")):
            if key in self._stats:
                return f" {sum(self._stats[key].values()):>9d} {unit}"
        return ""

    def __call__(self, stage: str, frac: float):
        now = time.time()
        if now - self._last < self._min_interval and frac < 1.0:
            return
        self._last = now
        bar_n = int(frac * 30)
        bar = "#" * bar_n + "-" * (30 - bar_n)
        self._out.write(
            f"\r[{now - self._t0:7.1f}s] {stage:<26s} [{bar}] {frac*100:5.1f}%"
            f"{self._count_suffix()}{self._mem_suffix()}"
        )
        if frac >= 1.0:
            self._out.write("\n")
        self._out.flush()

    def render_histogram(self, stats: Optional[dict] = None) -> str:
        """The triangle histogram after a run: per octree level for the
        adaptive strategy (the reference prints one per level,
        DesignCSG.cpp:896-924), per slab for the uniform ones."""
        stats = stats if stats is not None else (self._stats or {})
        if "level_triangles" in stats:
            items, label = sorted(stats["level_triangles"].items()), "level"
        elif "slab_triangles" in stats:
            items, label = sorted(stats["slab_triangles"].items()), "slab z0"
        else:
            return ""
        total = max(1, sum(c for _, c in items))
        width = 40
        lines = [f"{label:>8s}  {'triangles':>10s}"]
        for k, c in items:
            bar = "#" * max(0, int(round(width * c / total)))
            lines.append(f"{k:>8d}  {c:>10d}  {bar}")
        return "\n".join(lines)
