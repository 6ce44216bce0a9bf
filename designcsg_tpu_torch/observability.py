"""Logging, timing and profiling (observability.py of the JAX package).

The reference's observability is a mutexed GUI console, redirected stdout
and a 100 ms monitor thread rendering export state, elapsed time and memory
(DesignCSG.cpp:300-310,575-601,839-1025).  Library equivalents: the
package's logger, a stage-timing registry, a ``torch.profiler`` trace
context writing a Chrome trace, and :class:`ExportMonitor`, a progress
renderer for terminals.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

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


@dataclass
class StageTimer:
    """Accumulates wall-clock seconds per named stage; renders a report
    table."""

    stages: Dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + time.time() - t0

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
    finished.  Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
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
