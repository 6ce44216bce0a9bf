"""The profiler's record of a traced window, reduced to what the per-layer
metrics read: the device's operations, the host's spans and the window
they fall in, all in nanoseconds on the profiler's clock.

The card is traced with the profiler's CUDA activity alone.  Its CPU
activity records every operator on the host, and slowed a Design1 viewport
frame from about 1.25 to 2.2 ms (NVIDIA H100 80GB HBM3), so that the idle
share it gave was mostly the profiler's own.  The host's side of the trace
is then the CUDA runtime's calls and the harness's own spans (each call of
the program), which the harness times on the host clock; a marker fill
launched at each end of the window puts both on the profiler's clock."""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List, Optional, Tuple

Span = Tuple[str, int, int]  # (name, start, end)

WINDOW = "benchmark.window"  # the harness's span around the traced window
MARGIN_S = 0.05  # idle seconds kept on both sides of the window
# The traced window's longest: past it the profiler's growing buffers slow
# the host (with CPU activity on, a 51 s trace of design1.viewport read its
# copies at 1.09 ms a frame, a 10 s one at 0.58 ms; NVIDIA H100 80GB HBM3).
TRACE_SECONDS = 10.0


@dataclasses.dataclass
class Trace:
    window: Tuple[int, int]
    device: List[Span]  # kernels, copies and fills on the card
    host: List[Span]  # the CUDA runtime's calls and the harness's spans

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def in_window(self, spans: List[Span]) -> List[Span]:
        lo, hi = self.window
        return [(n, max(a, lo), min(b, hi)) for n, a, b in spans if b > lo and a < hi]

    def busy(self) -> List[Tuple[int, int]]:
        """The union of the device's operations within the window."""
        return union([(a, b) for _, a, b in self.in_window(self.device)])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) * 1e-9

    def idle_gaps(self) -> List[Tuple[int, int]]:
        lo, hi = self.window
        out, at = [], lo
        for a, b in self.busy():
            if a > at:
                out.append((at, a))
            at = max(at, b)
        if hi > at:
            out.append((at, hi))
        return out

    def device_ops(self, prefix: str = "") -> List[Span]:
        return [s for s in self.in_window(self.device) if s[0].startswith(prefix)]

    def host_at(self, t: int) -> str:
        """The innermost host span that covers ``t`` (the latest to start),
        else "host"."""
        best: Optional[Span] = None
        for span in self.host:
            if span[1] <= t < span[2] and (best is None or span[1] >= best[1]):
                best = span
        return best[0] if best is not None else "host"

    def breakdown(self, n: int = 10) -> dict:
        totals: dict = {}
        for name, a, b in self.in_window(self.device):
            totals[name] = totals.get(name, 0) + (b - a)
        ops = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:n]
        return {"device_ops": [[_short(k), v * 1e-9] for k, v in ops],
                "idle_gaps": [[_short(self.host_at((a + b) // 2)), (b - a) * 1e-9] for a, b in gaps]}


def _short(name: str) -> str:
    return name if len(name) <= 96 else name[:96]


def union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Capture:
    """What a traced block leaves: the profiler's events (none for a CPU
    device) and the host clock at the window's ends, in nanoseconds of
    ``time.perf_counter``."""

    events: tuple = ()
    start_ns = end_ns = 0


@contextlib.contextmanager
def traced(device):
    """Profile the block's device operations (a CPU ``device`` has none);
    yields a :class:`Capture`, complete once the block has ended."""
    import torch

    capture = Capture()
    if device.type != "cuda":
        capture.start_ns = time.perf_counter_ns()
        yield capture
        capture.end_ns = time.perf_counter_ns()
        return
    from torch.profiler import ProfilerActivity, profile

    mark = torch.zeros(1, device=device)
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(MARGIN_S)
        capture.start_ns = time.perf_counter_ns()
        mark.fill_(1.0)  # the window's first device operation
        yield capture
        torch.cuda.synchronize(device)
        capture.end_ns = time.perf_counter_ns()
        mark.fill_(2.0)  # and its last
        torch.cuda.synchronize(device)
        time.sleep(MARGIN_S)
    capture.events = prof.profiler.kineto_results.events()


def reduce(capture: Capture, spans: List[Span]) -> Trace:
    """The trace of a captured window: on the card its kernels, copies and
    fills between the two markers; on the host the runtime's calls and
    ``spans`` (host-clock nanoseconds, each moved onto the profiler's clock
    by the first marker's lag behind ``capture.start_ns``), within a
    ``WINDOW`` span of the whole."""
    device, host = [], []
    for e in capture.events:
        span = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        (device if str(e.device_type()).endswith("CUDA") else host).append(span)
    device.sort(key=lambda s: s[1])
    if device:
        first, last = device[0], device[-1]
        if len(device) < 2 or first[0] != last[0]:
            raise RuntimeError(f"the trace lost a marker of its window: {first[0]!r}, {last[0]!r}")
        lo, hi, device = first[1], last[1], device[1:-1]
    else:
        lo, hi = capture.start_ns, capture.end_ns
    shift = lo - capture.start_ns
    ends = [(WINDOW, capture.start_ns, capture.end_ns)]
    host += [(n, a + shift, b + shift) for n, a, b in ends + list(spans)]
    return Trace((lo, hi), device, host)
