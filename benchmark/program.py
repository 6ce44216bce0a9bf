"""The program's own spans on the profiler's clock, for the per-layer
metrics that read them.

The program records its spans (``designcsg_tpu_torch.observability.spans``:
name, start, end, parent index, value) on ``time.perf_counter_ns`` while a
profiler runs.  The harness's own spans (``ctx.window["spans"]``) are on
that clock too, and ``trace.reduce`` moves each onto the profiler's
(``ctx.trace.host``), so a raw span against its moved twin gives the
harness's shift.  That shift reads the window's first marker, whose start
on the card lags the harness's clock read by the profiler's first launch
(0.2-0.5 ms on an NVIDIA H100), so :func:`shift` takes the two clocks'
offset read side by side where the harness's shift bounds it.  A program
that records no spans gives None, and so does every reader.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Iterator, List, Optional, Tuple

from benchmark.trace import union


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    start: int  # ns on the profiler's clock, clipped to the window
    end: int
    parent: int  # the index of the enclosing span, -1 for a root
    value: Optional[int]  # a count: a copy's bytes

    @property
    def ns(self) -> int:
        return self.end - self.start


Spans = List[Optional[Span]]  # by the program's index; None outside the window


def recorded() -> Optional[list]:
    """The program's recorded spans, or None where it records none."""
    try:
        from designcsg_tpu_torch import observability
    except ImportError:
        return None
    read = getattr(observability, "spans", None)
    return list(read()) if read is not None else None


# The longest the window's first marker can lag the harness's clock read
# (the profiler's first launch: 0.2-0.5 ms on an NVIDIA H100).
MAX_LAG_NS = 10_000_000


def host_offset() -> int:
    """Unix time less ``time.perf_counter_ns``, from the pair of reads, of
    101, taken closest together."""
    pairs = []
    for _ in range(101):
        a = time.perf_counter_ns()
        unix = time.time_ns()
        b = time.perf_counter_ns()
        pairs.append((b - a, unix - (a + b) // 2))
    return min(pairs)[1]


def shift(ctx) -> Optional[int]:
    """Nanoseconds to add to a host-clock time to put it on the profiler's
    clock.  The harness's shift comes from each of its raw spans against
    its moved twin (``reduce`` appends them last and in order; None unless
    all agree).  It reads the window's first marker, which starts on the
    card a launch after the harness read its clock, so it runs late by
    that lag; the profiler stamps its records in Unix time, so where the
    harness's shift exceeds :func:`host_offset` by less than
    ``MAX_LAG_NS``, the offset is the shift.  Otherwise (the CPU's window,
    on the host's own clock) the harness's shift is."""
    raw = ctx.window.get("spans") or []
    if ctx.trace is None or not raw:
        return None
    names = {s[0] for s in raw}
    moved = [s for s in ctx.trace.host if s[0] in names][-len(raw):]
    if len(moved) != len(raw) or any(m[0] != r[0] for r, m in zip(raw, moved)):
        return None
    shifts = {m[k] - r[k] for r, m in zip(raw, moved) for k in (1, 2)}
    if len(shifts) != 1:
        return None
    harness, offset = shifts.pop(), host_offset()
    return offset if 0 <= harness - offset < MAX_LAG_NS else harness


def spans(ctx, recorded_spans: Optional[list] = None) -> Optional[Spans]:
    """The program's spans (``recorded_spans``, default :func:`recorded`)
    moved onto the profiler's clock and clipped to the traced window; a
    span outside it, or still open, is None."""
    if recorded_spans is None:
        recorded_spans = recorded()
    by = shift(ctx)
    if recorded_spans is None or by is None:
        return None
    lo, hi = ctx.trace.window
    out: Spans = []
    for name, start, end, parent, value in recorded_spans:
        if end is None or end + by <= lo or start + by >= hi:
            out.append(None)
        else:
            out.append(Span(name, max(start + by, lo), min(end + by, hi), parent, value))
    return out


def named(all_spans: Spans, prefix: str) -> Iterator[Tuple[int, Span]]:
    """``(index, span)`` of the spans whose names start with ``prefix``."""
    return ((i, s) for i, s in enumerate(all_spans) if s is not None and s.name.startswith(prefix))


def ancestors(all_spans: Spans, i: int) -> Iterator[int]:
    """The indices of the spans that enclose span ``i``, innermost first."""
    parent = all_spans[i].parent
    while parent >= 0 and all_spans[parent] is not None:
        yield parent
        parent = all_spans[parent].parent


def under(all_spans: Spans, i: int, prefix: str) -> bool:
    """Whether a span enclosing span ``i`` has a name starting with
    ``prefix``."""
    return any(all_spans[k].name.startswith(prefix) for k in ancestors(all_spans, i))


def roots(all_spans: Optional[Spans], name: str) -> int:
    """The root spans called ``name`` in the window (frames or exports)."""
    if all_spans is None:
        return 0
    return sum(1 for _, s in named(all_spans, name) if s.name == name and s.parent == -1)


def covered(span: Span, intervals: List[Tuple[int, int]]) -> int:
    """Nanoseconds of ``span`` that the union of ``intervals`` covers."""
    clipped = [(max(a, span.start), min(b, span.end)) for a, b in intervals]
    return sum(b - a for a, b in union([c for c in clipped if c[1] > c[0]]))


def self_ns(all_spans: Spans, name: str, inner: str = "") -> int:
    """Over the spans called ``name``: each less the part its descendants
    named ``inner...`` cover (every descendant by default, which gives the
    spans' self time)."""
    within = {i: [] for i, s in named(all_spans, name) if s.name == name}
    for j, s in named(all_spans, inner):
        owner = next((k for k in ancestors(all_spans, j) if k in within), None)
        if owner is not None:
            within[owner].append((s.start, s.end))
    return sum(all_spans[i].ns - covered(all_spans[i], cover) for i, cover in within.items())


def idle_ns(trace, spans_in: List[Span]) -> int:
    """Nanoseconds inside ``spans_in`` in which the card ran nothing (the
    trace's idle gaps, which are sorted and disjoint)."""
    gaps = trace.idle_gaps()
    ends = [b for _, b in gaps]
    total = 0
    for span in spans_in:
        k = bisect.bisect_right(ends, span.start)
        while k < len(gaps) and gaps[k][0] < span.end:
            total += min(gaps[k][1], span.end) - max(gaps[k][0], span.start)
            k += 1
    return total
