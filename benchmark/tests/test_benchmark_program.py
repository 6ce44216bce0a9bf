"""The program's spans on the profiler's clock (benchmark/program.py) and
the per-layer metrics that read them, on synthetic traces."""

import time
import types

import pytest

from benchmark import program
from benchmark.run import metric_reader
from benchmark.trace import Capture, Trace, reduce

US = 1_000
SHIFT = 7 * US  # the profiler's clock runs 7 us ahead of the host's here


def ctx(raw, trace):
    return types.SimpleNamespace(window={"spans": raw, "frames": len(raw)}, trace=trace)


def viewport_trace():
    """Two frames on the host clock, the first starting at 100 us, and the
    card's K2 and copies on the profiler's clock, inside a window that cuts
    the second frame's end."""
    raw = [("benchmark.frame", 100 * US, 400 * US), ("benchmark.frame", 400 * US, 700 * US)]
    recorded = [
        ("viewer.frame", 105 * US, 395 * US, -1, None),
        ("viewer.render", 110 * US, 150 * US, 0, None),
        ("copy.d2h", 150 * US, 390 * US, 0, 3_686_400),
        ("viewer.frame", 405 * US, 695 * US, -1, None),
        ("viewer.render", 410 * US, 450 * US, 3, None),
        ("copy.d2h", 450 * US, 690 * US, 3, 3_686_400),
        ("viewer.frame", 800 * US, None, -1, None),  # still open
    ]
    device = [("render_kernel", 130 * US + SHIFT, 330 * US + SHIFT),
              ("Memcpy DtoH (Device -> Pageable)", 350 * US + SHIFT, 380 * US + SHIFT),
              ("render_kernel", 430 * US + SHIFT, 630 * US + SHIFT)]
    host = [(n, a + SHIFT, b + SHIFT) for n, a, b in raw]
    return raw, recorded, Trace((100 * US + SHIFT, 600 * US + SHIFT), device, host)


def test_spans_move_by_the_harness_shift_and_clip_to_the_window():
    raw, recorded, trace = viewport_trace()
    assert program.shift(ctx(raw, trace)) == SHIFT
    spans = program.spans(ctx(raw, trace), recorded)
    assert spans[0] == program.Span("viewer.frame", 105 * US + SHIFT, 395 * US + SHIFT, -1, None)
    assert spans[5].end == 600 * US + SHIFT  # clipped at the window's end
    assert spans[6] is None  # open
    assert program.roots(spans, "viewer.frame") == 2


def test_the_shift_comes_from_reduce_itself():
    capture = Capture()
    capture.start_ns, capture.end_ns = 1_000, 900_000
    raw = [("benchmark.export", 2_000, 50_000), ("benchmark.export", 50_000, 80_000)]
    trace = reduce(capture, raw)  # on the CPU: no markers, no shift
    assert program.shift(ctx(raw, trace)) == 0
    broken = Trace(trace.window, [], [("benchmark.export", 2_500, 50_500),
                                      ("benchmark.export", 50_000, 80_000)])
    assert program.shift(ctx(raw, broken)) is None
    assert program.shift(ctx([], trace)) is None


def test_the_shift_is_the_clocks_offset_where_the_harness_bounds_it(monkeypatch):
    """The harness's shift runs late by its first marker's lag; where it
    exceeds the host clocks' offset by less than MAX_LAG_NS, the offset is
    the shift, else (the CPU's window) the harness's shift is."""
    raw, recorded, trace = viewport_trace()
    monkeypatch.setattr(program, "host_offset", lambda: SHIFT - 5 * US)
    assert program.shift(ctx(raw, trace)) == SHIFT - 5 * US
    assert program.spans(ctx(raw, trace), recorded)[1].start == 105 * US + SHIFT
    for far in (SHIFT + 1, SHIFT - program.MAX_LAG_NS):
        monkeypatch.setattr(program, "host_offset", lambda: far)
        assert program.shift(ctx(raw, trace)) == SHIFT
    monkeypatch.undo()
    unix = time.time_ns() - time.perf_counter_ns()
    assert abs(program.host_offset() - unix) < 1_000_000


def test_self_time_and_idle_inside_a_span():
    raw, recorded, trace = viewport_trace()
    spans = program.spans(ctx(raw, trace), recorded)
    # Frame 1: 290 us less its children's 40 + 240; frame 2, clipped: 195
    # less 40 + 150.
    assert program.self_ns(spans, "viewer.frame") == (290 - 280) * US + (195 - 190) * US
    assert program.self_ns(spans, "viewer.frame", "copy.") == (290 - 240) * US + (195 - 150) * US
    # Idle within the first copy (150-390 on the host clock): 330-350 and
    # 380-390; the second (450-600 once clipped) lies inside K2.
    copies = [s for _, s in program.named(spans, "copy.d2h")]
    assert program.idle_ns(trace, copies[:1]) == 30 * US
    assert program.idle_ns(trace, copies[1:]) == 0
    assert program.covered(spans[0], [(0, 10**12)]) == spans[0].ns


def test_viewport_readers(monkeypatch):
    raw, recorded, trace = viewport_trace()
    monkeypatch.setattr(program, "recorded", lambda: recorded)
    # Two renders of 40 us; 30 us of idle card in the copies, over 2 frames.
    assert metric_reader("render_call_ms.viewport").read(ctx(raw, trace)) == pytest.approx(0.040)
    assert metric_reader("readback_idle_ms.viewport").read(ctx(raw, trace)) == pytest.approx(0.015)


def export_trace():
    """One export: a level with two evaluator calls (one nested in another's
    span, counted once), the mesh ops, and uploads."""
    raw = [("benchmark.export", 0, 1000 * US)]
    recorded = [
        ("export.mesh", 10 * US, 990 * US, -1, None),                       # 0
        ("export.bounding_box", 10 * US, 100 * US, 0, None),                # 1
        ("evaluator.autodetect_bounding_box_device", 20 * US, 90 * US, 1, None),
        ("export.extract", 100 * US, 900 * US, 0, None),                    # 3
        ("extract.level", 110 * US, 600 * US, 3, None),                     # 4
        ("extract.corners", 110 * US, 300 * US, 4, None),                   # 5
        ("evaluator.eval_corner_signs_near", 120 * US, 220 * US, 5, None),  # 6
        ("copy.h2d", 121 * US, 122 * US, 6, 1_000),
        ("evaluator.eval_sdf_at_lattice", 130 * US, 140 * US, 6, None),     # nested
        ("extract.emit", 300 * US, 600 * US, 4, None),                      # 9
        ("evaluator.eval_sdf_at_lattice", 400 * US, 450 * US, 9, None),     # 10
        ("copy.h2d", 401 * US, 402 * US, 10, 500),
        ("extract.mesh_ops", 600 * US, 890 * US, 3, None),
        ("export.refine", 900 * US, 950 * US, 0, None),
        ("evaluator.refine_on_device", 900 * US, 950 * US, 13, None),
        ("copy.h2d", 901 * US, 902 * US, 14, 24),
        ("copy.h2d", 995 * US, 996 * US, -1, 9_999),  # outside any export
    ]
    trace = Trace((0, 1000 * US), [], list(raw))
    return raw, recorded, trace


def test_export_readers(monkeypatch):
    raw, recorded, trace = export_trace()
    monkeypatch.setattr(program, "recorded", lambda: recorded)
    c = types.SimpleNamespace(window={"spans": raw, "exports": 1}, trace=trace)
    value = {name: metric_reader(name).read(c) for name in
             ("extract_eval_s.export", "level_host_s.export", "mesh_ops_s.export",
              "h2d_bytes.export")}
    assert value["extract_eval_s.export"] == pytest.approx(150e-6)
    assert value["level_host_s.export"] == pytest.approx(490e-6 - 150e-6)
    assert value["mesh_ops_s.export"] == pytest.approx(290e-6)
    assert value["h2d_bytes.export"] == 1_524


def test_readers_say_nothing_without_program_spans(monkeypatch):
    raw, _, trace = export_trace()
    names = ("render_call_ms.viewport", "readback_idle_ms.viewport", "extract_eval_s.export",
             "level_host_s.export", "mesh_ops_s.export", "h2d_bytes.export")
    # A program without a span recorder (the parent of the one that added
    # it), a run without a trace, and a trace with no program spans in it.
    monkeypatch.setattr(program, "recorded", lambda: None)
    c = types.SimpleNamespace(window={"spans": raw, "exports": 1, "frames": 1}, trace=trace)
    assert all(metric_reader(n).read(c) is None for n in names)
    monkeypatch.setattr(program, "recorded", lambda: [])
    assert all(metric_reader(n).read(c) is None for n in names)
    c.trace = None
    assert all(metric_reader(n).read(c) is None for n in names)


def test_recorded_reads_the_program_or_nothing(monkeypatch):
    import sys

    from designcsg_tpu_torch import observability

    assert isinstance(program.recorded(), list)
    monkeypatch.delattr(observability, "spans")
    assert program.recorded() is None
    monkeypatch.setitem(sys.modules, "designcsg_tpu_torch", None)
    assert program.recorded() is None
