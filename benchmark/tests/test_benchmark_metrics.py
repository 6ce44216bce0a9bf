"""The metrics' arithmetic on synthetic windows and traces."""

import types

import numpy as np
import pytest

import statistics

from benchmark import peaks
from benchmark.run import metric_reader
from benchmark.trace import WINDOW, Capture, Trace, reduce, union


def ctx(window=None, trace=None, **kw):
    return types.SimpleNamespace(window=window or {}, trace=trace, setup_s=kw.get("setup_s", 1.0),
                                 cell=kw.get("cell"))


def test_frames_per_s_is_the_windows_frames_over_its_seconds():
    window = {"frames": 2500, "window_s": 2.5, "call_s": [0.001] * 2500}
    assert metric_reader("frames_per_s").read(ctx(window)) == pytest.approx(1000.0)
    assert metric_reader("frames_per_s").read(ctx({"exports": 3, "window_s": 9.0})) is None


def test_p95_is_taken_over_every_frame():
    times = [i / 1000.0 for i in range(1, 101)]  # 1..100 ms
    got = metric_reader("frame_ms_p95").read(ctx({"frames": 100, "call_s": times}))
    assert got == pytest.approx(float(np.percentile(np.arange(1, 101), 95)))
    # A window of one frame (the bf16 control's) has that frame as its tail.
    assert metric_reader("frame_ms_p95").read(ctx({"frames": 1, "call_s": [0.004]})) == 4.0
    # One slow frame among many moves the tail only as far as its rank.
    p95 = lambda xs: statistics.quantiles(xs, n=100, method="inclusive")[94]  # noqa: E731
    assert p95([1.0] * 99 + [500.0]) == 1.0
    assert p95([1.0] * 90 + [500.0] * 10) == 500.0


def test_export_s_is_the_window_over_its_exports():
    window = {"exports": 4, "window_s": 12.0,
              "records": [{"stage_seconds": {"extract": 2.0, "refine": 0.5}, "sdf_evals": 10}] * 4}
    assert metric_reader("export_s").read(ctx(window)) == 3.0
    assert metric_reader("extract_s.export").read(ctx(window)) == 2.0
    assert metric_reader("refine_s.export").read(ctx(window)) == 0.5
    assert metric_reader("sdf_evals.export").read(ctx(window)) == 10


def synthetic_trace():
    ms = 1_000_000
    device = [("render_kernel(float*, int)", 0, 4 * ms), ("Memcpy DtoH (Device -> Pageable)", 3 * ms, 6 * ms),
              ("render_kernel(float*, int)", 8 * ms, 12 * ms), ("Memcpy DtoH (Device -> Pageable)", 12 * ms, 14 * ms),
              ("late_kernel", 19 * ms, 25 * ms)]
    host = [("benchmark.frame", 0, 8 * ms), ("aten::copy_", 6 * ms, 8 * ms),
            ("benchmark.frame", 8 * ms, 15 * ms), ("numpy", 15 * ms, 19 * ms)]
    return Trace((0, 20 * ms), device, host)


def test_idle_is_the_window_less_the_union_of_device_operations():
    t = synthetic_trace()
    assert union([(0, 4), (3, 6), (8, 12), (12, 14)]) == [(0, 6), (8, 14)]
    assert t.window_s == pytest.approx(0.020)
    assert t.busy_s == pytest.approx(0.013)  # 0-6, 8-14, 19-20 (clipped)
    idle = metric_reader("device_idle_pct.viewport").read(ctx(trace=t))
    assert idle == pytest.approx(100 * 7 / 20)
    gaps = t.breakdown()["idle_gaps"]
    assert gaps[0] == ["numpy", pytest.approx(0.005)]
    assert gaps[1] == ["aten::copy_", pytest.approx(0.002)]
    ops = dict(t.breakdown()["device_ops"])
    assert ops["render_kernel(float*, int)"] == pytest.approx(0.008)


def test_kernel_time_readback_and_roofline():
    t = synthetic_trace()
    window = {"frames": 2}
    assert metric_reader("render_kernel_ms.viewport").read(ctx(window, t)) == pytest.approx(4.0)
    assert metric_reader("readback_ms.viewport").read(ctx(window, t)) == pytest.approx(2.5)
    cell = types.SimpleNamespace(reference_evals=[1], frame_flops=lambda: 67e12 * 1e-3,
                                 frame_bytes=lambda: 3.35e12 * 2e-4)
    # The bound is 1 ms of FP32 work against 4 ms of K2: 25%.
    roof = metric_reader("render_roofline.viewport").read(ctx(window, t, cell=cell))
    assert roof == pytest.approx(25.0)
    assert peaks.bound_s(0.0, 3.35e12) == pytest.approx(1.0)


class Event:
    def __init__(self, name, start, end, device):
        self._name, self._start, self._end, self._device = name, start, end, device

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start

    def device_type(self):
        return "DeviceType.CUDA" if self._device else "DeviceType.CPU"


def test_reduce_takes_the_window_from_its_markers_and_moves_host_spans_onto_it():
    """The first and last device operations are the markers; the host's
    spans, on the host clock, move by the first marker's lag."""
    fill = "fill_kernel"
    capture = Capture()
    capture.start_ns, capture.end_ns = 1_000, 41_000
    capture.events = [Event(fill, 5_000, 5_100, True), Event("render_kernel", 6_000, 16_000, True),
                      Event("cudaLaunchKernel", 5_500, 5_900, False),
                      Event(fill, 45_000, 45_100, True)]
    t = reduce(capture, [("benchmark.frame", 1_400, 21_000)])
    assert t.window == (5_000, 45_000)
    assert [s[0] for s in t.device] == ["render_kernel"]
    assert (WINDOW, 5_000, 45_000) in t.host and ("benchmark.frame", 5_400, 25_000) in t.host
    gaps = t.breakdown()["idle_gaps"]
    assert gaps[0] == [WINDOW, pytest.approx(29e-6)]  # 16,000 to 45,000, after the frame
    assert gaps[1] == ["cudaLaunchKernel", pytest.approx(1e-6)]  # 5,000 to 6,000
    broken = Capture()
    broken.events = [Event(fill, 0, 1, True), Event("render_kernel", 2, 3, True)]
    with pytest.raises(RuntimeError, match="marker"):
        reduce(broken, [])


def test_reduce_on_the_cpu_is_the_host_window():
    capture = Capture()
    capture.start_ns, capture.end_ns = 10, 2_000_000_010
    t = reduce(capture, [("benchmark.frame", 20, 1_000)])
    assert t.window_s == pytest.approx(2.0) and t.busy_s == 0.0
    assert t.breakdown()["idle_gaps"] == [[WINDOW, pytest.approx(2.0)]]


def test_readers_say_nothing_without_a_trace():
    for name in ("readback_ms.viewport", "render_kernel_ms.viewport", "render_roofline.viewport",
                 "device_idle_pct.export", "export_device_ms.export"):
        assert metric_reader(name).read(ctx({"frames": 1, "exports": 1})) is None
