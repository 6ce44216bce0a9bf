"""The port's span recorder (observability.py) on the CPU: spans are kept
only while a torch profiler runs, a viewport frame and an adaptive export
record their trees, the stage and level seconds the export reports are its
spans' durations, copies carry their bytes, and a span with the profiler
off costs little."""

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from designcsg_tpu_torch import observability as obs
from designcsg_tpu_torch.camera import Camera
from designcsg_tpu_torch.compiler import ExportConfig
from designcsg_tpu_torch.config import RenderConfig
from designcsg_tpu_torch.designs import get_design
from designcsg_tpu_torch.evaluator import BatchEvaluator
from designcsg_tpu_torch.export.pipeline import export_mesh
from designcsg_tpu_torch.viewer import _make_render_fn

STAGES = ("bounding_box", "extract", "refine", "write")
# The evaluator's entry points that call another: the surface cells are the
# corner signs filtered.
COMPOSED = {("evaluator.eval_surface_cells", "evaluator.eval_corner_signs_near")}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread per test process: the suite runs one process per
    worker, and a default-sized thread pool in each oversubscribes the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def profiled():
    obs.clear_spans()
    return profile(activities=[ProfilerActivity.CPU])


def children(spans, parent):
    return [s[0] for s in spans if s[3] == parent]


@pytest.fixture(scope="module")
def frame_fn():
    config = RenderConfig(width=32, height=24, max_steps=16)
    return _make_render_fn(get_design("design1"), config, "cpu")


@pytest.fixture(scope="module")
def traced_export(tmp_path_factory):
    """A small adaptive export of Design1 on the CPU, profiled: its report,
    its stats and its spans."""
    scene = get_design("design1")
    config = ExportConfig(bounding_box_half_diameter=10.0, minimum_octree_level=3,
                          maximum_octree_level=5, grid_level=5, complex_surface_threshold=0.3,
                          gradient_descent_steps=2)
    evaluator = BatchEvaluator(scene, device="cpu", use_kernels=True)
    stl = str(tmp_path_factory.mktemp("stl") / "a.stl")
    with profiled():
        _, report = export_mesh(scene, config, stl_path=stl, evaluator=evaluator,
                                autodetect_resolution=32, strategy="adaptive")
    return report, list(obs.spans())


def test_no_span_is_kept_with_the_profiler_off(frame_fn):
    obs.clear_spans()
    cam = Camera.initial()
    for _ in range(50):
        frame_fn(cam)
        cam.orbit(0.01, 0.0)
    assert obs.spans() == []


def test_a_frame_records_render_and_readback_under_its_root(frame_fn):
    with profiled():
        image = frame_fn(Camera.initial())
    spans = obs.spans()
    assert [s[0] for s in spans] == ["viewer.frame", "viewer.render", "copy.d2h"]
    frame, render, copy = spans
    assert frame[3] == -1 and render[3] == 0 and copy[3] == 0
    assert frame[1] <= render[1] <= render[2] <= copy[1] <= copy[2] <= frame[2]
    assert copy[4] == 0 and image.shape == (24, 32, 3)  # nothing leaves a CPU device


def test_an_export_records_its_tree(traced_export):
    _, spans = traced_export
    (root,) = [i for i, s in enumerate(spans) if s[3] == -1]
    assert spans[root][0] == "export.mesh"
    assert children(spans, root) == [f"export.{stage}" for stage in STAGES]
    index = {s[0]: i for i, s in enumerate(spans) if s[3] == root}
    extract = index["export.extract"]
    assert children(spans, extract) == ["extract.level"] * 3 + ["extract.mesh_ops"]
    levels = [i for i, s in enumerate(spans) if s[0] == "extract.level"]
    assert children(spans, levels[0]) == ["extract.corners", "extract.normals",
                                          "extract.ambiguity", "extract.emit"]
    assert children(spans, levels[-1]) == ["extract.corners", "extract.emit"]
    assert children(spans, index["export.bounding_box"]) == [
        "evaluator.autodetect_bounding_box_device"]
    assert children(spans, index["export.refine"]) == ["evaluator.refine_on_device"]
    for i, s in enumerate(spans):
        assert s[2] is not None and s[1] <= s[2]
        if s[3] >= 0:  # inside its parent
            assert spans[s[3]][1] <= s[1] and s[2] <= spans[s[3]][2]
        if s[0].startswith("evaluator."):  # a stage's call, or a part of one
            parent = spans[s[3]][0]
            assert parent.startswith(("extract.", "export.")) or (parent, s[0]) in COMPOSED
        if s[0].startswith("copy."):  # the evaluator's, or a level step's
            assert spans[s[3]][0].startswith(("evaluator.", "extract.")) and s[4] == 0


def test_stage_and_level_seconds_are_their_spans(traced_export):
    report, spans = traced_export
    seconds = {s[0]: (s[2] - s[1]) * 1e-9 for s in spans if s[0].startswith("export.")}
    assert report.stage_seconds == {stage: seconds[f"export.{stage}"] for stage in STAGES}
    levels = report.stats["level_seconds"]
    assert sorted(levels) == [3, 4, 5]
    for L, i in zip(sorted(levels), [i for i, s in enumerate(spans) if s[0] == "extract.level"]):
        steps = {s[0][len("extract."):]: (s[2] - s[1]) * 1e-9 for s in spans if s[3] == i}
        assert levels[L] == steps


def test_the_emit_spans_count_the_level_triangles(traced_export):
    report, spans = traced_export
    triangles = report.stats["level_triangles"]
    values = {L: s[4] for L, s in zip(sorted(report.stats["level_seconds"]),
                                      [s for s in spans if s[0] == "extract.emit"])}
    assert values == {L: triangles.get(L, 0) for L in (3, 4, 5)}
    assert sum(values.values()) == sum(triangles.values()) > 0


def test_the_ambiguity_spans_count_the_candidates_tested(monkeypatch):
    """The ``extract.ambiguity`` span's value is the number of surface
    cells that the ambiguity test sampled: those the complexity test let
    through, at most the level's surface cells."""
    from designcsg_tpu_torch.export import adaptive

    tested = []
    ambiguous = adaptive._ambiguous_edges

    def spy(evaluator, tables, cells, *args):
        tested.append(cells.shape[0])
        return ambiguous(evaluator, tables, cells, *args)

    monkeypatch.setattr(adaptive, "_ambiguous_edges", spy)
    scene = get_design("design1")
    config = ExportConfig(bounding_box_half_diameter=10.0, minimum_octree_level=3,
                          maximum_octree_level=5, grid_level=6, complex_surface_threshold=0.5,
                          gradient_descent_steps=0)
    with profiled():
        export_mesh(scene, config, evaluator=BatchEvaluator(scene, device="cpu"),
                    autodetect_resolution=32, strategy="adaptive")
    spans = obs.spans()
    values = [s[4] for s in spans if s[0] == "extract.ambiguity"]
    surface = [s[4] for s in spans if s[0] == "extract.corners"]
    assert values == tested and len(values) == 2
    assert all(0 < v <= n for v, n in zip(values, surface))
    assert values != surface[:2]  # the complexity test held some cells back


@pytest.mark.parametrize("source, device, moved", [
    (np.zeros((5, 3), np.float32), "cpu", 0),
    (np.zeros((5, 3), np.int32), "meta", 60),
    (torch.zeros(7, dtype=torch.float64), "meta", 56),
    (np.float32(2.5), "meta", 4),
])
def test_an_upload_carries_the_bytes_it_moves(source, device, moved):
    with profiled():
        tensor = obs.to_device(source, device)
    assert tensor.device.type == device
    assert obs.spans() == [("copy.h2d", obs.spans()[0][1], obs.spans()[0][2], -1, moved)]


def test_a_readback_on_the_cpu_moves_nothing():
    tensor = torch.arange(6, dtype=torch.float32)
    with profiled():
        out = obs.to_host(tensor)
    assert np.array_equal(out, np.arange(6, dtype=np.float32))
    assert [(s[0], s[4]) for s in obs.spans()] == [("copy.d2h", 0)]


def test_profile_trace_empties_the_spans_when_it_opens(tmp_path):
    with profiled():
        with obs.span("earlier"):
            pass
    assert [s[0] for s in obs.spans()] == ["earlier"]
    with obs.profile_trace(str(tmp_path)):
        assert obs.spans() == []
        with obs.span("inside"):
            pass
    assert [s[0] for s in obs.spans()] == ["inside"]


def test_a_span_open_across_a_clear_is_dropped_and_threads_have_their_own_roots():
    with profiled():
        with obs.span("outer") as outer:
            obs.clear_spans()
            with obs.span("after"):
                pass
        worker = threading.Thread(target=lambda: obs.span("thread").__enter__().__exit__())
        with obs.span("main"):
            worker.start()
            worker.join(10)
    assert not worker.is_alive() and outer.seconds > 0
    assert sorted((s[0], s[3]) for s in obs.spans()) == [("after", -1), ("main", -1),
                                                        ("thread", -1)]


def test_stage_timer_keys_by_the_last_part_of_the_name():
    timer = obs.StageTimer()
    with timer.stage("export.extract"):
        pass
    with timer.stage("export.extract"):
        pass
    with timer.stage("plain"):
        pass
    assert set(timer.stages) == {"extract", "plain"} and timer.stages["extract"] > 0


def test_a_span_with_the_profiler_off_costs_under_2us():
    """The best of five batches of 20,000 spans, each a few hundred
    nanoseconds on a CPU core; PERF.md records the number."""
    obs.clear_spans()
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter_ns()
        for _ in range(20_000):
            with obs.span("cost"):
                pass
        best = min(best, (time.perf_counter_ns() - t0) / 20_000)
    print(f"span with the profiler off: {best:.0f} ns")
    assert best < 2_000 and obs.spans() == []
