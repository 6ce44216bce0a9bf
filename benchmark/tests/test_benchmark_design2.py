"""The ``design2.export`` cell on the CPU: a sound run is correct and its
traced window gives the mesh ops' spans, and each fault planted in the
writer underneath ``export_mesh``, and the bfloat16 control, make it
incorrect.

The cell's octree is 6 -> 8; here it starts at level 5 (``SIZES``), which
keeps the finest level, the grid and the 50 refine steps and takes an
export from ~6 to ~45 s on two CPU threads.  At a coarser finest level the
sound export misses thin struts and its volume gap passes the limit
(0.024 at 4 -> 7, 0.073 at 4 -> 6), so the finest level is not cut."""

import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import faults, run
from benchmark.drivers import export

CELL = "design2.export"
SIZES = {"export": {"minimumOctreeLevel": 5}}
MESH_OPS = ("weld_s.export", "retopo_s.export", "stitch_s.export")


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def run_cell(seed, trace=False):
    return run.run_cell(run.manifest(), CELL, seed, 0.5, trace, torch.device("cpu"),
                        time.perf_counter(), sizes=SIZES)


@pytest.fixture(scope="module")
def sound():
    """A traced run under a CPU profiler, so that the program keeps its
    spans (the harness's own trace profiles only a card)."""
    with profile(activities=[ProfilerActivity.CPU]):
        return run_cell(2147483913, trace=True)


def test_sound_run_is_correct(sound):
    assert sound["correct"], sound["compared"]
    assert sound["window"]["triangles_seen"][0] > 150_000


def test_mesh_op_readers_split_the_mesh_ops(sound):
    value = {name: m["value"] for name, m in sound["metrics"].items()}
    assert all(value.get(n, 0) > 0 for n in MESH_OPS + ("mesh_ops_s.export",)), value
    assert sum(value[n] for n in MESH_OPS) == pytest.approx(value["mesh_ops_s.export"], rel=0.03)
    assert value["mesh_faces.export"] > 150_000  # faces into the weld, an export


@pytest.mark.parametrize("kind", export.FAULTS)
def test_fault_underneath_the_export_is_caught(kind):
    with faults.planted(CELL, kind, 2147483914, torch.device("cpu")):
        result = run_cell(2147483914)
    assert result["correct"] is False, result["compared"]


def test_bfloat16_control_fails():
    with faults.planted(CELL, "control", 2147483917, torch.device("cpu")):
        result = run_cell(2147483917)
    assert result["correct"] is False, result["compared"]
    assert result["compared"]["vertex_gap_max"]["value"] > result["compared"]["vertex_gap_max"]["limit"]
