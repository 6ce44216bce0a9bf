"""The ``logo.export_exact`` cell on the CPU: a sound run is correct on the
exact field and its traced window gives the new readers' values; each fault
planted in the writer underneath ``export_mesh``, the bfloat16 control,
and a run that the engine rule sends onto the baked twin make it
incorrect.

The cell's export is octree 5 -> 7 after a 256^3 autodetect, and its check
counts the volume on a 256^3 lattice; one such export took ten minutes on
eight CPU threads, since every field evaluation measures 4,352
point-sample distances.  Here (``SIZES``): octree 4 -> 6, which keeps the
grid and the 50 refine steps and leaves the letters' strokes some 7 cells
wide, so the sound export stays inside every limit; a 64^3 autodetect,
which finds the letters' cube to within its cells of 0.16 world units;
and a 64^3 volume lattice, whose count stays well inside the volume limit
on these plates.  Each run is then two to four minutes."""

import time
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import faults, peaks, run
from benchmark.drivers import export_exact
from benchmark.reference import logo
from benchmark.trace import Trace

CELL = "logo.export_exact"
SIZES = {"export": {"minimumOctreeLevel": 4, "maximumOctreeLevel": 6},
         "autodetect_resolution": 64, "volume_cells": 64}


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
        return run_cell(2147483951, trace=True)


def test_sound_run_is_correct_on_the_exact_field(sound):
    assert sound["correct"], sound["compared"]
    assert sound["compared"]["field_not_exact"]["value"] == 0.0
    assert sound["window"]["sdf_field_seen"] == ["tape-exact"]
    assert sound["window"]["triangles_seen"][0] > 20_000


def test_new_readers_give_values(sound):
    value = {name: m["value"] for name, m in sound["metrics"].items()}
    (evals,) = sound["window"]["sdf_evals_seen"]
    # Every evaluation evaluates all three letters.
    assert value["letter_pairs.export_exact"] == evals * logo.SAMPLES_PER_EVALUATION
    assert 0 < value["bbox_s.export_exact"] < value["refine_s.export"] + value["extract_s.export"]
    # A CPU window has no device operations; on a trace whose card was busy
    # one second an export the share is the letter work's least time.
    busy = Trace((0, 2_000_000_000), [("k", 0, 1_000_000_000)], [])
    ctx = types.SimpleNamespace(window={"records": [{"sdf_evals": evals}]}, trace=busy)
    share = run.metric_reader("letter_roofline.export_exact").read(ctx)
    flops = evals * logo.SAMPLES_PER_EVALUATION * logo.FLOPS_PER_PAIR
    assert share == pytest.approx(100.0 * peaks.bound_s(flops, 16 * evals))
    assert 0 < share <= 100


@pytest.mark.parametrize("kind", export_exact.FAULTS)
def test_fault_underneath_the_export_is_caught(kind):
    with faults.planted(CELL, kind, 2147483952, torch.device("cpu")):
        result = run_cell(2147483952)
    assert result["correct"] is False, result["compared"]


def test_bfloat16_control_fails():
    with faults.planted(CELL, "control", 2147483957, torch.device("cpu")):
        result = run_cell(2147483957)
    assert result["correct"] is False, result["compared"]
    off = result["compared"]["vertex_off_share"]
    assert off["value"] > off["limit"]


def test_a_run_on_the_baked_field_fails(monkeypatch):
    """Where the engine rule took the kernels' field, Logo would export its
    baked twin: the check's ``field_not_exact`` refuses it."""
    from designcsg_tpu_torch import evaluator

    monkeypatch.setattr(evaluator, "default_use_kernels", lambda scene, device: True)
    result = run_cell(2147483958)
    assert result["window"]["sdf_field_seen"] == ["tape-baked"]
    assert result["compared"]["field_not_exact"]["value"] == 1.0
    assert result["correct"] is False
