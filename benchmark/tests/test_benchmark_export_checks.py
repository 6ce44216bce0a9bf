"""The export's check on the CPU at the cell's own octree: a sound run is correct,
each fault planted in the writer underneath ``export_mesh`` makes it
incorrect, and so does the control (the program's vertices projected onto
the zero set of the reference in bfloat16)."""

import pytest
import torch

from benchmark import faults
from benchmark.drivers import export

from .small import run_small


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_sound_run_is_correct():
    result = run_small("design1.export", 2147483903, 0.5)
    assert result["correct"], result["compared"]


@pytest.mark.parametrize("kind", export.FAULTS)
def test_fault_underneath_the_export_is_caught(kind):
    with faults.planted("design1.export", kind, 2147483904, torch.device("cpu")):
        result = run_small("design1.export", 2147483904, 0.5)
    assert result["correct"] is False, result["compared"]


def test_bfloat16_control_fails():
    with faults.planted("design1.export", "control", 2147483907, torch.device("cpu")):
        result = run_small("design1.export", 2147483907, 0.5)
    assert result["correct"] is False, result["compared"]
    assert result["compared"]["vertex_gap_max"]["value"] > result["compared"]["vertex_gap_max"]["limit"]
