"""The viewport's check on the CPU at 40x30: a sound run is correct, each
fault planted underneath the frame function makes it incorrect, and so does
the control (the reference in bfloat16 in the program's place)."""

import pytest
import torch

from benchmark import faults
from benchmark.drivers import viewport

from .small import run_small


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_sound_run_is_correct():
    result = run_small("design1.viewport", 2147483901, 1.5)
    assert result["correct"], result["compared"]
    assert list(result)[-1] == "compared" and result["attempted"] >= 2
    assert set(result["metrics"]) == {"frames_per_s", "frame_ms_p95", "setup_s"}


def test_traced_run_reports_the_layers_it_can_read():
    """On the CPU the trace holds host operations only: the counter's
    metric is there, the device's are left out, and the device is idle."""
    result = run_small("design1.viewport", 2147483905, 1.5, trace=True)
    assert result["correct"], result["compared"]
    assert result["metrics"]["launches_per_frame.viewport"]["value"] == 0.0
    assert result["metrics"]["device_idle_pct.viewport"]["value"] == 100.0
    assert "render_kernel_ms.viewport" not in result["metrics"]
    assert result["device"]["busy_s"] == 0.0 and result["device"]["window_s"] > 1.0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("kind", viewport.FAULTS)
def test_fault_underneath_the_frame_is_caught(kind):
    with faults.planted("design1.viewport", kind, 2147483902, torch.device("cpu")):
        result = run_small("design1.viewport", 2147483902, 1.5)
    assert result["attempted"] >= 2 and result["correct"] is False, result["compared"]


def test_bfloat16_control_fails():
    assert faults.kinds("design1.viewport") == ("control",) + viewport.FAULTS
    with faults.planted("design1.viewport", "control", 2147483906, torch.device("cpu")):
        result = run_small("design1.viewport", 2147483906, 1.5)
    assert result["attempted"] >= 2 and result["correct"] is False, result["compared"]
