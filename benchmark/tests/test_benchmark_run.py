"""A run without a card, or without the program, fails and prints no
result."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["-m", "benchmark.run", "--workload", "design1.viewport", "--seed", "2147483999",
        "--seconds", "1", "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable] + ARGS, cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_a_run_without_a_card_fails_rather_than_falling_back():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = _run(ROOT, env)
    assert out.returncode != 0 and "{" not in out.stdout
    assert "CUDA device" in out.stderr


def test_a_checkout_of_only_the_benchmark_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _run(tmp_path, env)
    assert out.returncode != 0 and "{" not in out.stdout
    assert "designcsg_tpu_torch" in out.stderr


def test_manifest_command_is_this_module():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert bench["command"][1:] == ["-m", "benchmark.run"]
