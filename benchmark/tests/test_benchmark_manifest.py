"""BENCHMARK.json keeps to its contract, and every cell finds its files by
name."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
HERE = ROOT / "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "bound", "source", "workloads"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves", "workloads"}


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and all(
        re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/") and ".." not in p
        for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # A full check of 24 cells fits its 43,200 seconds.
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_finds_its_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["name"] == f"{cell['config']}.{cell['traffic']}"
    assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200
    config = json.loads((HERE / "configs" / f"{cell['config']}.json").read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{cell['name']}.json").read_text())
    assert (HERE / "drivers" / f"{traffic['kind']}.py").exists()
    assert (HERE / "reference" / f"{config['reference']}.py").exists()
    assert limits and all(isinstance(v, (int, float)) for v in limits.values())
    reported = [m for m in BENCH["end_to_end"] + BENCH["per_layer"]
                if cell["name"] in m.get("workloads", [cell["name"]])]
    assert any(m["name"] == "setup_s" for m in reported)
    assert any(m["name"] != "setup_s" for m in reported if m in BENCH["end_to_end"])
    assert any(m in BENCH["per_layer"] for m in reported)


def test_names_units_and_metric_files():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    cells = {c["name"] for c in BENCH["workloads"]}
    names = [m["name"] for m in metrics] + sorted(cells) + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    for m in BENCH["end_to_end"]:
        assert set(m) <= METRIC_KEYS and m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= LAYER_KEYS and m["moves"] in e2e and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
        assert (HERE / "metrics" / f"{m['name']}.py").exists(), m["name"]


def test_every_config_is_used_and_its_file_lies_under_paths():
    used = {c["config"] for c in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and c["file"].startswith("benchmark/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
        assert c["file"] not in files
        files.add(c["file"])
        assert c["reduced"] == json.loads((ROOT / c["file"]).read_text())["reduced"]
