"""The harness finds each cell's parts by name, and a new metric by its file."""

import json
import shutil

from conftest import ROOT

from portbench import spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_cell_finds_its_parts():
    for w in BENCH["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert spec.driver(cell.mix["kind"]).Driver
        names = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.metric(m["name"]).read)
        moved = set(names)
        assert all(m["moves"] in moved for m in cell.per_layer)


def test_every_configuration_and_metric_is_used():
    cells = BENCH["workloads"]
    assert {c["name"] for c in BENCH["configs"]} == {w["config"] for w in cells}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", [])) <= {w["name"] for w in cells}


def test_a_metric_added_as_a_file_is_picked_up(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = bench["workloads"][0]["name"]
    bench["per_layer"].append({"name": "calls_seen.test", "unit": "calls", "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "setup_s", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "portbench" / "metrics" / "calls_seen.test.py").write_text(
        "def read(record, cell):\n    return len(record['calls'])\n")
    loaded = spec.load_cell(cell, tmp_path)
    assert "calls_seen.test" in [m["name"] for m in loaded.per_layer]
    assert spec.metric("calls_seen.test", tmp_path).read({"calls": [1, 2, 3]}, loaded) == 3
