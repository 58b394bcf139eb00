"""Finds what a cell is made of, by the names in `BENCHMARK.json`.

A cell (`workloads` entry) names a configuration and a traffic mix. The
configuration's file is the entry's `file`; the mix is
`portbench/mixes/<traffic>.json`, whose `kind` names its driver,
`portbench/drivers/<kind>.py`; each metric is read by
`portbench/metrics/<name>.py`. A new cell, mix, driver or metric is a new
file and a new entry: nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    root: Path


def _entry(entries: list[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of `root/BENCHMARK.json`, with its configuration,
    its mix and the metrics it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    w = _entry(bench["workloads"], name, "workload")
    c = _entry(bench["configs"], w["config"], "configuration")
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Cell(name=name, chips=int(w["chips"]), config=json.loads((root / c["file"]).read_text()),
                mix=json.loads((root / "portbench" / "mixes" / f"{w['traffic']}.json").read_text()),
                end_to_end=e2e, per_layer=per_layer, root=root)


def _module(path: Path) -> ModuleType:
    if not path.exists():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(f"portbench_{path.parent.name}_{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(kind: str, root: Path = ROOT) -> ModuleType:
    """The driver of a mix's `kind`: `portbench/drivers/<kind>.py`."""
    return _module(root / "portbench" / "drivers" / f"{kind}.py")


def metric(name: str, root: Path = ROOT) -> ModuleType:
    """The reader of metric `name`: `portbench/metrics/<name>.py`, whose
    `read(record, cell)` gives a number or None."""
    return _module(root / "portbench" / "metrics" / f"{name}.py")
