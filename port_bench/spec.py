"""Find a cell's files by name: ``BENCHMARK.json`` at the checkout's root,
``configs/<config>.json``, ``mixes/<traffic>.json``,
``limits/<cell>.json``."""
from __future__ import annotations

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _load(ROOT / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return _load(ROOT / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def mix(name: str) -> dict:
    return _load(HERE / "mixes" / f"{name}.json")


def limits(cell: str) -> dict:
    """The limit of each number the judge compares in ``cell``."""
    path = HERE / "limits" / f"{cell}.json"
    return _load(path)["limits"] if path.is_file() else {}


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]
