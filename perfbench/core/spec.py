"""A cell as ``BENCHMARK.json`` names it, with its configuration, its
traffic mix, its limits and the metrics it reports, each found by name."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Any, Dict, List

PB = Path(__file__).resolve().parents[1]          # perfbench/
ROOT = PB.parent                                   # the checkout


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]        # perfbench/configs/<config>.json
    traffic: Dict[str, Any]       # perfbench/traffic/<traffic>.json
    limits: Dict[str, float]      # perfbench/cells/<cell>.json "limits"
    end_to_end: List[dict]        # BENCHMARK.json entries this cell reports
    per_layer: List[dict]


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str, moves_reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", "") in moves_reported


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``; KeyError if absent."""
    bench = read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json "
                       f"(cells: {sorted(cells)})")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = read_json(root / cfg_entry["file"])
    traffic = read_json(PB / "traffic" / f"{w['traffic']}.json")
    limits = read_json(PB / "cells" / f"{name}.json")["limits"]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    moves = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, moves)]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits, end_to_end=e2e,
                per_layer=per_layer)


def load_module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py`` as a module (names may hold dots,
    so it is loaded by path)."""
    path = PB / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
