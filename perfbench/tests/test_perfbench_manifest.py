"""``BENCHMARK.json`` against the benchmark's contract, and every piece a
cell names present as a file of its own."""
import json
import re

import pytest

from perfbench.core.spec import PB, ROOT, load_cell, load_module, read_json

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = read_json(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = 24           # the most a later benchmark may hold
    runs = 2 + 14 * cells
    assert runs * (BENCH["run_seconds"] + 60) + cells * 180 + 1200 \
        <= 43200
    for p in BENCH["paths"]:
        assert (ROOT / p).is_dir() and not p.startswith("/")
    assert not any(w.startswith("/") or ".." in w
                   for w in BENCH["command"])


def test_names_units_and_entries():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]) and e["name"] not in seen
            seen.add(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        assert set(m["workloads"]) <= set(CELLS)


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_finds_its_files(name):
    cell = load_cell(name)
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    assert cell.chips == 1
    load_module("drivers", cell.traffic["entry"])
    for m in cell.per_layer:
        assert hasattr(load_module("metrics", m["name"]), "read")
        assert m["moves"] in e2e
    w = {x["name"]: x for x in BENCH["workloads"]}[name]
    assert len(w["why"]) <= 200
    assert all(v > 0 for v in cell.limits.values())


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_configs_state_what_they_cut(entry):
    cfg = read_json(ROOT / entry["file"])
    assert set(entry["reduced"]) == set(cfg["reduced"])
    assert entry["file"].startswith("perfbench/configs/")
    widths = ("hidden_size", "intermediate_size", "num_attention_heads",
              "state_size", "conv_kernel", "time_step_rank", "expand")
    assert not set(entry["reduced"]) & set(widths)
    port = cfg["port"]
    assert port["num_layers"] == cfg["num_hidden_layers"]
    assert port["d_model"] == cfg["hidden_size"]
    assert port["vocab_size"] == cfg["vocab_size"]


def test_every_metric_has_a_reader_and_no_reader_is_orphaned():
    names = {m["name"] for m in BENCH["per_layer"]}
    files = {p.name[:-3] for p in (PB / "metrics").glob("*.py")}
    assert names == files
