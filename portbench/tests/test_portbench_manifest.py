"""BENCHMARK.json against the benchmark's contract, and every name resolving
to its files."""

import json
import re
from pathlib import Path

import pytest

from conftest import PARKED
from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["portbench"]
    assert MANIFEST["command"] == ["python3", "portbench/run.py"]
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)
    assert len(json.dumps(MANIFEST)) < 64 * 1024


@pytest.mark.parametrize("entry", MANIFEST["configs"] + MANIFEST["workloads"]
                         + list(PARKED.values()) + METRICS, ids=lambda e: e["name"])
def test_names_units_and_texts(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert TEXT.match(entry[key]), key
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in entry.get("reduced", []):
        assert NAME.match(key)


def test_names_are_unique():
    for group in (MANIFEST["configs"], MANIFEST["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_entry_keys_and_bounds():
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in MANIFEST["end_to_end"]}
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in MANIFEST["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = harness.load_cell(cell)
    assert c.config["name"] == next(w["config"] for w in MANIFEST["workloads"]
                                    if w["name"] == cell)
    assert hasattr(c.driver, "setup") and hasattr(c.driver, "check")
    assert c.limits and all(v >= 0 for v in c.limits.values())
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert hasattr(harness.load_module(harness.BENCH / "metrics" / f"{m['name']}.py"),
                       "read")
    for m in c.per_layer:  # each reports the end-to-end metric it moves
        assert m["moves"] in names


@pytest.mark.parametrize("cell", sorted(PARKED))
def test_parked_cell_resolves_to_its_files(cell):
    """A cell left out of BENCHMARK.json keeps its files, ready for an entry."""
    c = harness.load_cell(cell, entry=PARKED[cell])
    assert c.config["name"] == PARKED[cell]["config"]
    assert hasattr(c.driver, "setup") and hasattr(c.driver, "check")
    assert c.limits and all(v >= 0 for v in c.limits.values())
    assert c.config["precision"] in ("bf16", "f32-tf32") and "precision" not in c.traffic


def test_precision_is_stated_once():
    """A configuration states the precision; no traffic mix does."""
    for f in sorted((harness.BENCH / "configs").glob("*.json")):
        assert harness.load_json(f)["precision"] in ("bf16", "f32-tf32"), f.name
    for f in sorted((harness.BENCH / "traffic").glob("*.json")):
        assert "precision" not in harness.load_json(f), f.name


def test_metric_workloads_name_cells_and_every_config_is_used():
    for m in METRICS:
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    assert {c["name"] for c in MANIFEST["configs"]} == {w["config"] for w in MANIFEST["workloads"]}
    for c in MANIFEST["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]


def test_four_chip_cells_within_share():
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_check_time_fits():
    cells = 24  # later PRs may fill every slot at this window
    runs = 2 + 14 * cells
    assert runs * (MANIFEST["run_seconds"] + 60) + cells * 180 + 1200 <= 43200

