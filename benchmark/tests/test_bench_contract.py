"""BENCHMARK.json keeps to the benchmark contract's form, and every cell
finds its files by name."""

import json
import os
import re

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = harness.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) and not p.startswith("/") and ".." not in p
                                                   for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keys_names_units(section):
    entries = BENCH[section]
    assert entries
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and section in ("configs", "workloads", "per_layer"):
                assert _line(e[key]), (e["name"], key)
        if section == "configs":
            assert len(e["reduced"]) <= 16 and all(NAME.match(k) for k in e["reduced"])
        if section == "workloads":
            assert NAME.match(e["config"]) and NAME.match(e["traffic"]) and e["chips"] in (1, 4)


def test_metric_sources_bounds_and_moves():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            assert cell in e2e[m["moves"]].get("workloads", CELLS), (m["name"], cell)


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = harness.Cell(name, BENCH)
    assert cell.entry().run and cell.reference().param_shapes(cell.config["args"])
    assert set(cell.limits) and all("limit" in v for v in cell.limits.values())
    assert any(m["name"] == "setup_s" for m in cell.end_to_end) and len(cell.end_to_end) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert (harness.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
    config = next(c for c in BENCH["configs"] if c["name"] == cell.spec["config"])
    assert os.path.samefile(harness.ROOT / config["file"], harness.BENCH_DIR / "configs" / f"{config['name']}.json")
    with open(harness.ROOT / config["file"]) as fp:
        assert json.load(fp)["reduced"] == config["reduced"]


def test_every_config_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
