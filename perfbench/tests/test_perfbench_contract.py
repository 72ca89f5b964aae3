"""BENCHMARK.json against the benchmark's contract, and every name in it
resolving to a file of the harness."""
from __future__ import annotations

import json
import re

import pytest

from perfbench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _text_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(section):
    entries = BENCH[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer"):
            if key in e:
                assert _text_ok(e[key]), (e["name"], key)
        if section == "configs":
            assert _text_ok(e["source"])


def test_metric_keys_and_sources():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            cells = e2e[m["moves"]].get("workloads")
            assert cells is None or cell in cells, (m["name"], cell)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_resolves_and_reports():
    cells = {w["name"]: w for w in BENCH["workloads"]}
    assert 1 <= len(cells) <= 24
    pairs = {(w["config"], w["traffic"]) for w in cells.values()}
    assert len(pairs) == len(cells)
    configs = {c["name"]: c for c in BENCH["configs"]}
    assert {w["config"] for w in cells.values()} == set(configs)
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(1, len(cells) // 4)
    for name, w in cells.items():
        assert _text_ok(w["why"]) and w["chips"] in (1, 4)
        cell = harness.load_cell(name)
        assert (cell.config_name, cell.traffic_name, cell.chips) == (w["config"], w["traffic"], w["chips"])
        assert (harness.HERE / "drivers" / f"{cell.kind}.py").exists()
        e2e = [m["name"] for m in BENCH["end_to_end"] if name in m.get("workloads", [name])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.per_layer_metrics(name, e2e)
    for c in BENCH["configs"]:
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        data = json.loads((harness.ROOT / c["file"]).read_text())
        assert sorted(c["reduced"]) == sorted(data["reduced"]) and len(c["reduced"]) <= 16
        assert data["source"] == c["source"] and c["source"].startswith("https://")


def test_every_per_layer_metric_has_a_reader():
    for m in BENCH["per_layer"]:
        mod = harness.load_module(harness.reader(m["name"]))
        assert mod.read({}) is None
