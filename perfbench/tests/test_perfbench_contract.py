"""BENCHMARK.json against the contract's form: names, units, metrics'
cells and ``moves``, and the files each entry names."""

import json
import re
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word


def test_names_units_and_keys():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names)), kind
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and (REPO / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and NAME.match(w["traffic"]) and len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
            assert m["better"] == "higher"
    assert len(json.dumps(BENCH)) < 64 * 1024


def _reports(cell, metric):
    return cell in metric["workloads"] if "workloads" in metric else True


def test_every_cell_reports_setup_an_end_to_end_and_a_layer_metric():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in BENCH["end_to_end"] if _reports(w["name"], m)]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert any(_reports(w["name"], m) for m in BENCH["per_layer"]), w["name"]


def test_moves_points_at_a_metric_each_of_its_cells_reports():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s", m["name"]
        for cell in m.get("workloads", cells):
            assert cell in cells and _reports(cell, e2e[m["moves"]]), (m["name"], cell)


def test_each_entry_has_its_files():
    pb = REPO / "perfbench"
    for w in BENCH["workloads"]:
        traffic = json.loads((pb / "traffic" / f"{w['traffic']}.json").read_text())
        assert (pb / "drivers" / f"{traffic['driver']}.py").is_file()
        assert (pb / "limits" / f"{w['name']}.json").is_file()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (pb / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_a_full_check_fits_its_time_with_24_cells():
    r = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200
