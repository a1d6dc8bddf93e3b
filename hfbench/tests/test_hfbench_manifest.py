"""``BENCHMARK.json`` against the rules it is checked by: its keys, names,
units and lengths, every ``moves`` naming an end-to-end metric that each of
its cells reports, and every file it names present under its paths."""

from __future__ import annotations

import json
import re

import pytest

from hfbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
DATA = manifest.load()
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def one_line(text, most=200):
    return (isinstance(text, str) and 1 <= len(text) <= most
            and "\n" not in text and "\t" not in text)


def test_keys_and_size():
    assert set(DATA) == KEYS
    assert len((manifest.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= DATA["run_seconds"] <= 51
    assert isinstance(DATA["run_seconds"], int)


def test_command_and_paths():
    assert 1 <= len(DATA["paths"]) <= 16
    for p in DATA["paths"]:
        assert PATH.match(p) and ".." not in p and not p.startswith("/")
    assert len(DATA["command"]) <= 32
    assert all(one_line(w) for w in DATA["command"])
    for word in DATA["command"]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in DATA["paths"])


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_are_names_and_unique(group):
    names = [e["name"] for e in DATA[group]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs():
    assert 1 <= len(DATA["configs"]) <= 24
    used = {w["config"] for w in DATA["workloads"]}
    files = [c["file"] for c in DATA["configs"]]
    assert len(files) == len(set(files))
    for c in DATA["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert one_line(c["source"]) and one_line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in DATA["paths"])
        config = manifest.read_json(manifest.ROOT / c["file"])
        assert config["name"] == c["name"]
        assert config["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_workloads():
    assert 1 <= len(DATA["workloads"]) <= 24
    pairs = [(w["config"], w["traffic"]) for w in DATA["workloads"]]
    assert len(pairs) == len(set(pairs))
    fours = sum(w["chips"] == 4 for w in DATA["workloads"])
    assert fours <= max(1, len(DATA["workloads"]) // 4)
    for w in DATA["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert one_line(w["why"])
        traffic = manifest.read_json(
            manifest.ROOT / "hfbench" / "cells" / f"{w['traffic']}.json")
        assert one_line(traffic["why"])


def test_metrics():
    e2e = DATA["end_to_end"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(DATA["per_layer"]) <= 128
    assert "setup_s" in [m["name"] for m in e2e]
    for m in e2e:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in e2e + DATA["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in DATA["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert one_line(m["layer"])
        reader = m["name"].split(".")[0]
        assert (manifest.HERE / "metrics" / f"{reader}.py").exists()
    layers = {}
    for m in DATA["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_every_moves_is_reported_in_its_cells():
    names = [w["name"] for w in DATA["workloads"]]
    for m in DATA["per_layer"]:
        target = [e for e in DATA["end_to_end"] if e["name"] == m["moves"]]
        assert len(target) == 1, m["name"]
        for cell in m.get("workloads", names):
            assert cell in names
            assert cell in target[0].get("workloads", names), (m["name"],
                                                               cell)


def test_every_cell_reports_enough():
    for w in DATA["workloads"]:
        cell = manifest.Cell(w["name"])
        e2e = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer


def test_a_full_check_fits_its_time():
    runs = 2 + 14 * 24
    seconds = runs * (DATA["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert seconds <= 43200


def test_limits_are_set_for_every_compared_number():
    for w in DATA["workloads"]:
        limits = manifest.Cell(w["name"]).traffic["limits"]
        # a null limit: the number is read, not compared (PERF.md says why)
        assert limits and all(v is None or isinstance(v, (int, float))
                              and v > 0 for v in limits.values()), w["name"]
        assert {"loss", "grad", "select", "update", "state"} <= set(limits)
        assert any(v is not None for v in limits.values())


def test_json_files_parse():
    for path in manifest.HERE.rglob("*.json"):
        json.loads(path.read_text())
