"""BENCHMARK.json against the benchmark's contract: its keys, names, units
and limits, and that every name it uses finds its file."""

import json
import os
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}


@pytest.fixture(scope="module")
def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_keys_and_size(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51


def test_command_and_paths(spec):
    assert 1 <= len(spec["paths"]) <= 16
    for p in spec["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(ROOT, p))
    assert 1 <= len(spec["command"]) <= 32 and all(_line(w) for w in spec["command"])
    for word in spec["command"]:
        if "/" in word or word.endswith(".py"):
            assert not word.startswith("/") and ".." not in word.split("/")
            assert any(word == p or word.startswith(p + "/") for p in spec["paths"])


def test_names_units_and_entry_keys(spec):
    names = []
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in spec["paths"])
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in SOURCES_E2E and 0 < m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in (
            "lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))
    assert 1 <= len(spec["configs"]) <= 24 and 1 <= len(spec["workloads"]) <= 24
    assert 1 <= len(spec["end_to_end"]) <= 16 and 1 <= len(spec["per_layer"]) <= 128
    for group in ("configs", "workloads"):
        got = [x["name"] for x in spec[group]]
        assert len(got) == len(set(got))


def test_every_name_finds_its_file(spec):
    bench = os.path.join(ROOT, "benchmark")
    used = {w["config"] for w in spec["workloads"]}
    for c in spec["configs"]:
        assert c["name"] in used
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and cfg["why"] == c["why"]
    cells = {w["name"] for w in spec["workloads"]}
    for w in spec["workloads"]:
        with open(os.path.join(bench, "workloads", w["name"] + ".json")) as f:
            cell = json.load(f)
        assert (cell["name"], cell["config"], cell["traffic"], cell["why"]) == (
            w["name"], w["config"], w["traffic"], w["why"])
        assert os.path.exists(os.path.join(bench, "traffic", w["traffic"] + ".py"))
    for m in spec["per_layer"]:
        assert os.path.exists(os.path.join(bench, "metrics", m["name"] + ".py"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells


def test_every_cell_reports_what_it_must(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for w in spec["workloads"]:
        mine = [m for m in spec["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert len(mine) >= 2
        layer = [m for m in spec["per_layer"]
                 if w["name"] in m.get("workloads", [w["name"]])]
        assert layer
        for m in layer:
            assert m["moves"] in e2e and w["name"] in e2e[m["moves"]].get(
                "workloads", [w["name"]])


def test_layers_named_alike_and_rooflines(spec):
    for m in spec["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    moved = {m["moves"] for m in spec["per_layer"] if m["name"].endswith("_roofline")}
    for e in moved:
        assert any("mfu" in m["name"] and m["moves"] == e for m in spec["per_layer"])


def test_four_chip_cells_and_the_time_budget(spec):
    four = sum(w["chips"] == 4 for w in spec["workloads"])
    assert four <= max(1, len(spec["workloads"]) // 4)
    runs = 2 + 14 * 24
    assert runs * (spec["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
