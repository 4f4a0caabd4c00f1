"""BENCHMARK.json is whole: every name, unit and file it gives exists and
keeps the characters the format allows, and every cell finds its
configuration, its traffic, and a reader for each per-layer metric."""

import json
import os
import re

import pytest

from cell import BENCH_DIR, ROOT, load_cell

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def test_top_level_keys_and_paths():
    assert set(BENCH) == TOP_KEYS
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"][1] == "benchmark/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_and_units():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_configs_are_files_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("benchmark/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"] == []


def test_four_chip_cells_are_a_quarter_at_most():
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_finds_its_files(cell):
    c = load_cell(cell)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert os.path.exists(os.path.join(BENCH_DIR, "metrics",
                                           m["name"] + ".py"))
        assert m["moves"] in names
    assert set(c.traffic["limits"]) and c.traffic["driver"] in (
        "characterise", "collect")
