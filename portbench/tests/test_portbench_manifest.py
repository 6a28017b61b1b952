"""BENCHMARK.json keeps to the benchmark's contract, and every name in
it finds its files."""
import json
import math
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
E2E = {m["name"]: m for m in BENCH["end_to_end"]}


def reports(metric, workload):
    return workload in metric.get("workloads", [workload])


def test_top_level_keys_and_sizes():
    assert set(BENCH) == KEYS
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16
    assert len(BENCH["command"]) <= 32


def test_paths_and_command_stay_inside_the_benchmark():
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
        assert not p.startswith("/") and not p.endswith("_torch")
        assert (ROOT / p).is_dir()
    for word in BENCH["command"][1:]:
        assert not word.startswith("/") and ".." not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_unique_and_plain(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_entries_have_just_the_contract_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                           "source"}
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                           "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_text_fields_are_one_short_line():
    texts = ([c["source"] for c in BENCH["configs"]]
             + [e["why"] for e in BENCH["configs"] + BENCH["workloads"]]
             + [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"])
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t


def test_units_and_directions():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert E2E["setup_s"]["bound"] <= 0.25


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = [m for m in BENCH["end_to_end"] if reports(m, w["name"])]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert any(reports(m, w["name"]) for m in BENCH["per_layer"])


def test_each_layer_metric_moves_an_end_to_end_metric_its_cells_report():
    for m in BENCH["per_layer"]:
        assert m["moves"] in E2E
        for w in m.get("workloads", [x["name"] for x in BENCH["workloads"]]):
            assert reports(E2E[m["moves"]], w), (m["name"], w)


def test_four_chip_cells_are_few():
    n = len(BENCH["workloads"])
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, math.floor(0.25 * n))


def test_a_cell_is_a_pair_of_files_each_found_by_name():
    configs = {c["name"]: c for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(configs)
    for c in BENCH["configs"]:
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        assert (ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        traffic = ROOT / "portbench" / "traffic" / f"{w['traffic']}.json"
        driver = json.loads(traffic.read_text())["driver"]
        assert (ROOT / "portbench" / "drivers" / f"{driver}.py").is_file()
        limits = json.loads((ROOT / "portbench" / "cells"
                             / f"{w['name']}.json").read_text())["limits"]
        assert limits and all(v > 0 for v in limits.values())


def test_every_metric_has_a_reader():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()


def test_a_run_of_the_full_check_fits_its_time():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200
