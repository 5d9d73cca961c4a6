"""BENCHMARK.json and the files it names: names, units, keys and the budget."""

from __future__ import annotations

import json
import re

from bench_helpers import ROOT

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def man():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_command():
    m = man()
    assert set(m) == TOP
    assert m["command"] == ["python3", "benchmark/run.py"] and m["paths"] == ["benchmark"]
    assert 1 <= m["run_seconds"] <= 51 and isinstance(m["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entry_keys():
    m = man()
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
    for section in ("end_to_end", "per_layer"):
        for metric in m[section]:
            assert NAME.match(metric["name"]) and UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    for metric in m["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert metric["source"] in ("host_clock", "device_trace") and 0.01 <= metric["bound"] <= 0.25
    perf = (ROOT / "PERF.md").read_text()
    e2e = {x["name"]: x for x in m["end_to_end"]}
    for metric in m["per_layer"]:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert metric["moves"] in e2e
        for cell in metric["workloads"]:  # each cell listed reports the metric it moves
            assert "workloads" not in e2e[metric["moves"]] or cell in e2e[metric["moves"]]["workloads"]
        assert f"\n| {metric['layer']} |" in perf  # a row of PERF.md's list of layers
    names = [x["name"] for s in ("end_to_end", "per_layer") for x in m[s]]
    assert len(names) == len(set(names)) and "setup_s" in names


def test_every_cell_finds_its_files_by_name():
    m = man()
    configs = {c["name"]: c for c in m["configs"]}
    for w in m["workloads"]:
        workload, config = harness.cell_files(w["name"])
        for key in ("config", "traffic", "chips", "why"):
            assert workload[key] == w[key]
        assert config["name"] == w["config"] and (ROOT / configs[w["config"]]["file"]).is_file()
        assert all(k in config for k in configs[w["config"]]["reduced"])
        assert (harness.HERE / "traffic" / f"{workload['driver']}.py").is_file()
        assert set(workload["params"]["limits"])
        e2e = harness.cell_metrics(m, w["name"], "end_to_end")
        assert "setup_s" in [x["name"] for x in e2e] and len(e2e) >= 2
        assert harness.cell_metrics(m, w["name"], "per_layer")
    for metric in m["per_layer"]:
        assert (harness.HERE / "metrics" / f"{metric['name']}.py").is_file()
    assert {w["config"] for w in m["workloads"]} == set(configs)


def test_budget_fits_the_full_benchmark():
    m = man()
    runs = 2 + 14 * 24
    assert runs * (m["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    four = sum(w["chips"] == 4 for w in m["workloads"])
    assert four <= max(1, len(m["workloads"]) // 4)
