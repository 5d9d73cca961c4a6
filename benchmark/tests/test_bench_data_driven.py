"""A new cell and a new per-layer metric are files and manifest entries only:
in a copy of the benchmark, a throwaway configuration, workload and metric
reader are found by name and run, with no existing file edited."""

from __future__ import annotations

import json
import shutil

import torch

from bench_helpers import ROOT, tiny_cell
from benchmark import harness


def test_harness_finds_and_runs_a_new_cell_by_name(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(harness.HERE, bench, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(bench): p.read_bytes() for p in bench.rglob("*") if p.is_file()}

    workload, config = tiny_cell("train_b64")
    config["name"] = "tiny_baseline"
    workload.update(name="train_tiny", config="tiny_baseline", traffic="train_closed_tiny")
    (bench / "configs" / "tiny_baseline.json").write_text(json.dumps(config))
    (bench / "workloads" / "train_tiny.json").write_text(json.dumps(workload))
    (bench / "metrics" / "steps_traced.train.py").write_text("def read(rec):\n    return float(rec['steps'])\n")
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in man["end_to_end"]:
        if m["name"] == "train_samples_per_s":
            m["workloads"].append("train_tiny")
    man["per_layer"] = [{"name": "steps_traced.train", "unit": "steps", "better": "higher", "source": "program_counter",
                         "layer": "train step", "moves": "train_samples_per_s", "workloads": ["train_tiny"]}]

    found_workload, found_config = harness.cell_files("train_tiny", bench)
    assert found_config["name"] == "tiny_baseline" and found_workload["driver"] == "train_steps"
    run = harness.load_file(bench / "run.py", "copied_run")
    torch.manual_seed(0)
    res = run.run_cell("train_tiny", found_workload, found_config, man, 5, 0.2, 0, torch.device("cpu"))
    assert set(res["metrics"]) == {"train_samples_per_s", "setup_s"} and res["correct"]
    res = run.run_cell("train_tiny", found_workload, found_config, man, 6, 0.2, 1, torch.device("cpu"))
    assert res["metrics"] == {"steps_traced.train": {"value": 2.0, "unit": "steps"}}

    after = {p.relative_to(bench): p.read_bytes() for p in bench.rglob("*") if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())  # nothing that was there changed
