"""The control of each cell's check fails it: the plain reference in the
program's place, with TF32 on where the configuration states float32
without it, at a size a test run holds. Needs a card (TF32 exists only
there); the full-size readings come from ``benchmark/control.py``."""

from __future__ import annotations

import pytest

from bench_helpers import cuda_device, tiny_cell
from benchmark import control, harness


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["opt_b1024", "train_b256", "train_b64"])
def test_control_fails_the_check(cell):
    device = cuda_device()
    workload, config = tiny_cell(cell)
    config["image_size"] = 224
    workload["params"]["batch"] = 16 if workload["driver"] == "opt_batches" else 8
    mod = harness.load_file(harness.HERE / "traffic" / f"{workload['driver']}.py", "control_test_driver")
    case = control.opt_case if workload["driver"] == "opt_batches" else control.train_case
    gaps = case(mod, config, workload["params"], 21, device, "control")
    limits = workload["params"]["limits"]
    assert any(gaps[k] > v for k, v in limits.items()), gaps
