"""Helpers of the benchmark's tests (``python -m pytest benchmark/tests -q``
from the repository's root); the tests marked ``cuda`` run on a card and skip
without one."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def cuda_device():
    """The card, or a skip where there is none (decided inside the test)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def tiny_cell(name: str, **params):
    """A cell's workload and configuration cut to a size the CPU runs in
    seconds: 64x64 images, stages of 12 epochs, small batches."""
    from benchmark import harness

    workload, config = harness.cell_files(name)
    workload, config = copy.deepcopy(workload), copy.deepcopy(config)
    config["image_size"] = 64
    for stage in config.get("stages", ()):
        stage["epoch"] = 12
    if workload["driver"] == "opt_batches":
        workload["params"].update(batch=4, warm_epoch=2, check_hands=4, check_block=2)
    else:
        workload["params"].update(batch=4, label_sets=2, trace_steps=2)
    workload["params"].update(params)
    return workload, config
