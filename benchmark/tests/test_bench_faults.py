"""Each fault a cell can have, planted in the program underneath a run of the
harness (the look for a card skipped, the CPU standing in, tiny sizes),
turns ``correct`` false; the sound program keeps it true."""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from bench_helpers import ROOT, tiny_cell

import benchmark.run as run


def unchanged_state(monkeypatch):
    from ihmr_tpu_torch.refine import adam

    monkeypatch.setattr(adam.Adam, "step", lambda self, params, grads, lr: dict(params))


def half_batch_opt(monkeypatch):
    """Half of the batch left out of every update: the mean over the rest
    gives the other half the same Adam steps."""
    from ihmr_tpu_torch.refine import adam

    real = adam.Adam.step

    def step(self, params, grads, lr):
        out = real(self, params, grads, lr)
        return {k: torch.cat([out[k][: len(v) // 2], v[len(v) // 2:]]) for k, v in params.items()}

    monkeypatch.setattr(adam.Adam, "step", step)


def half_batch_train(monkeypatch):
    """The loss a mean over the first half of the batch."""
    from ihmr_tpu_torch.train import baseline

    real = baseline.forward_and_loss

    def forward_and_loss(encoder, mean_params, batch, *args, **kwargs):
        half = batch.img.shape[0] // 2
        cut = {f.name: getattr(batch, f.name)[:half] for f in dataclasses.fields(batch)}
        return real(encoder, mean_params, dataclasses.replace(batch, **cut), *args, **kwargs)

    monkeypatch.setattr(baseline, "forward_and_loss", forward_and_loss)


def altered_depth(monkeypatch):
    """One vertex's exact depth altered where the final pass produces it."""
    from ihmr_tpu_torch.ops import collision

    real = collision.pair_parity_filter

    def pair_parity_filter(*args, **kwargs):
        d = real(*args, **kwargs).clone()
        d[0, 5] += 1e-2
        return d

    monkeypatch.setattr(collision, "pair_parity_filter", pair_parity_filter)


def altered_loss(monkeypatch):
    """The loss a train step reports altered where it is produced."""
    from ihmr_tpu_torch.train import baseline

    real = baseline.train_step

    def train_step(*args, **kwargs):
        state, metrics = real(*args, **kwargs)
        return state, {**metrics, "total_loss": metrics["total_loss"] * 1.01}

    monkeypatch.setattr(baseline, "train_step", train_step)


CASES = [
    ("opt_b1024", None), ("opt_b1024", unchanged_state), ("opt_b1024", half_batch_opt), ("opt_b1024", altered_depth),
    ("train_b64", None), ("train_b64", unchanged_state), ("train_b64", half_batch_train), ("train_b64", altered_loss),
]


@pytest.mark.parametrize("cell,fault", CASES, ids=[f"{c}-{f.__name__ if f else 'sound'}" for c, f in CASES])
def test_planted_fault_turns_correct_false(cell, fault, monkeypatch):
    workload, config = tiny_cell(cell)
    if fault is not None:
        fault(monkeypatch)
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    torch.manual_seed(0)
    res = run.run_cell(cell, workload, config, man, 2**31 + 17, 0.05, 0, torch.device("cpu"))
    assert res["correct"] is (fault is None), res["checks"]
