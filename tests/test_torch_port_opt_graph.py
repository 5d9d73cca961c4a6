"""The OPT block engine's steps as captured CUDA graphs
(``refine/opt_graph.py``, ``opt_engine._StageGraph``).

On the CPU: the graph's path (``run_stage(..., _graph=True)``, uncaptured
there) gives the eager engine's bits through a kept graph, over batches and
epochs; the function a capture records reads no host data and waits on no
device value (which a capture cannot do); and the graph engages only on the
default frozen-triangle payload or a stage that skips collision, outside a
shard, with Adam. On the card (``pytest.mark.cuda``, B=64, ``opt_default``
at epoch 12: a superblock with a payload rebuild, a tail block and
snapshots): ``optimize_batch`` through the graphs gives the eager engine's
refined params and results bit for bit, or differs by no more than two
eager runs differ; four captures on the first call, none after, and a
replay for every step. Then 16 keys and two batch sizes on one key,
captured into one memory pool in turns, each run held to the eager bits
the same way. This file imports nothing of JAX; on the GPU machine:

    python3 -m pytest --noconftest -m cuda tests/test_torch_port_opt_graph.py
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from ihmr_tpu_torch import profiling
from ihmr_tpu_torch.data import make_opt_inputs
from ihmr_tpu_torch.device import set_fp32_matmul_precision
from ihmr_tpu_torch.mano import synthetic_mano_model
from ihmr_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch
from ihmr_tpu_torch.refine import OptConfig, opt_default, optimize_batch
from ihmr_tpu_torch.refine import opt_engine as TE

GRAPH_COUNTERS = ("opt.graph_captures", "opt.graph_replays", "opt.steps")


def _stages(epoch):
    return tuple(dataclasses.replace(s, epoch=epoch) for s in opt_default)


def _collision_weighed_0(stages):
    return tuple(dataclasses.replace(s, loss_weights=tuple(
        (k, 0.0 if k == "collision_loss_weight" else w) for k, w in s.loss_weights)) for s in stages)


def _changed(before, after):
    return {k: after.get(k, 0) - before.get(k, 0) for k in GRAPH_COUNTERS}


def _run_stages(model, params, batch, stages, config, graph):
    """The stages chained through ``run_stage`` -> (params, counter changes)."""
    before = profiling.counters()
    for stage in stages:
        params = TE.run_stage(model, params, batch, stage, config, _graph=graph)
    return params, _changed(before, profiling.counters())


def _bits_equal(a, b):
    return all(torch.equal(a[k], b[k]) for k in a) and a.keys() == b.keys()


@pytest.mark.parametrize("hoist", [True, False], ids=["hoisted", "full_decode"])
def test_graph_path_gives_the_eager_bits(hoist):
    """Two batches at epoch 12, then one at epoch 20, through one cache
    (the graphs are kept per model: this test's model starts with none)."""
    torch.set_num_threads(2)
    mano = synthetic_mano_model(device="cpu")
    config = OptConfig(save_mid_freq=10, stage_hoist_decode=hoist)
    for n, (seed, epoch) in enumerate([(0, 12), (1, 12), (1, 20)]):
        params, batch = make_opt_inputs(mano, batch=3, seed=seed)
        eager, _ = _run_stages(mano, params, batch, _stages(epoch), config, graph=False)
        graphed, counts = _run_stages(mano, params, batch, _stages(epoch), config, graph=True)
        assert _bits_equal(eager, graphed), (seed, epoch)
        assert counts == {"opt.graph_captures": 4 if n == 0 else 0, "opt.graph_replays": 4 * (epoch + 1),
                          "opt.steps": 4 * (epoch + 1)}


_HOST_CALLS = {
    torch.tensor, torch.as_tensor, torch.from_numpy, torch.Tensor.new_tensor, torch.Tensor.item,
    torch.Tensor.tolist, torch.Tensor.numpy, torch.Tensor.cpu, torch.Tensor.__bool__, torch.Tensor.__float__,
    torch.Tensor.__int__, torch.Tensor.__index__, torch.nonzero, torch.Tensor.nonzero, torch.masked_select,
    torch.Tensor.masked_select, torch.unique, torch.Tensor.unique,
}


class _HostTraffic(TorchFunctionMode):
    """Records the calls that copy host data to the device (a tensor made
    from Python or numpy values, an index given as a list or an array) or
    wait for a device value (a read to the host, a shape that depends on
    the data): none of them can be captured in a CUDA graph."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in _HOST_CALLS:
            self.calls.append(getattr(func, "__name__", str(func)))
        elif func in (torch.Tensor.__getitem__, torch.Tensor.__setitem__):
            index = args[1] if isinstance(args[1], tuple) else (args[1],)
            if any(isinstance(i, (list, np.ndarray)) for i in index):
                self.calls.append(f"{func.__name__} {args[1]!r}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("hoist", [True, False], ids=["hoisted", "full_decode"])
def test_captured_step_has_no_host_traffic(hoist, monkeypatch):
    """Every call of the step a capture records, the warm-up's included,
    after an eager run has made the decode's device constants."""
    mano = synthetic_mano_model(device="cpu")
    params, batch = make_opt_inputs(mano, batch=2, seed=0)
    config = OptConfig(save_mid_freq=2, stage_hoist_decode=hoist)
    _run_stages(mano, params, batch, _stages(3), config, graph=False)
    traffic = _HostTraffic()
    step = TE._StageGraph._step

    def watched(self):
        with traffic:
            return step(self)

    monkeypatch.setattr(TE._StageGraph, "_step", watched)
    _, counts = _run_stages(mano, params, batch, _stages(3), config, graph=True)
    assert counts["opt.graph_replays"] == 16
    assert traffic.calls == []


_DEFAULT = OptConfig(save_mid_freq=2)
_IDX = _DEFAULT.replace(loop_collision_freeze_positions=False)
_PATHS = {  # path -> (config, collision weighed 0, whether a graph engages on a card; None: not asked)
    "default": (_DEFAULT, False, True),
    "idx": (_IDX, False, False),
    "idx_weight_0": (_IDX, True, True),
    "per_step_selection": (_DEFAULT.replace(loop_collision_lazy_reselect=False), False, False),
    "grid": (_DEFAULT.replace(loop_collision_fast=False, collision_backend="grid", grid_res=4), False, False),
    "parity": (_DEFAULT.replace(loop_collision_alternate=True), False, False),
    "sgd": (_DEFAULT.replace(optimizer="sgd"), False, False),
    "run_stage_program": (_DEFAULT, False, None),
    "shard": (_DEFAULT, False, False),
    "cpu": (_DEFAULT, False, False),
}


@pytest.mark.parametrize("path", list(_PATHS))
def test_graph_engages_only_where_safe(path):
    """``_engages`` asked of each stage, on a card (but in the case
    ``cpu``): the default payload's stages capture, and so do stages whose
    collision weight is 0 on any payload (``idx_weight_0``); the frozen
    selection, per-step selection, grid, parity and SGD paths and a shard
    of a one-device mesh step eagerly. Each path then runs on the CPU with
    no capture and no replay (``run_stage_program`` too); where a graph
    engages, its path forced on the CPU gives the eager bits."""
    mano = synthetic_mano_model(device="cpu")
    params, batch = make_opt_inputs(mano, batch=2, seed=0)
    config, zero_collision, engages = _PATHS[path]
    stages = _stages(3)
    if zero_collision:
        stages = _collision_weighed_0(stages)
    asked = torch.device("cpu" if path == "cpu" else "cuda")
    run = TE.run_stage_program if path == "run_stage_program" else TE.run_stage
    seen = []

    def chained(model, p, b):
        for stage in stages:
            seen.append(TE._engages(config, stage, True, asked))
            p = run(model, p, b, stage, config)
        return p

    before = profiling.counters()
    if path == "shard":
        mesh = make_mesh([torch.device("cpu")])
        mesh.map(chained, replicate(mano, mesh), shard_batch(params, mesh), shard_batch(batch, mesh))
        eager = None
    else:
        eager = chained(mano, params, batch)
    counts = _changed(before, profiling.counters())
    assert counts == {"opt.graph_captures": 0, "opt.graph_replays": 0, "opt.steps": 16}
    if engages is not None:
        assert seen == [engages] * 4
    if engages:
        graphed, counts = _run_stages(mano, params, batch, stages, config, graph=True)
        assert _bits_equal(eager, graphed)
        assert counts == {"opt.graph_captures": 4, "opt.graph_replays": 16, "opt.steps": 16}


def test_forcing_a_graph_on_another_path_raises():
    mano = synthetic_mano_model(device="cpu")
    params, batch = make_opt_inputs(mano, batch=2, seed=0)
    with pytest.raises(ValueError, match="no graph"):
        TE.run_stage(mano, params, batch, opt_default[1], _IDX, _graph=True)


# ---- on the card ----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA graph has no CPU mode)")
    set_fp32_matmul_precision()
    return torch.device("cuda")


def _optimize(mano, params, batch, stages, config, graph, monkeypatch):
    """``optimize_batch`` with the steps captured or eager -> (params,
    results, counter changes)."""
    with monkeypatch.context() as m:
        if not graph:
            m.setattr(TE, "_engages", lambda *args: False)
        before = profiling.counters()
        out, results = optimize_batch(mano, params, batch, stages, config)
        torch.cuda.synchronize()
        return out, results, _changed(before, profiling.counters())


def _gap(a, b):
    return max(float((a[k].double() - b[k].double()).abs().max()) for k in a)


def _held_to_eager(ref, other, got, what):
    """``got`` equals the eager run ``ref`` bit for bit, or differs from it
    by no more than the second eager run ``other`` does."""
    assert got.keys() == ref.keys()
    if not _bits_equal(ref, got):
        assert _gap(ref, got) <= _gap(ref, other), (what, _gap(ref, got), _gap(ref, other))


@pytest.mark.cuda
@pytest.mark.parametrize("hoist", [True, False], ids=["hoisted", "full_decode"])
def test_graphs_give_the_eager_bits_on_the_card(cuda, hoist, monkeypatch):
    """Two batches at epoch 12 (seeds 0 and 1), then seed 1 at epoch 20,
    through one cache; each against two eager runs of the same batch."""
    mano = synthetic_mano_model(device=cuda)
    config = OptConfig(save_mid_freq=10, stage_hoist_decode=hoist)
    for n, (seed, epoch) in enumerate([(0, 12), (1, 12), (1, 20)]):
        params, batch = make_opt_inputs(mano, batch=64, seed=seed)
        stages = _stages(epoch)
        eager = [_optimize(mano, params, batch, stages, config, False, monkeypatch) for _ in range(2)]
        out, results, counts = _optimize(mano, params, batch, stages, config, True, monkeypatch)
        assert eager[0][2]["opt.graph_replays"] == 0
        assert counts == {"opt.graph_captures": 4 if n == 0 else 0, "opt.graph_replays": 4 * (epoch + 1),
                          "opt.steps": 4 * (epoch + 1)}
        for i, got in ((0, out), (1, results)):
            _held_to_eager(eager[0][i], eager[1][i], got, (seed, epoch, i))


@pytest.mark.cuda
def test_keys_and_batch_sizes_share_one_pool_on_the_card(cuda):
    """Four strategies of four stages each (16 keys: ``opt_default``, its
    learning rates halved, its collision weighed 0, and the frozen-selection
    config's weight-0 stages) and one strategy at B=8, 16 and 8 again, in
    turns, every capture into the device's one pool: each run through
    ``run_stage`` equals two eager runs of the same inputs bit for bit or
    differs by no more than they differ, and captures exactly where a key
    is new or its batch size changed."""
    mano = synthetic_mano_model(device=cuda)
    config = OptConfig(save_mid_freq=5)
    halved = tuple(dataclasses.replace(s, lr=s.lr / 2) for s in _stages(6))
    zero = _collision_weighed_0(_stages(6))
    idx = config.replace(loop_collision_freeze_positions=False)
    families = {"default": (_stages(6), config), "halved": (halved, config), "zero": (zero, config),
                "idx_zero": (zero, idx)}
    turns = [("default", 8, 4), ("halved", 8, 4), ("zero", 8, 4), ("default", 16, 4), ("idx_zero", 8, 4),
             ("default", 8, 4), ("halved", 8, 0), ("zero", 16, 4), ("default", 8, 0), ("idx_zero", 8, 0)]
    for n, (family, B, captures) in enumerate(turns):
        stages, cfg = families[family]
        params, batch = make_opt_inputs(mano, batch=B, seed=n)
        eager = [_run_stages(mano, params, batch, stages, cfg, graph=False)[0] for _ in range(2)]
        graphed, counts = _run_stages(mano, params, batch, stages, cfg, graph=None)
        torch.cuda.synchronize()
        assert counts == {"opt.graph_captures": captures, "opt.graph_replays": 28, "opt.steps": 28}, (n, family)
        _held_to_eager(eager[0], eager[1], graphed, (n, family, B))
