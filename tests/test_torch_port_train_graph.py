"""The IHMR-Baseline train step as one CUDA graph
(``train.baseline.train_step``, ``_StaticStep``, ``refine/opt_graph.StepGraph``),
on the CPU (ResNet-18 at 64x64, B=2; the card's side is
``tests/test_torch_port_train_graph_cuda.py``, which holds the helpers).

``train_step``'s graph path, which calls the static function directly
here, gives the eager step's bits (the forward and losses,
``autograd.grad``, ``Adam.step(lr_last=True)`` and the parameters'
``copy_``) over 3 steps with the learning rate changed before the third:
parameters, both moments, running statistics and every metric;
``adam_update_`` with ``lr_last=True`` gives ``Adam.step``'s bits for steps
1..5; the function a capture records reads no host data and waits on no
device value; with the collision loss the same function runs directly,
with no graph, and gives the eager bits too; a new batch size
rebuilds the graph, and dropping the state frees it at once.
"""

from __future__ import annotations

import dataclasses
import gc
import weakref

from ihmr_tpu_torch import profiling
from ihmr_tpu_torch.train import baseline as TB
from tests.test_torch_port_opt_graph import _HostTraffic
from tests.test_torch_port_train_graph_cuda import (
    assert_same_bits,
    check_adam_update_lr_last,
    eager_step,
    make_inputs,
    three_steps,
)
from tests.torch_threads import one_torch_thread  # noqa: F401


def test_graph_path_gives_the_eager_bits():
    graphed, eager = make_inputs("cpu"), make_inputs("cpu")
    g_metrics, counts = three_steps(graphed, TB.train_step)
    e_metrics, _ = three_steps(eager, eager_step)
    assert_same_bits(graphed, eager, g_metrics, e_metrics)
    assert counts == {"train.graph_captures": 1, "train.graph_replays": 3, "train.steps": 3, "k3.launches": 0}


def test_adam_update_lr_last_matches_adam_step():
    check_adam_update_lr_last("cpu")


def test_captured_step_has_no_host_traffic(monkeypatch):
    """Every call of the static step (the warm-up's and the capture's on a
    card), after an eager step has made the decode's device constants."""
    inputs = make_inputs("cpu")
    eager_step(inputs.state, inputs.batch, inputs.mano_right, inputs.mano_left, inputs.config)
    traffic = _HostTraffic()
    call = TB._StaticStep.__call__

    def watched(self):
        with traffic:
            return call(self)

    monkeypatch.setattr(TB._StaticStep, "__call__", watched)
    _, counts = three_steps(inputs, TB.train_step)
    assert counts["train.graph_replays"] == 3
    assert traffic.calls == []


def test_collision_loss_steps_eagerly():
    """Payloads of data-dependent shapes: the static function called
    directly on the caller's batch, no graph kept, and the eager step's
    bits."""
    inputs, eager = (make_inputs("cpu") for _ in range(2))
    inputs, eager = (dataclasses.replace(x, config=dataclasses.replace(x.config, use_collision_loss=True))
                     for x in (inputs, eager))
    metrics, counts = three_steps(inputs, TB.train_step)
    e_metrics, _ = three_steps(eager, eager_step)
    assert counts == {"train.graph_captures": 0, "train.graph_replays": 0, "train.steps": 3, "k3.launches": 0}
    assert inputs.state.graphs == {} and "collision_loss" in metrics[0]
    assert_same_bits(inputs, eager, metrics, e_metrics)


def test_a_new_batch_size_rebuilds_and_a_dropped_state_frees_the_graph():
    inputs = make_inputs("cpu")
    small = make_inputs("cpu", batch=1, seed=1).batch
    before = profiling.counters()
    for batch in (inputs.batch, inputs.batch, small, small, inputs.batch):
        TB.train_step(inputs.state, batch, inputs.mano_right, inputs.mano_left, inputs.config)
    assert profiling.counters()["train.graph_captures"] - before.get("train.graph_captures", 0) == 3
    (kept,) = inputs.state.graphs.values()
    graph = weakref.ref(kept[1])
    gc.disable()  # freed by reference counts alone, as the benchmark frees it before its check
    try:
        del kept, inputs
        assert graph() is None
    finally:
        gc.enable()
