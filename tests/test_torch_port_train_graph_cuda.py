"""The IHMR-Baseline train step as one CUDA graph on the card
(``train.baseline.train_step``, ``_StaticStep``, ``refine/opt_graph.StepGraph``),
with the helpers that ``tests/test_torch_port_train_graph.py`` (the CPU
side) shares.

ResNet-50 at 224, B=8, K3, deterministic cuDNN: three replays against the
eager sequence (the forward and losses, ``autograd.grad``,
``Adam.step(lr_last=True)`` and the parameters' ``copy_``) bit for bit with
the learning rate changed before the third: parameters, both moments,
running statistics and every metric; one capture and a replay a step, K3's
wrapper run at the warm-up and the capture alone, a rebuild when B
changes; ``adam_update_`` with ``lr_last=True`` against ``Adam.step`` on
the card; and the capture's memory returned when the state is dropped. This file imports nothing of JAX and
nothing of ``tests``; on the GPU machine:

    python3 -m pytest --noconftest -m cuda tests/test_torch_port_train_graph_cuda.py
"""

from __future__ import annotations

import pytest
import torch

from ihmr_tpu_torch import profiling
from ihmr_tpu_torch.pipeline import make_train_bench_inputs
from ihmr_tpu_torch.refine.adam import Adam, adam_update_, bias_factors
from ihmr_tpu_torch.train import baseline as TB

COUNTERS = ("train.graph_captures", "train.graph_replays", "train.steps", "k3.launches")


def make_inputs(device, batch=2, image_size=64, arch="resnet18", seed=0):
    return make_train_bench_inputs(batch=batch, image_size=image_size, arch=arch, bn_impl="pallas", seed=seed,
                                   device=device)


def eager_step(state, batch, mano_right, mano_left, config):
    """The step as it ran before the graph: forward and losses,
    ``autograd.grad``, ``Adam.step`` and the parameters' ``copy_``."""
    encoder = state.encoder.train()
    total, metrics, _ = TB.forward_and_loss(encoder, state.mean_params, batch, mano_right, mano_left, config)
    params = dict(encoder.named_parameters())
    grads = torch.autograd.grad(total, list(params.values()))
    TB._adam_update(state, dict(zip(params, grads)))
    return {k: v.detach() for k, v in metrics.items()}


def three_steps(inputs, step):
    """Steps 1..3 on the inputs' batch, at lr 1e-4 then 3e-5 for the third
    -> (each step's metrics, counter changes)."""
    before = profiling.counters()
    metrics = []
    for i in range(3):
        if i == 2:
            TB.set_learning_rate(inputs.state, 3e-5)
        out = step(inputs.state, inputs.batch, inputs.mano_right, inputs.mano_left, inputs.config)
        metrics.append(out[1] if isinstance(out, tuple) else out)
    after = profiling.counters()
    return metrics, {k: after.get(k, 0) - before.get(k, 0) for k in COUNTERS}


def assert_same_bits(graphed, eager, graphed_metrics, eager_metrics):
    ga, ea = graphed.state, eager.state
    assert ga.adam.t == ea.adam.t == 3
    for k, v in ea.encoder.state_dict().items():  # parameters and running statistics
        assert torch.equal(ga.encoder.state_dict()[k], v), k
    for moments in ("m", "v"):
        theirs = getattr(ea.adam, moments)
        assert getattr(ga.adam, moments).keys() == theirs.keys()
        for k, v in theirs.items():
            assert torch.equal(getattr(ga.adam, moments)[k], v), (moments, k)
    for g, e in zip(graphed_metrics, eager_metrics):
        assert g.keys() == e.keys()
        for k in e:
            assert torch.equal(g[k], e[k]), k


def check_adam_update_lr_last(device):
    """Steps 1..5 of ``Adam(lr_last=True).step`` at a host lr against
    ``adam_update_(..., lr_last=True)`` reading lr and the bias corrections
    from 0-dim tensors filled as ``train_step`` fills them: the same bits."""
    gen = torch.Generator().manual_seed(3)
    shapes = {"w": (7, 5), "b": (5,)}
    start = {k: torch.randn(s, generator=gen).to(device) for k, s in shapes.items()}
    adam = Adam(start, lr_last=True)
    eager = dict(start)
    params = {k: x.clone() for k, x in start.items()}
    m, v = ({k: torch.zeros_like(x) for k, x in start.items()} for _ in range(2))
    lr, *corr = (torch.zeros((), dtype=torch.float32, device=device) for _ in range(3))
    for t, step_lr in zip(range(1, 6), (1e-3, 1e-3, 3e-4, 3e-4, 1.7e-5)):
        grads = {k: torch.randn(s, generator=gen).to(device) for k, s in shapes.items()}
        eager = adam.step(eager, grads, step_lr)
        lr.fill_(step_lr)
        for c, f in zip(corr, bias_factors(t, device == "cuda").tolist()):
            c.fill_(f)
        adam_update_(params, grads, m, v, corr, lr, lr_last=True)
        for k in shapes:
            assert torch.equal(params[k], eager[k]) and torch.equal(m[k], adam.m[k]) and torch.equal(v[k], adam.v[k])


# ---- on the card ----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA graph has no CPU mode)")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    torch.backends.cudnn.deterministic = deterministic


@pytest.mark.cuda
def test_adam_update_lr_last_matches_adam_step_on_the_card(cuda):
    check_adam_update_lr_last(cuda.type)


@pytest.mark.cuda
def test_replays_give_the_eager_bits_on_the_card(cuda):
    """ResNet-50 at 224, B=8, K3: three replays against three eager steps
    from the same weights on the same batch (lr changed before the third);
    one capture, a replay a step, K3's wrapper run in the warm-up and the
    capture alone; then B=4 and B=8 again, each a rebuild."""
    graphed, eager = (make_inputs(cuda, batch=8, image_size=224, arch="resnet50") for _ in range(2))
    g_metrics, counts = three_steps(graphed, TB.train_step)
    e_metrics, e_counts = three_steps(eager, eager_step)
    torch.cuda.synchronize()
    assert_same_bits(graphed, eager, g_metrics, e_metrics)
    assert e_counts["k3.launches"] == 3 * 53
    # K3's wrapper runs in the warm-up and in the capture; a replay launches K3 from the graph
    assert counts == {"train.graph_captures": 1, "train.graph_replays": 3, "train.steps": 3,
                      "k3.launches": 2 * 53}
    before = profiling.counters()["train.graph_captures"]
    for b in (4, 8):
        batch = make_inputs(cuda, batch=b, image_size=224, arch="resnet50", seed=b).batch
        _, m = TB.train_step(graphed.state, batch, graphed.mano_right, graphed.mano_left, graphed.config)
        assert bool(torch.isfinite(m["total_loss"]))
    assert profiling.counters()["train.graph_captures"] - before == 2


@pytest.mark.cuda
def test_dropping_the_state_returns_the_capture_memory(cuda):
    """The capture's pool is the graph's own: after the state is dropped and
    the cache emptied, the card holds less than half of what the first
    step (warm-up and capture) reserved, as the benchmark's check needs at
    B=256."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    inputs = make_inputs(cuda, batch=32, image_size=224, arch="resnet50")
    TB.train_step(inputs.state, inputs.batch, inputs.mano_right, inputs.mano_left, inputs.config)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_reserved() - base
    del inputs
    torch.cuda.empty_cache()
    left = torch.cuda.memory_reserved() - base
    print(f"reserved by the first step {grown / 2**30:.3f} GiB, left after the state is dropped "
          f"{left / 2**30:.3f} GiB")
    assert grown > 2**30 and left < grown / 2
