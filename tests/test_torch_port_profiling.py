"""The port's span-and-counter recorder (``ihmr_tpu_torch/profiling.py``) and
the spans the OPT engine, the encoder and the train step draw with it. CPU
only, no JAX."""

from __future__ import annotations

import dataclasses
import sys
import threading
from collections import Counter

import torch

from ihmr_tpu_torch import profiling
from ihmr_tpu_torch.data import make_opt_inputs
from ihmr_tpu_torch.mano import synthetic_mano_model
from ihmr_tpu_torch.refine import OptConfig, opt_default, optimize_batch
from tests.torch_threads import one_torch_thread  # noqa: F401


def _names(rec):
    return Counter(s[0] for s in rec.spans)


def test_off_records_nothing():
    assert profiling.span("a") is profiling.span("b", x=1)  # the one shared no-op
    with profiling.span("a"):
        pass
    with profiling.recording() as rec:
        pass
    assert rec.spans == [] and rec.counters == {}


def test_spans_nest_per_thread():
    def other():
        with profiling.span("c"):
            with profiling.span("d"):
                pass

    with profiling.recording() as rec:
        with profiling.span("a", k=1):
            with profiling.span("b"):
                pass
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    by = {s[0]: (i, s) for i, s in enumerate(rec.spans)}
    assert [s[0] for s in rec.spans] == ["a", "b", "c", "d"]  # in order of start
    assert by["a"][1][1] is None and by["a"][1][5] == {"k": 1}
    assert by["b"][1][1] == by["a"][0]
    assert by["c"][1][1] is None  # a span of another thread has no parent here
    assert by["d"][1][1] == by["c"][0]
    assert by["c"][1][2] == by["d"][1][2] != by["a"][1][2] == threading.get_ident()
    for _name, _parent, _tid, start, end, _attrs in rec.spans:
        assert 0 < start <= end
    a, b = by["a"][1], by["b"][1]
    assert a[3] <= b[3] <= b[4] <= a[4]


def test_recordings_nest_and_bound_the_spans(monkeypatch):
    with profiling.recording() as outer:
        with profiling.span("x"):
            with profiling.recording() as inner:
                with profiling.span("y"):
                    pass
    assert [s[0] for s in outer.spans] == ["x", "y"] and outer.spans[1][1] == 0
    assert [s[0] for s in inner.spans] == ["y"] and inner.spans[0][1] is None  # its parent lies outside
    monkeypatch.setattr(profiling, "SPAN_LIMIT", 3)
    with profiling.recording() as rec:
        for _ in range(5):
            with profiling.span("z"):
                pass
    assert len(rec.spans) == 3 and rec.counters == {"profiling.dropped": 2}


def test_counters_add_up_across_threads():
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording() as rec:
            threads = [threading.Thread(target=lambda: [profiling.count("test.n") for _ in range(2000)])
                       for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            profiling.count("test.m", 5)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert rec.counters == {"test.n": 32000, "test.m": 5}
    assert profiling.counters()["test.n"] >= 32000


def test_spans_share_the_profilers_clock():
    """A span around an operator encloses the profiler's event of it: the two
    clocks agree on the host."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(3)
    x.sum()
    with profiling.recording() as rec, profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(50):
            with profiling.span("sum"):
                x.sum()
    sums = [(e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events() if e.name() == "aten::sum"]
    spans = [(s[3], s[4]) for s in rec.spans]
    assert len(spans) == 50 and len(sums) >= 50
    inside = [[(s, e) for s, e in sums if a <= s <= e <= b] for a, b in spans]
    assert all(inside) and sum(map(len, inside)) == len(sums)  # each event in one span, each span holds one


def test_optimize_batch_records_its_schedule():
    """Per stage: 7 steps in 3 blocks of 2 and a 1-step tail (4 snapshots),
    2 payloads (one superblock of 2 blocks, then the rest); then one final pass."""
    mano = synthetic_mano_model(device="cpu")
    params, batch = make_opt_inputs(mano, batch=2, seed=0)
    strategy = tuple(dataclasses.replace(s, epoch=6) for s in opt_default)
    with profiling.recording() as rec:
        optimize_batch(mano, params, batch, strategy, OptConfig(save_mid_freq=2))
    steps = 4 * 7
    assert _names(rec) == {
        "opt.batch": 1, "opt.stage": 4, "opt.step": steps, "opt.snapshot": 16, "opt.payload": 8, "opt.final": 1,
        "opt.losses": steps + 1, "opt.decode": steps + 1, "opt.collision": steps + 1,
        "opt.backward": steps, "opt.adam": steps,
    }
    assert rec.counters == {"opt.steps": steps, "opt.snapshots": 16, "opt.payloads": 8}  # no kernel on the CPU
    names = [s[0] for s in rec.spans]
    parent = lambda s: names[s[1]]  # noqa: E731
    stages = [s for s in rec.spans if s[0] == "opt.stage"]
    assert [s[5]["stage"] for s in stages] == [0, 1, 2, 3]
    assert [s[5]["groups"] for s in stages] == [st.update_params for st in strategy]
    for s in rec.spans:
        if s[0] in ("opt.step", "opt.payload"):
            assert parent(s) == "opt.stage"
        elif s[0] in ("opt.stage", "opt.final"):
            assert parent(s) == "opt.batch"
        elif s[0] in ("opt.collision",):
            assert parent(s) == "opt.losses"
        elif s[0] in ("opt.decode", "opt.losses"):
            assert parent(s) in ("opt.losses", "opt.step", "opt.final")
        elif s[0] != "opt.batch":
            assert parent(s) == "opt.step", s
    assert sum(s[1] is not None and parent(s) == "opt.final" for s in rec.spans) == 2  # its decode and losses


def test_train_step_records_its_phases():
    from ihmr_tpu_torch.pipeline import make_train_bench_inputs
    from ihmr_tpu_torch.train.baseline import train_step

    inputs = make_train_bench_inputs(batch=2, image_size=64, arch="resnet18", bn_impl="stock", device="cpu")
    train_step(inputs.state, inputs.batch, inputs.mano_right, inputs.mano_left, inputs.config)  # the capture
    with profiling.recording() as rec:
        train_step(inputs.state, inputs.batch, inputs.mano_right, inputs.mano_left, inputs.config)
    assert _names(rec) == {"train.step": 1, "train.replay": 1, "enc.forward": 1, "train.losses": 1,
                           "train.backward": 1, "train.adam": 1}
    assert rec.counters == {"train.steps": 1, "train.graph_replays": 1}
    # the replay under the step and every phase under the replay (on a card the replay has no phases)
    assert [s[1] for s in rec.spans] == [None, 0, 1, 1, 1, 1]
