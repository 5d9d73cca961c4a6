"""The phase rows (``phases.py``), the kernels' launches (``launches.py``)
and the traced run with the program's spans (``phase_trace.py``): on
synthetic events, on the CPU at tiny sizes, and on a card."""

from __future__ import annotations

import json
import statistics
import sys
import types

import pytest
import torch

from bench_helpers import ROOT, cuda_device, tiny_cell

from benchmark import harness, launches, phase_trace, phases


def span(name, parent, start, end, tid=1, **attrs):
    return (name, parent, tid, start, end, attrs)


def row(rows, path, stage=None):
    return next(r for r in rows if r["path"] == path and r["stage"] == stage)


SPANS = [
    span("opt.stage", None, 0, 1000, stage=2),
    span("opt.step", 0, 100, 200),
    span("opt.backward", 1, 120, 180),
    span("opt.step", 0, 300, 400),
]


def test_a_kernel_goes_to_the_span_that_launched_it_whenever_it_runs():
    kernels = [("k", 5000, 5100, 150), ("k", 5100, 5150, 190), ("k", 5150, 5160, None), ("k", 5160, 5170, 2000)]
    rows = phases.table(SPANS, kernels, [], 0, 6000)
    assert row(rows, "opt.stage/opt.step/opt.backward", 2)["device_s"] == 100e-9  # started after the span ended
    assert row(rows, "opt.stage/opt.step", 2)["kernels"] == 1
    assert row(rows, phases.NO_LAUNCH)["device_s"] == 10e-9
    assert row(rows, phases.OUTSIDE)["kernels"] == 1
    step = row(rows, "opt.stage/opt.step", 2)
    assert step["count"] == 2 and step["host_self_s"] == pytest.approx((100 - 60 + 100) * 1e-9)
    assert row(rows, "opt.stage", 2)["host_self_s"] == pytest.approx((1000 - 200) * 1e-9)


def test_idle_gaps_take_the_innermost_span_on_any_thread():
    spans = SPANS + [span("enc.forward", None, 140, 160, tid=2)]  # shorter, on another thread
    events = [("a", 0, 110), ("b", 118, 141), ("c", 149, 165), ("d", 171, 700), ("e", 800, 1000)]
    rows = phases.table(spans, [], events, 0, 1200)
    assert row(rows, "opt.stage/opt.step", 2)["idle_s"] == pytest.approx(8e-9)  # 110..118
    assert row(rows, "enc.forward")["idle_s"] == pytest.approx(8e-9)  # 141..149, inside opt.backward too
    assert row(rows, "opt.stage/opt.step/opt.backward", 2)["idle_s"] == pytest.approx(6e-9)  # 165..171
    assert row(rows, "opt.stage", 2)["idle_s"] == pytest.approx(100e-9)  # 700..800
    assert row(rows, phases.OUTSIDE)["idle_s"] == pytest.approx(200e-9) and row(rows, phases.OUTSIDE)["gaps"] == 1


def test_innermost_and_union():
    times, owners = phases.innermost([(0, 10), (2, 5), (4, 8)])
    assert [phases.owner_at(times, owners, t) for t in (-1, 0, 3, 4, 6, 9, 10)] == [None, 0, 1, 1, 2, 0, None]
    assert phases.union_ns([(5, 8), (0, 2), (1, 3), (7, 9)]) == 3 + 4


class Kind:
    def __init__(self, name):
        self.name = name


class Event:
    def __init__(self, name, device, start, duration, cid=0):
        self._v = (name, Kind(device), start, duration, cid)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


def fake_prof(events):
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))


def test_launches_pair_each_device_operation_with_its_runtime_call():
    events = [
        Event("cudaLaunchKernel", "CPU", 100, 5, cid=7), Event("Runtime Triggered Module Loading", "CPU", 90, 1, cid=7),
        Event("kernel_a", "CUDA", 400, 50, cid=7),
        Event("cuLaunchKernel", "CPU", 120, 5, cid=8), Event("kernel_b", "CUDA", 450, 10, cid=8),
        Event("Memcpy HtoD", "CUDA", 470, 10, cid=9), Event("cudaMemcpyAsync", "CPU", 130, 30, cid=9),
        Event("kernel_c", "CUDA", 500, 10, cid=10),
    ]
    assert launches.device_launches(fake_prof(events)) == [
        ("kernel_a", 400, 450, 100), ("kernel_b", 450, 460, 120), ("Memcpy HtoD", 470, 480, 130),
        ("kernel_c", 500, 510, None)]
    cpu = [Event("aten::add", "CPU", 10, 4), Event("aten::mul", "CPU", 20, 2)]
    assert launches.device_launches(fake_prof(cpu)) == [("aten::add", 10, 14, 10), ("aten::mul", 20, 22, 20)]


def test_existing_readers_read_the_same_with_the_programs_spans_merged():
    """Every per-layer reader of the manifest, on the same records, with and
    without the program's spans among the benchmark's."""
    events = [Event("cudaLaunchKernel", "CPU", 1000 + 50 * i, 5, cid=i) for i in range(40)]
    events += [Event(f"kernel_{i % 3}" + ("bn_stats_x" if i % 5 == 0 else "exact_collision_kernel" * (i == 7)),
                     "CUDA", 2000 + 300 * i, 120, cid=i) for i in range(40)]
    events += [Event("Memset (Device)", "CUDA", 1900, 20, cid=99)]
    program = types.SimpleNamespace(spans=[span("opt.batch", None, 1200, 3000), span("opt.step", 0, 1300, 1500)],
                                    counters={"opt.steps": 1})
    extra = dict(steps=4, flops=1e9, peak_flops_per_s=1e12, peak_bytes_per_s=1e12, k1_flops=1e6, k1_bytes=1e6,
                 k3_bytes=1e6, memory_peak_bytes=2**30, encoder_s=0.5)
    out = []
    for merged in (False, True):
        spans = harness.Spans()
        spans.items += [("encoder", 900, 1100), ("optimize_batch", 1100, 20000), ("train_step", 900, 20000)]
        if merged:
            phases.merge_spans(spans, program)
        rec = harness.trace_records(fake_prof(events), spans, 800, 20000)
        rec.update(extra)
        if merged:
            phases.attach(rec, fake_prof(events), program)
        man = json.loads((ROOT / "BENCHMARK.json").read_text())
        out.append({m["name"]: harness.read_metric(m["name"], rec) for m in man["per_layer"]})
    assert out[0] == out[1] and all(v is not None for v in out[0].values())


def _phase_run(cell, monkeypatch=None):
    workload, config = tiny_cell(cell)
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    torch.manual_seed(0)
    return phase_trace.run(cell, workload, config, man, 2**31 + 23, torch.device("cpu"), turns=1)


def test_a_traced_opt_run_gives_its_phases():
    res = _phase_run("opt_b1024")
    steps = 4 * 13  # tiny_cell's stages of 12 epochs
    assert res["correct"] and res["counters"]["opt.steps"] == steps
    assert res["counters"]["opt.snapshots"] == 4 * 2 and res["counters"]["opt.payloads"] == 4 * 1
    assert set(res["phase_metrics"]) == {"decode_host_us.opt", "loss_host_us.opt", "collision_host_us.opt",
                                         "backward_host_us.opt", "adam_host_us.opt", "fixed_host_ms.opt",
                                         "encoder_device_ms.opt"}
    assert all(v > 0 for v in res["phase_metrics"].values())
    assert 0.5 < res["coverage"]["opt_step_host"] <= 1.0 and res["coverage"]["train_step_device"] is None
    assert {k for k, v in res["metrics"].items() if v is None} == {"k1_roofline.opt", "peak_mem_gib.opt"}  # CPU
    labels = {name.split(" (")[0] for name, _t in res["breakdown"]["idle_gaps"]}
    assert labels & {"opt.decode", "opt.losses", "opt.collision", "opt.backward", "opt.adam"}
    assert len(res["cost"]["on"]) == len(res["cost"]["off"]) == 1 and res["span_ns"]["on"] > res["span_ns"]["off"] > 0


def test_a_traced_train_run_gives_its_phases():
    res = _phase_run("train_b64")
    assert res["correct"] and res["counters"] == {"train.steps": 2}
    assert set(res["phase_metrics"]) == {"forward_device_ms.train", "backward_device_ms.train",
                                         "adam_device_ms.train", "adam_host_ms.train"}
    assert 0.5 < res["coverage"]["train_step_device"] <= 1.0
    by_path = {r["path"]: r for r in res["phases"]}
    assert {"train.step", "train.step/enc.forward", "train.step/train.losses", "train.step/train.backward",
            "train.step/train.adam"} <= set(by_path)
    assert by_path["train.step/train.backward"]["kernels"] > 0


def test_a_program_without_the_recorder_gives_no_phases(monkeypatch):
    import ihmr_tpu_torch

    monkeypatch.delattr(ihmr_tpu_torch, "profiling")
    monkeypatch.setitem(sys.modules, "ihmr_tpu_torch.profiling", None)
    res = _phase_run("train_b64")
    assert res["correct"] and res["phases"] is None and res["phase_metrics"] == {} and res["span_ns"]["off"] is None
    assert {k for k, v in res["metrics"].items() if v is None} == {"k3_roofline.train", "peak_mem_gib.train"}  # CPU


@pytest.mark.cuda
def test_a_launch_falls_inside_the_span_around_it():
    """The program's clock against the profiler's on a card: each span
    around one ``torch.cuda._sleep`` holds its launch. Prints the least
    margins on both sides, which bound the skew between the two clocks."""
    from ihmr_tpu_torch import profiling

    device = cuda_device()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profiling.recording() as rec, harness.profiler(device) as prof:
        for _ in range(300):
            with profiling.span("sleep"):
                torch.cuda._sleep(20_000)
        torch.cuda.synchronize()
    spins = sorted(k[3] for k in launches.device_launches(prof) if "spin" in k[0])
    spans = [(s[3], s[4]) for s in rec.spans]
    assert len(spins) == len(spans) == 300
    before = [t - a for (a, _b), t in zip(spans, spins)]
    after = [b - t for (_a, b), t in zip(spans, spins)]
    print(f"launch after span start: min {min(before)} ns, median {statistics.median(before)} ns; "
          f"span end after launch: min {min(after)} ns, median {statistics.median(after)} ns")
    assert min(before) >= 0 and min(after) >= 0


@pytest.mark.cuda
def test_a_traced_opt_batch_counts_its_schedule():
    device = cuda_device()
    workload, config = harness.cell_files("opt_b1024")
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    res = phase_trace.run("opt_b1024", workload, config, man, 2**31 + 101, device)
    steps = sum(s["epoch"] + 1 for s in config["stages"])
    assert res["correct"] and res["counters"]["opt.steps"] == steps == 404
    assert res["counters"]["opt.payloads"] == 24 and res["counters"]["opt.snapshots"] == 44
    assert res["counters"]["k1.launches"] == 1
    assert not [r for r in res["phases"] if r["path"] == phases.NO_LAUNCH]  # every kernel paired with its launch
    assert len(res["phase_metrics"]) == 7
