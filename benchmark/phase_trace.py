"""One traced run of a cell, as ``run.py --trace 1`` makes it, with the
program's own spans recorded and the device's kernels and idle gaps put
down to them (``phases.py``).

    python3 benchmark/phase_trace.py --workload <cell> --seed <n> [--turns k]

from the root of a checkout that holds the port, on a card. The cell's
driver is the one ``run.py`` runs, unchanged: while it traces, this wraps
``harness.profiler`` (to record the program's spans over the profiled
block) and ``harness.trace_records`` (to put the program's spans among the
driver's before the breakdown, and to add the phase rows). The last line of standard
output is one JSON object: ``correct`` and the checks, the device, the
breakdown (its idle gaps labelled by the innermost span, the program's
included), every per-layer metric of the cell read from these records, the
numbers the phases give (``phases.phases_metrics``) and their coverage, the
phase rows and the program's counters. With ``--turns k`` the traced
stretch then runs 2k times more, with the program's recording on and off
in turns, and ``cost`` gives each one's window in seconds; ``span_ns``
is a span's own cost, disabled, and recorded in loops as long as the
traced stretch's. A program without the span
recorder runs too, and gives no phases.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def traced_with_phases(driver, harness, phases):
    """``driver.traced()`` with the program's spans recorded over its
    profiled block -> its records (the phase rows added where the program
    records spans)."""
    kept = {}
    profiler, trace_records = harness.profiler, harness.trace_records

    @contextlib.contextmanager
    def recorded_profiler(device):
        with phases.program_recording() as program, profiler(device) as prof:
            yield prof
        kept["program"] = program  # filled as its block ended

    def records_with_phases(prof, spans, lo, hi):
        phases.merge_spans(spans, kept.get("program"))
        rec = trace_records(prof, spans, lo, hi)
        phases.attach(rec, prof, kept.get("program"))
        return rec

    harness.profiler, harness.trace_records = recorded_profiler, records_with_phases
    try:
        return driver.traced()
    finally:
        harness.profiler, harness.trace_records = profiler, trace_records


def span_ns(on: bool, n: int, repeat: int = 1):
    """Nanoseconds a span costs to enter and leave, disabled or recorded
    (``on``): the median over ``repeat`` loops of ``n`` spans (each loop
    its own recording) against the same loop empty; None in a program
    without spans."""
    try:
        from ihmr_tpu_torch.profiling import recording, span
    except ImportError:
        return None
    costs = []
    for _ in range(repeat):
        with recording() if on else contextlib.nullcontext():
            t0 = time.perf_counter_ns()
            for _ in range(n):
                with span("opt.step"):
                    pass
            t1 = time.perf_counter_ns()
        for _ in range(n):
            pass
        costs.append(((t1 - t0) - (time.perf_counter_ns() - t1)) / n)
    return statistics.median(costs)


def run(cell: str, workload, config, man, seed: int, device, turns: int = 0) -> dict:
    """Set-up, the traced stretch with the phases, ``turns`` turns of it
    with the recording on and off, then the check -> the result object."""
    import torch

    from benchmark import harness, phases

    driver = harness.driver_class(workload, BENCH)(config, workload["params"], seed, device)
    cuda = device.type == "cuda"
    driver.setup()
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    records = traced_with_phases(driver, harness, phases)
    if cuda:
        records["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    cost = {"on": [], "off": []}
    for i in range(2 * turns):
        on = (i % 4) in (0, 3)  # on, off, off, on, ...
        with phases.program_recording() if on else contextlib.nullcontext():
            cost["on" if on else "off"].append(driver.traced()["window_s"])
    phase_rows = records.get("phases")
    counters = records.get("program_counters")
    driver.release()
    if cuda:
        torch.cuda.empty_cache()
    checks = driver.check(records)
    metrics = {}
    for m in harness.cell_metrics(man, cell, "per_layer"):
        metrics[m["name"]] = harness.read_metric(m["name"], records, BENCH)
    return {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "device": {"kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "busy_s": records["busy_s"], "window_s": records["window_s"]},
        "breakdown": records["breakdown"],
        "metrics": metrics,
        "phase_metrics": {k: v for k, v in phases.phases_metrics(records).items() if v is not None},
        "coverage": phases.coverage(records),
        "counters": counters,
        "cost": cost if turns else None,
        "span_ns": {"off": span_ns(False, 10**6),
                    "on": span_ns(True, len(records.get("program_spans", ())) or 1000, 20)},
        "phases": phase_rows,
        "checks": checks,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--turns", type=int, default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from benchmark import harness

    workload, config = harness.cell_files(args.workload, BENCH)
    t0 = time.perf_counter()
    result = run(args.workload, workload, config, harness.manifest(ROOT), args.seed, torch.device("cuda"), args.turns)
    result["seconds"] = time.perf_counter() - t0
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
