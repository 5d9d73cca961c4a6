"""What every cell of the benchmark shares: finding a cell's files by name,
the check of loaded modules, the device trace and its reduction, and the
result line.

A cell is found by name: ``workloads/<cell>.json`` names its configuration
(``configs/<config>.json``), its traffic driver (``traffic/<driver>.py``,
a class ``Driver``) and the driver's parameters; each per-layer metric of
``BENCHMARK.json`` is read by ``metrics/<metric>.py`` (a function
``read(records)`` that returns a number, or None where the traced run holds
nothing for it to read).
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "chex", "ihmr_tpu")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path) -> Dict:
    return load_json(root / "BENCHMARK.json")


def cell_files(name: str, bench: Path = HERE) -> Tuple[Dict, Dict]:
    """-> (workload, configuration) of a cell, by its name."""
    path = bench / "workloads" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no workload file {path}")
    workload = load_json(path)
    return workload, load_json(bench / "configs" / f"{workload['config']}.json")


def load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver_class(workload: Dict, bench: Path = HERE):
    return load_file(bench / "traffic" / f"{workload['driver']}.py", f"benchmark_traffic_{workload['driver']}").Driver


def cell_metrics(man: Dict, cell: str, section: str) -> List[Dict]:
    """The metrics of ``section`` ("end_to_end" or "per_layer") that ``cell`` reports."""
    return [m for m in man[section] if "workloads" not in m or cell in m["workloads"]]


def read_metric(name: str, records: Dict, bench: Path = HERE) -> Optional[float]:
    reader = load_file(bench / "metrics" / f"{name}.py", "benchmark_metric_" + name.replace(".", "_").replace("-", "_"))
    return reader.read(records)


def forbidden_modules(modules: Sequence[str] = ()) -> List[str]:
    """Loaded modules whose top-level name (before the first dot), compared
    whole, is one of ``FORBIDDEN``."""
    names = modules or list(sys.modules)
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


# ---- the device trace ----------------------------------------------------


class Spans:
    """Host spans on the clock the profiler stamps its events with
    (``time.time_ns``)."""

    def __init__(self):
        self.items: List[Tuple[str, int, int]] = []

    def run(self, name: str, fn, *args, sync=None, **kwargs):
        t0 = time.time_ns()
        out = fn(*args, **kwargs)
        if sync is not None:
            sync()
        self.items.append((name, t0, time.time_ns()))
        return out


def profiler(device):
    """The profiler of a traced stretch: device activity only on a card (the
    host's operators on the CPU, where the CPU is the device)."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA if device.type == "cuda" else ProfilerActivity.CPU])


def device_events(prof) -> List[Tuple[str, int, int]]:
    """(name, start ns, end ns) of every operation the profiler saw on the
    device it traced."""
    out = []
    events = prof.profiler.kineto_results.events()
    kind = "CUDA" if any(e.device_type().name == "CUDA" for e in events) else "CPU"
    for e in events:
        if e.device_type().name == kind:
            start = e.start_ns()
            out.append((e.name(), start, start + e.duration_ns()))
    return out


def is_kernel(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def busy_ns(events: List[Tuple[str, int, int]], lo: int, hi: int) -> int:
    """Length of the union of the events' intervals inside [lo, hi]."""
    total, end = 0, lo
    for _n, s, e in sorted(events, key=lambda x: x[1]):
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


def breakdown(events, spans: List[Tuple[str, int, int]], lo: int, hi: int) -> Dict[str, List]:
    """The 10 device operations with the most time, and the idle time inside
    [lo, hi] summed by the host span each gap fell in (the innermost one that
    holds its middle)."""
    per_op: Dict[str, int] = {}
    for n, s, e in events:
        per_op[n] = per_op.get(n, 0) + (e - s)
    ops = sorted(per_op.items(), key=lambda x: -x[1])[:10]
    idle: Dict[str, List[int]] = {}
    end = lo
    ordered = sorted(spans, key=lambda x: x[2] - x[1])
    for _n, s, e in sorted(events, key=lambda x: x[1]) + [("", hi, hi)]:
        if s > end:
            mid = (s + end) // 2
            label = next((name for name, a, b in ordered if a <= mid <= b), "outside spans")
            slot = idle.setdefault(label, [0, 0])
            slot[0] += min(s, hi) - end
            slot[1] += 1
        end = max(end, e)
    gaps = sorted(idle.items(), key=lambda x: -x[1][0])[:10]
    return {
        "device_ops": [[n[:120], t / 1e9] for n, t in ops],
        "idle_gaps": [[f"{name} ({count} gaps)", t / 1e9] for name, (t, count) in gaps],
    }


def trace_records(prof, spans: Spans, lo: int, hi: int) -> Dict:
    events = device_events(prof)
    kernels = [ev for ev in events if is_kernel(ev[0])]
    return {
        "events": events,
        "kernels": kernels,
        "spans": spans.items,
        "window_ns": (lo, hi),
        "busy_s": busy_ns(events, lo, hi) / 1e9,
        "window_s": (hi - lo) / 1e9,
        "breakdown": breakdown(events, spans.items, lo, hi),
    }


def kernel_seconds(records: Dict, needle: str) -> Tuple[float, int]:
    """Summed device seconds and count of the kernels whose name holds ``needle``."""
    hits = [e - s for n, s, e in records["kernels"] if needle in n]
    return sum(hits) / 1e9, len(hits)
