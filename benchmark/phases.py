"""The traced stretch split into the program's phases: its own spans
(``ihmr_tpu_torch/profiling.py``), with the device's kernels and idle gaps
put down to them.

A phase row is keyed by a span's path (the names from its outermost span
down to it, joined by ``/``) and, inside an OPT stage, the stage's index.
For each row: the spans' count; their host self time (each span's duration
less the union of its direct children's intervals); the device time and
number of the kernels whose host launch (``launches.py``) falls inside the
span; and the idle time of the gaps whose middle falls inside it. A kernel
or gap is given to the innermost span that holds the instant by time, on
any thread: the autograd engine launches a backward's kernels from a
thread of its own while the caller waits inside ``torch.autograd.grad``,
and where the host runs ahead of the card a kernel's start says nothing of
the phase that launched it. What no span holds goes to the row
``(outside)``; kernels with no launch in the trace to ``(no launch)``.

The readers of ``metrics/`` take these rows through ``phase_sum``. A
program without the recorder (an older checkout) records no span, and they
read nothing.
"""

from __future__ import annotations

import bisect
import contextlib
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

from benchmark import harness, launches

OUTSIDE, NO_LAUNCH = "(outside)", "(no launch)"


def program_recording():
    """The program's span recorder (``ihmr_tpu_torch.profiling.recording``),
    or, in a program that has none, a block that yields None."""
    try:
        from ihmr_tpu_torch import profiling
    except ImportError:
        return contextlib.nullcontext(None)
    return profiling.recording()


def innermost(intervals: Sequence[Tuple[int, int]]) -> Tuple[List[int], List[Optional[int]]]:
    """-> (times, owners): from ``times[i]`` on until ``times[i + 1]`` the
    shortest interval that holds the instant is ``intervals[owners[i]]``
    (None where none does)."""
    points = sorted([(s, 0, i) for i, (s, _e) in enumerate(intervals)]
                    + [(e, 1, i) for i, (_s, e) in enumerate(intervals)])
    heap: List[Tuple[int, int]] = []
    active = set()
    times: List[int] = []
    owners: List[Optional[int]] = []
    k = 0
    while k < len(points):
        t = points[k][0]
        while k < len(points) and points[k][0] == t:
            _t, end, i = points[k]
            if end:
                active.discard(i)
            else:
                active.add(i)
                heapq.heappush(heap, (intervals[i][1] - intervals[i][0], i))
            k += 1
        while heap and heap[0][1] not in active:
            heapq.heappop(heap)
        times.append(t)
        owners.append(heap[0][1] if heap else None)
    return times, owners


def owner_at(times: List[int], owners: List[Optional[int]], t: int) -> Optional[int]:
    j = bisect.bisect_right(times, t) - 1
    return owners[j] if j >= 0 else None


def union_ns(intervals: Sequence[Tuple[int, int]]) -> int:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is not None and s < end:
            s = end
        if e > s:
            total += e - s
            end = e
    return total


def table(spans: Sequence[Tuple], kernels: Sequence[launches.Launched], events: Sequence[Tuple[str, int, int]],
          lo: int, hi: int) -> List[Dict]:
    """The phase rows of the traced window [lo, hi]. ``spans``: the
    program's (name, parent index, thread, start ns, end ns, attributes);
    ``kernels``: (name, start, end, launch) of the device kernels;
    ``events``: every device operation, for the idle gaps."""
    paths: List[str] = []
    stages: List[Optional[int]] = []
    for name, parent, _tid, _s, _e, attrs in spans:  # a parent starts before its children
        paths.append(name if parent is None else paths[parent] + "/" + name)
        stages.append(attrs.get("stage") if name == "opt.stage" else (None if parent is None else stages[parent]))
    children: Dict[int, List[Tuple[int, int]]] = {}
    for name, parent, _tid, s, e, _attrs in spans:
        if parent is not None:
            children.setdefault(parent, []).append((s, e))
    rows: Dict[Tuple[str, Optional[int]], Dict] = {}

    def row(key):
        if key not in rows:
            rows[key] = {"path": key[0], "stage": key[1], "count": 0, "host_self_s": 0.0, "device_s": 0.0,
                         "kernels": 0, "idle_s": 0.0, "gaps": 0}
        return rows[key]

    keys = list(zip(paths, stages))
    for i, (_name, _parent, _tid, s, e, _attrs) in enumerate(spans):
        r = row(keys[i])
        r["count"] += 1
        r["host_self_s"] += ((e - s) - union_ns(children.get(i, ()))) / 1e9
    times, owners = innermost([(s[3], s[4]) for s in spans])

    def key_at(t):
        i = owner_at(times, owners, t)
        return (OUTSIDE, None) if i is None else keys[i]

    for _n, s, e, launch in kernels:
        r = row((NO_LAUNCH, None) if launch is None else key_at(launch))
        r["device_s"] += (e - s) / 1e9
        r["kernels"] += 1
    end = lo
    for _n, s, e in sorted(events, key=lambda x: x[1]) + [("", hi, hi)]:
        if s > end:
            r = row(key_at((s + end) // 2))
            r["idle_s"] += (min(s, hi) - end) / 1e9
            r["gaps"] += 1
        end = max(end, e)
    return sorted(rows.values(), key=lambda r: (r["path"], -1 if r["stage"] is None else r["stage"]))


def merge_spans(spans: harness.Spans, program) -> None:
    """Put the program's spans among the benchmark's, before
    ``harness.trace_records``, so that ``breakdown`` labels each idle gap by
    the innermost of them."""
    if program is not None:
        spans.items.extend((s[0], s[3], s[4]) for s in program.spans)


def attach(records: Dict, prof, program) -> None:
    """Add the program's spans, counters and phase rows to a traced run's
    records (``trace_records``), and the rows to its notes."""
    if program is None:
        return
    kernels = [k for k in launches.device_launches(prof) if harness.is_kernel(k[0])]
    lo, hi = records["window_ns"]
    rows = table(program.spans, kernels, records["events"], lo, hi)
    records.update(program_spans=program.spans, program_counters=program.counters, phases=rows)
    records.setdefault("notes", {})["phases"] = rows


def phase_sum(records: Dict, field: str, name: str, within: Optional[str] = None,
              outside: Optional[str] = None) -> Optional[float]:
    """``field`` summed over the rows of spans named ``name`` (``"*"``: any)
    whose path holds a span named ``within`` and none named ``outside``, or
    None where the run recorded no such span."""
    hits = []
    for r in records.get("phases", ()):
        parts = r["path"].split("/")
        if (name in ("*", parts[-1]) and (within is None or within in parts)
                and (outside is None or outside not in parts)):
            hits.append(r[field])
    return sum(hits) if hits else None


def per_step(records: Dict, field: str, name: str, within: Optional[str], counter: str,
             scale: float) -> Optional[float]:
    """``phase_sum`` times ``scale`` over the count of ``counter`` in the
    traced stretch, or None where either is missing."""
    total = phase_sum(records, field, name, within)
    steps = records.get("program_counters", {}).get(counter)
    return None if total is None or not steps else total * scale / steps


def phases_metrics(records: Dict) -> Dict[str, Optional[float]]:
    """The per-layer numbers the phase rows give (each None where the run
    recorded nothing for it): the host self time a step of each part of an
    OPT step and of the train step's optimizer, the work an OPT batch does
    outside its steps, and the device time of the kernels each phase
    launched."""
    host_ms_outside_steps = phase_sum(records, "host_self_s", "*", "opt.batch", "opt.step")
    encoder_s = phase_sum(records, "device_s", "enc.forward")
    return {
        "decode_host_us.opt": per_step(records, "host_self_s", "opt.decode", "opt.step", "opt.steps", 1e6),
        "loss_host_us.opt": per_step(records, "host_self_s", "opt.losses", "opt.step", "opt.steps", 1e6),
        "collision_host_us.opt": per_step(records, "host_self_s", "opt.collision", "opt.step", "opt.steps", 1e6),
        "backward_host_us.opt": per_step(records, "host_self_s", "opt.backward", "opt.step", "opt.steps", 1e6),
        "adam_host_us.opt": per_step(records, "host_self_s", "opt.adam", "opt.step", "opt.steps", 1e6),
        "fixed_host_ms.opt": None if host_ms_outside_steps is None else host_ms_outside_steps * 1e3,
        "encoder_device_ms.opt": (None if encoder_s is None or not phase_sum(records, "count", "opt.batch")
                                  else encoder_s * 1e3),
        "forward_device_ms.train": per_step(records, "device_s", "enc.forward", "train.step", "train.steps", 1e3),
        "backward_device_ms.train": per_step(records, "device_s", "train.backward", "train.step", "train.steps", 1e3),
        "adam_device_ms.train": per_step(records, "device_s", "train.adam", "train.step", "train.steps", 1e3),
        "adam_host_ms.train": per_step(records, "host_self_s", "train.adam", "train.step", "train.steps", 1e3),
    }


def coverage(records: Dict) -> Dict[str, Optional[float]]:
    """How much of the work the named phases hold: the share of the host
    time inside ``opt.step`` spans that the self times of decode, losses,
    collision, backward and Adam take; and the share of the device time of
    the kernels launched inside ``train.step`` that the kernels launched
    inside the encoder, the losses, the backward and Adam take."""
    def share(field, names, within):
        whole = phase_sum(records, field, "*", within)
        parts = [phase_sum(records, field, n, within) or 0.0 for n in names]
        return None if not whole else sum(parts) / whole

    return {
        "opt_step_host": share("host_self_s", ("opt.decode", "opt.losses", "opt.collision", "opt.backward",
                                               "opt.adam"), "opt.step"),
        "train_step_device": share("device_s", ("enc.forward", "train.losses", "train.backward", "train.adam"),
                                   "train.step"),
    }
