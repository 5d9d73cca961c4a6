"""Profiling helpers (port of ihmr_tpu/train/profiling.py): a device trace of
a block (``trace``, on ``torch.profiler``), named regions inside it
(``annotate``, ``record_function``) and a steady-state step timer.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, List, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True) -> Iterator[Optional[torch.profiler.profile]]:
    """Profile the enclosed block (CPU, and CUDA when there is a card) and
    write a Chrome trace to ``log_dir/trace.json`` (open it in Perfetto):

        with profiling.trace("log/profile") as prof:
            run_some_steps()

    Yields the profiler (None when not ``enabled``)."""
    if not enabled:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named region inside a trace (shows up on the timeline)."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Steady-state step timer that skips the first ``warmup`` measurements.
    The caller ends each timed block with its own device synchronisation."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.times: List[float] = []
        self._skipped = 0
        self._start: Optional[float] = None

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._start
        if self._skipped < self.warmup:
            self._skipped += 1
        else:
            self.times.append(dt)

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else float("nan")

    @property
    def best(self) -> float:
        return min(self.times) if self.times else float("nan")
