"""Spans and counters of the program, and a Chrome-trace exporter (the port
of ihmr_tpu/train/profiling.py's ``trace``).

    with profiling.span("opt.step"):          # a layer boundary
        ...
    profiling.count("k1.launches")            # always on

Spans are off by default: ``span`` then returns one shared no-op context,
so a span on a hot path costs a call and an empty ``with``. Inside
``recording()`` (or ``trace()``) each span records its name, its parent (the
span open around it on the same thread: the shards of ``parallel/mesh.py``
run on threads of their own), its thread, its start and end and its
attributes. Starts and ends are ``time.time_ns()``, the clock that
``torch.profiler`` stamps its host and device events with, so a span and the
kernels launched inside it share one timeline. At most ``SPAN_LIMIT`` spans
are kept; the rest are counted under ``profiling.dropped``.

Counters are plain integers in one registry, added under a lock (the shard
threads count at once); ``counters()`` returns a snapshot.

This module imports only torch and the standard library, so every layer of
the package may import it.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch

SPAN_LIMIT = 10**6

# (name, parent index or None, thread id, start ns, end ns, attributes)
SpanRecord = Tuple[str, Optional[int], int, int, int, Dict]


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_lock = threading.Lock()
_counters: Dict[str, int] = {}
_records: List[list] = []  # [name, parent record, thread, start, end, attrs], in order of start
_recording = 0  # recordings open
_annotating = 0  # trace() blocks open
_local = threading.local()


class _Span:
    __slots__ = ("rec", "annotation")

    def __init__(self, name: str, attrs: Dict):
        self.rec = [name, None, threading.get_ident(), 0, 0, attrs]
        self.annotation = None

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        rec = self.rec
        rec[1] = stack[-1] if stack else None
        stack.append(rec)
        if _annotating:
            self.annotation = torch.profiler.record_function(rec[0])
            self.annotation.__enter__()
        rec[3] = time.time_ns()
        _records.append(rec)
        return self

    def __exit__(self, *exc):
        self.rec[4] = time.time_ns()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        _local.stack.pop()
        return False


def span(name: str, **attrs):
    """A with-block recorded as a span while a ``recording()`` is open; a
    shared no-op otherwise. ``name`` is a constant string."""
    if not _recording:
        return _OFF
    if len(_records) >= SPAN_LIMIT:
        count("profiling.dropped")
        return _OFF
    return _Span(name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A snapshot of every counter."""
    with _lock:
        return dict(_counters)


class Recording:
    """What a ``recording()`` block saw, filled when the block exits:
    ``spans``, the spans that started and ended inside it (``SpanRecord``,
    in order of start; a parent is an index into ``spans``, None for a span
    whose parent lies outside them), and ``counters``, each counter's change
    over the block (those that changed)."""

    def __init__(self):
        self.spans: List[SpanRecord] = []
        self.counters: Dict[str, int] = {}


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Record the program's spans over the block (recordings may nest)."""
    global _recording
    handle = Recording()
    before = counters()
    with _lock:
        first = len(_records)
        _recording += 1
    try:
        yield handle
    finally:
        with _lock:
            _recording -= 1
            recs = [r for r in _records[first:] if r[4]]  # those that ended
            if not _recording:
                _records.clear()
        index = {id(r): i for i, r in enumerate(recs)}
        handle.spans = [(r[0], None if r[1] is None else index.get(id(r[1])), r[2], r[3], r[4], r[5]) for r in recs]
        after = counters()
        handle.counters = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True) -> Iterator[Optional[torch.profiler.profile]]:
    """Profile the enclosed block (CPU, and CUDA when there is a card) and
    write a Chrome trace to ``log_dir/trace.json`` (open it in Perfetto):

        with profiling.trace("log/profile") as prof:
            run_some_steps()

    The program's spans are recorded meanwhile and appear in the trace as
    annotations on its own timeline. Yields the profiler (None when not
    ``enabled``)."""
    global _annotating
    if not enabled:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof, recording():
        _annotating += 1
        try:
            yield prof
        finally:
            _annotating -= 1
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
