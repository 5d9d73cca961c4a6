"""A step of the OPT block engine as one CUDA graph, captured once and
replayed (``opt_engine.run_stage``).

A ``StepGraph`` wraps a function of no arguments that reads and writes only
tensors that outlive it, the step's static state (the engine copies each
stage's values into them with ``copy_``). Before its first replay the
function runs once on a side stream, so that lazy initialisations happen
outside the capture, the tensors it writes are put back, and
``torch.cuda.graph`` captures it. A replay then launches every kernel of
the step in one call, so a step costs the host one launch whatever its
number of kernels. Off the card the function is called at every replay:
the same code without the capture, which the CPU tests hold to the eager
engine bit for bit.

``cached`` keeps one entry per key, replaced when its layout changes (a new
batch size), so that a key holds the memory of one capture. Every graph of
a device captures into one memory pool: the graphs never run at once, and
the engine reads a replay's outputs before another graph replays.

Counters ``opt.graph_captures`` and ``opt.graph_replays``; span
``opt.replay`` around each replay.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Hashable, Sequence

import torch

from ihmr_tpu_torch.profiling import count, span

_lock = threading.Lock()
_cache: Dict[Hashable, tuple] = {}  # key -> (layout, entry)
_pools: Dict[torch.device, tuple] = {}


def _pool(device: torch.device):
    if device not in _pools:
        _pools[device] = torch.cuda.graph_pool_handle()
    return _pools[device]


class StepGraph:
    """``fn`` captured on first ``replay``; ``written`` are the tensors it
    overwrites, restored after the warm-up run."""

    def __init__(self, fn: Callable[[], object], written: Sequence[torch.Tensor], device: torch.device):
        self.fn, self.written, self.device = fn, list(written), device
        self.graph = None
        self.captured = False
        self.out = None

    def replay(self):
        """Run the step -> ``fn``'s outputs, overwritten by the next replay."""
        if not self.captured:
            self._capture()
        count("opt.graph_replays")
        with span("opt.replay"):
            if self.graph is None:
                self.out = self.fn()
            else:
                self.graph.replay()
        return self.out

    def _capture(self):
        count("opt.graph_captures")
        saved = [t.clone() for t in self.written]
        cuda = self.device.type == "cuda"
        stream = torch.cuda.Stream(self.device) if cuda else None
        if cuda:
            stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream) if cuda else contextlib.nullcontext():
            self.fn()  # warm-up
            if cuda:
                self.graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(self.graph, pool=_pool(self.device), stream=stream):
                    self.out = self.fn()
        if cuda:
            torch.cuda.current_stream(self.device).wait_stream(stream)
        for t, s in zip(self.written, saved):
            t.copy_(s)
        self.captured = True


def cached(key: Hashable, layout: Hashable, build: Callable[[], object]):
    """The entry kept for ``key`` if it was built at ``layout``, else
    ``build()``'s (the old entry dropped first, so that its memory is free
    for the new one)."""
    with _lock:
        hit = _cache.get(key)
        if hit is None or hit[0] != layout:
            _cache.pop(key, None)
            del hit  # the old entry's memory is free for the new one
            hit = _cache[key] = (layout, build())
    return hit[1]
