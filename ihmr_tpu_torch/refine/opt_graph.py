"""A step as one CUDA graph, captured once and replayed: each Adam step of
the OPT block engine (``opt_engine.run_stage``) and the IHMR-Baseline train
step (``train.baseline.train_step``).

A ``StepGraph`` wraps a function of no arguments that reads and writes only
tensors that outlive it, the step's static state (its caller copies each
step's values into them with ``copy_`` or ``fill_``). Before its first
replay the function runs once on a side stream, so that lazy
initialisations happen outside the capture, the tensors it writes are put
back, and ``torch.cuda.graph`` captures it. A replay then launches every
kernel of the step in one call, so a step costs the host one launch
whatever its number of kernels. Off the card the function is called at
every replay: the same code without the capture, which the CPU tests hold
to the eager step bit for bit.

A graph's counters and span carry its caller's name: ``opt.graph_captures``,
``opt.graph_replays`` and span ``opt.replay`` around each replay for the OPT
engine, ``train.*`` for training. A kernel's launch counter (``k1.launches``,
...) counts where its wrapper runs: at the warm-up and at the capture, not
at a replay, which launches the recorded kernels with no Python in between.

``cached`` keeps one entry per key, replaced when its layout changes (a new
batch size), so that a key holds the memory of one capture. The OPT
engine's graphs of a device capture into one memory pool: the graphs never
run at once, and the engine reads a replay's outputs before another graph
replays. A graph made with ``shared_pool=False`` (training's) captures into
a pool of its own, freed with the graph.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Hashable, Optional, Sequence

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
    overwrites, restored after the warm-up run. ``name`` prefixes the
    graph's counters and span; ``shared_pool`` captures into the device's
    one pool, else into a pool of the graph's own."""

    def __init__(self, fn: Callable[[], object], written: Sequence[torch.Tensor], device: torch.device,
                 name: str = "opt", shared_pool: bool = True):
        self.fn, self.written, self.device, self.shared_pool = fn, list(written), device, shared_pool
        self.captures, self.replays = f"{name}.graph_captures", f"{name}.graph_replays"
        self.replay_span = f"{name}.replay"
        self.graph = None
        self.captured = False
        self.out = None

    def replay(self):
        """Run the step -> ``fn``'s outputs, overwritten by the next replay."""
        if not self.captured:
            self._capture()
        count(self.replays)
        with span(self.replay_span):
            if self.graph is None:
                self.out = self.fn()
            else:
                self.graph.replay()
        return self.out

    def _capture(self):
        count(self.captures)
        saved = [t.clone() for t in self.written]
        cuda = self.device.type == "cuda"
        stream = torch.cuda.Stream(self.device) if cuda else None
        if cuda:
            stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream) if cuda else contextlib.nullcontext():
            self.fn()  # warm-up
            if cuda:
                self.graph = torch.cuda.CUDAGraph()
                pool = _pool(self.device) if self.shared_pool else None
                with torch.cuda.graph(self.graph, pool=pool, stream=stream):
                    self.out = self.fn()
        if cuda:
            torch.cuda.current_stream(self.device).wait_stream(stream)
        for t, s in zip(self.written, saved):
            t.copy_(s)
        self.captured = True


def cached(key: Hashable, layout: Hashable, build: Callable[[], object], store: Optional[Dict] = None):
    """The entry kept for ``key`` in ``store`` (default: this module's, which
    the OPT engine shares) if it was built at ``layout``, else ``build()``'s
    (the old entry dropped first, so that its memory is free for the new
    one)."""
    store = _cache if store is None else store
    with _lock:
        hit = store.get(key)
        if hit is None or hit[0] != layout:
            store.pop(key, None)
            del hit  # the old entry's memory is free for the new one
            hit = store[key] = (layout, build())
    return hit[1]
