"""Kernel timing on the card: CUDA events around calls, and device time alone.

    cuda_ms(fn, reps)  median ms of one call of ``fn``, CUDA events around it:
                       the host's launch latency (Python, ctypes, allocation)
                       is inside the reading when it exceeds the device time
    cold_ms(fn, n)     device ms per call with a cold L2 cache, from a CUDA
                       graph replay: no host latency between the calls
"""

from __future__ import annotations

import statistics

import torch


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` on the card (CUDA events), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cold_ms(fn, n: int = 10) -> float:
    """Device milliseconds per call of ``fn`` with a cold L2 cache: n calls,
    each after a 128 MB write that evicts the card's 50 MB L2, captured as
    one CUDA graph (so no host launch latency between them), less the same
    graph without ``fn``."""
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()

    def replay_ms(body):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n):
                body()
        graph.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    both = replay_ms(lambda: (flush.zero_(), fn()))
    only = replay_ms(flush.zero_)
    return max(both - only, 0.0) / n
