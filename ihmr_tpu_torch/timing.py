"""Kernel timing on the card: CUDA events around calls, and device time alone.

    cuda_ms(fn, reps)  median ms of one call of ``fn``, CUDA events around it:
                       the host's launch latency (Python, ctypes, allocation)
                       is inside the reading when it exceeds the device time
    cold_ms(fn, n)     device ms per call with a cold L2 cache, from a CUDA
                       graph replay: no host latency between the calls
    device_kernels(fn) the names of the device kernels one call of ``fn``
                       runs, recorded by torch.profiler
"""

from __future__ import annotations

import statistics
import time

import torch

_capture_stream = None  # the stream cold_ms warms up and captures on


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
    graph without ``fn``. The warm-up call runs on the capturing stream, so
    that state a kernel keeps per stream (``ops.bn_stats``' ticket counters)
    exists before the capture."""
    global _capture_stream
    if _capture_stream is None:
        _capture_stream = torch.cuda.Stream()
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    with torch.cuda.stream(_capture_stream):
        fn()
    torch.cuda.synchronize()

    def replay_ms(body):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=_capture_stream):
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


def device_kernels(fn, settle_s: float = 0.01) -> list:
    """The names of the device kernels one call of ``fn`` runs, recorded by
    torch.profiler (CPU + CUDA activity): fn runs three times under a
    schedule of one wait, one warm-up and one recorded step. Each call starts
    ``settle_s`` after its step begins and its step ends ``settle_s`` after
    the card is done: the profiler now and then drops the record of a kernel
    that starts right at the recorded window's start (seen on an H100 with
    no settle time, never with 10 ms before the call)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, schedule=torch.profiler.schedule(wait=1, warmup=1, active=1)) as prof:
        for _ in range(3):
            torch.cuda.synchronize()
            time.sleep(settle_s)
            fn()
            torch.cuda.synchronize()
            time.sleep(settle_s)
            prof.step()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith("ProfilerStep")]
