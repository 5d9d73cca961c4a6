"""The host launch of each device operation of a finished ``torch.profiler``
run.

On a card the profiler (device activity only, ``harness.profiler``) records
besides every device operation the CUDA runtime or driver call that
enqueued it (``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaMemcpyAsync``,
...), on the host's timeline and with the device operation's correlation
id. A device operation's launch is the start of that call. Where the CPU is
the device, each operation is its own launch.

Imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# (name, device start ns, device end ns, host launch ns or None where the trace holds no launch)
Launched = Tuple[str, int, int, Optional[int]]


def device_launches(prof) -> List[Launched]:
    """Every operation on the traced device, with its launch. The device
    operations are those of ``harness.device_events``: the card's, or the
    CPU's where the CPU is the device."""
    events = prof.profiler.kineto_results.events()
    kind = "CUDA" if any(e.device_type().name == "CUDA" for e in events) else "CPU"
    calls: Dict[int, int] = {}
    if kind == "CUDA":
        # the runtime and driver calls; other host records (the profiler's own
        # overhead) may share a correlation id and are not launches
        for e in events:
            if e.device_type().name == "CPU" and e.name().startswith("cu") and e.correlation_id():
                start = e.start_ns()
                cid = e.correlation_id()
                calls[cid] = min(start, calls.get(cid, start))
    out = []
    for e in events:
        if e.device_type().name != kind:
            continue
        start = e.start_ns()
        launch = calls.get(e.correlation_id()) if kind == "CUDA" else start
        out.append((e.name(), start, start + e.duration_ns(), launch))
    return out
