"""Device mesh and data-parallel sharding (port of ihmr_tpu/parallel/mesh.py).

The JAX package runs one program over a 1-D mesh of devices: batches are
sharded on the 'data' axis, parameters replicated, and XLA inserts the
cross-device reductions. The port keeps that model in one process with
explicit containers and one host thread per shard:

  * ``shard_batch`` splits the leading dimension of every tensor of a tree
    (a dataclass, dict, list or tuple) into one contiguous part per device,
    in device order, and returns a ``Sharded``; ``replicate`` gives one copy
    per device, a ``Replicated`` (an ``nn.Module``'s copies hold no weights:
    a shard calls its copy with the primary's tensors, ``Mesh.reads``);
  * ``Mesh.map(fn, *args)`` runs ``fn`` once per shard, each on a host
    thread of its own under its own CUDA stream on its device, with the
    shard's part of every ``Sharded`` and ``Replicated`` argument; the
    threads meet through ``Shard.all_gather`` / ``Shard.all_sum``;
  * ``gather_to_host`` brings the shards back to one host array per leaf.

The device list may repeat a device: torch has one CPU device, and a card
can hold several shards. Each shard's launches go to its own stream, and
ctypes and torch's operators release the interpreter lock while they run,
so the shards' launches interleave; their Python work still contends for
the lock (PERF.md measures what that costs on one card).

Code that must know it runs in a shard reads ``current_shard()``, a
thread-local: the OPT engine weighs its batch-mean loss by the shard's share
of the global batch (``refine/opt_engine.py``), and train-mode BatchNorm
sums its statistics over the shards (``models/resnet.py``).

A shard that raises aborts the mesh's barrier, so the others leave their
collective at once; ``map`` re-raises the first error in the caller. A
collective that some shard never reaches fails after ``BARRIER_TIMEOUT``
seconds. Nothing falls back to running the shards one after another.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as td
from torch import nn

DATA_AXIS = "data"
BARRIER_TIMEOUT = 600.0  # s a shard waits in a collective for the others

_local = threading.local()


def current_shard() -> Optional["Shard"]:
    """The shard this thread runs (inside ``Mesh.map``), else None."""
    return getattr(_local, "shard", None)


def _reader_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` for one more reader: a view, made on the current stream.

    On the card a tensor that several shards' streams read must reach each
    through a view of its own made on ONE stream. In the backward each view
    then takes the gradient of one reader, and the terms are summed on the
    stream the views were made on. Read straight from four shards' streams,
    the terms of a parameter's gradient were summed into one buffer from
    four streams, which on the H100 (torch 2.11) came out different from run
    to run: the stem BatchNorm's gradient up to 20x off."""
    return t.view_as(t)


def _canonical(device) -> torch.device:
    """``device`` with its index: "cuda" is the current card, so that a
    shard's device compares equal to its tensors' devices."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A 1-D mesh: the devices of ``axis``, one shard each, in order."""

    def __init__(self, devices: Sequence, axis: str = DATA_AXIS):
        self.devices = tuple(_canonical(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis = axis
        self._streams: Optional[List[Optional[torch.cuda.Stream]]] = None

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, axis={self.axis!r})"

    def _shard_streams(self) -> List[Optional[torch.cuda.Stream]]:
        """One CUDA stream per shard on a CUDA device (None on the CPU),
        made at first use and kept, so that state kept per stream (K3's
        ticket counters) is made once."""
        if self._streams is None:
            self._streams = [torch.cuda.Stream(device=d) if d.type == "cuda" else None for d in self.devices]
        return self._streams

    def reads(self, tensors: Dict[str, torch.Tensor]) -> List[Dict[str, torch.Tensor]]:
        """Each shard's differentiable read of ``tensors``, made now on the
        caller's stream: a view of its own (``_reader_view``) where the
        shard's device is the tensor's, else a copy to the shard's device.
        The gradients that the shards' reads take are summed on the
        caller's stream."""
        return [{k: _reader_view(t) if t.device == d else t.to(d) for k, t in tensors.items()} for d in self.devices]

    def map(self, fn: Callable, *args) -> List[Any]:
        """``fn`` once per shard, on one thread each -> the results in shard
        order. A ``Sharded`` or ``Replicated`` argument is replaced by the
        shard's part; other arguments are passed as they are. The shard's
        rows are the leading dimension of its part of the first ``Sharded``
        argument. Each thread runs under the caller's grad mode, with its
        device current and its stream current; the shards' streams wait for
        the caller's stream before they start, and the caller's stream waits
        for theirs before ``map`` returns. Raises the first error a shard
        raised."""
        if any(isinstance(a, (Sharded, Replicated)) and a.mesh is not self for a in args):
            raise ValueError("an argument is sharded or replicated over another mesh")
        sharded = [a for a in args if isinstance(a, Sharded)]
        rows = sharded[0].rows() if sharded else [None] * self.size
        streams = self._shard_streams()
        _fork(self.devices, streams)
        run = _Run(self.size)
        grad, inference = torch.is_grad_enabled(), torch.is_inference_mode_enabled()
        results: List[Any] = [None] * self.size

        def part(a, k):
            return a.parts[k] if isinstance(a, Sharded) else a.copies[k] if isinstance(a, Replicated) else a

        def body(k):
            shard = Shard(self, k, run, rows[k], sum(rows) if rows[k] is not None else None)
            _local.shard = shard
            try:
                with torch.inference_mode(inference), torch.set_grad_enabled(grad), _on(self.devices[k], streams[k]):
                    results[k] = fn(*[part(a, k) for a in args])
            except BaseException as e:  # noqa: B036 - handed to the caller, which re-raises it
                run.fail(k, e)
            finally:
                _local.shard = None

        threads = [threading.Thread(target=body, args=(k,), name=f"mesh-shard-{k}", daemon=True) for k in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        _join(self.devices, streams)
        run.raise_first()
        return results


def make_mesh(devices: Optional[Sequence] = None, axis: str = DATA_AXIS) -> Mesh:
    """A mesh over ``devices`` (default: every visible CUDA device). The CPU
    is used only when the caller passes it (``[torch.device("cpu")] * 8``);
    with no card and no devices given this raises."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass the devices (e.g. ['cpu'] * 8) to use the CPU explicitly")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return Mesh(list(devices), axis)


@dataclass(frozen=True)
class BatchSharding:
    """The leading (batch) dimension split over ``mesh``'s axis."""

    mesh: Mesh
    axis: str = DATA_AXIS


@dataclass(frozen=True)
class ReplicatedSharding:
    """One whole copy on every device of ``mesh``."""

    mesh: Mesh


def batch_sharding(mesh: Mesh, axis: str = DATA_AXIS) -> BatchSharding:
    """Shard the leading (batch) dimension across the mesh."""
    return BatchSharding(mesh, axis)


def replicated(mesh: Mesh) -> ReplicatedSharding:
    return ReplicatedSharding(mesh)


@dataclass
class Sharded:
    """A tree split on its leading dimension: ``parts[k]`` lies on
    ``mesh.devices[k]``. A 0-d tensor in a part is a value replicated over
    the shards (a batch scalar of a sharded result)."""

    mesh: Mesh
    parts: List[Any]

    def rows(self) -> List[int]:
        """Each part's leading dimension (of its first tensor with one)."""
        out = []
        for p in self.parts:
            lead = [x.shape[0] for x in _leaves(p) if torch.is_tensor(x) and x.dim() > 0]
            if not lead:
                raise ValueError("a sharded tree holds no tensor with a leading dimension")
            out.append(int(lead[0]))
        return out


@dataclass
class Replicated:
    """One copy of ``primary`` per shard: ``copies[k]`` on ``mesh.devices[k]``."""

    mesh: Mesh
    primary: Any
    copies: List[Any]


def shard_batch(tree: Any, mesh: Mesh, axis: str = DATA_AXIS) -> Sharded:
    """Every tensor of ``tree`` split on its leading dimension into
    ``mesh.size`` contiguous parts, in device order, each moved to its
    device. Raises when the mesh size does not divide a leading dimension
    (pad first: ``pad_to_multiple``) or a tensor has none."""
    if axis != mesh.axis:
        raise ValueError(f"the mesh has axis {mesh.axis!r}, not {axis!r}")
    n = mesh.size

    def split(x, k):
        if x.dim() == 0 or x.shape[0] % n:
            raise ValueError(
                f"cannot shard a tensor of shape {tuple(x.shape)} over {n} devices: its leading dimension must be a "
                "multiple of the mesh size"
            )
        m = x.shape[0] // n
        return x[k * m:(k + 1) * m].to(mesh.devices[k])

    return Sharded(mesh, [_map(tree, lambda x, k=k: split(x, k)) for k in range(n)])


def replicate(tree: Any, mesh: Mesh) -> Replicated:
    """One copy of ``tree`` per device: tensors moved (on the tree's own
    device the tensor itself); other leaves are shared, except modules.
    Each shard gets a module object of its own, since
    ``torch.func.functional_call`` swaps a module's tensors while it runs,
    but that copy holds no weights: its parameters and buffers lie on the
    meta device, so the shard calls it with the primary's tensors
    (``Mesh.reads``), which always hold the current weights, and a call
    without them fails."""

    def copy_to(x, dev):
        return _hollow(x) if isinstance(x, nn.Module) else x.to(dev)

    return Replicated(mesh, tree, [_map(tree, lambda x, d=d: copy_to(x, d), modules=True) for d in mesh.devices])


def _hollow(module: nn.Module) -> nn.Module:
    """A deep copy of ``module`` whose parameters and buffers are meta
    tensors of the same shapes (no weights are copied)."""
    memo = {}
    for t in (*module.parameters(), *module.buffers()):
        e = torch.empty_like(t, device="meta")
        memo[id(t)] = nn.Parameter(e, requires_grad=t.requires_grad) if isinstance(t, nn.Parameter) else e
    return copy.deepcopy(module, memo)


def pad_to_multiple(n: int, m: int) -> int:
    """Samples to add so n is divisible by m (the reference pads eval datasets
    to batch*world_size by replicating the first sample; ref
    baseline_dataset.py:57-64)."""
    return (m - n % m) % m


def gather_to_host(tree: Any) -> Any:
    """Host numpy of a tree: a ``Sharded`` tree's parts concatenated in device
    order (a 0-d leaf, replicated, taken once), a ``Replicated`` tree's
    primary, plain tensors as they are. Under an initialised process group
    with several processes, every process's result is gathered and stacked
    in rank order on a new leading axis (``process_allgather`` in the JAX
    package)."""
    if isinstance(tree, Sharded):
        host = [_map(p, lambda x: x.detach().cpu().numpy()) for p in tree.parts]
        out = _zip_map(host, lambda xs: xs[0] if np.ndim(xs[0]) == 0 else np.concatenate(xs, axis=0))
    elif isinstance(tree, Replicated):
        out = _map(tree.primary, lambda x: x.detach().cpu().numpy())
    else:
        out = _map(tree, lambda x: x.detach().cpu().numpy())
    if td.is_available() and td.is_initialized() and td.get_world_size() > 1:
        every = [None] * td.get_world_size()
        td.all_gather_object(every, out)
        out = _zip_map(every, lambda xs: np.stack(xs, axis=0))
    return out


class Shard:
    """What a thread of ``Mesh.map`` knows of its shard: ``index``, ``device``,
    and its ``rows`` of the global batch's ``global_rows`` (None when no
    argument was sharded)."""

    def __init__(self, mesh: Mesh, index: int, run: "_Run", rows: Optional[int], global_rows: Optional[int]):
        self.mesh = mesh
        self.index = index
        self.device = mesh.devices[index]
        self.rows = rows
        self.global_rows = global_rows
        self._run = run
        self._calls = 0

    @property
    def share(self) -> float:
        """rows / global_rows: the weight of this shard's batch mean in the
        global batch's mean."""
        return self.rows / self.global_rows

    @contextlib.contextmanager
    def batch(self, rows: int, global_rows: int):
        """Take ``rows`` of ``global_rows`` as this shard's batch for the
        duration (a sub-batch each shard picks from its part)."""
        saved = self.rows, self.global_rows
        self.rows, self.global_rows = rows, global_rows
        try:
            yield self
        finally:
            self.rows, self.global_rows = saved

    def all_gather(self, value: Any) -> List[Any]:
        """Meet every other shard; each shard's ``value``, in shard order.
        Every shard must make the same sequence of calls."""
        slots = self._run.slots[self._calls % 2]  # two slot lists: a shard may write the next while others read
        self._calls += 1
        slots[self.index] = value
        self._run.wait()
        return list(slots)

    def all_sum(self, values: Sequence[Any]) -> List[Any]:
        """The sum over the shards of each of ``values`` (tensors or
        numbers), added in shard order on this shard's device, so that every
        shard holds the same bits. Differentiable: each term is a ``.to``
        copy of the other shard's tensor, so the backward reaches every
        shard's graph and needs no meeting."""
        # one view of each tensor per reader, made on this shard's stream,
        # so that the readers' gradient terms are summed on it (_reader_view)
        views = [[_reader_view(v) if torch.is_tensor(v) else v for v in values] for _ in range(self.mesh.size)]
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        total = None
        for theirs, ev in self.all_gather((views, event)):
            moved = [self._receive(v, ev) for v in theirs[self.index]]
            total = moved if total is None else [a + b for a, b in zip(total, moved)]
        return total

    def _receive(self, v, event):
        if not torch.is_tensor(v):
            return v
        if event is not None:
            # the producer's stream finished it; this thread reads it on its
            # current stream of the tensor's device, and the allocator must
            # not hand its memory out before that read is done
            stream = torch.cuda.current_stream(v.device)
            stream.wait_event(event)
            v.record_stream(stream)
        return v.to(self.device)


class _Run:
    """One ``map`` call's meeting point and error record."""

    def __init__(self, n: int):
        self.barrier = threading.Barrier(n)
        self.slots = ([None] * n, [None] * n)
        self.errors: List[tuple] = []  # (shard, exception), in the order raised
        self._lock = threading.Lock()

    def wait(self):
        self.barrier.wait(timeout=BARRIER_TIMEOUT)

    def fail(self, index: int, error: BaseException):
        with self._lock:
            self.errors.append((index, error))
        self.barrier.abort()

    def raise_first(self):
        """The first error a shard raised; a broken barrier only where no
        shard raised anything else (a collective timed out)."""
        if not self.errors:
            return
        own = [e for e in self.errors if not isinstance(e[1], threading.BrokenBarrierError)]
        index, error = (own or self.errors)[0]
        error.add_note(f"raised in shard {index} of the mesh")
        raise error


def _on(device: torch.device, stream):
    if stream is None:
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.cuda.device(device))
    stack.enter_context(torch.cuda.stream(stream))
    return stack


def _fork(devices, streams):
    """Each shard's stream waits for the caller's current stream on its device."""
    for d, s in zip(devices, streams):
        if s is not None:
            s.wait_stream(torch.cuda.current_stream(d))


def _join(devices, streams):
    """The caller's current stream on each device waits for the shards' streams."""
    for d, s in zip(devices, streams):
        if s is not None:
            torch.cuda.current_stream(d).wait_stream(s)


def _leaves(tree):
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _map(tree, fn, modules: bool = False):
    """``fn`` on every tensor leaf (and, with ``modules``, every
    ``nn.Module``) of a dataclass / dict / list / tuple tree; other leaves
    are kept."""
    if torch.is_tensor(tree) or (modules and isinstance(tree, nn.Module)):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _map(getattr(tree, f.name), fn, modules)
                                            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return type(tree)((k, _map(v, fn, modules)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn, modules) for v in tree)
    return tree


def _zip_map(trees: List[Any], fn):
    """``fn`` on the list of corresponding numpy leaves of same-structured
    trees (as ``_map`` left them)."""
    first = trees[0]
    if isinstance(first, np.ndarray):
        return fn(trees)
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        return dataclasses.replace(first, **{f.name: _zip_map([getattr(t, f.name) for t in trees], fn)
                                             for f in dataclasses.fields(first) if f.init})
    if isinstance(first, dict):
        return type(first)((k, _zip_map([t[k] for t in trees], fn)) for k in first)
    if isinstance(first, (list, tuple)):
        return type(first)(_zip_map([t[i] for t in trees], fn) for i in range(len(first)))
    return first
