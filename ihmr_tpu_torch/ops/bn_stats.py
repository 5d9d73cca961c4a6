"""Per-channel BatchNorm batch statistics: the Hopper kernel and its plain version.

Counterpart of ``ihmr_tpu/ops/pallas_bn.py`` (the TPU kernel K3,
``_stats_kernel``, launched by ``bn_stats`` / ``batch_moments``).
``bn_stats(x)`` returns the fp32 sums (sum x, sum x^2) per channel of an
activation x of shape (B, C, S...), summed over every axis but axis 1. The
port's activations are NCHW, so the sums run over (B, H, W); a (rows, C)
matrix is the case of no spatial axes, which is the JAX function's layout.
``batch_moments(x)`` turns them into flax's fast-variance moments,
mean = s / n and var = max(0, s2 / n - mean^2).

The CUDA kernel is ``csrc/bn_stats.cu`` (built by ``ihmr_tpu_torch.build``).
It reads the contiguous activation in place, fp32 or bf16, with 16-byte
loads at every shape whose rows are whole vectors, and accumulates in fp32
without float atomics in one launch: on the runs path the blocks of a
channel that spans several slices of the batch take tickets from a counter,
and the last adds the partials in slice order; on the tiles path a block
takes a channel group over the whole batch. Its result has the same bits
run to run; the launch plan (``launch_plan``) depends on the shape, the
element size and the alignment alone. It raises on any other layout
(channels-last, strided views). The counters are one int32 buffer per
device and stream, zeroed once on that stream and left zero by every
launch, so the launches that share them are ordered by their stream, and
launches on other streams or threads never see them. A CUDA graph capture
uses the capturing stream's buffer, which must exist before the capture
(one launch on that stream first, as ``timing.cold_ms`` does); the first
launch on a stream inside a capture raises.
``bn_stats_reference`` is the plain PyTorch version. The wrapper takes the
plain version only for CPU tensors; a CUDA tensor launches the kernel or
raises.

Gradient: the TPU kernel has none. JAX differentiates through a closed-form
``custom_vjp``, d(sum)/dx = 1 and d(sum x^2)/dx = 2x, which XLA fuses into
one elementwise pass; ``BNStats.backward`` is the same formula in plain
PyTorch.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import NamedTuple, Tuple

import torch

from ihmr_tpu_torch.build import kernel_function

THREADS = 256  # threads per block (csrc/bn_stats.cu kThreads)
SMS = 132  # streaming multiprocessors of an H100 SXM
BLOCKS_PER_SM = 4  # resident blocks per SM (csrc/bn_stats.cu kMinBlocks)
SLOTS = SMS * BLOCKS_PER_SM  # one wave: no grid has more blocks
SMALL_RUN_BYTES = 1024  # runs this short go by channel tiles
LOADS = 8  # loads in flight a thread (csrc/bn_stats.cu kLoads): runs two rounds of LOADS // 2
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# launches of the CUDA kernel (incremented only where the kernel is launched,
# under the lock: the shard threads of parallel/mesh.py launch at once)
launch_count = 0
_count_lock = threading.Lock()


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


class LaunchPlan(NamedTuple):
    path: str  # "runs" (one channel an item) or "tiles" (ct channels over the whole batch an item)
    batch: int  # samples (axis 0)
    channels: int
    hw: int  # elements of one channel of one sample (the product of the spatial axes)
    vector: bool  # 16-byte loads (else masked scalar loads)
    ct: int  # channels of a group (1 on the runs path)
    groups: int  # channel groups (on the runs path the ticket counters)
    rows: int  # samples of a slice
    slices: int  # slices of the batch a group is split into (1 on the tiles path)
    grid: int  # blocks; each walks the items (group, slice) gridDim.x apart

    @property
    def items(self) -> int:
        return self.groups * self.slices

    @property
    def scratch_floats(self) -> int:
        """fp32 partials (sum, sum of squares) the runs path's items write when
        a channel spans several slices."""
        return 2 * self.items if self.slices > 1 else 0


def launch_plan(shape: Tuple[int, ...], element_size: int, aligned: bool = True) -> LaunchPlan:
    """The kernel's work split for a contiguous activation of ``shape`` (B, C,
    S...) whose base is 16-byte ``aligned`` or not; a pure function of those.

    Tiles path, where a channel's run of hw elements is at most
    SMALL_RUN_BYTES or not a whole number of 16-byte vectors: one block a
    group of ct consecutive channels over the whole batch (one slice, no
    partials), ct the smallest multiple of 16 / gcd(hw * element_size, 16)
    that leaves at most SLOTS groups (so that each group's span in a sample
    starts 16-byte aligned and is a whole number of vectors, and the grid is
    one wave), its span at most THREADS vectors; 16-byte loads when the base
    is aligned and a sample's C * hw elements are a whole number of vectors.
    Runs path otherwise (one channel a group), 16-byte loads when the base is
    aligned and hw is a whole number of vectors; the batch is cut into
    ``slices`` of ``rows`` samples so that channels x slices fills one wave of
    SLOTS blocks, but no slice has fewer samples than LOADS loads a thread
    cover. The grid never has more blocks than SLOTS."""
    if len(shape) < 2:
        raise ValueError(f"expected (B, C, ...) activations, got shape {tuple(shape)}")
    batch, channels = int(shape[0]), int(shape[1])
    hw = math.prod(int(d) for d in shape[2:])
    width = 16 // element_size
    unit = width // math.gcd(hw, width)  # channels whose span is a whole number of vectors
    if unit * hw <= THREADS * width and (hw % width != 0 or hw * element_size <= SMALL_RUN_BYTES):
        ct = unit * max(1, -(-channels // (SLOTS * unit)))  # at most SLOTS groups
        ct = min(ct, THREADS * width // hw // unit * unit, channels)  # a span of at most THREADS vectors
        groups = -(-channels // ct)
        vector = aligned and (channels * hw) % width == 0
        return LaunchPlan("tiles", batch, channels, hw, vector, ct, groups, batch, 1, min(groups, SLOTS))
    vector = aligned and hw % width == 0
    round_rows = -(-LOADS * THREADS // (hw // width if vector else hw))  # samples LOADS loads a thread cover
    slices = max(1, min(batch // round_rows, SLOTS // channels))
    rows = -(-batch // slices)
    slices = -(-batch // rows)
    if rows * hw >= 2**31:
        raise ValueError(f"bn_stats kernel: {rows} x {hw} elements in one slice of a channel exceed its 32-bit count")
    return LaunchPlan("runs", batch, channels, hw, vector, 1, channels, rows, slices, min(channels * slices, SLOTS))


def _reduce_dims(x: torch.Tensor) -> Tuple[int, ...]:
    return (0,) + tuple(range(2, x.dim()))


def bn_stats_reference(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (sum x, sum x^2) per channel (axis 1), fp32."""
    xf = x.float()
    dims = _reduce_dims(x)
    return xf.sum(dims), (xf * xf).sum(dims)


# the C entry point's arguments: x, dtype code, out, partials, tickets, path,
# vector, batch, channels, hw, ct, groups, rows, slices, grid, stream
_FORWARD_ARGS = (
    [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_longlong]
    + [ctypes.c_int] * 5 + [ctypes.c_void_p]
)

# per (device, stream): int32 ticket counters (one a channel on the runs
# path), zeroed once on that stream; every launch leaves them 0. 4096 covers
# every ResNet BatchNorm (at most 2048 channels) without a second allocation.
# Shard threads (parallel/mesh.py) each launch on a stream of their own, so
# each keeps its own counters; the lock makes the get-or-create one step.
_tickets = {}
_tickets_lock = threading.Lock()


def _ticket_counters(device: torch.device, stream: torch.cuda.Stream, n: int) -> torch.Tensor:
    key = (device, stream.cuda_stream)
    with _tickets_lock:
        t = _tickets.get(key)
        if t is None or t.numel() < n:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "bn_stats kernel: first launch on this stream inside a CUDA graph capture; its ticket counters "
                    "would be zeroed only when the graph replays. Launch it once on the capturing stream first."
                )
            with torch.cuda.stream(stream):
                t = _tickets[key] = torch.zeros((max(n, 4096),), dtype=torch.int32, device=device)
    return t


def _launch_kernel(x: torch.Tensor, fn=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch csrc/bn_stats.cu on a contiguous fp32/bf16 CUDA activation: one
    kernel, its partials combined in the same launch. ``fn``: the C entry
    point of another build of the source (``compare_kernels``); default the
    package's."""
    global launch_count
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"bn_stats kernel takes fp32 or bf16, got {x.dtype}")
    if x.dim() < 2 or not x.is_contiguous() or x.numel() == 0:
        raise ValueError(
            f"bn_stats kernel needs a non-empty contiguous (B, C, ...) activation (NCHW), got shape "
            f"{tuple(x.shape)} strides {x.stride()}"
        )
    plan = launch_plan(tuple(x.shape), x.element_size(), aligned=x.data_ptr() % 16 == 0)
    fn = fn or kernel_function("bn_stats", "ihmr_bn_stats_forward", _FORWARD_ARGS)
    C = plan.channels
    stream = torch.cuda.current_stream(x.device)
    tickets = _ticket_counters(x.device, stream, plan.groups)
    # one allocation: (sums, sums of squares), then the partials
    buf = torch.empty((2 * C + plan.scratch_floats,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), _DTYPE_CODE[x.dtype], buf.data_ptr(), buf.data_ptr() + 8 * C, tickets.data_ptr(),
            int(plan.path == "tiles"), int(plan.vector), plan.batch, C, plan.hw, plan.ct, plan.groups, plan.rows,
            plan.slices, plan.grid, stream.cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"bn_stats kernel launch failed: cudaError {err}")
    with _count_lock:
        launch_count += 1
    return buf[:C], buf[C : 2 * C]


class BNStats(torch.autograd.Function):
    """(sum x, sum x^2) per channel, differentiable in x."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        if x.is_cuda:
            return _launch_kernel(x)
        if x.device.type == "cpu":
            return bn_stats_reference(x)
        raise RuntimeError(f"no bn_stats implementation for device {x.device}")

    @staticmethod
    def backward(ctx, gs, gs2):
        (x,) = ctx.saved_tensors
        view = (1, x.shape[1]) + (1,) * (x.dim() - 2)
        gx = 2.0 * x.float() * gs2.reshape(view)
        gx = gs.reshape(view) + gx
        return gx.to(x.dtype)


def bn_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, C, S...) activation -> (sum x, sum x^2), each (C,) fp32, summed over
    every axis but axis 1. Kernel on CUDA tensors, plain version on CPU
    tensors; differentiable (d/dx = gs + 2 x gs2)."""
    return BNStats.apply(x)


def batch_moments(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, var) per channel via ``bn_stats``: flax's fast-variance formula,
    var = max(0, E[x^2] - E[x]^2), fp32."""
    n = x.numel() // x.shape[1]
    s, s2 = bn_stats(x)
    mean = s / n
    v = s2 / n - mean * mean
    var = torch.maximum(torch.zeros_like(v), v)  # jnp.maximum's derivative: a tie at 0 splits 0.5 / 0.5
    return mean, var
