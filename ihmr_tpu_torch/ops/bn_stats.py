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
It reads the contiguous activation in place, fp32 or bf16, and accumulates
in fp32 without atomics, so its result has the same bits run to run; the
launch plan (``launch_plan``) depends on the shape and alignment alone. It
raises on any other layout (channels-last, strided views).
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
from typing import NamedTuple, Tuple

import torch

THREADS = 256  # threads per block (csrc/bn_stats.cu kThreads)
TARGET_BLOCKS = 1024  # about 8 blocks of 256 threads per SM on 132 SMs
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# launches of the CUDA kernel (incremented only where the kernel is launched)
launch_count = 0


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


class LaunchPlan(NamedTuple):
    batch: int  # runs per channel (axis 0)
    channels: int
    hw: int  # elements per run (the product of the spatial axes)
    vector: bool  # 16-byte loads
    team: int  # threads per run
    runs_per_slice: int
    slices: int  # blocks per channel


def launch_plan(shape: Tuple[int, ...], element_size: int, aligned: bool = True) -> LaunchPlan:
    """The kernel's grid for an activation of ``shape`` (B, C, S...):
    vector loads when a run is a whole number of 16-byte vectors and the base
    is 16-byte ``aligned``; a team of the smallest power of two in 32..256
    threads that covers one run's loads; enough slices of the batch that the
    grid has about TARGET_BLOCKS blocks, no more slices than a team count of
    runs allows."""
    if len(shape) < 2:
        raise ValueError(f"expected (B, C, ...) activations, got shape {tuple(shape)}")
    batch, channels = int(shape[0]), int(shape[1])
    hw = math.prod(int(d) for d in shape[2:])
    width = 16 // element_size
    vector = aligned and hw % width == 0
    loads = hw // width if vector else hw
    team = min(THREADS, max(32, 1 << max(0, loads - 1).bit_length()))
    teams = THREADS // team
    slices = max(1, min(-(-batch // teams), -(-TARGET_BLOCKS // channels)))
    runs_per_slice = -(-batch // slices)
    slices = -(-batch // runs_per_slice)
    return LaunchPlan(batch, channels, hw, vector, team, runs_per_slice, slices)


def _reduce_dims(x: torch.Tensor) -> Tuple[int, ...]:
    return (0,) + tuple(range(2, x.dim()))


def bn_stats_reference(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (sum x, sum x^2) per channel (axis 1), fp32."""
    xf = x.float()
    dims = _reduce_dims(x)
    return xf.sum(dims), (xf * xf).sum(dims)


_forward_fn = None  # the configured ctypes entry point, set at the first launch


def _kernel_entry():
    global _forward_fn
    if _forward_fn is None:
        from ihmr_tpu_torch.build import load_library

        fn = load_library("bn_stats").ihmr_bn_stats_forward
        fn.argtypes = (
            [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_longlong]
            + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _forward_fn = fn
    return _forward_fn


def _launch_kernel(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch csrc/bn_stats.cu on a contiguous fp32/bf16 CUDA activation."""
    global launch_count
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"bn_stats kernel takes fp32 or bf16, got {x.dtype}")
    if x.dim() < 2 or not x.is_contiguous() or x.numel() == 0:
        raise ValueError(
            f"bn_stats kernel needs a non-empty contiguous (B, C, ...) activation (NCHW), got shape "
            f"{tuple(x.shape)} strides {x.stride()}"
        )
    plan = launch_plan(tuple(x.shape), x.element_size(), aligned=x.data_ptr() % 16 == 0)
    fn = _kernel_entry()
    C = plan.channels
    # one allocation: (sum, sum of squares), then the slices' partials
    buf = torch.empty((2 * C * (1 + plan.slices if plan.slices > 1 else 1),), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), _DTYPE_CODE[x.dtype], buf.data_ptr(), buf.data_ptr() + 4 * C, buf.data_ptr() + 8 * C,
            plan.batch, C, plan.hw, plan.team, plan.runs_per_slice, plan.slices, int(plan.vector),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"bn_stats kernel launch failed: cudaError {err}")
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
    var = torch.clamp(s2 / n - mean * mean, min=0.0)
    return mean, var
