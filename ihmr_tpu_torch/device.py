"""Device resolution for the port's entry points.

The port runs on the GPU. The CPU is used only when a caller asks for it
explicitly (the CPU parity tests do); a missing card is an error, never a
silent fallback.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """None or "cuda[:k]" -> a CUDA device (raises without one); "cpu" -> CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU explicitly"
        )
    return dev


def set_fp32_matmul_precision() -> None:
    """Full fp32 for matmuls and convolutions (no TF32), the precision the
    parity tolerances assume (the JAX side pins Precision.HIGH/HIGHEST)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
