"""ResNet backbone with the IHMR feature head (port of ihmr_tpu/models/resnet.py).

resnet18/34/50/101/152 whose classifier is replaced by avgpool -> relu ->
fc1 (512 * expansion -> 1024) -> relu, giving a 1024-d image feature.
Parameter names follow torchvision (``layer1.0.conv1.weight``,
``layer1.0.downsample.0.weight``, ...), so torchvision-style state dicts load
natively; ``convert.encoder_from_jax`` maps the flax names onto them.

BatchNorm (eps 1e-5): in eval mode ``nn.BatchNorm2d``'s own path with the
running statistics; in train mode flax's (``BatchNorm``). The stem max-pool
pads with -inf (3x3, stride 2, padding 1); 3x3 convolutions pad 1, 1x1
convolutions (incl. the strided downsample) pad 0 — the same geometry as
the flax model. The public input is NHWC (B, H, W, 3), as in JAX; the
module makes a contiguous NCHW copy inside, so every activation is
contiguous NCHW (the layout the BatchNorm-statistics kernel reads).

Mixed precision (``dtype=torch.bfloat16``, the JAX package's
``ResNet(dtype=bfloat16)``) follows flax's casts, not torch's autocast:
the input is cast to bf16 once, each convolution computes in bf16 with its
fp32 weight cast to bf16 (fp32 accumulation, a bf16 output); BatchNorm
takes its statistics in fp32 (K3 reads the bf16 activation in place),
normalises in fp32 (``(x - mean) * (rsqrt(var + eps) * scale) + bias``,
flax's ``_normalize`` promotes the bf16 input to the fp32 statistics) and
rounds the result to bf16, in train and in eval mode; residual adds, ReLU
and max-pool stay bf16; the global mean accumulates in fp32 and rounds to
bf16; ``fc1`` rounds its bf16 product to bf16 before adding the bf16 bias,
as ``nn.Dense(dtype=bf16)`` does; the feature comes back as fp32,
``relu(x.float())``. Parameters, running statistics and checkpoints stay
fp32.
"""

from __future__ import annotations

from typing import Sequence, Type, Union

import torch
from torch import nn
from torch.nn import functional as F

from ihmr_tpu_torch.ops.bn_stats import batch_moments, bn_stats, bn_stats_reference
from ihmr_tpu_torch.parallel.mesh import current_shard

BN_IMPLS = ("stock", "fused", "pallas")
BN_MOMENTUM = 0.9  # flax: running = momentum * running + (1 - momentum) * batch


def _moments(x: torch.Tensor, impl: str):
    """Per-channel (mean, var) of an NCHW activation, flax's fast variance
    max(0, E[x^2] - E[x]^2) in fp32, by the statistics implementation of the
    JAX package's ``IHMR_BN_IMPL`` of the same name:
    "stock" (nn.BatchNorm: mean(x) and mean(x * x)), "fused"
    (FusedStatsBatchNorm: one pass of sums, here the plain version of K3)
    or "pallas" (PallasStatsBatchNorm: the kernel K3)."""
    if impl == "pallas":
        return batch_moments(x)
    if impl == "fused":
        s, s2 = bn_stats_reference(x)
        n = x.numel() // x.shape[1]
        mean = s / n
        return mean, torch.clamp(s2 / n - mean * mean, min=0.0)
    xf = x.float()
    mean = xf.mean((0, 2, 3))
    return mean, torch.clamp((xf * xf).mean((0, 2, 3)) - mean * mean, min=0.0)


def _global_moments(x: torch.Tensor, impl: str, shard):
    """``_moments`` over the global batch of a data-parallel step, from
    inside one shard of it (``parallel.mesh``): this shard's (sum x, sum
    x^2) by ``impl`` (K3 for "pallas"; its plain version for "fused", and
    for "stock" the sums that mean(x) and mean(x * x) take), summed over
    the shards in shard order, then divided by the global count, and
    flax's max(0, E[x^2] - E[x]^2) taken once on the global moments, as
    the JAX package's one program over the global batch computes them. The
    sum is differentiable (``Shard.all_sum``)."""
    s, s2 = bn_stats(x) if impl == "pallas" else bn_stats_reference(x)
    s, s2, n = shard.all_sum((s, s2, x.numel() // x.shape[1]))
    mean = s / n
    v = s2 / n - mean * mean
    # jnp.maximum's derivative on K3's path, as batch_moments; clamp's on the others, as _moments
    return mean, torch.maximum(torch.zeros_like(v), v) if impl == "pallas" else torch.clamp(v, min=0.0)


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (same state-dict names) whose train mode is flax's
    ``nn.BatchNorm``: batch moments by ``bn_impl`` (see ``_moments``),
    y = (x - mean) * (rsqrt(var + eps) * weight) + bias, and running stats
    updated with the biased variance, running = 0.9 running + 0.1 batch.
    torch's own train mode would update the running variance with the
    unbiased n / (n - 1) variance. ``num_batches_tracked`` is not advanced
    (flax keeps no such count). Eval mode is ``nn.BatchNorm2d``'s path on
    fp32 inputs; on bf16 inputs it is the formula above with the running
    statistics. The output has the input's dtype (see the module docstring).

    In train mode inside a shard of a data-parallel step
    (``parallel.mesh.Mesh.map``) the moments are the global batch's
    (``_global_moments``), and only shard 0 updates the running statistics,
    once, from them."""

    def __init__(self, num_features: int, bn_impl: str = "stock"):
        if bn_impl not in BN_IMPLS:
            raise ValueError(f"bn_impl must be one of {BN_IMPLS}, got {bn_impl!r}")
        super().__init__(num_features, eps=1e-5, momentum=1.0 - BN_MOMENTUM)
        self.bn_impl = bn_impl

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            shard = current_shard()
            mean, var = _moments(x, self.bn_impl) if shard is None else _global_moments(x, self.bn_impl, shard)
            if shard is None or shard.index == 0:
                with torch.no_grad():
                    self.running_mean.copy_(BN_MOMENTUM * self.running_mean + (1.0 - BN_MOMENTUM) * mean)
                    self.running_var.copy_(BN_MOMENTUM * self.running_var + (1.0 - BN_MOMENTUM) * var)
        elif x.dtype == torch.float32:
            return super().forward(x)
        else:
            mean, var = self.running_mean, self.running_var
        view = (1, -1, 1, 1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        # a bf16 x promotes to the fp32 statistics; the result rounds back once
        return ((x - mean.reshape(view)) * mul.reshape(view) + self.bias.reshape(view)).to(x.dtype)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in its input's dtype: a bf16 input meets
    the fp32 weight cast to bf16 (flax's ``nn.Conv(dtype=bf16)``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), None)


class Linear(nn.Linear):
    """``nn.Linear`` that computes in its input's dtype. A bf16 input meets
    the weight and the bias cast to bf16, and the product is rounded to
    bf16 before the bias is added, as in flax's ``nn.Dense(dtype=bf16)``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        return F.linear(x, self.weight.to(x.dtype)) + self.bias.to(x.dtype)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> Conv2d:
    return Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int = 1, bn_impl: str = "stock"):
        super().__init__()
        self.conv1 = _conv(cin, filters, 3, stride)
        self.bn1 = BatchNorm(filters, bn_impl)
        self.conv2 = _conv(filters, filters, 3)
        self.bn2 = BatchNorm(filters, bn_impl)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or cin != filters:
            self.downsample = nn.Sequential(_conv(cin, filters, 1, stride), BatchNorm(filters, bn_impl))

    def forward(self, x):
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1, bn_impl: str = "stock"):
        super().__init__()
        out = filters * self.expansion
        self.conv1 = _conv(cin, filters, 1)
        self.bn1 = BatchNorm(filters, bn_impl)
        self.conv2 = _conv(filters, filters, 3, stride)  # stride on the 3x3 (v1.5)
        self.bn2 = BatchNorm(filters, bn_impl)
        self.conv3 = _conv(filters, out, 1)
        self.bn3 = BatchNorm(out, bn_impl)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or cin != out:
            self.downsample = nn.Sequential(_conv(cin, out, 1, stride), BatchNorm(out, bn_impl))

    def forward(self, x):
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(y + residual)


class ResNet(nn.Module):
    """ResNet trunk ending in the IHMR 1024-d feature head. ``bn_impl``
    chooses how train-mode BatchNorm computes its batch moments
    (``BatchNorm``); ``dtype`` (fp32 or bf16) the dtype its convolutions,
    BatchNorm outputs and ``fc1`` compute in (module docstring)."""

    def __init__(
        self,
        stage_sizes: Sequence[int],
        block: Type[Union[BasicBlock, Bottleneck]],
        feature_dim: int = 1024,
        bn_impl: str = "stock",
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, got {dtype}")
        self.dtype = dtype
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64, bn_impl)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        cin = 64
        for i, n in enumerate(stage_sizes):
            blocks = []
            for j in range(n):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block(cin, 64 * 2**i, stride, bn_impl))
                cin = 64 * 2**i * block.expansion
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        self.num_stages = len(stage_sizes)
        self.fc1 = Linear(cin, feature_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, 3) NHWC -> (B, feature_dim)."""
        # a contiguous NCHW copy: the permuted view is channels-last in memory,
        # and convolutions would carry that layout through the whole network
        x = x.permute(0, 3, 1, 2).contiguous().to(self.dtype)
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for i in range(self.num_stages):
            x = getattr(self, f"layer{i + 1}")(x)
        x = torch.relu(x.mean(dim=(2, 3)))
        return torch.relu(self.fc1(x).float())


ARCHS = {
    "resnet18": ((2, 2, 2, 2), BasicBlock),
    "resnet34": ((3, 4, 6, 3), BasicBlock),
    "resnet50": ((3, 4, 6, 3), Bottleneck),
    "resnet101": ((3, 4, 23, 3), Bottleneck),
    "resnet152": ((3, 8, 36, 3), Bottleneck),
}


def get_backbone(arch: str, **kwargs) -> ResNet:
    """``kwargs``: ``feature_dim``, ``bn_impl``, ``dtype`` (see ``ResNet``)."""
    if arch not in ARCHS:
        raise ValueError(f"Invalid backbone architecture: {arch}")
    stage_sizes, block = ARCHS[arch]
    return ResNet(stage_sizes, block, **kwargs)
