"""ResNet backbone with the IHMR feature head (port of ihmr_tpu/models/resnet.py).

resnet18/34/50/101/152 whose classifier is replaced by avgpool -> relu ->
fc1 (512 * expansion -> 1024) -> relu, giving a 1024-d image feature.
Parameter names follow torchvision (``layer1.0.conv1.weight``,
``layer1.0.downsample.0.weight``, ...), so torchvision-style state dicts load
natively; ``convert.encoder_from_jax`` maps the flax names onto them.

Stock BatchNorm (eps 1e-5) in eval mode uses the running statistics; the
stem max-pool pads with -inf (3x3, stride 2, padding 1); 3x3 convolutions pad
1, 1x1 convolutions (incl. the strided downsample) pad 0 — the same
geometry as the flax model. The public input is NHWC (B, H, W, 3), as in
JAX; the module permutes to NCHW inside.
"""

from __future__ import annotations

from typing import Sequence, Type, Union

import torch
from torch import nn


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)  # torch momentum 0.1 == flax 0.9


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, filters, 3, stride)
        self.bn1 = _bn(filters)
        self.conv2 = _conv(filters, filters, 3)
        self.bn2 = _bn(filters)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or cin != filters:
            self.downsample = nn.Sequential(_conv(cin, filters, 1, stride), _bn(filters))

    def forward(self, x):
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1):
        super().__init__()
        out = filters * self.expansion
        self.conv1 = _conv(cin, filters, 1)
        self.bn1 = _bn(filters)
        self.conv2 = _conv(filters, filters, 3, stride)  # stride on the 3x3 (v1.5)
        self.bn2 = _bn(filters)
        self.conv3 = _conv(filters, out, 1)
        self.bn3 = _bn(out)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or cin != out:
            self.downsample = nn.Sequential(_conv(cin, out, 1, stride), _bn(out))

    def forward(self, x):
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(y + residual)


class ResNet(nn.Module):
    """ResNet trunk ending in the IHMR 1024-d feature head."""

    def __init__(
        self,
        stage_sizes: Sequence[int],
        block: Type[Union[BasicBlock, Bottleneck]],
        feature_dim: int = 1024,
    ):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = _bn(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        cin = 64
        for i, n in enumerate(stage_sizes):
            blocks = []
            for j in range(n):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block(cin, 64 * 2**i, stride))
                cin = 64 * 2**i * block.expansion
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        self.num_stages = len(stage_sizes)
        self.fc1 = nn.Linear(cin, feature_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, 3) NHWC -> (B, feature_dim)."""
        x = x.permute(0, 3, 1, 2)
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for i in range(self.num_stages):
            x = getattr(self, f"layer{i + 1}")(x)
        x = torch.relu(x.mean(dim=(2, 3)))
        return torch.relu(self.fc1(x))


ARCHS = {
    "resnet18": ((2, 2, 2, 2), BasicBlock),
    "resnet34": ((3, 4, 6, 3), BasicBlock),
    "resnet50": ((3, 4, 6, 3), Bottleneck),
    "resnet101": ((3, 4, 23, 3), Bottleneck),
    "resnet152": ((3, 8, 36, 3), Bottleneck),
}


def get_backbone(arch: str, **kwargs) -> ResNet:
    if arch not in ARCHS:
        raise ValueError(f"Invalid backbone architecture: {arch}")
    stage_sizes, block = ARCHS[arch]
    return ResNet(stage_sizes, block, **kwargs)
