"""Plain ResNet-50 encoder of IHMR for the benchmark's reference.

A functional network over a dict of tensors named as torchvision names them
(under ``main_encoder.``), with IHMR's head: global mean -> ReLU -> fc1
(2048 -> 1024) -> ReLU is the backbone's feature; then ReLU -> Linear(1024,
1024) -> ReLU, a 3-iteration residual regressor Linear(1024 + 122, 122)
from the mean parameters, and a sigmoid Linear(1024, 2) for handedness.
The stem is conv 7x7/2 pad 3, BatchNorm, ReLU, max-pool 3x3/2 pad 1; a
bottleneck strides its 3x3 convolution (v1.5) and projects its shortcut by
a strided 1x1 convolution and BatchNorm where the shape changes.

BatchNorm (eps 1e-5) in train mode takes flax's fast variance
max(0, E[x^2] - E[x]^2) over (N, H, W), normalises as
(x - mean) * (rsqrt(var + eps) * weight) + bias, and returns the batch
moments for the running statistics (0.9 running + 0.1 batch, the biased
variance). In eval mode it normalises with the running statistics.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch.nn import functional as F

STAGES = (3, 4, 6, 3)
EXPANSION = 4
FEATURE = 1024
PARAMS = 122
BN_EPS = 1e-5
BN_MOMENTUM = 0.9


def bottlenecks() -> List[Tuple[str, int, int, int, bool]]:
    """(prefix, input channels, width, stride, has projection) of each block."""
    out, cin = [], 64
    for i, n in enumerate(STAGES):
        width = 64 * 2**i
        for j in range(n):
            stride = 2 if i > 0 and j == 0 else 1
            out.append((f"main_encoder.layer{i + 1}.{j}", cin, width, stride, stride != 1 or cin != width * EXPANSION))
            cin = width * EXPANSION
    return out


def param_shapes() -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """name -> (shape, kind); kind is "weight" (a convolution or dense
    kernel), "bias", "bn_weight", "bn_bias", "bn_mean" or "bn_var"."""
    spec: Dict[str, Tuple[Tuple[int, ...], str]] = {}

    def bn(prefix, c):
        for suffix, kind in (("weight", "bn_weight"), ("bias", "bn_bias"), ("running_mean", "bn_mean"), ("running_var", "bn_var")):
            spec[f"{prefix}.{suffix}"] = ((c,), kind)

    spec["main_encoder.conv1.weight"] = ((64, 3, 7, 7), "weight")
    bn("main_encoder.bn1", 64)
    for prefix, cin, w, _stride, proj in bottlenecks():
        spec[f"{prefix}.conv1.weight"] = ((w, cin, 1, 1), "weight")
        bn(f"{prefix}.bn1", w)
        spec[f"{prefix}.conv2.weight"] = ((w, w, 3, 3), "weight")
        bn(f"{prefix}.bn2", w)
        spec[f"{prefix}.conv3.weight"] = ((w * EXPANSION, w, 1, 1), "weight")
        bn(f"{prefix}.bn3", w * EXPANSION)
        if proj:
            spec[f"{prefix}.downsample.0.weight"] = ((w * EXPANSION, cin, 1, 1), "weight")
            bn(f"{prefix}.downsample.1", w * EXPANSION)
    for name, shape in (
        ("main_encoder.fc1", (FEATURE, 2048)),
        ("feat_encoder.1", (FEATURE, FEATURE)),
        ("regressor_ih.0", (PARAMS, FEATURE + PARAMS)),
        ("hand_classifier.0", (2, FEATURE)),
    ):
        spec[f"{name}.weight"] = (shape, "weight")
        spec[f"{name}.bias"] = ((shape[0],), "bias")
    return spec


class _TrainBN(torch.autograd.Function):
    """Train-mode BatchNorm with flax's fast variance; backward by the
    closed form of its gradient (it keeps x and the statistics only)."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        n = x.numel() // x.shape[1]
        mean = x.mean((0, 2, 3))
        var = torch.clamp((x * x).mean((0, 2, 3)) - mean * mean, min=0.0)
        r = torch.rsqrt(var + BN_EPS)
        ctx.save_for_backward(x, mean, r, weight)
        ctx.n = n
        ctx.mark_non_differentiable(mean, var)
        y = (x - mean[None, :, None, None]) * (r * weight)[None, :, None, None] + bias[None, :, None, None]
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gm, _gv):
        x, mean, r, weight = ctx.saved_tensors
        xhat = (x - mean[None, :, None, None]) * r[None, :, None, None]
        gb = gy.sum((0, 2, 3))
        gw = (gy * xhat).sum((0, 2, 3))
        gx = (weight * r)[None, :, None, None] * (
            gy - (gb / ctx.n)[None, :, None, None] - xhat * (gw / ctx.n)[None, :, None, None]
        )
        return gx, gw, gb


def _bn(x, p, prefix, train, stats):
    w, b = p[f"{prefix}.weight"], p[f"{prefix}.bias"]
    if train:
        y, mean, var = _TrainBN.apply(x, w, b)
        stats[prefix] = (mean.detach(), var.detach())
        return y
    rm, rv = p[f"{prefix}.running_mean"], p[f"{prefix}.running_var"]
    return (x - rm[None, :, None, None]) * (torch.rsqrt(rv + BN_EPS) * w)[None, :, None, None] + b[None, :, None, None]


def backbone(p, images, train: bool = False, stats=None):
    """images (B, H, W, 3) -> feature (B, 1024)."""
    x = images.permute(0, 3, 1, 2).contiguous()
    x = F.conv2d(x, p["main_encoder.conv1.weight"], stride=2, padding=3)
    x = F.max_pool2d(torch.relu(_bn(x, p, "main_encoder.bn1", train, stats)), 3, 2, 1)
    for prefix, _cin, _w, stride, proj in bottlenecks():
        y = torch.relu(_bn(F.conv2d(x, p[f"{prefix}.conv1.weight"]), p, f"{prefix}.bn1", train, stats))
        y = torch.relu(_bn(F.conv2d(y, p[f"{prefix}.conv2.weight"], stride=stride, padding=1), p, f"{prefix}.bn2", train, stats))
        y = _bn(F.conv2d(y, p[f"{prefix}.conv3.weight"]), p, f"{prefix}.bn3", train, stats)
        if proj:
            x = _bn(F.conv2d(x, p[f"{prefix}.downsample.0.weight"], stride=stride), p, f"{prefix}.downsample.1", train, stats)
        x = torch.relu(y + x)
    x = torch.relu(x.mean((2, 3)))
    return torch.relu(F.linear(x, p["main_encoder.fc1.weight"], p["main_encoder.fc1.bias"]))


def encoder(p, images, mean_params, train: bool = False, stats=None):
    """-> (params (B, 122), hand type (B, 2))."""
    feat = torch.relu(F.linear(torch.relu(backbone(p, images, train, stats)), p["feat_encoder.1.weight"], p["feat_encoder.1.bias"]))
    pred = mean_params.expand(feat.shape[0], PARAMS)
    for _ in range(3):
        pred = pred + F.linear(torch.cat([feat, pred], -1), p["regressor_ih.0.weight"], p["regressor_ih.0.bias"])
    return pred, torch.sigmoid(F.linear(feat, p["hand_classifier.0.weight"], p["hand_classifier.0.bias"]))


def mean_params(device) -> torch.Tensor:
    """IHMR's regressor start: cam (5, 0, 0), zero pose and betas, zero trans."""
    m = torch.zeros(PARAMS, device=device)
    m[0] = 5.0
    return m


def running_update(p, stats) -> None:
    """Running statistics after a train-mode forward, in place."""
    with torch.no_grad():
        for prefix, (mean, var) in stats.items():
            p[f"{prefix}.running_mean"].mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * mean)
            p[f"{prefix}.running_var"].mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * var)
