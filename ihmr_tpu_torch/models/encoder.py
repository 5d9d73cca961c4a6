"""InterHandEncoder and the MLP stage network (port of ihmr_tpu/models/encoder.py).

backbone -> relu -> fc2 (1024 -> 1024) -> relu -> 3-iteration residual
regressor from the mean parameter vector -> 122 params; a sigmoid 2-way
handedness classifier on the same feature. Submodule names follow the
reference's torch encoder (``main_encoder``, ``feat_encoder.1``,
``regressor_ih.0``, ``hand_classifier.0``), so its checkpoints load natively.

``SubNetwork``: the per-stage refinement MLP of IHMR-MLP,
(B, 1024 + 122) -> 512 -> 256 -> 128 -> (B, update_dim), ReLU between layers.
"""

from __future__ import annotations

import torch
from torch import nn

from ihmr_tpu_torch.device import DeviceLike, resolve_device
from ihmr_tpu_torch.models.resnet import get_backbone

TOTAL_PARAMS_DIM = 122


class InterHandEncoder(nn.Module):
    """Images (B, H, W, 3) NHWC -> (params (B, 122), hand_type (B, 2))."""

    def __init__(self, arch: str = "resnet50", total_params_dim: int = TOTAL_PARAMS_DIM, num_iterations: int = 3):
        super().__init__()
        self.main_encoder = get_backbone(arch)
        self.feat_encoder = nn.Sequential(nn.ReLU(), nn.Linear(1024, 1024), nn.ReLU())
        self.regressor_ih = nn.Sequential(nn.Linear(1024 + total_params_dim, total_params_dim))
        self.hand_classifier = nn.Sequential(nn.Linear(1024, 2), nn.Sigmoid())
        self.total_params_dim = total_params_dim
        self.num_iterations = num_iterations

    def features(self, images: torch.Tensor) -> torch.Tensor:
        """The 1024-d feature (the MLP cascade's img_feat)."""
        return self.feat_encoder(self.main_encoder(images))

    def forward(self, images: torch.Tensor, mean_params: torch.Tensor):
        """mean_params: (122,) or (B, 122), the start of the iterative regressor."""
        feat = self.features(images)
        pred = mean_params.expand(feat.shape[0], self.total_params_dim)
        for _ in range(self.num_iterations):
            pred = pred + self.regressor_ih(torch.cat([feat, pred], dim=-1))
        return pred, self.hand_classifier(feat)


class SubNetwork(nn.Module):
    """Per-stage refinement MLP: (B, 1024 + 122) -> (B, update_dim)."""

    def __init__(self, update_dim: int, in_dim: int = 1024 + TOTAL_PARAMS_DIM):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, 512)
        self.fc2 = nn.Linear(512, 256)
        self.fc3 = nn.Linear(256, 128)
        self.regressor = nn.Linear(128, update_dim)
        self.update_dim = update_dim

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.fc1(inputs))
        x = torch.relu(self.fc2(x))
        x = torch.relu(self.fc3(x))
        return self.regressor(x)


@torch.no_grad()
def init_subnetwork_weights(net: SubNetwork, generator: torch.Generator, gain: float = 0.01) -> None:
    """The JAX package's init: xavier-uniform kernels times ``gain``, zero
    biases; drawn on the CPU from ``generator`` and copied to the weights'
    device."""
    for layer in (net.fc1, net.fc2, net.fc3, net.regressor):
        fan_out, fan_in = layer.weight.shape
        limit = (6.0 / (fan_in + fan_out)) ** 0.5
        w = (torch.rand(layer.weight.shape, generator=generator) * 2.0 - 1.0) * limit * gain
        layer.weight.copy_(w)
        layer.bias.zero_()


def build_mean_params(mean_pose, mean_betas, device: DeviceLike = None) -> torch.Tensor:
    """The 122-d mean vector on ``device`` (CUDA unless "cpu" is asked for):
    cam = (5, 0, 0); pose = the mean pose twice with a zeroed global orient;
    shape = the mean betas twice; trans = 0."""
    device = resolve_device(device)
    mean_pose = torch.as_tensor(mean_pose, dtype=torch.float32, device=device).reshape(48).clone()
    mean_pose[:3] = 0.0
    mean_betas = torch.as_tensor(mean_betas, dtype=torch.float32, device=device).reshape(10)
    cam = torch.tensor([5.0, 0.0, 0.0], device=device)
    return torch.cat([cam, mean_pose, mean_pose, mean_betas, mean_betas, torch.zeros(3, device=device)])


@torch.no_grad()
def init_encoder_weights(encoder: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights (flax's defaults: lecun-normal convolution and
    dense kernels, zero biases, unit BatchNorm scale, zero-mean unit-variance
    running statistics). For benchmarks and smoke runs without trained weights."""
    for mod in encoder.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            fan_in = mod.weight[0].numel()
            mod.weight.normal_(0.0, fan_in**-0.5, generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.BatchNorm2d):
            mod.reset_parameters()
