from ihmr_tpu_torch.models.encoder import (
    InterHandEncoder,
    SubNetwork,
    build_mean_params,
    init_encoder_weights,
    init_subnetwork_weights,
)
from ihmr_tpu_torch.models.resnet import ARCHS, ResNet, get_backbone

__all__ = [
    "ARCHS",
    "InterHandEncoder",
    "ResNet",
    "SubNetwork",
    "build_mean_params",
    "get_backbone",
    "init_encoder_weights",
    "init_subnetwork_weights",
]
