from ihmr_tpu_torch.models.encoder import InterHandEncoder, build_mean_params, init_encoder_weights
from ihmr_tpu_torch.models.resnet import ARCHS, ResNet, get_backbone

__all__ = ["ARCHS", "InterHandEncoder", "ResNet", "build_mean_params", "get_backbone", "init_encoder_weights"]
