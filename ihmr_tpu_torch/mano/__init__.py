from ihmr_tpu_torch.mano.layer import HandParams, joints21, mano_decode, two_hand_decode, two_hand_decode_mirrored
from ihmr_tpu_torch.mano.loader import (
    load_mano_model,
    load_mano_pair,
    mirror_mano_model,
    sort_faces_spatially,
    synthetic_mano_model,
)
from ihmr_tpu_torch.mano.model import FINGERTIP_VERTEX_IDS, MANO_PARENTS, ManoModel

__all__ = [
    "FINGERTIP_VERTEX_IDS",
    "HandParams",
    "MANO_PARENTS",
    "ManoModel",
    "joints21",
    "load_mano_model",
    "load_mano_pair",
    "mano_decode",
    "mirror_mano_model",
    "sort_faces_spatially",
    "synthetic_mano_model",
    "two_hand_decode",
    "two_hand_decode_mirrored",
]
