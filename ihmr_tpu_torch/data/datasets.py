"""Datasets: annotation loading, per-sample assembly, augmentation (port of
ihmr_tpu/data/datasets.py).

  * annotation pkl = list of dicts with keys img_path, hand_type,
    hand_type_valid, joints_2d (42, 2|3), joints_3d (42, 3|4), scale,
    right_hand_param/left_hand_param {pose (48,), shape (10,)}, and optionally
    param_path (a per-image param pkl merged at load)
  * prediction pkl = dict img_path -> {pred_cam_params, pred_shape_params,
    pred_pose_params, pred_hand_trans, joints_2d, joints_3d, img_feat}
    (joints_2d/joints_3d come from the keypoint predictor, not from decoding
    the predicted MANO params)

Items are numpy dicts with the JAX package's keys, shapes and dtypes. The
augmentation RNG is ``random.Random(seed)``, drawn in the JAX package's
order, so one seed flips and rescales the same samples in both packages.
Single-hand left samples are always flipped to right (train and eval); eval
datasets pad to a multiple of batch * world_size by repeating the first
sample (``num_add``).

Images are read by ``image_io.imread`` (PNG decoded by the port; JPEG needs
cv2). ``BaselineDataset`` letterboxes with ``preprocess.padding_and_resize``;
the prediction datasets with the native letterbox
(``native.letterbox_normalize``), as the JAX package does when its native
library is built: the port has no other path there and raises if the
library cannot be built. Not ported yet: the rotation, colour-jitter and
motion-blur augmentations (a config that asks for them raises).
"""

from __future__ import annotations

import os.path as osp
import random
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ihmr_tpu_torch.data import native
from ihmr_tpu_torch.data import preprocess as pp
from ihmr_tpu_torch.data.image_io import imread
from ihmr_tpu_torch.utils import io_utils

_UNPORTED_AUGMENTATIONS = ("use_random_rotation", "use_color_jittering", "use_motion_blur")


@dataclass
class DataConfig:
    data_root: str = ""
    param_root: str = ""
    image_root: str = "hand26m/image"
    anno_path: str = ""
    pred_path: str = ""
    batch_size: int = 64
    world_size: int = 1
    input_size: int = 224
    num_joints: int = 42
    is_train: bool = False
    # augmentation switches
    use_random_flip: bool = False
    use_random_rescale: bool = False
    use_random_position: bool = False
    use_random_rotation: bool = False
    use_color_jittering: bool = False
    use_motion_blur: bool = False
    blur_kernel_dir: str = ""
    motion_blur_prob: float = 0.5
    use_opt_params: bool = False  # MLP trains against OPT pseudo-GT
    # pkl of img_path -> {opt_pose_params, opt_shape_params, opt_hand_trans}
    # written by `optimize --export_pseudo_gt`
    opt_params_path: str = ""


def load_annotation(data_root: str, anno_path: str) -> List[dict]:
    """The annotation pkl's list, or, for a directory, one entry per image under it."""
    full = osp.join(data_root, anno_path) if data_root else anno_path
    if osp.isdir(full):
        data_list = []
        for rel in io_utils.get_all_files(full, path_type="relative"):
            if rel.lower().endswith((".jpg", ".jpeg", ".png")):
                data_list.append(dict(img_path=rel))
        if not data_list:
            raise ValueError(f"{full} contains no image")
        return data_list
    data = io_utils.load_pkl(full)
    if not isinstance(data, list):
        raise ValueError(f"{full}: an annotation pkl holds a list, not {type(data).__name__}")
    return data


def load_anno_pred_data(data_root: str, anno_path: str, pred_path: str) -> List[dict]:
    """Join the annotations with the prediction pkl on img_path."""
    annos = load_annotation(data_root, anno_path)
    pred_full = osp.join(data_root, pred_path) if data_root else pred_path
    preds = io_utils.load_pkl(pred_full)
    out = []
    for anno in annos:
        pred = preds[anno["img_path"]]
        merged = dict(anno)
        for key in ("pred_cam_params", "pred_shape_params", "pred_pose_params", "pred_hand_trans"):
            merged[key] = pred[key]
        for key in ("joints_2d", "joints_3d"):
            merged[f"pred_{key}"] = pred[key]
        merged["img_feat"] = pred["img_feat"]
        out.append(merged)
    if not out:
        raise ValueError(f"{anno_path}: no annotation to join with the predictions")
    return out


def _joints_with_validity(raw: Optional[np.ndarray], num_joints: int, cols: int) -> np.ndarray:
    if raw is None:
        return np.zeros((num_joints, cols), np.float32)
    raw = np.asarray(raw, np.float32).copy()
    if raw.shape[1] == cols - 1:
        raw = np.concatenate([raw, np.ones((raw.shape[0], 1), np.float32)], axis=1)
    return raw


def _unpack_mano(single: dict):
    """(96,) pose, (20,) betas, (2,) validity."""
    pose = np.zeros(96, np.float32)
    betas = np.zeros(20, np.float32)
    weight = np.zeros(2, np.float32)
    for hand, ps, bs, wi in (("right", 0, 0, 0), ("left", 48, 10, 1)):
        value = single.get(f"{hand}_hand_param")
        if value is not None:
            pose[ps: ps + 48] = np.asarray(value["pose"], np.float32).reshape(48)
            betas[bs: bs + 10] = np.asarray(value["shape"], np.float32).reshape(10)
            weight[wi] = 1.0
    return pose, betas, weight


def _padded(data_list: List[dict], config: DataConfig):
    """(data_list, num_add): eval lists padded with their first sample to a
    multiple of batch * world_size; training lists as they are."""
    if config.is_train:
        return data_list, 0
    bs = config.batch_size * config.world_size
    num_add = (bs - len(data_list) % bs) % bs
    return data_list + data_list[0:1] * num_add, num_add


class BaselineDataset:
    """Image + ground-truth annotations for encoder training and evaluation."""

    name = "hand26m"

    def __init__(self, config: DataConfig, seed: int = 0):
        unported = [flag for flag in _UNPORTED_AUGMENTATIONS if getattr(config, flag)]
        if unported:
            raise NotImplementedError(f"DataConfig {unported}: those augmentations are not ported yet")
        self.config = config
        self.image_root = osp.join(config.data_root, config.image_root)
        self.rng = random.Random(seed)
        self.data_list: List[dict] = []
        self.num_add = 0

    def load_data(self):
        data_list = sorted(load_annotation(self.config.data_root, self.config.anno_path), key=lambda a: a["img_path"])
        self.all_data_list = data_list
        self.data_list, self.num_add = _padded(data_list, self.config)

    def shuffle_data(self):
        self.rng.shuffle(self.data_list)

    def __len__(self):
        return len(self.data_list)

    def _load_image(self, single: dict) -> np.ndarray:
        return imread(osp.join(self.image_root, single["img_path"]))

    def _single(self, index: int) -> dict:
        single = self.data_list[index]
        if "param_path" in single:
            param = io_utils.load_pkl(osp.join(self.config.param_root, single["param_path"]))
            single = {**single, **param}
        return single

    def _preprocess(self, img, hand_type_array, joints_2d, joints_3d, pose, betas, weight):
        """The augmentation pipeline: letterbox, flip, rescale, normalize joints."""
        cfg = self.config
        img, joints_2d = pp.padding_and_resize(img, joints_2d, cfg.input_size)
        do_flip = False
        if hand_type_array[0] < 0.5 and hand_type_array[1] > 0.5:
            # left-only sample: always flip to right (train and eval)
            img, hand_type_array, joints_2d, joints_3d, pose, betas, weight = pp.flip_sample(
                img, hand_type_array, joints_2d, joints_3d, pose, betas, weight
            )
            do_flip = True
        elif cfg.is_train and cfg.use_random_flip and np.sum(hand_type_array) > 1.5:
            if self.rng.random() > 0.5:
                img, hand_type_array, joints_2d, joints_3d, pose, betas, weight = pp.flip_sample(
                    img, hand_type_array, joints_2d, joints_3d, pose, betas, weight
                )
                do_flip = True
        if cfg.is_train and cfg.use_random_rescale:
            img, joints_2d = pp.random_rescale(
                img, joints_2d, self.rng, cfg.input_size, use_random_position=cfg.use_random_position
            )
        joints_2d = pp.normalize_joints_2d(joints_2d, cfg.input_size)
        return img, hand_type_array, joints_2d, joints_3d, pose, betas, weight, do_flip

    def _common_fields(self, single: dict):
        cfg = self.config
        hand_type_array = pp.hand_type_str2array(single.get("hand_type", "interacting"))
        hand_type_valid = np.asarray([single.get("hand_type_valid", 1.0)], np.float32)
        joints_2d = _joints_with_validity(single.get("joints_2d"), cfg.num_joints, 3)
        joints_3d = _joints_with_validity(single.get("joints_3d"), cfg.num_joints, 4)
        scale = float(single.get("scale", 1.0))
        pose, betas, weight = _unpack_mano(single)
        return hand_type_array, hand_type_valid, joints_2d, joints_3d, scale, pose, betas, weight

    @staticmethod
    def _hand_trans(joints_3d: np.ndarray) -> np.ndarray:
        """Ground-truth inter-hand translation, left wrist - right wrist, with validity."""
        if joints_3d[0, -1] > 0.0 and joints_3d[21, -1] > 0.0:
            trans = -joints_3d[0, :3] + joints_3d[21, :3]
            w = np.ones(1, np.float32)
        else:
            trans = np.zeros(3, np.float32)
            w = np.zeros(1, np.float32)
        return np.concatenate([trans, w]).reshape(1, 4).astype(np.float32)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        single = self._single(index)
        img = self._load_image(single)
        (hand_type_array, hand_type_valid, joints_2d, joints_3d, scale, pose, betas, weight) = (
            self._common_fields(single)
        )
        if self.config.is_train and "joints_2d" not in single:
            raise ValueError(f"{single['img_path']}: training data must provide joints_2d")
        img, hand_type_array, joints_2d, joints_3d, pose, betas, weight, do_flip = self._preprocess(
            img, hand_type_array, joints_2d, joints_3d, pose, betas, weight
        )
        return dict(
            img=pp.normalize_image(img),
            joints_2d=joints_2d.astype(np.float32),
            joints_3d=joints_3d.astype(np.float32),
            mano_pose=pose,
            mano_betas=betas,
            mano_params_weight=weight,
            hand_trans=self._hand_trans(joints_3d),
            hand_type_array=hand_type_array,
            hand_type_valid=hand_type_valid,
            do_flip=np.asarray(do_flip, np.int32),
            scale_ratio=np.asarray(scale, np.float32),
            index=np.asarray(index, np.int32),
        )

    getitem = __getitem__


def _opt_key(single: dict, name: str):
    """An OPT pseudo-GT entry under either spelling: the export chain's
    ``opt_<name>`` or the reference's annotation pkls' ``<name>_opt``."""
    return single.get(f"opt_{name}", single.get(f"{name}_opt"))


class PredictionDataset(BaselineDataset):
    """Shared base of the MLP and OPT datasets: annotations joined with the
    prediction pkl, no augmentation; ground-truth and initial 2D joints go
    through the image's letterbox ratio and the [-1, 1] normalization."""

    with_image: bool = True
    with_feat: bool = True
    # hands with a None MANO param fall back to the OPT pseudo-GT keys (MLP
    # only; OPT keeps validity-0 zeros)
    fallback_opt_params: bool = False

    def load_data(self):
        cfg = self.config
        data_list = load_anno_pred_data(cfg.data_root, cfg.anno_path, cfg.pred_path)
        if cfg.opt_params_path:
            from ihmr_tpu_torch.eval.export import merge_opt_pseudo_gt_into_annotations

            full = osp.join(cfg.data_root, cfg.opt_params_path) if cfg.data_root else cfg.opt_params_path
            merge_opt_pseudo_gt_into_annotations(data_list, io_utils.load_pkl(full))
        data_list = sorted(data_list, key=lambda a: a["img_path"])
        self.all_data_list = data_list
        self.data_list, self.num_add = _padded(data_list, cfg)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        single = self._single(index)
        # the image is always read: even when it is not emitted (OPT), its
        # size sets the letterbox ratio of the ground-truth and initial 2D joints
        img = self._load_image(single)
        (hand_type_array, hand_type_valid, joints_2d, joints_3d, scale, pose, betas, weight) = (
            self._common_fields(single)
        )
        if self.fallback_opt_params and not self.config.use_opt_params:
            # a hand whose MANO param is None takes its ground truth from the
            # OPT pseudo-GT arrays, with validity 1
            opt_pose, opt_shape = _opt_key(single, "pose_params"), _opt_key(single, "shape_params")
            if opt_pose is not None:
                opt_pose = np.asarray(opt_pose, np.float32).reshape(96)
                opt_shape = np.asarray(opt_shape, np.float32).reshape(20)
                for wi, ps, bs in ((0, 0, 0), (1, 48, 10)):
                    if weight[wi] == 0.0:
                        pose[ps: ps + 48] = opt_pose[ps: ps + 48]
                        betas[bs: bs + 10] = opt_shape[bs: bs + 10]
                        weight[wi] = 1.0

        opt_trans = None
        if self.config.use_opt_params:
            # the OPT pseudo-GT replaces the MANO ground truth
            opt_pose, opt_shape = _opt_key(single, "pose_params"), _opt_key(single, "shape_params")
            if opt_pose is not None:
                pose = np.asarray(opt_pose, np.float32).reshape(96)
                betas = np.asarray(opt_shape, np.float32).reshape(20)
                weight = np.ones(2, np.float32)
            ot = _opt_key(single, "hand_trans")
            if ot is not None:  # overrides the translation, with validity 1
                opt_trans = np.concatenate([np.asarray(ot, np.float32).reshape(3), np.ones(1, np.float32)]).reshape(1, 4)

        init_cam = np.asarray(single["pred_cam_params"], np.float32).reshape(3)
        init_shape = np.asarray(single["pred_shape_params"], np.float32).reshape(20)
        init_pose = np.asarray(single["pred_pose_params"], np.float32).reshape(96)
        init_trans = np.asarray(single["pred_hand_trans"], np.float32).reshape(3)
        init_j2 = _joints_with_validity(single["pred_joints_2d"], self.config.num_joints, 3)
        init_j3 = _joints_with_validity(single["pred_joints_3d"], self.config.num_joints, 4)

        # letterbox both ground-truth and initial 2D joints with the image's
        # ratio (the native kernel's float32 ratio)
        img_out, ratio = native.letterbox_normalize(img, self.config.input_size)
        joints_2d = joints_2d.copy()
        joints_2d[:, :2] *= ratio
        init_j2 = init_j2.copy()
        init_j2[:, :2] *= ratio
        joints_2d = pp.normalize_joints_2d(joints_2d, self.config.input_size)
        init_j2 = pp.normalize_joints_2d(init_j2, self.config.input_size)

        init_trans_j = init_j3[21, :3] - init_j3[0, :3]
        result = dict(
            joints_2d=joints_2d.astype(np.float32),
            joints_3d=joints_3d.astype(np.float32),
            mano_pose=pose,
            mano_betas=betas,
            mano_params_weight=weight,
            hand_trans=opt_trans if opt_trans is not None else self._hand_trans(joints_3d),
            hand_type_array=hand_type_array,
            hand_type_valid=hand_type_valid,
            init_cam=init_cam,
            init_pose_params=init_pose,
            init_shape_params=init_shape,
            init_hand_trans=np.concatenate([init_trans, np.ones(1, np.float32)]).reshape(1, 4),
            init_joints_2d=init_j2.astype(np.float32),
            init_joints_3d=init_j3.astype(np.float32),
            init_hand_trans_j=np.concatenate([init_trans_j, np.ones(1, np.float32)]).reshape(1, 4),
            do_flip=np.asarray(0, np.int32),
            scale_ratio=np.asarray(scale, np.float32),
            index=np.asarray(index, np.int32),
        )
        if self.with_image:
            result["img"] = img_out
        if self.with_feat:
            result["img_feat"] = np.asarray(single["img_feat"], np.float32).reshape(-1)
        return result

    getitem = __getitem__


class MLPDataset(PredictionDataset):
    with_image = True
    with_feat = True
    fallback_opt_params = True


class OPTDataset(PredictionDataset):
    """OPT needs joints and params only; images feed no network."""

    with_image = False
    with_feat = False
