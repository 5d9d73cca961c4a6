"""Pipeline hand-off exporters (port of ihmr_tpu/eval/export.py).

The pkl files hold numpy arrays only, with the JAX package's keys and
dtypes, so either package reads the other's.

In the reference, the pickled Evaluator is the inter-phase artifact: the
baseline's eval pkl becomes the OPT/MLP ``prediction`` input (keys
pred_cam_params/pred_*_params/pred_hand_trans + keypoint-net joints_2d/
joints_3d + img_feat; ref src/data/data_utils.py:42-70), and OPT's refined
parameters can serve as MLP pseudo-GT (``--use_opt_params``; ref
src/data/mlp_dataset.py:117-145). These helpers produce those artifacts from
our Evaluator results.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ihmr_tpu_torch.utils import io_utils


def evaluator_to_prediction_pkl(
    evaluator,
    out_path: str,
    img_feats: Optional[Dict[str, np.ndarray]] = None,
    joints_2d: Optional[Dict[str, np.ndarray]] = None,
) -> Dict[str, dict]:
    """Build the prediction pkl consumed by OPT/MLP datasets.

    ``joints_2d``/``img_feats`` map img_path -> array; when absent, the
    decoded 2D joints / zero features are used (the reference's keypoint
    predictions come from a separate network we do not re-implement — any
    keypoint source can be plugged in here).
    """
    out: Dict[str, dict] = {}
    for pred in evaluator.pred_results:
        key = pred["img_path_relative"]
        j3 = np.asarray(pred["pred_joints_3d"], np.float32)
        entry = dict(
            pred_cam_params=np.asarray(pred["pred_cam_params"], np.float32),
            pred_shape_params=np.asarray(pred["pred_shape_params"], np.float32),
            pred_pose_params=np.asarray(pred["pred_pose_params"], np.float32),
            pred_hand_trans=np.asarray(pred["pred_hand_trans"], np.float32),
            joints_3d=j3,
            joints_2d=(
                joints_2d[key]
                if joints_2d and key in joints_2d
                else pred.get("pred_joints_2d", j3[:, :2]).astype(np.float32)
            ),
            img_feat=(
                img_feats[key]
                if img_feats and key in img_feats
                else pred.get("img_feat", np.zeros(1024, np.float32))
            ),
        )
        out[key] = entry
    io_utils.save_pkl(out_path, out)
    return out


def evaluator_to_opt_pseudo_gt(evaluator, out_path: str) -> Dict[str, dict]:
    """OPT refined params keyed by img_path, for MLP --use_opt_params."""
    out = {
        pred["img_path_relative"]: dict(
            opt_pose_params=np.asarray(pred["pred_pose_params"], np.float32),
            opt_shape_params=np.asarray(pred["pred_shape_params"], np.float32),
            opt_hand_trans=np.asarray(pred["pred_hand_trans"], np.float32),
        )
        for pred in evaluator.pred_results
    }
    io_utils.save_pkl(out_path, out)
    return out


def merge_opt_pseudo_gt_into_annotations(anno_list, pseudo_gt: Dict[str, dict]):
    """Attach OPT pseudo-GT keys to annotation dicts in place."""
    for anno in anno_list:
        extra = pseudo_gt.get(anno["img_path"])
        if extra:
            anno.update(extra)
    return anno_list
