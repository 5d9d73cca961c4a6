"""Evaluation metric math (host-side NumPy; a copy of ihmr_tpu/eval/metrics.py).

Port of ref src/utils/metric_utils.py with identical semantics:
  * per-wrist root-aligned joint errors, scale-normalized (:23-38)
  * inter-hand error after alignment (:41-56)
  * PA / no-rotation-PA 42-joint error (:120-143)
  * collision AUC threshold sweep 0.5-15 (:146-160)
  * handedness accuracy (:12-20)
"""

from __future__ import annotations

from typing import List

import numpy as np

from ihmr_tpu_torch.core.procrustes import no_rot_align, similarity_align


def hand_type_accuracy(hand_type: str, hand_type_valid: float, pred_hand_type: np.ndarray) -> List[bool]:
    if hand_type_valid > 0:
        if hand_type == "interacting":
            return [bool(pred_hand_type[0] > 0.5 and pred_hand_type[1] > 0.5)]
        # single-hand eval samples are flipped to right, so check right only
        return [bool(pred_hand_type[0] > 0.5 and pred_hand_type[1] < 0.5)]
    return []


def single_joints_error(
    joints_1: np.ndarray,  # (42, 3)
    joints_2: np.ndarray,  # (42, 3)
    joint_weights: np.ndarray,  # (42, 1) or (42,)
    scale_factor: float,
) -> List[float]:
    """Per-hand root-aligned joint errors / scale (ref :23-38).

    NOTE (faithful to the reference): the alignment subtractions accumulate —
    when both wrists are valid the left hand is aligned after the right-wrist
    subtraction has already been applied, exactly as the in-place reference
    code does.
    """
    w = np.asarray(joint_weights).reshape(-1)
    j1 = np.array(joints_1, np.float64, copy=True)
    j2 = np.array(joints_2, np.float64, copy=True)
    errors: List[float] = []
    for i in (0, 21):
        if w[i] > 0:
            j1 -= j1[i : i + 1]
            j2 -= j2[i : i + 1]
            for j in range(21):
                if w[i + j] > 0:
                    errors.append(float(np.linalg.norm(j1[i + j] - j2[i + j]) / scale_factor))
    return errors


def single_pa_inter_joints_error(
    pred_joints: np.ndarray,  # (42, >=3)
    gt_joints: np.ndarray,  # (42, >=3)
    joints_valid: np.ndarray,  # (42,) or (42, 1)
    scale_factor: float,
    use_rot: bool,
) -> List[float]:
    """42-joint error after (no-rot) Procrustes on valid joints (ref :120-143)."""
    valid = np.asarray(joints_valid).reshape(-1)
    if np.sum(valid) < 2.0:
        return []
    pred = np.asarray(pred_joints)[valid > 0, :3]
    gt = np.asarray(gt_joints)[valid > 0, :3]
    align = similarity_align if use_rot else no_rot_align
    pred_t = align(pred.copy(), gt.copy())
    err = np.linalg.norm(pred_t - gt, axis=1) / scale_factor
    return err.tolist()


def collision_auc(collision_all: np.ndarray, start: float = 0.5, end: float = 15.0) -> float:
    """Area under the fraction-below-threshold curve (ref :146-160)."""
    col = np.asarray(collision_all)
    xs, ratios = [], []
    for thresh in np.linspace(start, end):
        ratios.append(float(np.mean(col < thresh)))
        xs.append((thresh - start) / (end - start))
    return float(np.trapezoid(ratios, xs))
