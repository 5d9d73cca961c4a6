"""Evaluator: per-sample result accumulation and the headline metrics (port
of ihmr_tpu/eval/evaluator.py).

``update(data_idxs, pred_results)`` ingests a batch of results, computes the
per-sample joint errors at once, un-flips mirrored samples, and keeps the
vertices as fp16; ``remove_redunc`` drops the divisibility padding by image
path; the properties give mpjpe_3d, inter_mpjpe_3d, collision_ave,
collision_max, collision_auc and hand_type_acc. Results may be numpy arrays
or torch tensors on any device: a batch's tensors reach the host in one
transfer per dtype. Everything after that is the JAX package's numpy code,
so both Evaluators give the same entries and metrics for the same results.

Ranks merge their Evaluators with ``gather_pred`` (each pickles its
``pred_results``), as in the reference.

Not ported yet: ``render_results`` (needs the ``utils/`` renderer).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ihmr_tpu_torch.eval import metrics as mu
from ihmr_tpu_torch.utils import io_utils


def results_to_host(results: Dict[str, object]) -> Dict[str, object]:
    """A results dict with every torch tensor replaced by a numpy array.

    The tensors of one device and dtype are flattened into one buffer and
    copied in one transfer; other values (numpy arrays, None) pass through."""
    out = dict(results)
    groups: Dict[tuple, List[str]] = {}
    for k, v in results.items():
        if isinstance(v, torch.Tensor):
            groups.setdefault((v.device, v.dtype), []).append(k)
    for keys in groups.values():
        flat = torch.cat([results[k].detach().reshape(-1) for k in keys]).cpu().numpy()
        start = 0
        for k in keys:
            shape = tuple(results[k].shape)
            n = int(np.prod(shape, dtype=np.int64))
            out[k] = flat[start : start + n].reshape(shape)
            start += n
    return out


class Evaluator:
    def __init__(
        self,
        data_list: Sequence[dict],
        image_root: str = "",
        dataset_name: str = "synthetic",
        input_size: int = 224,
        right_faces: Optional[np.ndarray] = None,
        left_faces: Optional[np.ndarray] = None,
    ):
        self.dataset_name = dataset_name
        self.data_list = list(data_list)
        self.image_root = image_root
        self.input_size = input_size
        self.right_faces = None if right_faces is None else _as_numpy(right_faces)
        self.left_faces = None if left_faces is None else _as_numpy(left_faces)
        self.pred_results: List[dict] = []

    def clear(self):
        self.pred_results = []

    def gather_pred(self, pred_results: List[dict]):
        self.pred_results += pred_results

    # ------------------------------------------------------------------
    def update(self, data_idxs, pred_results: Dict[str, object], save_verts: bool = True):
        self.save_verts = save_verts
        pred_results = results_to_host(pred_results)
        for i, data_idx in enumerate(_as_numpy(data_idxs)):
            data_idx = int(data_idx)
            anno = self.data_list[data_idx] if data_idx < len(self.data_list) else {}
            img_path_rel = anno.get("img_path", f"sample_{data_idx:08d}")
            # copies: flip-back mutates in place
            single = dict(
                data_idx=data_idx,
                pred_cam_params=np.array(pred_results["pred_cam_params"][i]),
                pred_shape_params=np.array(pred_results["pred_shape_params"][i]),
                pred_pose_params=np.array(pred_results["pred_pose_params"][i]),
                pred_hand_trans=np.array(pred_results["pred_hand_trans"][i]),
                pred_joints_3d=np.array(pred_results["pred_joints_3d"][i]),
                collision_loss_origin_scale=np.array(pred_results["collision_loss_origin_scale"][i]),
                gt_joints_3d=np.array(pred_results["gt_joints_3d"][i]),
                img_path=io_utils.osp.join(self.image_root, img_path_rel) if self.image_root else img_path_rel,
                img_path_relative=img_path_rel,
            )
            if "pred_joints_2d" in pred_results:
                single["pred_joints_2d"] = np.array(pred_results["pred_joints_2d"][i])
            if "pred_hand_type" in pred_results:
                single["pred_hand_type"] = np.array(pred_results["pred_hand_type"][i])
            if pred_results.get("img_feat") is not None:
                single["img_feat"] = np.array(pred_results["img_feat"][i], np.float32)
            defaults = dict(annot_type="machine", hand_type="interacting", hand_type_valid=1.0, scale=1.0)
            for key, val in defaults.items():
                single[key] = anno.get(key, val)

            if save_verts:
                for mode in ("pred", "gt"):
                    for hand in ("left", "right"):
                        key = f"{mode}_{hand}_hand_verts"
                        if key in pred_results and pred_results[key] is not None:
                            single[key] = np.array(pred_results[key][i]).astype(np.float16)

            pred_j3 = single["pred_joints_3d"]
            gt_j3 = single["gt_joints_3d"][:, :3]
            valid = single["gt_joints_3d"][:, 3:]
            scale = single["scale"]
            single["j3d_error"] = mu.single_joints_error(pred_j3, gt_j3, valid, scale)
            single["pa_no_rot_inter_j3d_error"] = mu.single_pa_inter_joints_error(
                pred_j3, gt_j3, valid, scale, use_rot=False
            )
            if "pred_hand_type" in single:
                # before the flip-back: a flipped (left -> right) sample's
                # prediction lives in the flipped frame, which the
                # reference's right-only check expects
                single["hand_type_acc"] = mu.hand_type_accuracy(
                    single["hand_type"], single["hand_type_valid"], single["pred_hand_type"]
                )

            if "do_flip" in pred_results and pred_results["do_flip"][i]:
                self._flip_back(single)
            self.pred_results.append(single)

    def _flip_back(self, single: dict):
        """Un-mirror a sample that was flipped left -> right at load time."""
        single["pred_cam_params"][1] *= -1
        single["pred_hand_trans"][0] *= -1
        pose = single["pred_pose_params"].copy()
        single["pred_pose_params"][:48] = pose[48:]
        single["pred_pose_params"][48:] = pose[:48]
        single["pred_pose_params"][1::3] *= -1
        single["pred_pose_params"][2::3] *= -1
        for key in ("pred_joints_3d", "gt_joints_3d"):
            j = single[key].copy()
            single[key][:21] = j[21:]
            single[key][21:] = j[:21]
            single[key][:, 0] *= -1
        coll = single["collision_loss_origin_scale"].copy()
        half = coll.shape[0] // 2
        single["collision_loss_origin_scale"][:half] = coll[half:]
        single["collision_loss_origin_scale"][half:] = coll[:half]
        if self.save_verts:
            saved = {}
            for mode in ("pred", "gt"):
                for hand in ("left", "right"):
                    key = f"{mode}_{hand}_hand_verts"
                    if key in single:
                        saved[key] = single[key].copy()
            for mode in ("pred", "gt"):
                for hand in ("left", "right"):
                    other = "left" if hand == "right" else "right"
                    key = f"{mode}_{hand}_hand_verts"
                    key_flip = f"{mode}_{other}_hand_verts"
                    if key_flip in saved:
                        single[key] = saved[key_flip]
                        single[key][:, 0] *= -1

    def remove_redunc(self):
        """Drop the first-sample padding duplicates."""
        seen, out = set(), []
        for data in self.pred_results:
            if data["img_path_relative"] not in seen:
                out.append(data)
                seen.add(data["img_path_relative"])
        self.pred_results = out

    # ------------------------------------------------------------------
    @property
    def mpjpe_3d(self) -> float:
        errors: List[float] = []
        for pred in self.pred_results:
            errors += pred["j3d_error"]
        return float(np.average(errors)) if errors else float("nan")

    @property
    def inter_mpjpe_3d(self) -> float:
        errors: List[float] = []
        for pred in self.pred_results:
            errors += pred["pa_no_rot_inter_j3d_error"]
        return float(np.average(errors)) if errors else float("nan")

    @property
    def collision_ave(self) -> float:
        vals = [
            float(np.mean(p["collision_loss_origin_scale"])) * 1000
            for p in self.pred_results
            if p["hand_type"] == "interacting"
        ]
        return float(np.average(vals)) if vals else float("nan")

    @property
    def collision_max(self) -> float:
        vals = [
            float(np.max(p["collision_loss_origin_scale"])) * 1000
            for p in self.pred_results
            if p["hand_type"] == "interacting"
        ]
        return float(np.average(vals)) if vals else float("nan")

    @property
    def collision_auc(self) -> float:
        vals = [
            np.asarray(p["collision_loss_origin_scale"]) * 1000
            for p in self.pred_results
            if p["hand_type"] == "interacting"
        ]
        if not vals:
            return float("nan")
        return mu.collision_auc(np.concatenate(vals))

    @property
    def hand_type_acc(self) -> float:
        """Handedness classification accuracy (runs with a handedness head)."""
        flags: List[bool] = []
        for p in self.pred_results:
            flags += p.get("hand_type_acc", [])
        return float(np.mean(flags)) if flags else float("nan")

    def metric_dict(self) -> "OrderedDict[str, float]":
        md = OrderedDict(
            mpjpe_3d=self.mpjpe_3d,
            inter_mpjpe_3d=self.inter_mpjpe_3d,
            collision_ave=self.collision_ave,
            collision_max=self.collision_max,
            collision_auc=self.collision_auc,
        )
        acc = self.hand_type_acc
        if np.isfinite(acc):  # only baseline/MLP runs carry a handedness head
            md["hand_type_acc"] = acc
        return md

    # ------------------------------------------------------------------
    def render_results(self, res_vis_dir: str, limit: Optional[int] = None, size_type: str = "double",
                       num_workers: int = 16):
        raise NotImplementedError(
            "Evaluator.render_results needs the mesh renderer of the utils/ slice (ihmr_tpu/utils/vis.py), "
            "which is not ported yet; export_objs writes the meshes"
        )

    def export_objs(self, res_obj_dir: str, limit: Optional[int] = None):
        """Dump the predicted two-hand meshes as .obj files, one per result."""
        if self.right_faces is None or self.left_faces is None:
            raise ValueError("export_objs needs the Evaluator's right_faces and left_faces")
        for result in self.pred_results[:limit]:
            if "pred_right_hand_verts" not in result:
                continue
            rv = np.asarray(result["pred_right_hand_verts"], np.float32)
            lv = np.asarray(result["pred_left_hand_verts"], np.float32)
            verts = np.concatenate([rv, lv], axis=0)
            faces = np.concatenate([self.right_faces, self.left_faces + rv.shape[0]], axis=0)
            name = result["img_path_relative"].replace("/", "_")
            name = name.rsplit(".", 1)[0] + ".obj"
            io_utils.save_mesh_to_obj(io_utils.osp.join(res_obj_dir, name), verts, faces)


def evaluator_for(dataset, right_faces, left_faces) -> Evaluator:
    """An empty Evaluator over ``dataset``'s samples, as the run loops make
    one: ``data_list``, ``image_root`` and ``name`` when the dataset has them
    (None or a dataset without them: samples named by index)."""
    return Evaluator(
        getattr(dataset, "data_list", []),
        image_root=getattr(dataset, "image_root", ""),
        dataset_name=getattr(dataset, "name", "dataset"),
        right_faces=right_faces,
        left_faces=left_faces,
    )


def _as_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
