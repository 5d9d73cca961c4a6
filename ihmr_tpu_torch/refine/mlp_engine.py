"""IHMR-MLP: the learned per-parameter-group refinement cascade (port of
ihmr_tpu/refine/mlp_engine.py).

A frozen baseline's cached outputs (1024-d image feature + 122-d parameter
vector) seed the cascade; each stage's small MLP (``models.SubNetwork``)
emits a residual for one parameter group. After every stage each sample
keeps the update only if every filter loss stayed strictly below
prev * (1 + pct/100) and the select loss did not increase, else it keeps the
previous parameters.

Collision: the per-step gradient pass of stage training (``in_loop=True``)
uses the single-candidate ``backend="fast"`` (the nearest-centroid kernel
K2); the warm, selection and cascade passes score on the exact kernel K1
with the ray-parity filter, so every cached loss and every accept/reject
compares exact metrics.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Sequence, Tuple

import torch
from torch import nn

from ihmr_tpu_torch.device import DeviceLike, resolve_device
from ihmr_tpu_torch.losses import losses as L
from ihmr_tpu_torch.mano.model import ManoModel
from ihmr_tpu_torch.ops.collision import collision_loss
from ihmr_tpu_torch.refine.opt_engine import OptConfig, ParamDict, forward, params_from_init, params_to_handparams
from ihmr_tpu_torch.refine.schedule import PARAM_GROUP_DIMS, Stage

_TRACKED = ("joints_2d_loss_p_batch", "joints_3d_loss_p_batch", "collision_loss_batch")
_FILTER_KEY = {
    "joints_2d_loss_p": "joints_2d_loss_p_batch",
    "joints_3d_loss_p": "joints_3d_loss_p_batch",
    "collision_loss": "collision_loss_batch",
}


@dataclass(frozen=True)
class MLPBatch:
    """Inputs of the MLP workload."""

    hand_type_array: torch.Tensor  # (B, 2)
    hand_type_valid: torch.Tensor  # (B, 1)
    joints_2d: torch.Tensor  # (B, 42, 3)
    joints_3d: torch.Tensor  # (B, 42, 4)
    gt_pose_params: torch.Tensor  # (B, 96)
    gt_shape_params: torch.Tensor  # (B, 20)
    mano_params_weight: torch.Tensor  # (B, 2)
    hand_trans: torch.Tensor  # (B, 1, 4)
    img_feat: torch.Tensor  # (B, 1024)
    init_joints_2d: torch.Tensor  # (B, 42, 3)
    init_joints_3d: torch.Tensor  # (B, 42, 4)
    init_cam: torch.Tensor  # (B, 3)
    init_pose_params: torch.Tensor  # (B, 96)
    init_shape_params: torch.Tensor  # (B, 20)
    init_hand_trans: torch.Tensor  # (B, 3)
    index: torch.Tensor  # (B,) int64 global sample ids


def seed_from_backbone(batch: MLPBatch) -> ParamDict:
    """The cascade's starting parameters: the cached baseline predictions."""
    return params_from_init(batch.init_cam, batch.init_pose_params, batch.init_shape_params, batch.init_hand_trans)


def flat_params(p: ParamDict) -> torch.Tensor:
    """(B, 122) in the layout [cam | pose 96 | shape 20 | trans]."""
    return params_to_handparams(p).to_flat()


def apply_stage_mlp(subnet: nn.Module, stage: Stage, img_feat: torch.Tensor, p: ParamDict) -> ParamDict:
    """Add the stage MLP's residual to the stage's parameter groups."""
    residual = subnet(torch.cat([img_feat, flat_params(p)], dim=-1))  # (B, update_dim)
    out = dict(p)
    offset = 0
    for name in stage.update_params:
        dim = PARAM_GROUP_DIMS[name]
        out[name] = p[name] + residual[:, offset : offset + dim]
        offset += dim
    return out


def compute_losses(
    model: ManoModel,
    p: ParamDict,
    batch: MLPBatch,
    weights: Dict[str, float],
    config: OptConfig = OptConfig(),
    in_loop: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The MLP loss set -> (weighted total, aux).

    The total is driven by ground truth (2D/3D joints, MANO pose/shape,
    translation) plus the shape priors and the weighted collision loss. aux
    holds the weighted terms, the per-sample tracked vectors (``_TRACKED``)
    and the decoded meshes and joints. ``in_loop=True`` (the gradient pass of
    stage training) scores collision on the fast backend without the parity
    filter; otherwise on ``config.collision_backend`` with
    ``config.exact_parity_filter``."""
    rv, lv, joints3d, joints2d = forward(model, p)
    aux: Dict[str, torch.Tensor] = {}

    j2d, _ = L.joints_2d_loss(batch.joints_2d[:, :, :2], joints2d, batch.joints_2d[:, :, 2:3])
    aux["joints_2d_loss"] = j2d * weights["joints_2d_loss"]
    total = aux["joints_2d_loss"]
    _, j2d_p_batch = L.joints_2d_loss(batch.init_joints_2d[:, :, :2], joints2d, batch.init_joints_2d[:, :, 2:3])
    aux["joints_2d_loss_p_batch"] = j2d_p_batch * weights["joints_2d_loss"]

    j3d, _ = L.joints_3d_loss(batch.joints_3d[:, :, :3], joints3d, batch.joints_3d[:, :, 3:4])
    aux["joints_3d_loss"] = j3d * weights["joints_3d_loss"]
    total = total + aux["joints_3d_loss"]
    _, j3d_p_batch = L.joints_3d_loss(batch.init_joints_3d[:, :, :3], joints3d, batch.init_joints_3d[:, :, 3:4])
    aux["joints_3d_loss_p_batch"] = j3d_p_batch * weights["joints_3d_loss"]

    w = batch.mano_params_weight
    pose_r = L.mano_pose_loss(batch.gt_pose_params[:, 3:48], p["right_pose"], w[:, 0:1])
    pose_l = L.mano_pose_loss(batch.gt_pose_params[:, 51:96], p["left_pose"], w[:, 1:2])
    aux["mano_pose_loss"] = (pose_r + pose_l) * weights["mano_pose_loss"]
    total = total + aux["mano_pose_loss"]

    shape_r = L.mano_shape_loss(batch.gt_shape_params[:, :10], p["right_shape"], w[:, 0:1])
    shape_l = L.mano_shape_loss(batch.gt_shape_params[:, 10:], p["left_shape"], w[:, 1:2])
    aux["mano_shape_loss"] = (shape_r + shape_l) * weights["mano_shape_loss"]
    total = total + aux["mano_shape_loss"]

    trans = L.hand_trans_loss(batch.hand_trans[:, 0, :3], p["trans"], batch.hand_trans[:, :, 3:4])
    aux["hand_trans_loss"] = trans * weights["hand_trans_loss"]
    total = total + aux["hand_trans_loss"]

    reg, _ = L.shape_reg_loss(torch.cat([p["right_shape"], p["left_shape"]], dim=1))
    aux["shape_reg_loss"] = reg * weights["shape_reg_loss"]
    total = total + aux["shape_reg_loss"]

    res_r = L.shape_residual_loss(p["right_shape"], batch.init_shape_params[:, :10])
    res_l = L.shape_residual_loss(p["left_shape"], batch.init_shape_params[:, 10:])
    aux["shape_residual_loss"] = (res_r + res_l) * weights["shape_residual_loss"]
    total = total + aux["shape_residual_loss"]

    w_coll = float(weights["collision_loss"])
    if w_coll == 0.0:
        # weight 0 skips the kernels; such a stage must not filter or select
        # on collision (the vector is zeros)
        B, V = rv.shape[0], rv.shape[1]
        coll, coll_batch, coll_origin = rv.new_zeros(()), rv.new_zeros((B,)), rv.new_zeros((B, 2 * V))
    else:
        coll, coll_batch, coll_origin = collision_loss(
            rv,
            lv,
            model.faces,
            model.faces.flip(-1),  # mirrored-left winding
            batch.hand_type_array,
            robustifier=config.robustifier,
            num_candidates=1 if in_loop else config.num_candidates,
            backend="fast" if in_loop else config.collision_backend,
            parity_filter=(not in_loop) and config.exact_parity_filter,
        )
    aux["collision_loss"] = coll * w_coll
    aux["collision_loss_batch"] = coll_batch * w_coll
    aux["collision_loss_origin_scale"] = coll_origin
    total = total + aux["collision_loss"]

    aux["pred_right_hand_verts"] = rv
    aux["pred_left_hand_verts"] = lv
    aux["pred_joints_3d"] = joints3d
    aux["pred_joints_2d"] = joints2d
    return total, aux


def select_better_params(
    stage: Stage,
    cur_params: ParamDict,
    cur_losses: Dict[str, torch.Tensor],
    prev_params: ParamDict,
    prev_losses: Dict[str, torch.Tensor],
) -> Tuple[ParamDict, Dict[str, torch.Tensor]]:
    """Per-sample accept/reject of a stage update.

    Filters use strict '<' against prev * (1 + pct/100) (no +0.1 smoothing,
    unlike OPT); the select loss must not increase ('<='). Rejected samples
    revert the stage's parameter groups and all tracked losses to prev."""
    sel = _FILTER_KEY[stage.select_loss]
    keep = cur_losses[sel] <= prev_losses[sel]
    for loss_name, pct in stage.filter_loss:
        key = _FILTER_KEY[loss_name]
        keep = keep & (cur_losses[key] < prev_losses[key] * (1.0 + float(pct) / 100.0))

    out_params = dict(cur_params)
    for name in stage.update_params:
        out_params[name] = torch.where(keep[:, None], cur_params[name], prev_params[name])
    out_losses = {key: torch.where(keep, cur_losses[key], prev_losses[key]) for key in _TRACKED}
    return out_params, out_losses


def make_cascade_apply(
    model: ManoModel,
    strategy: Sequence[Stage],
    default_weights: Dict[str, float],
    config: OptConfig = OptConfig(),
) -> Callable[[Sequence[nn.Module], MLPBatch], Tuple[ParamDict, Dict[str, torch.Tensor]]]:
    """The full-cascade inference function: (one SubNetwork per stage, batch)
    -> (refined params, results). Every pass scores on the exact backend."""
    strategy = tuple(strategy)

    @torch.no_grad()
    def cascade(subnets: Sequence[nn.Module], batch: MLPBatch):
        if len(subnets) != len(strategy):
            raise ValueError(f"{len(subnets)} stage networks for {len(strategy)} stages")
        prev_params = seed_from_backbone(batch)
        _, aux = compute_losses(model, prev_params, batch, default_weights, config)
        prev_losses = {k: aux[k] for k in _TRACKED}
        for subnet, stage in zip(subnets, strategy):
            p_new = apply_stage_mlp(subnet, stage, batch.img_feat, prev_params)
            _, aux = compute_losses(model, p_new, batch, default_weights, config)
            cur_losses = {k: aux[k] for k in _TRACKED}
            prev_params, prev_losses = select_better_params(stage, p_new, cur_losses, prev_params, prev_losses)

        total, aux = compute_losses(model, prev_params, batch, default_weights, config)
        hp = params_to_handparams(prev_params)
        results = {
            "pred_cam_params": prev_params["cam"],
            "pred_hand_trans": prev_params["trans"],
            "pred_shape_params": hp.shape_params,
            "pred_pose_params": hp.pose_params,
            "pred_right_hand_verts": aux["pred_right_hand_verts"],
            "pred_left_hand_verts": aux["pred_left_hand_verts"],
            "pred_joints_3d": aux["pred_joints_3d"],
            "pred_joints_2d": aux["pred_joints_2d"],
            "gt_joints_3d": batch.joints_3d,
            "mano_params_weight": batch.mano_params_weight,
            "collision_loss": aux["collision_loss_batch"],
            "collision_loss_origin_scale": aux["collision_loss_origin_scale"],
            "total_loss": total,
        }
        return prev_params, results

    return cascade


class MLPCaches:
    """Dataset-sized prediction caches: per sample, whether it was cached, its
    image feature, the cascade's current parameters and tracked losses.

    The tensors live on ``device`` (the card by default, like every entry
    point; "cpu" when asked), so the training loop reads and writes batch
    slices without host copies. ``merge`` folds in another cache's samples
    (the cross-rank sync of a sharded run)."""

    def __init__(self, num_data: int, device: DeviceLike = None):
        dev = resolve_device(device)
        self.num_data = num_data
        self.exists = torch.zeros(num_data, dtype=torch.bool, device=dev)
        self.img_feat = torch.zeros((num_data, 1024), device=dev)
        self.prev_params = {name: torch.zeros((num_data, dim), device=dev) for name, dim in PARAM_GROUP_DIMS.items()}
        self.prev_losses = {k: torch.zeros(num_data, device=dev) for k in _TRACKED}

    def save(self, idx: torch.Tensor, img_feat: torch.Tensor, params: ParamDict, losses: Dict[str, torch.Tensor]):
        idx = idx.to(self.exists.device)
        self.exists[idx] = True
        self.img_feat[idx] = img_feat.detach()
        for name, cached in self.prev_params.items():
            cached[idx] = params[name].detach()
        for key in _TRACKED:
            self.prev_losses[key][idx] = losses[key].detach()

    def retrieve(self, idx: torch.Tensor) -> Tuple[torch.Tensor, ParamDict, Dict[str, torch.Tensor]]:
        idx = idx.to(self.exists.device)
        if not bool(self.exists[idx].all()):
            raise KeyError("retrieving samples never cached")
        params = {name: cached[idx] for name, cached in self.prev_params.items()}
        losses = {k: self.prev_losses[k][idx] for k in _TRACKED}
        return self.img_feat[idx], params, losses

    def merge(self, other: "MLPCaches") -> None:
        idx = torch.nonzero(other.exists.to(self.exists.device)).flatten()
        src = idx.to(other.exists.device)
        self.exists[idx] = True
        self.img_feat[idx] = other.img_feat[src].to(self.img_feat.device)
        for name, cached in self.prev_params.items():
            cached[idx] = other.prev_params[name][src].to(cached.device)
        for key in _TRACKED:
            self.prev_losses[key][idx] = other.prev_losses[key][src].to(self.exists.device)
