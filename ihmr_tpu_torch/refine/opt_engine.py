"""IHMR-OPT: per-sample collision-aware test-time refinement (port of
ihmr_tpu/refine/opt_engine.py, engine semantics of ``_run_one_stage_hoisted``).

For each strategy stage: ``epoch + 1`` Adam steps on the stage's parameter
groups, fresh moments per stage. Steps are grouped in snapshot blocks of
``save_mid_freq`` steps; only the first step of a block (a snapshot step)
evaluates the filter/select losses: the first block of a stage sets the
filter bars (origin * (1 + (pct + 0.1)/100)) and the best params
unconditionally; later snapshots replace a sample's best when every filter
loss is under its bar and the select loss is strictly lower (the earliest
minimum wins). The other steps of a block only compute gradients and Adam.

In-loop collision is the block-frozen nearest-face payload: every
``reselect_every_blocks`` blocks (a superblock) the current mesh is decoded
once, each stride-2 query picks its nearest face of the stride-2 face set of
the other hand (bf16 rank), and those triangles' positions plus the AABB
scale are frozen for the superblock; the steps then evaluate the exact depth
of the live queries against the frozen triangles. 301 steps at
save_mid_freq=10 are 30 blocks in 15 superblocks plus a 1-step tail block
with its own payload.

The final pass recomputes every loss at the default weights with the exact
collision kernel (ops/exact_collision.py) ANDed with the ray-parity filter.

Adam note: the reference optimises the batch-MEAN loss; Adam's update is
invariant to that uniform 1/B gradient scale (up to eps), so per-sample
trajectories do not depend on the batch size.

Not ported yet (OptConfig raises if they are asked for): SGD, the
stage-hoisted decode payloads, the fused/scan engines, escalation, the grid, 2-level and
K-candidate backends, parity-alternating queries and per-step reselection.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ihmr_tpu_torch.core.projection import orthographic_project
from ihmr_tpu_torch.losses import losses as L
from ihmr_tpu_torch.mano.layer import HandParams, two_hand_decode_mirrored
from ihmr_tpu_torch.mano.model import ManoModel
from ihmr_tpu_torch.ops.collision import (
    collision_loss,
    depths_to_loss,
    pair_aabb_scale,
    pair_depths_at_tris,
    pair_indices,
    pair_tris_at,
)
from ihmr_tpu_torch.refine.adam import Adam
from ihmr_tpu_torch.refine.schedule import OPT_DEFAULT_LOSS_WEIGHTS, Stage

ParamDict = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class OptBatch:
    """Per-batch inputs of the OPT workload."""

    hand_type_array: torch.Tensor  # (B, 2)
    hand_type_valid: torch.Tensor  # (B, 1)
    joints_2d: torch.Tensor  # (B, 42, 3) gt, [-1,1] coords + validity
    joints_3d: torch.Tensor  # (B, 42, 4) gt + validity
    gt_pose_params: torch.Tensor  # (B, 96)
    gt_shape_params: torch.Tensor  # (B, 20)
    mano_params_weight: torch.Tensor  # (B, 2)
    hand_trans: torch.Tensor  # (B, 1, 4) gt trans + validity
    init_joints_2d: torch.Tensor  # (B, 42, 3) predicted joints (self-consistency targets)
    init_joints_3d: torch.Tensor  # (B, 42, 4)
    init_hand_trans_j: torch.Tensor  # (B, 1, 4) trans from predicted joints


@dataclass(frozen=True)
class OptConfig:
    """The JAX package's OptConfig: same field names and defaults.

    Fields whose code paths are not ported raise when set to a non-default
    value (see ``_UNPORTED``). Ported: save_mid_freq,
    robustifier, collision_backend ("auto" / "pallas": the exact kernel),
    loop_collision_subsample, loop_collision_face_subsample,
    reselect_every_blocks, loop_collision_margin, exact_parity_filter."""

    optimizer: str = "adam"
    save_mid_freq: int = 10
    num_candidates: int = 8
    robustifier: Optional[float] = None
    collision_backend: str = "auto"
    loop_collision_fast: bool = True
    loop_collision_subsample: int = 2
    loop_collision_face_subsample: int = 2
    loop_collision_cluster: int = 0
    loop_collision_alternate: bool = False
    loop_collision_lazy_reselect: bool = True
    loop_collision_freeze_positions: bool = True
    reselect_every_blocks: int = 2
    loop_collision_margin: float = 0.0
    escalate_collision: float = 0.0
    escalate_warm_start: float = 0.5
    escalate_fast_build: bool = True
    grid_face_subsample: int = 1
    grid_num_candidates: int = 0
    grid_res: int = 32
    grid_focus: bool = False
    exact_parity_filter: bool = True
    stage_hoist_decode: bool = True

    def __post_init__(self):
        defaults = {f.name: f.default for f in dataclasses.fields(self)}
        for name in _UNPORTED:
            if getattr(self, name) != defaults[name]:
                raise NotImplementedError(
                    f"OptConfig.{name}={getattr(self, name)!r}: that path is not ported "
                    f"(only the default {defaults[name]!r} is)"
                )
        if self.collision_backend not in ("auto", "pallas"):
            raise NotImplementedError(
                f"collision_backend={self.collision_backend!r} is not ported; "
                "'auto' and 'pallas' both mean the exact kernel"
            )
        if self.save_mid_freq < 1 or self.loop_collision_subsample < 1:
            raise ValueError("save_mid_freq and loop_collision_subsample must be >= 1")
        if self.loop_collision_face_subsample < 1 or self.reselect_every_blocks < 1:
            raise ValueError("loop_collision_face_subsample and reselect_every_blocks must be >= 1")


# fields whose non-default values select paths this port does not have yet:
# SGD, the K-candidate backend, the fast-off / per-step reselection / unfrozen
# in-loop variants, the 2-level hierarchy, parity-alternating queries, the
# grid backend and escalation, and the fused (non-hoisted) engine
_UNPORTED = (
    "optimizer",
    "num_candidates",
    "loop_collision_fast",
    "loop_collision_cluster",
    "loop_collision_alternate",
    "loop_collision_lazy_reselect",
    "loop_collision_freeze_positions",
    "escalate_collision",
    "escalate_warm_start",
    "escalate_fast_build",
    "grid_face_subsample",
    "grid_num_candidates",
    "grid_res",
    "grid_focus",
    "stage_hoist_decode",
)


def params_from_init(
    init_cam: torch.Tensor,  # (B, 3)
    init_pose_params: torch.Tensor,  # (B, 96)
    init_shape_params: torch.Tensor,  # (B, 20)
    init_hand_trans: torch.Tensor,  # (B, 1, 4) or (B, 3)
) -> ParamDict:
    """Split the flat initial prediction into the parameter groups."""
    trans = init_hand_trans.reshape(init_hand_trans.shape[0], -1)[:, :3]
    return {
        "cam": init_cam,
        "right_orient": init_pose_params[:, 0:3],
        "right_pose": init_pose_params[:, 3:48],
        "left_orient": init_pose_params[:, 48:51],
        "left_pose": init_pose_params[:, 51:96],
        "right_shape": init_shape_params[:, :10],
        "left_shape": init_shape_params[:, 10:],
        "trans": trans,
    }


def params_to_handparams(p: ParamDict) -> HandParams:
    return HandParams(**{name: p[name] for name in HandParams.__dataclass_fields__})


def forward(model: ManoModel, p: ParamDict):
    """params -> (right_verts, left_verts, joints3d (B,42,3), joints2d (B,42,2))."""
    rv, lv, joints = two_hand_decode_mirrored(
        model,
        p["right_orient"],
        p["left_orient"],
        p["right_pose"],
        p["left_pose"],
        p["right_shape"],
        p["left_shape"],
        p["trans"],
    )
    return rv, lv, joints, orthographic_project(joints, p["cam"])


def _query_subsets(rv: torch.Tensor, lv: torch.Tensor, sub: int):
    """Collision query subsets: every ``sub``-th vertex of each hand."""
    if sub > 1:
        return rv[:, ::sub], lv[:, ::sub]
    return rv, lv


def compute_losses(
    model: ManoModel,
    p: ParamDict,
    batch: OptBatch,
    weights: Dict[str, float],
    config: OptConfig,
    in_loop: bool = False,
    coll_tris: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
    outputs=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """All OPT losses -> (total scalar, aux dict).

    aux carries the per-sample vectors that drive snapshot filtering and
    selection ('joints_3d_loss_p_batch', 'joints_2d_loss_p_batch' weighted,
    'collision_loss_batch' unweighted) and the scalar logging losses. The
    ground-truth logging losses are computed only outside the loop (the
    engine never reads them in-loop).

    In the loop, ``coll_tris`` = (tri_r, tri_l, scale) is the block-frozen
    payload (``_lazy_coll_payload``); a stage whose collision weight is 0
    skips collision entirely. Outside the loop the exact kernel runs on the
    full meshes. ``outputs`` reuses a forward already computed for ``p``."""
    rv, lv, joints3d, joints2d = outputs if outputs is not None else forward(model, p)
    aux: Dict[str, torch.Tensor] = {}

    if not in_loop:
        j2d_gt, _ = L.joints_2d_loss(batch.joints_2d[:, :, :2], joints2d, batch.joints_2d[:, :, 2:3])
        aux["joints_2d_loss"] = j2d_gt
        j3d_gt, _ = L.joints_3d_loss(batch.joints_3d[:, :, :3], joints3d, batch.joints_3d[:, :, 3:4])
        aux["joints_3d_loss"] = j3d_gt * 1000.0
        trans_gt = L.hand_trans_loss(batch.hand_trans[:, :, :3], p["trans"], batch.hand_trans[:, :, 3:4])
        aux["hand_trans_loss"] = trans_gt * 10.0

    j2d_p, j2d_p_batch = L.joints_2d_loss(
        batch.init_joints_2d[:, :, :2], joints2d, batch.init_joints_2d[:, :, 2:3]
    )
    aux["joints_2d_loss_p_batch"] = j2d_p_batch * weights["joints_2d_loss"]
    total = j2d_p * weights["joints_2d_loss"]

    j3d_p, j3d_p_batch = L.joints_3d_loss(
        batch.init_joints_3d[:, :, :3], joints3d, batch.init_joints_3d[:, :, 3:4]
    )
    aux["joints_3d_loss_p_batch"] = j3d_p_batch * weights["joints_3d_loss"]
    total = total + j3d_p * weights["joints_3d_loss"]

    trans_p = L.hand_trans_loss(
        batch.init_hand_trans_j[:, :, :3], p["trans"], batch.init_hand_trans_j[:, :, 3:4]
    )
    total = total + trans_p * weights["trans_loss_weight"]

    w_coll = float(weights["collision_loss_weight"])
    sub = config.loop_collision_subsample if in_loop else 1
    if in_loop and w_coll == 0.0:
        # weight 0: no gradient and no filter pressure; skip the work
        B, V = rv.shape[0], rv.shape[1]
        coll = rv.new_zeros(())
        coll_batch = rv.new_zeros((B,))
        coll_origin = rv.new_zeros((B, 2 * V))
    elif in_loop:
        if coll_tris is None:
            raise ValueError("in-loop collision needs the block-frozen payload (coll_tris)")
        tri_r, tri_l, frozen_scale = coll_tris
        q_r, q_l = _query_subsets(rv, lv, sub)
        depths = pair_depths_at_tris(q_r, q_l, tri_r, tri_l, margin=config.loop_collision_margin)
        coll, coll_batch, coll_origin = depths_to_loss(
            depths, rv, lv, batch.hand_type_array, config.robustifier, scale=frozen_scale
        )
    else:
        coll, coll_batch, coll_origin = collision_loss(
            rv,
            lv,
            model.faces,
            model.faces.flip(-1),  # mirrored-left winding
            batch.hand_type_array,
            robustifier=config.robustifier,
            backend=config.collision_backend,
            parity_filter=config.exact_parity_filter,
        )
    if sub > 1:  # keep the loss magnitude comparable to full sampling
        coll = coll * sub
        coll_batch = coll_batch * sub
    aux["collision_loss"] = coll * w_coll
    aux["collision_loss_batch"] = coll_batch
    aux["collision_loss_origin_scale"] = coll_origin
    total = total + coll * w_coll

    shape_reg, _ = L.shape_reg_loss(torch.cat([p["right_shape"], p["left_shape"]], dim=1))
    total = total + shape_reg * weights["shape_reg_loss_weight"]
    aux["shape_reg_loss"] = shape_reg * weights["shape_reg_loss_weight"]

    finger_reg, _ = L.finger_reg_loss(joints3d)
    total = total + finger_reg * weights["finger_reg_loss_weight"]
    aux["finger_reg_loss"] = finger_reg * weights["finger_reg_loss_weight"]
    return total, aux


_FILTER_KEYS = {
    "joints_3d_loss_p": "joints_3d_loss_p_batch",
    "joints_2d_loss_p": "joints_2d_loss_p_batch",
    "collision_loss": "collision_loss_batch",
}


@torch.no_grad()
def _lazy_coll_payload(model: ManoModel, p: ParamDict, config: OptConfig):
    """The block-frozen collision payload at the current params:
    (tri_r, tri_l, scale) — each stride-``loop_collision_subsample`` query's
    nearest face of the other hand's stride-``loop_collision_face_subsample``
    face set (Morton order makes that a uniform sub-mesh of the FULL vertex
    array), as positions, plus the AABB normalisation scale."""
    rv, lv, _, _ = forward(model, p)
    fsub = config.loop_collision_face_subsample
    faces_r = model.faces[::fsub]
    faces_l = model.faces.flip(-1)[::fsub]
    q_r, q_l = _query_subsets(rv, lv, config.loop_collision_subsample)
    idx = pair_indices(q_r, q_l, rv, lv, faces_r, faces_l)
    tri_r, tri_l = pair_tris_at(rv, lv, faces_r, faces_l, *idx)
    return tri_r, tri_l, pair_aabb_scale(rv, lv)


def run_stage(
    model: ManoModel,
    params: ParamDict,
    batch: OptBatch,
    stage: Stage,
    config: OptConfig,
) -> ParamDict:
    """One refinement stage with the block engine described in the module
    docstring -> params with the stage's groups set to each sample's best
    snapshot."""
    w = stage.weights
    filter_names = [name for name, _pct in stage.filter_loss]
    select_key = _FILTER_KEYS[stage.select_loss]
    device = params["trans"].device
    B = batch.hand_type_array.shape[0]
    bars_pct = torch.tensor(
        [(float(pct) + 0.1) / 100.0 for _n, pct in stage.filter_loss], dtype=torch.float32, device=device
    )
    blocked = float(w["collision_loss_weight"]) != 0.0  # a block payload exists
    steps = stage.epoch + 1

    subset = {k: params[k].detach().clone() for k in stage.update_params}
    frozen = {k: v.detach() for k, v in params.items() if k not in stage.update_params}
    adam = Adam(subset)
    best = {k: x.detach() for k, x in subset.items()}
    best_select = torch.full((B,), float("inf"), dtype=torch.float32, device=device)
    bars = torch.zeros((len(filter_names), B), dtype=torch.float32, device=device)

    def grads_at(payload):
        leaves = {k: x.requires_grad_(True) for k, x in subset.items()}
        total, aux = compute_losses(
            model, {**frozen, **leaves}, batch, w, config, in_loop=True, coll_tris=payload
        )
        grads = torch.autograd.grad(total, list(leaves.values()))
        return {k: a.detach() for k, a in aux.items()}, dict(zip(leaves, grads))

    def update(grads):
        nonlocal subset
        subset = adam.step(subset, grads, stage.lr)

    def run_block(j0, length, payload):
        nonlocal best, best_select, bars
        aux, grads = grads_at(payload)
        with torch.no_grad():
            cur = torch.stack([aux[_FILTER_KEYS[n]] for n in filter_names], dim=0)  # (NF, B)
            cur_select = aux[select_key]
            if j0 == 0:  # first snapshot: set the bars, take the params unconditionally
                bars = cur * (1.0 + bars_pct[:, None])
                improve = torch.ones((B,), dtype=torch.bool, device=device)
            else:
                improve = (cur <= bars).all(dim=0) & (cur_select < best_select)
            best_select = torch.where(improve, cur_select, best_select)
            best = {k: torch.where(improve[:, None], subset[k], best[k]) for k in subset}
        update(grads)
        for _ in range(length - 1):  # lean steps: gradient + update only
            update(grads_at(payload)[1])

    freq = config.save_mid_freq
    nblocks, tail = divmod(steps, freq)
    kre = config.reselect_every_blocks if blocked else 1

    def payload_now():
        return _lazy_coll_payload(model, {**frozen, **subset}, config) if blocked else None

    # superblocks of kre snapshot blocks share one payload rebuild
    nsb, rem = divmod(nblocks, kre)
    for s in range(nsb):
        payload = payload_now()
        for i in range(kre):
            run_block(s * kre * freq + i * freq, freq, payload)
    if rem or tail:
        payload = payload_now()
        j0 = nsb * kre * freq
        for i in range(rem):
            run_block(j0 + i * freq, freq, payload)
        if tail:
            run_block(j0 + rem * freq, tail, payload)
    return {**frozen, **{k: x.detach() for k, x in best.items()}}


def optimize_batch(
    model: ManoModel,
    params_init: ParamDict,
    batch: OptBatch,
    strategy: Tuple[Stage, ...],
    config: OptConfig = OptConfig(),
) -> Tuple[ParamDict, Dict[str, torch.Tensor]]:
    """All stages, then a final pass at the default loss weights with the
    exact collision metric -> (refined params, results dict)."""
    params = {k: x.detach() for k, x in params_init.items()}
    for stage in strategy:
        params = run_stage(model, params, batch, stage, config)

    with torch.no_grad():
        outputs = forward(model, params)
        total, aux = compute_losses(
            model, params, batch, dict(OPT_DEFAULT_LOSS_WEIGHTS), config, outputs=outputs
        )
    rv, lv, joints3d, joints2d = outputs
    hp = params_to_handparams(params)
    results = {
        "pred_cam_params": params["cam"],
        "pred_hand_trans": params["trans"],
        "pred_shape_params": hp.shape_params,
        "pred_pose_params": hp.pose_params,
        "pred_right_hand_verts": rv,
        "pred_left_hand_verts": lv,
        "pred_joints_3d": joints3d,
        "pred_joints_2d": joints2d,
        "gt_joints_3d": batch.joints_3d,
        "mano_params_weight": batch.mano_params_weight,
        "collision_loss": aux["collision_loss_batch"],
        "collision_loss_origin_scale": aux["collision_loss_origin_scale"],
        "total_loss": total,
        "joints_2d_loss": aux["joints_2d_loss"],
        "joints_3d_loss": aux["joints_3d_loss"],
        "hand_trans_loss": aux["hand_trans_loss"],
    }
    return params, results
