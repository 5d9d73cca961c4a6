"""IHMR-OPT: per-sample collision-aware test-time refinement (port of
ihmr_tpu/refine/opt_engine.py, engine semantics of ``_run_one_stage_hoisted``).

For each strategy stage: ``epoch + 1`` optimizer steps (Adam, or SGD with
momentum 0.9) on the stage's parameter groups, fresh state per stage.
Steps are grouped in snapshot blocks of ``save_mid_freq`` steps; only the
first step of a block (a snapshot step) evaluates the filter/select losses:
the first block of a stage sets the filter bars (origin * (1 + (pct +
0.1)/100)) and the best params unconditionally; later snapshots replace a
sample's best when every filter loss is under its bar and the select loss
is strictly lower (the earliest minimum wins). The other steps of a block
only compute gradients and the optimizer's update.

In-loop collision, by default, is the block-frozen nearest-face payload:
every ``reselect_every_blocks`` blocks (a superblock) the current mesh is
decoded once, each stride-2 query picks its nearest face of the stride-2
face set of the other hand (bf16 rank), and those triangles' positions plus
the AABB scale are frozen for the superblock; the steps then evaluate the
exact depth of the live queries against the frozen triangles. 301 steps at
save_mid_freq=10 are 30 blocks in 15 superblocks plus a 1-step tail block
with its own payload. The other in-loop paths of the JAX package (a frozen
selection at live positions, per-step selection, parity-alternating
queries, the K-candidate and exact backends, the reference's grid field)
are listed at ``OptConfig``.

With ``OptConfig.stage_hoist_decode`` (the default, as in the JAX package)
each stage's forward is partially evaluated against the groups it keeps
frozen (``_make_stage_forward``): a trans/cam stage decodes once and adds
trans per step, an orient stage rotates an identity-orient decode about the
rest root, a shape stage contracts a 21x-batch affine basis, and a pose
stage reuses the betas-only rest parts and the root rotation. These are
exact, so ``stage_hoist_decode=False`` (the full decode at every step) gives
the same results up to fp32 rounding. The payload rebuilds use the stage's
forward too.

The final pass recomputes every loss at the default weights with the full
decode and ``collision_backend`` on the full meshes (by default the exact
kernel, ops/exact_collision.py; a grid config measures with the exact
kernel too) ANDed with the ray-parity filter.

Optimizer note: the reference optimises the batch-MEAN loss; Adam's update
is invariant to that uniform 1/B gradient scale (up to eps), so per-sample
trajectories do not depend on the batch size. SGD's are scaled by 1/B, as
in the JAX package.

Data parallel: ``optimize_batch`` on ``Sharded`` params and batch
(``parallel.mesh.shard_batch``) runs the engine once per shard, each on its
device; inside a shard the loss is the shard's batch mean weighted by its
share of the global batch (``_global_mean``), so each sample's gradient is
the one-device run's, and the batch scalars of the results are the global
means.

Without the hoist the engine follows the JAX package's choice: the block
engine on the full decode for Adam on a strategy whose stages share epoch,
filter and select losses (its fused engine), else its per-stage programs
(``run_stage_program``: collision afresh at every step). With
``escalate_collision > 0``, ``optimize_batch`` runs the two-pass grid
escalation of refine/escalation.py.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from ihmr_tpu_torch.core.projection import orthographic_project
from ihmr_tpu_torch.losses import losses as L
from ihmr_tpu_torch.mano.layer import (
    HandParams,
    two_hand_decode_from_identity,
    two_hand_decode_from_pose_payload,
    two_hand_decode_from_shape_affine,
    two_hand_decode_mirrored,
    two_hand_identity_orient_payload,
    two_hand_pose_payload,
    two_hand_shape_affine_payload,
)
from ihmr_tpu_torch.mano.model import ManoModel
from ihmr_tpu_torch.ops.collision import (
    collision_loss,
    depths_to_loss,
    pair_aabb_scale,
    pair_depths_at,
    pair_depths_at_tris,
    pair_indices,
    pair_select_tris,
    pair_tris_at,
)
from ihmr_tpu_torch.ops.grid_sdf import pair_depths_grid, pair_grids
from ihmr_tpu_torch.parallel.mesh import Replicated, Sharded, current_shard, replicate
from ihmr_tpu_torch.profiling import count, span
from ihmr_tpu_torch.refine.adam import SGD, Adam
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
    """The JAX package's OptConfig: same field names, defaults and meaning
    (``replace``, ``lazy_active``, ``grid_in_loop`` too).

    In the loop, collision runs one of these paths (``compute_losses``):
      * the block-frozen nearest-face payload (the default): triangles
        selected and positioned once a superblock, ``tris``;
      * ``loop_collision_freeze_positions=False``: the selection frozen, the
        positions tracked every step, ``idx``;
      * ``loop_collision_lazy_reselect=False``: selection every step (the
        K=1 ``"xla"`` depth), as JAX's per-stage programs always do;
      * ``loop_collision_alternate`` (stride 2): even vertices on even
        steps, odd on odd;
      * ``loop_collision_fast=False``: ``collision_backend`` at
        ``num_candidates`` every step ("auto"/"pallas": the exact kernel K1
        and its backward, which needs ``loop_collision_subsample=1``;
        "xla": the K-candidate depth; "fast": the kernel K2), or with
        "grid" the reference's field, rebuilt once a superblock from the
        ``grid_*`` knobs;
      * ``loop_collision_cluster = g > 0`` (with ``loop_collision_fast``):
        the 2-level hierarchy over clusters of g Morton-adjacent faces
        (``collision_loss(backend="2level")``) every step, no block payload;
      * ``escalate_collision > 0``: two passes (refine/escalation.py).
    ``collision_backend="2level"`` takes the hierarchy where the backend is
    read (``loop_collision_fast=False`` in the loop, the final pass), with
    ``loop_collision_cluster`` faces a cluster: it needs
    ``loop_collision_cluster > 0``. The pair constructs without it, as in
    JAX, and ``optimize_batch`` refuses it before any step."""

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
        if self.optimizer not in ("adam", "sgd"):
            raise ValueError(f"optimizer={self.optimizer!r}: 'adam' or 'sgd'")
        if self.collision_backend not in _BACKENDS:
            raise ValueError(f"collision_backend={self.collision_backend!r}: one of {_BACKENDS}")
        for name in ("save_mid_freq", "num_candidates", "loop_collision_subsample",
                     "loop_collision_face_subsample", "reselect_every_blocks", "grid_face_subsample"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1")
        if self.grid_res < 2 or self.grid_num_candidates < 0:
            raise ValueError("grid_res must be >= 2 and grid_num_candidates >= 0")

    def replace(self, **changes) -> "OptConfig":
        return dataclasses.replace(self, **changes)

    def lazy_active(self) -> bool:
        """Whether the block engine may freeze nearest-face selections: only
        on the fast in-loop path (an exact in-loop backend must not be
        downgraded to it)."""
        return self.loop_collision_lazy_reselect and self.loop_collision_fast and self.loop_collision_cluster == 0

    def grid_in_loop(self) -> bool:
        """In-loop collision through the reference's grid field
        (``loop_collision_fast=False`` with ``collision_backend="grid"``)."""
        return (not self.loop_collision_fast) and self.collision_backend == "grid"


# collision backends ("auto" and "pallas" are the exact kernel)
_BACKENDS = ("auto", "pallas", "xla", "grid", "fast", "2level")
# the merged per-block payload builder (ops/collision.py::pair_select_tris)
# instead of pair_indices + pair_tris_at, read at import as the JAX package
# reads it and looked up at call time: IHMR_PAYLOAD_FUSED=1
_PAYLOAD_FUSED = os.environ.get("IHMR_PAYLOAD_FUSED", "0") != "0"


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


def _query_subsets(rv: torch.Tensor, lv: torch.Tensor, sub: int, parity: Optional[int] = None):
    """Collision query subsets: every ``sub``-th vertex of each hand, or at
    stride 2 with a ``parity``, the even vertices (parity 0) or the odd ones
    (parity 1)."""
    if sub == 2 and parity is not None:
        return rv[:, parity::2], lv[:, parity::2]
    if sub > 1:
        return rv[:, ::sub], lv[:, ::sub]
    return rv, lv


def _strided_faces(model: ManoModel, fsub: int):
    """(right faces, mirrored-left faces), every ``fsub``-th: Morton order
    makes that a uniform sub-mesh of the FULL vertex array (queries are
    strided, the meshes stay full)."""
    return model.faces[::fsub], model.faces.flip(-1)[::fsub]


def _global_mean(total: torch.Tensor) -> torch.Tensor:
    """The loss whose gradient the optimizer takes: inside a shard of a
    data-parallel run (``parallel.mesh``) the shard's batch mean weighted by
    its share of the global batch, which makes it the global batch mean's
    term for these samples; elsewhere the batch mean itself."""
    shard = current_shard()
    return total if shard is None else total * shard.share


def compute_losses(
    model: ManoModel,
    p: ParamDict,
    batch: OptBatch,
    weights: Dict[str, float],
    config: OptConfig,
    in_loop: bool = False,
    coll_tris: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
    outputs=None,
    fwd_fn: Optional[Callable[[ParamDict], Tuple[torch.Tensor, ...]]] = None,
    coll_idx: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    coll_parity: Optional[int] = None,
    coll_grid=None,
    skip_zero_collision: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """All OPT losses -> (total scalar, aux dict).

    aux carries the per-sample vectors that drive snapshot filtering and
    selection ('joints_3d_loss_p_batch', 'joints_2d_loss_p_batch' weighted,
    'collision_loss_batch' unweighted) and the scalar logging losses. The
    ground-truth logging losses are computed only outside the loop (the
    engine never reads them in-loop).

    In the loop, collision takes the first path that applies, in the JAX
    package's order: weight 0 skips it (unless ``skip_zero_collision`` is
    False: the JAX package's fused engine, whose traced weights never skip); ``coll_grid`` (block-frozen grids)
    samples them trilinearly; on the fast path (``loop_collision_fast``),
    ``coll_tris`` = (tri_r, tri_l, scale) is the block-frozen payload,
    ``coll_idx`` = (idx_r, idx_l) a frozen selection at the current
    positions, and ``coll_parity`` alone selects every step on the parity's
    queries; otherwise ``collision_loss`` runs every step, the K=1 "xla"
    depth on the fast path, else ``collision_backend`` at
    ``num_candidates``. In-loop queries are strided by
    ``loop_collision_subsample`` (the loss scaled back by it) and faces by
    ``loop_collision_face_subsample``. Outside the loop the final metric
    runs on the full meshes with ``collision_backend`` ("grid" measures
    with the exact kernel), ANDed with the ray-parity filter.
    ``outputs`` reuses a forward already computed for ``p``; ``fwd_fn``
    (params -> the same four outputs) replaces the full decode with a
    stage's hoisted forward (``_make_stage_forward``)."""
    with span("opt.losses"):
        if outputs is None:
            with span("opt.decode"):
                outputs = fwd_fn(p) if fwd_fn is not None else forward(model, p)
        rv, lv, joints3d, joints2d = outputs
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

        w_coll = weights["collision_loss_weight"]
        if in_loop and config.loop_collision_fast:
            backend, num_candidates = ("2level" if config.loop_collision_cluster > 0 else "xla"), 1
        else:
            backend, num_candidates = config.collision_backend, config.num_candidates
            if backend == "fast":  # single-candidate whatever num_candidates says, as in JAX
                num_candidates = 1
            if not in_loop and backend == "grid":
                # the grid is an in-loop mechanism; the final metric is exact
                backend, num_candidates = "auto", 8
        sub = config.loop_collision_subsample if in_loop else 1
        fsub = config.loop_collision_face_subsample if in_loop else 1
        # the frozen-payload and parity paths ARE the flat nearest-face selection:
        # never taken with the 2-level hierarchy
        fast_in_loop = in_loop and config.loop_collision_fast and config.loop_collision_cluster == 0
        margin = config.loop_collision_margin
        with span("opt.collision"):
            if in_loop and skip_zero_collision and float(w_coll) == 0.0:
                # a weight of 0: no gradient and no filter pressure, so skip the work
                B, V = rv.shape[0], rv.shape[1]
                coll = rv.new_zeros(())
                coll_batch = rv.new_zeros((B,))
                coll_origin = rv.new_zeros((B, 2 * V))
            elif in_loop and coll_grid is not None:
                q_r, q_l = _query_subsets(rv, lv, sub, coll_parity)
                depths = pair_depths_grid(q_r, q_l, coll_grid)
                coll, coll_batch, coll_origin = depths_to_loss(
                    depths, rv, lv, batch.hand_type_array, config.robustifier
                )
            elif fast_in_loop and coll_tris is not None:
                tri_r, tri_l, frozen_scale = coll_tris
                q_r, q_l = _query_subsets(rv, lv, sub, coll_parity)
                depths = pair_depths_at_tris(q_r, q_l, tri_r, tri_l, margin=margin)
                coll, coll_batch, coll_origin = depths_to_loss(
                    depths, rv, lv, batch.hand_type_array, config.robustifier, scale=frozen_scale
                )
            elif fast_in_loop and (coll_idx is not None or coll_parity is not None):
                # a frozen selection at the current positions, or a fresh one on the
                # parity's queries
                q_r, q_l = _query_subsets(rv, lv, sub, coll_parity)
                faces_r, faces_l = _strided_faces(model, fsub)
                idx = coll_idx if coll_idx is not None else pair_indices(q_r, q_l, rv, lv, faces_r, faces_l)
                depths = pair_depths_at(q_r, q_l, rv, lv, faces_r, faces_l, *idx, margin=margin)
                coll, coll_batch, coll_origin = depths_to_loss(
                    depths, rv, lv, batch.hand_type_array, config.robustifier
                )
            else:
                coll, coll_batch, coll_origin = collision_loss(
                    rv,
                    lv,
                    *_strided_faces(model, fsub),
                    batch.hand_type_array,
                    robustifier=config.robustifier,
                    num_candidates=num_candidates,
                    backend=backend,
                    cluster_group=config.loop_collision_cluster,
                    query_subsample=sub,
                    margin=margin if in_loop else 0.0,
                    parity_filter=(not in_loop) and config.exact_parity_filter,
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
def _lazy_coll_payload(
    model: ManoModel,
    p: ParamDict,
    config: OptConfig,
    parities: Tuple[Optional[int], ...] = (None,),
    mode: str = "tris",
    fwd_fn=None,
) -> tuple:
    """The block-frozen collision payload at the current params, one entry
    per parity in ``parities`` (None = the fixed-stride queries), from one
    decode (``fwd_fn`` when given: the stage's hoisted forward):

      * ``"tris"``: (tri_r, tri_l, scale), each stride-
        ``loop_collision_subsample`` query's nearest face of the other
        hand's stride-``loop_collision_face_subsample`` face set (Morton
        order makes that a uniform sub-mesh of the FULL vertex array), as
        positions, plus the AABB normalisation scale (with
        ``IHMR_PAYLOAD_FUSED=1``: built by the merged ``pair_select_tris``);
      * ``"idx"``: (idx_r, idx_l), the selection alone (positions are taken
        at every step);
      * ``"grid"``: the two hands' grids from the ``grid_*`` knobs
        (``ops/grid_sdf.py::pair_grids``, the full face set unless
        ``grid_face_subsample``); query-independent, so one entry."""
    rv, lv, _, _ = fwd_fn(p) if fwd_fn is not None else forward(model, p)
    if mode == "grid":
        return (
            pair_grids(
                rv, lv, model.faces, model.faces.flip(-1), res=config.grid_res,
                num_candidates=config.grid_num_candidates or config.num_candidates,
                face_subsample=config.grid_face_subsample, focus=config.grid_focus,
            ),
        )
    faces_r, faces_l = _strided_faces(model, config.loop_collision_face_subsample)
    scale = pair_aabb_scale(rv, lv) if mode == "tris" else None
    if mode == "tris" and _PAYLOAD_FUSED:
        # every parity's queries in one merged call, concatenated on the V axis
        qs = [_query_subsets(rv, lv, config.loop_collision_subsample, parity) for parity in parities]
        tri_r, tri_l = pair_select_tris(
            torch.cat([q[0] for q in qs], dim=1), torch.cat([q[1] for q in qs], dim=1), rv, lv, faces_r, faces_l
        )
        v = qs[0][0].shape[1]
        return tuple((tri_r[:, i * v:(i + 1) * v], tri_l[:, i * v:(i + 1) * v], scale) for i in range(len(qs)))
    out = []
    for parity in parities:
        q_r, q_l = _query_subsets(rv, lv, config.loop_collision_subsample, parity)
        idx = pair_indices(q_r, q_l, rv, lv, faces_r, faces_l)
        out.append((*pair_tris_at(rv, lv, faces_r, faces_l, *idx), scale) if mode == "tris" else idx)
    return tuple(out)


@torch.no_grad()
def _make_stage_forward(
    model: ManoModel, stage: Stage, params_entry: ParamDict
) -> Optional[Callable[[ParamDict], Tuple[torch.Tensor, ...]]]:
    """The stage's exact forward with the decode partially evaluated against
    its frozen groups, or None when no hoist applies (a stage that updates a
    shaping group together with orient).

    ``params_entry`` are the params entering the stage; the groups the stage
    does not update keep those values for the whole stage. The four cases
    are tested in the JAX package's order: trans/cam only, orients, shapes,
    poses (each together with trans and cam)."""
    up = set(stage.update_params)
    pe = params_entry
    if up <= {"trans", "cam"}:
        # both meshes are rigid: decode once at trans=0; trans enters the
        # mirrored composition additively on the left hand only
        rv0, lv0, j0 = two_hand_decode_mirrored(
            model, pe["right_orient"], pe["left_orient"], pe["right_pose"], pe["left_pose"],
            pe["right_shape"], pe["left_shape"], torch.zeros_like(pe["trans"]),
        )

        def fwd(p):
            t = p["trans"][:, None, :]
            joints = torch.cat([j0[:, :21], j0[:, 21:] + t], dim=1)
            return rv0, lv0 + t, joints, orthographic_project(joints, p["cam"])

        return fwd
    if up <= {"right_orient", "left_orient", "trans", "cam"}:
        verts_id, lbsj_id = two_hand_identity_orient_payload(
            model, pe["right_pose"], pe["left_pose"], pe["right_shape"], pe["left_shape"]
        )

        def fwd(p):
            rv, lv, joints = two_hand_decode_from_identity(
                verts_id, lbsj_id, p["right_orient"], p["left_orient"], p["trans"]
            )
            return rv, lv, joints, orthographic_project(joints, p["cam"])

        return fwd
    if up <= {"right_shape", "left_shape", "trans", "cam"}:
        base, basis = two_hand_shape_affine_payload(
            model, pe["right_orient"], pe["left_orient"], pe["right_pose"], pe["left_pose"],
            pe["right_shape"], pe["left_shape"],
        )
        shape_r0, shape_l0 = pe["right_shape"], pe["left_shape"]

        def fwd(p):
            rv, lv, joints = two_hand_decode_from_shape_affine(
                base, basis, shape_r0, shape_l0, p["right_shape"], p["left_shape"], p["trans"]
            )
            return rv, lv, joints, orthographic_project(joints, p["cam"])

        return fwd
    if up <= {"right_pose", "left_pose", "trans", "cam"}:
        payload = two_hand_pose_payload(
            model, pe["right_orient"], pe["left_orient"], pe["right_shape"], pe["left_shape"]
        )

        def fwd(p):
            rv, lv, joints = two_hand_decode_from_pose_payload(
                model, payload, p["right_pose"], p["left_pose"], p["trans"]
            )
            return rv, lv, joints, orthographic_project(joints, p["cam"])

        return fwd
    return None


def run_stage(
    model: ManoModel,
    params: ParamDict,
    batch: OptBatch,
    stage: Stage,
    config: OptConfig,
    skip_zero_collision: bool = True,
) -> ParamDict:
    """One refinement stage with the block engine described in the module
    docstring -> params with the stage's groups set to each sample's best
    snapshot.

    The collision payload depends on the config: a superblock's frozen
    triangles (``tris``), its frozen selection (``idx``) or its grids
    (``grid``); with ``loop_collision_alternate`` at stride 2 one entry per
    parity, step j taking entry j % 2. A config that neither freezes
    selections (``lazy_active``) nor samples grids runs collision afresh at
    every step. ``skip_zero_collision=False`` is the JAX package's fused
    engine on a strategy where some stage weighs collision: a weight-0 stage
    then still computes collision (its per-sample values enter the filter)
    and builds payloads."""
    w = stage.weights
    filter_names = [name for name, _pct in stage.filter_loss]
    select_key = _FILTER_KEYS[stage.select_loss]
    device = params["trans"].device
    B = batch.hand_type_array.shape[0]
    bars_pct = torch.tensor(
        [(float(pct) + 0.1) / 100.0 for _n, pct in stage.filter_loss], dtype=torch.float32, device=device
    )
    alternate = config.loop_collision_alternate and config.loop_collision_subsample == 2
    coll_zero = skip_zero_collision and float(w["collision_loss_weight"]) == 0.0
    grid_mode = config.grid_in_loop()
    payload_mode = "grid" if grid_mode else ("tris" if config.loop_collision_freeze_positions else "idx")
    parities = (0, 1) if alternate else (None,)
    blocked = (not coll_zero) and (config.lazy_active() or grid_mode)  # a block payload exists
    steps = stage.epoch + 1

    subset = {k: params[k].detach().clone() for k in stage.update_params}
    frozen = {k: v.detach() for k, v in params.items() if k not in stage.update_params}
    fwd_fn = _make_stage_forward(model, stage, params) if config.stage_hoist_decode else None
    opt = Adam(subset) if config.optimizer == "adam" else SGD(subset)
    best = {k: x.detach() for k, x in subset.items()}
    best_select = torch.full((B,), float("inf"), dtype=torch.float32, device=device)
    bars = torch.zeros((len(filter_names), B), dtype=torch.float32, device=device)

    def grads_at(payload_set, j):
        parity = j % 2 if alternate else None
        payload = {}
        if payload_set is not None:
            entry = payload_set[j % 2] if alternate and len(payload_set) == 2 else payload_set[0]
            payload = {"coll_" + payload_mode: entry}
        leaves = {k: x.requires_grad_(True) for k, x in subset.items()}
        total, aux = compute_losses(
            model, {**frozen, **leaves}, batch, w, config, in_loop=True, fwd_fn=fwd_fn,
            coll_parity=parity, skip_zero_collision=skip_zero_collision, **payload,
        )
        with span("opt.backward"):
            grads = torch.autograd.grad(_global_mean(total), list(leaves.values()))
        return {k: a.detach() for k, a in aux.items()}, dict(zip(leaves, grads))

    def update(grads):
        nonlocal subset
        with span("opt.adam"):
            subset = opt.step(subset, grads, stage.lr)

    def run_block(j0, length, payload_set):
        nonlocal best, best_select, bars
        with span("opt.step"):
            count("opt.steps")
            aux, grads = grads_at(payload_set, j0)
            count("opt.snapshots")
            with span("opt.snapshot"), torch.no_grad():
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
        for j in range(j0 + 1, j0 + length):  # lean steps: gradient + update only
            with span("opt.step"):
                count("opt.steps")
                update(grads_at(payload_set, j)[1])

    freq = config.save_mid_freq
    nblocks, tail = divmod(steps, freq)
    kre = config.reselect_every_blocks if blocked else 1

    def payload_now():
        if not blocked:
            return None
        count("opt.payloads")
        with span("opt.payload"):
            return _lazy_coll_payload(model, {**frozen, **subset}, config, parities, payload_mode, fwd_fn)

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


def run_stage_program(
    model: ManoModel,
    params: ParamDict,
    batch: OptBatch,
    stage: Stage,
    config: OptConfig,
) -> ParamDict:
    """One stage as the JAX package's per-stage programs run it
    (``run_stage``; what ``optimize_batch`` runs without the hoist for SGD
    or a strategy whose stages differ in epoch, filter or select loss): the
    full decode at every step and collision afresh at every step (no block
    payload, no parity). Step 0 sets the origin losses, the filter bars and
    the first best, then takes the first update; each step j in 1..epoch
    snapshots when j % save_mid_freq == 0 (every filter loss under its bar
    and the select loss strictly lower) before its update. The optimizers
    are optax's: Adam divides the corrected moment before the learning rate
    (``lr_last``), SGD keeps momentum 0.9."""
    w = stage.weights
    filter_names = [name for name, _pct in stage.filter_loss]
    select_key = _FILTER_KEYS[stage.select_loss]
    device = params["trans"].device
    bars_pct = torch.tensor(
        [(float(pct) + 0.1) / 100.0 for _n, pct in stage.filter_loss], dtype=torch.float32, device=device
    )
    subset = {k: params[k].detach().clone() for k in stage.update_params}
    frozen = {k: v.detach() for k, v in params.items() if k not in stage.update_params}
    opt = Adam(subset, lr_last=True) if config.optimizer == "adam" else SGD(subset)

    def grads_at():
        leaves = {k: x.requires_grad_(True) for k, x in subset.items()}
        total, aux = compute_losses(model, {**frozen, **leaves}, batch, w, config, in_loop=True)
        with span("opt.backward"):
            grads = torch.autograd.grad(_global_mean(total), list(leaves.values()))
        return {k: a.detach() for k, a in aux.items()}, dict(zip(leaves, grads))

    def update(grads):
        with span("opt.adam"):
            return opt.step(subset, grads, stage.lr)

    with span("opt.step"):
        count("opt.steps")
        aux, grads = grads_at()
        count("opt.snapshots")
        with span("opt.snapshot"):
            bars = torch.stack([aux[_FILTER_KEYS[n]] for n in filter_names], dim=0) * (1.0 + bars_pct[:, None])
            best_select = aux[select_key]
            best = {k: x.detach() for k, x in subset.items()}
        subset = update(grads)
    for j in range(1, stage.epoch + 1):
        with span("opt.step"):
            count("opt.steps")
            aux, grads = grads_at()
            if j % config.save_mid_freq == 0:
                count("opt.snapshots")
                with span("opt.snapshot"), torch.no_grad():
                    cur = torch.stack([aux[_FILTER_KEYS[n]] for n in filter_names], dim=0)
                    cur_select = aux[select_key]
                    improve = (cur <= bars).all(dim=0) & (cur_select < best_select)
                    best_select = torch.where(improve, cur_select, best_select)
                    best = {k: torch.where(improve[:, None], subset[k], best[k]) for k in subset}
            subset = update(grads)
    return {**frozen, **{k: x.detach() for k, x in best.items()}}


def _strategy_is_fusable(strategy: Tuple[Stage, ...]) -> bool:
    """Whether the JAX package's fused engine (the block engine without the
    hoist) runs this strategy: every stage shares epoch, filter and select
    losses."""
    s0 = strategy[0]
    return all(
        s.epoch == s0.epoch and s.filter_loss == s0.filter_loss and s.select_loss == s0.select_loss
        for s in strategy
    )


def optimize_batch(
    model: ManoModel,
    params_init: ParamDict,
    batch: OptBatch,
    strategy: Tuple[Stage, ...],
    config: OptConfig = OptConfig(),
) -> Tuple[ParamDict, Dict[str, torch.Tensor]]:
    """All stages, then a final pass at the default loss weights with the
    full decode and the exact collision metric -> (refined params, results
    dict).

    The engine is chosen as the JAX package chooses it: the block engine
    with each stage's hoisted forward (``stage_hoist_decode``, Adam or SGD);
    else, for Adam on a strategy whose stages share epoch, filter and select
    losses, the block engine on the full decode (JAX's fused engine); else
    the per-stage programs (``run_stage_program``). With
    ``escalate_collision > 0`` this is pass 1 of the two-pass grid escalation
    (refine/escalation.py), which adds ``results["escalated"]``.

    On ``Sharded`` params and batch (``parallel.mesh.shard_batch``; the model
    replicated or on every shard's device) each shard runs the above on its
    device, and the results come back ``Sharded``: per-sample entries in
    their shards, the batch scalars (``total_loss``, ``joints_2d_loss``,
    ``joints_3d_loss``, ``hand_trans_loss``) the global batch means in
    every shard."""
    with span("opt.batch"):
        return _optimize_batch(model, params_init, batch, strategy, config)


def _optimize_batch(model, params_init, batch, strategy, config):
    if isinstance(params_init, Sharded):
        return _optimize_sharded(model, params_init, batch, strategy, config)
    if config.collision_backend == "2level" and config.loop_collision_cluster < 1:
        raise ValueError('collision_backend="2level" needs loop_collision_cluster > 0 (the faces of a cluster)')
    if config.escalate_collision > 0.0:
        from ihmr_tpu_torch.refine.escalation import optimize_batch_escalated

        return optimize_batch_escalated(model, params_init, batch, strategy, config)
    params = {k: x.detach() for k, x in params_init.items()}
    if config.stage_hoist_decode:
        run = run_stage
    elif _strategy_is_fusable(strategy) and config.optimizer == "adam":
        all_coll_zero = all(float(s.weights["collision_loss_weight"]) == 0.0 for s in strategy)
        run = functools.partial(run_stage, skip_zero_collision=all_coll_zero)
    else:
        run = run_stage_program
    for i, stage in enumerate(strategy):
        with span("opt.stage", stage=i, groups=stage.update_params):
            params = run(model, params, batch, stage, config)

    with span("opt.final"), torch.no_grad():
        with span("opt.decode"):
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


def _optimize_sharded(
    model, params: Sharded, batch: Sharded, strategy: Tuple[Stage, ...], config: OptConfig
) -> Tuple[Sharded, Sharded]:
    """``optimize_batch`` over a mesh: one engine per shard (``Mesh.map``),
    then each batch scalar of the results replaced by the shards' values
    weighted by their shares and added in shard order."""
    mesh = params.mesh
    if not isinstance(batch, Sharded) or batch.mesh is not mesh:
        raise ValueError("optimize_batch: params and batch must be sharded over one mesh")
    if not isinstance(model, Replicated):
        model = replicate(model, mesh)
    outs = mesh.map(optimize_batch, model, params, batch, strategy, config)
    rows = params.rows()
    scalars = [k for k, v in outs[0][1].items() if v.dim() == 0]
    home = mesh.devices[0]
    means = {k: sum(r[k].to(home) * (n / sum(rows)) for (_, r), n in zip(outs, rows)) for k in scalars}
    results = [{**r, **{k: means[k].to(d) for k in scalars}} for (_, r), d in zip(outs, mesh.devices)]
    return Sharded(mesh, [p for p, _ in outs]), Sharded(mesh, results)
