"""Refinement stage schedules (port of ihmr_tpu/refine/schedule.py).

``opt_default``: 4 stages x 300 epochs (301 steps) — trans -> orients ->
finger poses (+ finger_reg 1e5) -> shapes; filter {joints_3d_loss_p <= +0%,
collision_loss <= -10%}, select joints_3d_loss_p.
``opt_with_cam``: ``opt_default`` plus a camera stage.
``mlp_default``: 6 stages x 2-5 epochs (trans, left orient, right orient,
poses, shapes, cam), filter {joints_3d_loss_p +0, collision +0}, select
collision (cam stage: joints_2d_loss_p), cosine learning-rate decay.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

PARAM_GROUP_DIMS: Dict[str, int] = {
    "cam": 3,
    "right_orient": 3,
    "left_orient": 3,
    "right_pose": 45,
    "left_pose": 45,
    "right_shape": 10,
    "left_shape": 10,
    "trans": 3,
}

# losses computed against ground truth may not steer snapshot selection
INVALID_FILTER_LOSSES = ("joints_3d_loss", "joints_2d_loss", "hand_trans_loss")


def check_valid_loss(name: str) -> bool:
    return name not in INVALID_FILTER_LOSSES


@dataclass(frozen=True)
class Stage:
    """One refinement stage (hashable, like the JAX package's static stage)."""

    update_params: Tuple[str, ...]
    loss_weights: Tuple[Tuple[str, float], ...]
    lr: float
    epoch: int
    filter_loss: Tuple[Tuple[str, str], ...]  # (loss name, percent string like '+0')
    select_loss: str
    lr_decay_type: str = "none"

    def __post_init__(self):
        for name in self.update_params:
            if name not in PARAM_GROUP_DIMS:
                raise ValueError(f"unknown parameter group {name!r}")
        for loss_name, pct in self.filter_loss:
            if not check_valid_loss(loss_name):
                raise ValueError(f"{loss_name!r} is computed against ground truth; it may not filter")
            if pct[0] not in "+-":
                raise ValueError(f"filter percent must start with + or -: {pct!r}")
        if not check_valid_loss(self.select_loss):
            raise ValueError(f"{self.select_loss!r} is computed against ground truth; it may not select")

    @property
    def weights(self) -> Dict[str, float]:
        return dict(self.loss_weights)

    @property
    def update_dim(self) -> int:
        return sum(PARAM_GROUP_DIMS[p] for p in self.update_params)


def _w(**kw) -> Tuple[Tuple[str, float], ...]:
    return tuple(sorted(kw.items()))


_OPT_FILTER = (("joints_3d_loss_p", "+0"), ("collision_loss", "-10"))


def _opt_stage(update, j2d, trans_w, coll, finger, lr):
    return Stage(
        update_params=update,
        loss_weights=_w(
            joints_2d_loss=j2d,
            joints_3d_loss=1000.0,
            trans_loss_weight=trans_w,
            shape_reg_loss_weight=0.1,
            collision_loss_weight=coll,
            finger_reg_loss_weight=finger,
        ),
        lr=lr,
        epoch=300,
        filter_loss=_OPT_FILTER,
        select_loss="joints_3d_loss_p",
    )


opt_default: Tuple[Stage, ...] = (
    _opt_stage(("trans",), 100.0, 1000.0, 0.1, 0.0, 1e-4),
    _opt_stage(("left_orient", "right_orient"), 10.0, 100.0, 1.0, 0.0, 1e-2),
    _opt_stage(("left_pose", "right_pose"), 10.0, 100.0, 1.0, 100000.0, 1e-2),
    _opt_stage(("left_shape", "right_shape"), 10.0, 100.0, 1.0, 0.0, 1e-2),
)

# default (log / final) OPT loss weights
OPT_DEFAULT_LOSS_WEIGHTS = _w(
    joints_2d_loss=10.0,
    joints_3d_loss=1000.0,
    trans_loss_weight=100.0,
    shape_reg_loss_weight=0.1,
    collision_loss_weight=1.0,
    finger_reg_loss_weight=100000.0,
)

# opt_default plus the camera stage the reference keeps disabled
opt_with_cam: Tuple[Stage, ...] = opt_default + (
    Stage(
        update_params=("cam",),
        loss_weights=_w(
            joints_2d_loss=10.0,
            joints_3d_loss=1000.0,
            trans_loss_weight=100.0,
            shape_reg_loss_weight=0.01,
            collision_loss_weight=1.0,
            finger_reg_loss_weight=0.0,
        ),
        lr=1e-2,
        epoch=100,
        filter_loss=(("joints_2d_loss_p", "+0"),),
        select_loss="joints_2d_loss_p",
    ),
)

_MLP_FILTER = (("joints_3d_loss_p", "+0"), ("collision_loss", "+0"))


def _mlp_weights(**overrides) -> Tuple[Tuple[str, float], ...]:
    base = dict(
        joints_2d_loss=10.0,
        joints_3d_loss=10.0,
        mano_pose_loss=10.0,
        mano_shape_loss=10.0,
        hand_trans_loss=10.0,
        shape_reg_loss=0.1,
        shape_residual_loss=0.0,
        collision_loss=1.0,
    )
    base.update(overrides)
    return tuple(sorted(base.items()))


def _mlp_stage(update, epoch=2, weights=None, filter_loss=_MLP_FILTER, select="collision_loss"):
    return Stage(
        update_params=update,
        loss_weights=weights or _mlp_weights(),
        lr=1e-4,
        epoch=epoch,
        filter_loss=filter_loss,
        select_loss=select,
        lr_decay_type="cosine",
    )


mlp_default: Tuple[Stage, ...] = (
    _mlp_stage(("trans",), weights=_mlp_weights(joints_3d_loss=1000.0, hand_trans_loss=1000.0)),
    _mlp_stage(("left_orient",)),
    _mlp_stage(("right_orient",)),
    _mlp_stage(("left_pose", "right_pose")),
    _mlp_stage(("left_shape", "right_shape")),
    _mlp_stage(("cam",), epoch=5, filter_loss=(("joints_2d_loss_p", "+0"),), select="joints_2d_loss_p"),
)

# default MLP loss weights (warm, select and cascade passes)
MLP_DEFAULT_LOSS_WEIGHTS = _mlp_weights(shape_residual_loss=1.0)

strategies: Dict[str, Tuple[Stage, ...]] = {
    "opt_default": opt_default,
    "opt_with_cam": opt_with_cam,
    "mlp_default": mlp_default,
}
