"""Plain IHMR-Baseline train step for the benchmark's reference.

Loss (the collision term off): handedness BCE + w2d * 2D L1 + w3d *
root-aligned 3D L2 + wpose * (right + left Rodrigues pose L2) + wshape *
(right + left betas L1) + wtrans * translation L2 + wreg * betas symmetry,
each a batch mean, after the encoder's 122 parameters are decoded through
the right and the mirrored left MANO model. Adam as optax computes it:
m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2,
p -= lr * ((m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)), the bias
corrections in float32.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from . import losses as L
from . import mano, resnet

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


def total_loss(p, batch: Dict[str, torch.Tensor], mean, right, left, weights: Dict[str, float], stats) -> torch.Tensor:
    pred, hand_type = resnet.encoder(p, batch["img"], mean, train=True, stats=stats)
    pose, shape, trans, cam = pred[:, 3:99], pred[:, 99:119], pred[:, 119:122], pred[:, 0:3]
    _rv, _lv, j3 = mano.decode_two_models(right, left, pose, shape, trans)
    j2 = mano.project(j3, cam)
    w = batch["mano_params_weight"]
    per = L.hand_type_bce(batch["hand_type_array"], hand_type, batch["hand_type_valid"])
    per = per + weights["joints_2d"] * L.joints_2d(batch["joints_2d"][..., :2], j2, batch["joints_2d"][..., 2:3])
    per = per + weights["joints_3d"] * L.joints_3d(batch["joints_3d"][..., :3], j3, batch["joints_3d"][..., 3:4])
    per = per + weights["pose"] * (
        L.pose_l2(batch["gt_pose"][:, :48], pose[:, :48], w[:, 0:1]) + L.pose_l2(batch["gt_pose"][:, 48:], pose[:, 48:], w[:, 1:2])
    )
    per = per + weights["shape"] * (
        L.shape_l1(batch["gt_shape"][:, :10], shape[:, :10], w[:, 0:1]) + L.shape_l1(batch["gt_shape"][:, 10:], shape[:, 10:], w[:, 1:2])
    )
    per = per + weights["trans"] * L.trans_l2(batch["hand_trans"][..., :3], trans, batch["hand_trans"][..., 3:4])
    per = per + weights["shape_reg"] * L.shape_reg(shape)
    return per.mean()


def run_steps(weights, batches: List[Dict[str, torch.Tensor]], right, lr: float, loss_weights: Dict[str, float]):
    """Train steps on ``batches`` from ``weights`` (name -> tensor, copied) ->
    dict: "loss" (per step), "grad1" (name -> the first step's gradient),
    "running1" (the running statistics after the first step), "params"
    (name -> after the last step)."""
    left = mano.mirror_model(right)
    p = {k: v.detach().clone() for k, v in weights.items()}
    leaves = [k for k, v in resnet.param_shapes().items() if v[1] in ("weight", "bias", "bn_weight", "bn_bias")]
    m = {k: torch.zeros_like(p[k]) for k in leaves}
    v = {k: torch.zeros_like(p[k]) for k in leaves}
    mean = resnet.mean_params(p[leaves[0]].device)
    out = {"loss": [], "grad1": None}
    b1, b2 = torch.tensor(B1, dtype=torch.float32), torch.tensor(B2, dtype=torch.float32)
    for t, batch in enumerate(batches, start=1):
        for k in leaves:
            p[k].requires_grad_(True)
        stats: Dict = {}
        loss = total_loss(p, batch, mean, right, left, loss_weights, stats)
        grads = dict(zip(leaves, torch.autograd.grad(loss, [p[k] for k in leaves])))
        out["loss"].append(float(loss.detach()))
        if out["grad1"] is None:
            out["grad1"] = grads
        c1 = float(1.0 - b1 ** float(t))
        c2 = float(1.0 - b2 ** float(t))
        with torch.no_grad():
            for k in leaves:
                g = grads[k]
                m[k] = B1 * m[k] + (1 - B1) * g
                v[k] = B2 * v[k] + (1 - B2) * g * g
                p[k] = p[k].detach() - lr * ((m[k] / c1) / (torch.sqrt(v[k] / c2) + ADAM_EPS))
        resnet.running_update(p, stats)
        if t == 1:
            out["running1"] = {k: p[k].clone() for k, s in resnet.param_shapes().items() if s[1] in ("bn_mean", "bn_var")}
    out["params"] = {k: p[k].detach() for k in leaves}
    return out
