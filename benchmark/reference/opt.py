"""Plain IHMR-OPT refinement for the benchmark's reference.

For each stage, ``epoch + 1`` Adam steps on the stage's parameter groups
(fresh moments per stage; p -= (lr * m_hat) / (sqrt(v_hat) + eps)), the full
MANO decode at every step. Steps come in snapshot blocks of
``save_mid_freq``: the first step of a block evaluates the filter and select
losses before its update. The stage's first block sets each sample's filter
bars (origin * (1 + (pct + 0.1) / 100)) and its best parameters; a later
block replaces a sample's best when every filter loss is under its bar and
the select loss is strictly lower. The stage ends on each sample's best.

In-loop collision: every ``reselect_every_blocks`` blocks, and once more for
a tail block, the current meshes are decoded, every ``query_stride``-th
vertex of each hand picks its nearest face (``collision.nearest_faces``) of
every ``face_stride``-th face of the other hand, and those triangles'
positions and the two hands' bounding-box scale are frozen; each step then
takes the depth of the live queries against them, normalised by the frozen
scale, squared, summed per sample (interacting samples only) and scaled back
by ``query_stride``.

The final pass decodes in full and adds the losses at the default weights,
with the exact depth of every vertex against the other hand's whole mesh,
kept where the ray-parity test agrees it is inside.

Every batch loss is a sum over the samples followed here divided by
``batch_size``, the size of the whole batch: each sample gets the gradient
it gets in the whole batch, and the reference can follow any subset of it.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from . import collision as C
from . import losses as L
from . import mano

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8
GROUPS = ("cam", "right_orient", "left_orient", "right_pose", "left_pose", "right_shape", "left_shape", "trans")
FLAT = (("cam", 0, 3), ("right_orient", 3, 6), ("right_pose", 6, 51), ("left_orient", 51, 54), ("left_pose", 54, 99),
        ("right_shape", 99, 109), ("left_shape", 109, 119), ("trans", 119, 122))


def forward(model, p):
    rv, lv, j3 = mano.decode_mirrored(model, p)
    return rv, lv, j3, mano.project(j3, p["cam"])


def _interacting(batch):
    return (batch["hand_type_array"].sum(-1) > 1.5).to(torch.float32)


def _common_losses(p, batch, j3, j2, w):
    """Per-sample terms against the initial keypoints and the priors."""
    j2p = L.joints_2d(batch["init_joints_2d"][..., :2], j2, batch["init_joints_2d"][..., 2:3])
    j3p = L.joints_3d(batch["init_joints_3d"][..., :3], j3, batch["init_joints_3d"][..., 3:4])
    tp = L.trans_l2(batch["init_hand_trans_j"][..., :3], p["trans"], batch["init_hand_trans_j"][..., 3:4])
    sr = L.shape_reg(torch.cat([p["right_shape"], p["left_shape"]], 1))
    fr = L.finger_reg(j3)
    per = (w["joints_2d_loss"] * j2p + w["joints_3d_loss"] * j3p + w["trans_loss_weight"] * tp
           + w["shape_reg_loss_weight"] * sr + w["finger_reg_loss_weight"] * fr)
    return per, j2p, j3p


def in_loop_loss(model, p, batch, w, payload, stride: int, batch_size: int):
    """-> (the loss whose gradient Adam takes, filter dict of per-sample
    vectors)."""
    rv, lv, j3, j2 = forward(model, p)
    per, j2p, j3p = _common_losses(p, batch, j3, j2, w)
    tri_r, tri_l, scale = payload
    d = torch.cat([C.depth_single(rv[:, ::stride], tri_r), C.depth_single(lv[:, ::stride], tri_l)], 1) / scale
    coll = (d * d).sum(-1) * _interacting(batch) * stride
    per = per + w["collision_loss_weight"] * coll
    aux = {"joints_3d_loss_p": j3p * w["joints_3d_loss"], "joints_2d_loss_p": j2p * w["joints_2d_loss"], "collision_loss": coll}
    return per.sum() / batch_size, aux


@torch.no_grad()
def frozen_payload(model, p, stride: int, face_stride: int):
    rv, lv, _, _ = forward(model, p)
    fr, fl = model["faces"][::face_stride], model["faces"].flip(-1)[::face_stride]
    qr, ql = rv[:, ::stride], lv[:, ::stride]
    return (C.gather_tris(lv, fl, C.nearest_faces(qr, lv, fl)), C.gather_tris(rv, fr, C.nearest_faces(ql, rv, fr)),
            C.aabb_scale(rv, lv))


def run_stage(model, params, batch, stage: Dict, knobs: Dict, batch_size: int):
    w = stage["weights"]
    keys = list(stage["update"])
    pct = torch.tensor([(float(x) + 0.1) / 100.0 for _n, x in stage["filter"]], device=params["trans"].device)
    fnames = [n for n, _ in stage["filter"]]
    sub = {k: params[k].detach().clone() for k in keys}
    frozen = {k: v.detach() for k, v in params.items() if k not in keys}
    m = {k: torch.zeros_like(v) for k, v in sub.items()}
    v = {k: torch.zeros_like(x) for k, x in sub.items()}
    best = dict(sub)
    best_sel = None
    bars = None
    t = 0
    b1, b2 = torch.tensor(B1, dtype=torch.float32), torch.tensor(B2, dtype=torch.float32)
    stride, fstride = knobs["loop_collision_subsample"], knobs["loop_collision_face_subsample"]

    def step(payload, snapshot_j):
        nonlocal sub, best, best_sel, bars, t
        leaves = {k: x.detach().requires_grad_(True) for k, x in sub.items()}
        loss, aux = in_loop_loss(model, {**frozen, **leaves}, batch, w, payload, stride, batch_size)
        grads = dict(zip(keys, torch.autograd.grad(loss, [leaves[k] for k in keys])))
        with torch.no_grad():
            if snapshot_j is not None:
                cur = torch.stack([aux[n].detach() for n in fnames])
                sel = aux[stage["select"]].detach()
                if snapshot_j == 0:
                    bars = cur * (1.0 + pct[:, None])
                    better = torch.ones_like(sel, dtype=torch.bool)
                else:
                    better = (cur <= bars).all(0) & (sel < best_sel)
                best_sel = sel if snapshot_j == 0 else torch.where(better, sel, best_sel)
                best = {k: torch.where(better[:, None], sub[k], best[k]) for k in keys}
            t += 1
            c1, c2 = float(1.0 - b1 ** float(t)), float(1.0 - b2 ** float(t))
            for k in keys:
                g = grads[k]
                m[k] = B1 * m[k] + (1 - B1) * g
                v[k] = B2 * v[k] + (1 - B2) * g ** 2
                sub[k] = sub[k] - lr * (m[k] / c1) / (torch.sqrt(v[k] / c2) + ADAM_EPS)

    lr = stage["lr"]
    freq, kre = knobs["save_mid_freq"], knobs["reselect_every_blocks"]
    steps = stage["epoch"] + 1
    nblocks, tail = divmod(steps, freq)
    blocks = [(i * freq, freq) for i in range(nblocks)] + ([(nblocks * freq, tail)] if tail else [])
    payload = None
    for bi, (j0, length) in enumerate(blocks):
        if bi % kre == 0:  # a superblock of kre blocks, and the rest with the tail, share one payload
            payload = frozen_payload(model, {**frozen, **sub}, stride, fstride)
        for j in range(j0, j0 + length):
            step(payload, j0 if j == j0 else None)
    return {**frozen, **{k: x.detach() for k, x in best.items()}}


def optimize(model, params, batch, stages: List[Dict], knobs: Dict, batch_size: int):
    p = {k: params[k].detach() for k in GROUPS}
    for stage in stages:
        p = run_stage(model, p, batch, stage, knobs, batch_size)
    return p


@torch.no_grad()
def final_pass(model, p, batch, w, block: int = 128) -> Dict[str, torch.Tensor]:
    """Final outputs at the default weights (``w``), the exact depths in
    blocks of ``block`` samples. Also returns each vertex's least squared
    distance to the other mesh ("best_d2", (B, 2V)) and whether its sign is
    ambiguous ("ambiguous", ``collision.exact_depth``)."""
    rv, lv, j3, j2 = forward(model, p)
    B = rv.shape[0]
    faces_r, faces_l = model["faces"], model["faces"].flip(-1)
    depth, best, amb = [], [], []
    for s in range(0, B, block):
        r, l = rv[s:s + block], lv[s:s + block]
        n = r.shape[0]
        tri_l = l[:, faces_l].reshape(n, -1, 9)
        tri_r = r[:, faces_r].reshape(n, -1, 9)
        d, b, a = C.exact_depth(torch.cat([r, l]), torch.cat([tri_l, tri_r]))
        inside = torch.cat([C.ray_parity(r, l, faces_l), C.ray_parity(l, r, faces_r)], 1)
        depth.append(torch.cat([d[:n], d[n:]], 1) * inside.to(d.dtype))
        best.append(torch.cat([b[:n], b[n:]], 1))
        amb.append(torch.cat([a[:n], a[n:]], 1))
    depth = torch.cat(depth)
    dn = depth / C.aabb_scale(rv, lv)
    coll = (dn * dn).sum(-1) * _interacting(batch)
    per, _, _ = _common_losses(p, batch, j3, j2, w)
    per = per + w["collision_loss_weight"] * coll
    return {
        "right_verts": rv, "left_verts": lv, "joints_3d": j3, "joints_2d": j2,
        "collision_loss": coll, "depths": depth, "best_d2": torch.cat(best), "ambiguous": torch.cat(amb),
        "total_loss": per.mean(),
        "joints_2d_loss": L.joints_2d(batch["joints_2d"][..., :2], j2, batch["joints_2d"][..., 2:3]).mean(),
        "joints_3d_loss": L.joints_3d(batch["joints_3d"][..., :3], j3, batch["joints_3d"][..., 3:4]).mean() * 1000.0,
        "hand_trans_loss": L.trans_l2(batch["hand_trans"][..., :3], p["trans"], batch["hand_trans"][..., 3:4]).mean() * 10.0,
    }


def join_flat(p: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.cat([p[k] for k, _a, _b in FLAT], 1)
