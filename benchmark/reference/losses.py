"""Plain per-sample losses of IHMR for the benchmark's reference.

Each returns a per-sample vector (B,); a batch loss is the sum of these over
the batch divided by the batch size, so the reference can follow a sample of
a batch and give each sample the gradient it gets in the whole batch.
|x| takes the derivative +1 at 0 and min(0, x) splits it in half at 0, the
conventions of the JAX package the port follows.
"""

from __future__ import annotations

import torch

from .mano import rodrigues

FINGER_CHAINS = ((1, 2, 3, 17), (4, 5, 6, 18), (7, 8, 9, 20), (10, 11, 12, 19), (13, 14, 15, 16))
FINGER_IDX = [j for c in FINGER_CHAINS for j in c] + [j + 21 for c in FINGER_CHAINS for j in c]


def sabs(x):
    return torch.where(x >= 0, x, -x)


def joints_2d(gt, pred, w):
    """Weighted L1, mean over joints and coordinates: gt, pred (B, J, 2), w (B, J, 1)."""
    return (sabs(gt - pred) * w).reshape(gt.shape[0], -1).mean(1)


def _root_aligned(j, w):
    w0 = w[:, 0, 0]
    zero = torch.zeros((), dtype=j.dtype, device=j.device)
    root = torch.where((w0 > 0.5)[:, None, None], j[:, 0:1], torch.where((w0 < 1e-7)[:, None, None], j[:, 21:22], zero))
    return j - root


def joints_3d(gt, pred, w):
    """Root-aligned weighted L2: gt, pred (B, 42, 3), w (B, 42, 1)."""
    sq = (_root_aligned(gt, w) - _root_aligned(pred, w)) ** 2 * w
    return sq.reshape(gt.shape[0], -1).mean(1)


def trans_l2(gt, pred, w):
    B = gt.shape[0]
    return ((gt.reshape(B, -1) - pred.reshape(B, -1)) ** 2 * w.reshape(B, -1)).mean(1)


def shape_reg(shape20):
    d = shape20[:, :10] - shape20[:, 10:]
    return (d * d).mean(1)


def finger_reg(joints):
    """sum over the 10 fingers of |f2 . (f0 x f1)| - min(0, (f0 x f1) . (f1 x f2))."""
    B = joints.shape[0]
    ch = joints[:, FINGER_IDX].reshape(B, 10, 4, 3)
    bones = ch[:, :, :3] - ch[:, :, 1:]
    f0, f1, f2 = bones[:, :, 0], bones[:, :, 1], bones[:, :, 2]
    c01 = torch.linalg.cross(f0, f1)
    c12 = torch.linalg.cross(f1, f2)
    c1 = (f2 * c01).sum(-1)
    c2 = (c01 * c12).sum(-1)
    return (sabs(c1) - torch.minimum(torch.zeros_like(c2), c2)).sum(1)


def hand_type_bce(gt, pred, valid):
    p = torch.clamp(pred, 1e-7, 1.0 - 1e-7)
    bce = -(gt * torch.log(p) + (1.0 - gt) * torch.log(1.0 - p))
    return (bce * valid).mean(1)


def pose_l2(gt48, pred48, w, use_root: bool = False):
    """L2 between Rodrigues matrices of the 15 finger joints (16 with the root)."""
    B = gt48.shape[0]
    g, p = rodrigues(gt48.reshape(B, 16, 3)), rodrigues(pred48.reshape(B, 16, 3))
    if not use_root:
        g, p = g[:, 1:], p[:, 1:]
    d = (g - p).reshape(B, -1)
    return (d * d * w).mean(1)


def shape_l1(gt, pred, w):
    return (sabs(gt - pred) * w).mean(1)
