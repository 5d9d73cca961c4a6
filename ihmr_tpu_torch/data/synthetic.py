"""Synthetic two-hand OPT inputs (port of the ``standard`` variant of
ihmr_tpu/data/synthetic.py).

Ground-truth parameters are drawn with ``np.random.RandomState(seed)`` in the
same order and the same float32 arithmetic as the JAX package, decoded
through the MANO layer into joints, and noisy copies stand in for the
baseline network's predictions — so both packages build the same inputs from
one seed (up to the decode's rounding). The init joints play the reference's
separate keypoint model: gt joints plus a small independent jitter (they
must differ from decode(init params), or the self-consistency losses start
at zero and no snapshot is ever accepted).

``make_mlp_inputs`` builds the IHMR-MLP batch from the same draws plus a
seeded stand-in for the cached 1024-d image feature; ``make_baseline_batch``
builds a baseline training batch (the ground truth of ``generate`` plus
seeded Gaussian images, as ``scripts/train_bench.py`` does); ``BatchList``
replays pre-built batches as the loader of the MLP and baseline loops;
``opt_raw_batch`` and ``baseline_raw_batch`` turn batches into the raw
dataset dicts that ``optimize_loop`` and ``test_baseline_loop`` read.

Not ported yet: the interlocked, grazing and single-hand variants.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from ihmr_tpu_torch.core.projection import orthographic_project
from ihmr_tpu_torch.mano.layer import two_hand_decode_mirrored
from ihmr_tpu_torch.mano.model import ManoModel
from ihmr_tpu_torch.refine.mlp_engine import MLPBatch
from ihmr_tpu_torch.refine.opt_engine import OptBatch, ParamDict, params_from_init


@torch.no_grad()
def _decode(model: ManoModel, pose, shape, trans, cam):
    rv, lv, j3 = two_hand_decode_mirrored(
        model, pose[:, 0:3], pose[:, 48:51], pose[:, 3:48], pose[:, 51:96], shape[:, :10], shape[:, 10:], trans
    )
    return rv, lv, j3, orthographic_project(j3, cam)


def generate(model: ManoModel, batch: int, seed: int, noise: float) -> Dict[str, torch.Tensor]:
    """GT params + noisy init predictions, decoded on ``model``'s device."""
    dev = model.device
    f32 = np.float32
    rng = np.random.RandomState(seed)
    gt_pose = (rng.randn(batch, 96) * 0.2).astype(f32)
    gt_shape = (rng.randn(batch, 20) * 0.5).astype(f32)
    cam = np.tile(np.array([[5.0, 0.0, 0.0]], f32), (batch, 1))
    cam[:, 1:] += rng.randn(batch, 2).astype(f32) * f32(0.02)
    gt_trans = (rng.randn(batch, 3) * 0.02).astype(f32)

    def t(x):
        return torch.as_tensor(x, device=dev)

    _, _, gt_j3, gt_j2 = _decode(model, t(gt_pose), t(gt_shape), t(gt_trans), t(cam))

    init_pose = gt_pose + rng.randn(batch, 96).astype(f32) * f32(noise)
    init_shape = gt_shape + rng.randn(batch, 20).astype(f32) * f32(noise)
    init_trans = gt_trans + rng.randn(batch, 3).astype(f32) * f32(noise) * f32(0.2)
    kp_noise = f32(noise * 0.02)
    init_j3 = gt_j3 + t(rng.randn(*gt_j3.shape).astype(f32) * kp_noise)
    init_j2 = gt_j2 + t(rng.randn(*gt_j2.shape).astype(f32) * kp_noise)
    return dict(
        gt_pose=t(gt_pose),
        gt_shape=t(gt_shape),
        gt_cam=t(cam),
        gt_trans=t(gt_trans),
        gt_j3=gt_j3,
        gt_j2=gt_j2,
        init_pose=t(init_pose),
        init_shape=t(init_shape),
        init_cam=t(cam),
        init_trans=t(init_trans),
        init_j3=init_j3,
        init_j2=init_j2,
    )


def make_opt_inputs(
    model: ManoModel, batch: int = 8, seed: int = 0, noise: float = 0.15
) -> Tuple[ParamDict, OptBatch]:
    """(initial params, OptBatch) of the ``standard`` benchmark family (broad
    shallow contact, both hands valid), on ``model``'s device."""
    d = generate(model, batch, seed, noise)
    dev = model.device
    ones = torch.ones((batch, 42, 1), device=dev)
    ones1 = torch.ones((batch, 1), device=dev)
    params = params_from_init(d["init_cam"], d["init_pose"], d["init_shape"], d["init_trans"])
    init_trans_j = d["init_j3"][:, 21, :] - d["init_j3"][:, 0, :]
    opt_batch = OptBatch(
        hand_type_array=torch.ones((batch, 2), device=dev),
        hand_type_valid=ones1,
        joints_2d=torch.cat([d["gt_j2"], ones], dim=-1),
        joints_3d=torch.cat([d["gt_j3"], ones], dim=-1),
        gt_pose_params=d["gt_pose"],
        gt_shape_params=d["gt_shape"],
        mano_params_weight=torch.ones((batch, 2), device=dev),
        hand_trans=torch.cat([d["gt_trans"], ones1], dim=-1)[:, None, :],
        init_joints_2d=torch.cat([d["init_j2"], ones], dim=-1),
        init_joints_3d=torch.cat([d["init_j3"], ones], dim=-1),
        init_hand_trans_j=torch.cat([init_trans_j, ones1], dim=-1)[:, None, :],
    )
    return params, opt_batch


def make_mlp_inputs(
    model: ManoModel,
    batch: int = 8,
    seed: int = 0,
    noise: float = 0.15,
    index_offset: int = 0,
) -> MLPBatch:
    """An MLPBatch on ``model``'s device: the ``standard`` draws of
    ``generate`` plus img_feat = |randn(batch, 1024)| from
    RandomState(seed + 101), the cached baseline feature's stand-in, and
    sample indices index_offset .. index_offset + batch - 1."""
    d = generate(model, batch, seed, noise)
    dev = model.device
    rng = np.random.RandomState(seed + 101)
    ones = torch.ones((batch, 42, 1), device=dev)
    ones1 = torch.ones((batch, 1), device=dev)
    return MLPBatch(
        hand_type_array=torch.ones((batch, 2), device=dev),
        hand_type_valid=ones1,
        joints_2d=torch.cat([d["gt_j2"], ones], dim=-1),
        joints_3d=torch.cat([d["gt_j3"], ones], dim=-1),
        gt_pose_params=d["gt_pose"],
        gt_shape_params=d["gt_shape"],
        mano_params_weight=torch.ones((batch, 2), device=dev),
        hand_trans=torch.cat([d["gt_trans"], ones1], dim=-1)[:, None, :],
        img_feat=torch.as_tensor(np.abs(rng.randn(batch, 1024)).astype(np.float32), device=dev),
        init_joints_2d=torch.cat([d["init_j2"], ones], dim=-1),
        init_joints_3d=torch.cat([d["init_j3"], ones], dim=-1),
        init_cam=d["init_cam"],
        init_pose_params=d["init_pose"],
        init_shape_params=d["init_shape"],
        init_hand_trans=d["init_trans"],
        index=torch.arange(index_offset, index_offset + batch, device=dev),
    )


def make_baseline_batch(
    model: ManoModel,
    batch: int = 64,
    image_size: int = 224,
    seed: int = 0,
    noise: float = 0.1,
    image_scale: float = 0.5,
):
    """A BaselineBatch on ``model``'s device: the ground truth of
    ``generate(seed, noise)``, every hand valid and interacting, and images
    RandomState(seed).randn(batch, image_size, image_size, 3) * image_scale."""
    from ihmr_tpu_torch.train.baseline import BaselineBatch

    d = generate(model, batch, seed, noise)
    dev = model.device
    ones = torch.ones((batch, 42, 1), device=dev)
    ones1 = torch.ones((batch, 1), device=dev)
    img = np.random.RandomState(seed).randn(batch, image_size, image_size, 3).astype(np.float32)
    return BaselineBatch(
        img=torch.as_tensor(img * np.float32(image_scale), device=dev),
        hand_type_array=torch.ones((batch, 2), device=dev),
        hand_type_valid=ones1,
        joints_2d=torch.cat([d["gt_j2"], ones], dim=-1),
        joints_3d=torch.cat([d["gt_j3"], ones], dim=-1),
        gt_pose_params=d["gt_pose"],
        gt_shape_params=d["gt_shape"],
        mano_params_weight=torch.ones((batch, 2), device=dev),
        hand_trans=torch.cat([d["gt_trans"], ones1], dim=-1)[:, None, :],
        do_flip=torch.zeros((batch,), dtype=torch.int32, device=dev),
    )


class BatchList(list):
    """Pre-built batches, replayed in order every epoch: the loader protocol
    of the MLP and baseline loops (``len``, iteration, ``set_epoch``)."""

    def set_epoch(self, epoch: int) -> None:
        pass


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def opt_raw_batch(params: ParamDict, batch: OptBatch, index_offset: int = 0) -> Dict[str, np.ndarray]:
    """``make_opt_inputs``' (params, OptBatch) as a raw OPT-dataset batch:
    numpy arrays under the keys ``train.loops._to_opt_batch`` reads, with
    sample indices index_offset .. index_offset + B - 1."""
    n = batch.hand_type_array.shape[0]
    pose = torch.cat([params["right_orient"], params["right_pose"], params["left_orient"], params["left_pose"]], -1)
    raw = dict(
        init_cam=params["cam"],
        init_pose_params=pose,
        init_shape_params=torch.cat([params["right_shape"], params["left_shape"]], -1),
        init_hand_trans=params["trans"],
        mano_pose=batch.gt_pose_params,
        mano_betas=batch.gt_shape_params,
        **{k: getattr(batch, k) for k in (
            "hand_type_array", "hand_type_valid", "joints_2d", "joints_3d", "mano_params_weight", "hand_trans",
            "init_joints_2d", "init_joints_3d", "init_hand_trans_j",
        )},
    )
    out = {k: _host(v) for k, v in raw.items()}
    out["index"] = np.arange(index_offset, index_offset + n)
    return out


def baseline_raw_batch(batch, index_offset: int = 0) -> Dict[str, np.ndarray]:
    """A BaselineBatch as a raw baseline-dataset batch: numpy arrays under
    the keys ``train.loops._to_baseline_batch`` reads, with sample indices
    index_offset .. index_offset + B - 1."""
    names = dict(gt_pose_params="mano_pose", gt_shape_params="mano_betas")
    out = {names.get(f.name, f.name): _host(getattr(batch, f.name)) for f in dataclasses.fields(batch)}
    out["index"] = np.arange(index_offset, index_offset + batch.img.shape[0])
    return out
