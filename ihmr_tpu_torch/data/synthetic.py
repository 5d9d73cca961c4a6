"""Synthetic two-hand OPT inputs (port of ihmr_tpu/data/synthetic.py).

Ground-truth parameters are drawn with ``np.random.RandomState(seed)`` in the
same order and the same float32 arithmetic as the JAX package, decoded
through the MANO layer into joints, and noisy copies stand in for the
baseline network's predictions — so both packages build the same inputs from
one seed (up to the decode's rounding). The init joints play the reference's
separate keypoint model: gt joints plus a small independent jitter (they
must differ from decode(init params), or the self-consistency losses start
at zero and no snapshot is ever accepted).

``make_opt_inputs(variant=...)`` selects the benchmark family: ``standard``
(broad shallow contact), ``interlocked`` (``generate_interlocked``: facing,
curled hands with sparse deep finger interlocks), ``grazing``
(``generate_grazing``: the same poses a hair apart) and ``single`` (the
standard draws with one valid hand, so the collision loss is masked to 0).

``make_mlp_inputs`` builds the IHMR-MLP batch from the same draws plus a
seeded stand-in for the cached 1024-d image feature; ``make_baseline_batch``
builds a baseline training batch (the ground truth of ``generate`` plus
seeded Gaussian images, as ``scripts/train_bench.py`` does); ``BatchList``
replays pre-built batches as the loader of the MLP and baseline loops;
``opt_raw_batch`` and ``baseline_raw_batch`` turn batches into the raw
dataset dicts that ``optimize_loop`` and ``test_baseline_loop`` read;
``write_corpus`` writes the same draws as files the datasets and the CLI
read (PNG images, an annotation pkl and a prediction pkl);
``use_jpeg_images`` points such a corpus at JPEG files of the same shapes;
``write_blur_kernels`` writes two motion-blur point-spread functions
(``motion_psf``) as the ``.mat`` files ``--blur_kernel_dir`` reads.
"""

from __future__ import annotations

import dataclasses
import os
import os.path as osp
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ihmr_tpu_torch.core.projection import orthographic_project
from ihmr_tpu_torch.mano.layer import two_hand_decode_mirrored
from ihmr_tpu_torch.mano.model import ManoModel
from ihmr_tpu_torch.refine.mlp_engine import MLPBatch
from ihmr_tpu_torch.refine.opt_engine import OptBatch, ParamDict, params_from_init


@torch.no_grad()
def decode_gt(model: ManoModel, pose, shape, trans, cam):
    """(B, 96) pose, (B, 20) shape, (B, 3) trans, (B, 3) cam -> (right verts,
    left verts, joints 3D (B, 42, 3), joints 2D (B, 42, 2)), no autograd."""
    rv, lv, j3 = two_hand_decode_mirrored(
        model, pose[:, 0:3], pose[:, 48:51], pose[:, 3:48], pose[:, 51:96], shape[:, :10], shape[:, 10:], trans
    )
    return rv, lv, j3, orthographic_project(j3, cam)


def generate(model: ManoModel, batch: int, seed: int, noise: float) -> Dict[str, torch.Tensor]:
    """GT params + noisy init predictions, decoded on ``model``'s device."""
    f32 = np.float32
    rng = np.random.RandomState(seed)
    gt_pose = (rng.randn(batch, 96) * 0.2).astype(f32)
    gt_shape = (rng.randn(batch, 20) * 0.5).astype(f32)
    cam = np.tile(np.array([[5.0, 0.0, 0.0]], f32), (batch, 1))
    cam[:, 1:] += rng.randn(batch, 2).astype(f32) * f32(0.02)
    gt_trans = (rng.randn(batch, 3) * 0.02).astype(f32)
    return _noisy_init(model, rng, gt_pose, gt_shape, gt_trans, cam, noise)


def _noisy_init(model: ManoModel, rng: np.random.RandomState, pose, shape, trans, cam, noise: float):
    """GT draws (numpy fp32) -> ``generate``'s dict: decode the GT, then the
    noisy init params and keypoints from ``rng``, in the JAX package's order."""
    dev = model.device
    f32 = np.float32

    def t(x):
        return torch.as_tensor(x, device=dev)

    _, _, gt_j3, gt_j2 = decode_gt(model, t(pose), t(shape), t(trans), t(cam))
    init_pose = pose + rng.randn(*pose.shape).astype(f32) * f32(noise)
    init_shape = shape + rng.randn(*shape.shape).astype(f32) * f32(noise)
    init_trans = trans + rng.randn(*trans.shape).astype(f32) * f32(noise) * f32(0.2)
    kp_noise = f32(noise * 0.02)
    init_j3 = gt_j3 + t(rng.randn(*gt_j3.shape).astype(f32) * kp_noise)
    init_j2 = gt_j2 + t(rng.randn(*gt_j2.shape).astype(f32) * kp_noise)
    return dict(
        gt_pose=t(pose), gt_shape=t(shape), gt_cam=t(cam), gt_trans=t(trans), gt_j3=gt_j3, gt_j2=gt_j2,
        init_pose=t(init_pose), init_shape=t(init_shape), init_cam=t(cam), init_trans=t(init_trans),
        init_j3=init_j3, init_j2=init_j2,
    )


def _facing_curled(rng: np.random.RandomState, batch: int):
    """The interlocked and grazing families' GT pose, shape and camera draws:
    every finger joint of both hands curled by one per-sample amount plus
    jitter, the left hand turned ~pi about y to face the right one."""
    f32 = np.float32
    pose = np.zeros((batch, 96), f32)
    curl = rng.uniform(0.5, 1.1, size=(batch, 1)).astype(f32)
    for f in range(5):
        for k in range(3):
            base = 3 + (f * 3 + k) * 3
            pose[:, base + 2] = curl[:, 0] + rng.randn(batch).astype(f32) * 0.1  # right finger curl
            pose[:, 48 + base + 2] = curl[:, 0] + rng.randn(batch).astype(f32) * 0.1
    pose[:, 49] = np.pi + rng.randn(batch).astype(f32) * 0.15
    pose += rng.randn(batch, 96).astype(f32) * 0.05
    shape = (rng.randn(batch, 20) * 0.3).astype(f32)
    cam = np.tile(np.array([[5.0, 0.0, 0.0]], f32), (batch, 1))
    cam[:, 1:] += rng.randn(batch, 2).astype(f32) * 0.02
    return pose, shape, cam


def generate_interlocked(model: ManoModel, batch: int, seed: int, noise: float) -> Dict[str, torch.Tensor]:
    """Hard cases: the hands face each other with curled fingers, the wrists
    0.08-0.15 apart in x so fingertips drive into the other palm. Few
    vertices penetrate (~0.5-2%) but deep (up to ~0.14): sparse deep
    contacts, the adversarial case for in-loop subsampling and the family
    escalation is measured on."""
    rng = np.random.RandomState(seed)
    pose, shape, cam = _facing_curled(rng, batch)
    trans = np.zeros((batch, 3), np.float32)
    trans[:, 0] = rng.uniform(0.08, 0.15, size=batch)  # wrist offset -> overlap
    trans[:, 1:] = rng.randn(batch, 2).astype(np.float32) * 0.015
    return _noisy_init(model, rng, pose, shape, trans, cam, noise)


def generate_grazing(model: ManoModel, batch: int, seed: int, noise: float) -> Dict[str, torch.Tensor]:
    """Grazing contact: the interlocked family's poses with the left hand
    pushed +x until its AABB just clears the right hand's, minus a
    per-sample band of -2 to +6 mm in mesh units (decoded once at trans=0;
    trans enters the left hand additively). GT penetration is ~0, so any
    in-loop collision pressure can only push the hands apart."""
    rng = np.random.RandomState(seed)
    pose, shape, cam = _facing_curled(rng, batch)
    dev = model.device
    rv0, lv0, _, _ = decode_gt(
        model, torch.as_tensor(pose, device=dev), torch.as_tensor(shape, device=dev),
        torch.zeros((batch, 3), device=dev), torch.as_tensor(cam, device=dev),
    )
    gap = rng.uniform(-0.002, 0.006, size=batch).astype(np.float32)
    tx = rv0[:, :, 0].amax(dim=1).cpu().numpy() - lv0[:, :, 0].amin(dim=1).cpu().numpy() + gap
    trans = np.zeros((batch, 3), np.float32)
    trans[:, 0] = tx
    trans[:, 1:] = rng.randn(batch, 2).astype(np.float32) * 0.005
    return _noisy_init(model, rng, pose, shape, trans, cam, noise)


VARIANTS = ("standard", "interlocked", "grazing", "single")


def make_opt_inputs(
    model: ManoModel,
    batch: int = 8,
    seed: int = 0,
    noise: float = 0.15,
    interlocked: bool = False,
    variant: Optional[str] = None,
) -> Tuple[ParamDict, OptBatch]:
    """(initial params, OptBatch) of one benchmark family, on ``model``'s
    device: ``variant`` one of ``VARIANTS`` (``interlocked=True`` is the
    older spelling of ``variant="interlocked"``). ``single`` takes the
    standard draws with hand types [1, 0]."""
    if variant is None:
        variant = "interlocked" if interlocked else "standard"
    gen = {"standard": generate, "single": generate, "interlocked": generate_interlocked, "grazing": generate_grazing}
    params, opt_batch = opt_inputs(gen[variant](model, batch, seed, noise))
    if variant == "single":
        hand_type = torch.zeros_like(opt_batch.hand_type_array)
        hand_type[:, 0] = 1.0
        opt_batch = dataclasses.replace(opt_batch, hand_type_array=hand_type)
    return params, opt_batch


def opt_inputs(d: Dict[str, torch.Tensor]) -> Tuple[ParamDict, OptBatch]:
    """``generate``'s draws (or any dict of its keys) -> (initial params,
    OptBatch), both hands valid."""
    batch, dev = d["gt_pose"].shape[0], d["gt_pose"].device
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


HAND_TYPES = ("interacting", "right", "left")


CORPUS_SHAPES = ((256, 192), (192, 256))  # height x width, in turn: both letterbox branches


def write_corpus(root: str, n: int, seed: int = 0) -> None:
    """A dataset on disk from ``generate(synthetic hand, n, seed, noise=0.15)``:
    ``root/hand26m/image/img_{i:05d}.png`` (``CORPUS_SHAPES`` in turn, a
    smooth seeded pattern with noise, written by the port's PNG writer), ``root/anno.pkl`` (hand types interacting / right / left in
    turn; a single hand's other MANO param is None and its joints have
    validity 0; 2D joints in the image's pixels, so the datasets' letterbox
    and normalization map them back onto the projected ground truth) and
    ``root/pred.pkl`` (the noisy initial predictions, keypoints from the
    same draws, img_feat = |randn(1024)|)."""
    from ihmr_tpu_torch.data.image_io import imwrite_png
    from ihmr_tpu_torch.mano.loader import synthetic_mano_model
    from ihmr_tpu_torch.utils import io_utils

    d = {k: v.numpy() for k, v in generate(synthetic_mano_model(device="cpu"), n, seed, 0.15).items()}
    rng = np.random.RandomState(seed + 7)
    img_dir = io_utils.build_dir(osp.join(root, "hand26m", "image"))
    annos, preds = [], {}
    for i in range(n):
        height, width = CORPUS_SHAPES[i % len(CORPUS_SHAPES)]
        to_pixels = np.float32(max(height, width) / 2.0)  # [-1, 1] of the letterbox -> pixels
        yy, xx = np.mgrid[0:height, 0:width]
        pattern = np.stack([(xx * 3 + i) % 256, (yy * 2 + 5 * i) % 256, ((xx + yy) // 2) % 256], axis=-1)
        img = np.clip(pattern + rng.randint(-8, 9, size=pattern.shape), 0, 255).astype(np.uint8)
        img_path = f"img_{i:05d}.png"
        imwrite_png(osp.join(img_dir, img_path), img)

        hand_type = HAND_TYPES[i % len(HAND_TYPES)]
        valid = np.ones((42, 1), np.float32)
        if hand_type == "right":
            valid[21:] = 0.0
        elif hand_type == "left":
            valid[:21] = 0.0
        j2 = ((d["gt_j2"][i] + 1.0) * to_pixels).astype(np.float32)
        params = {
            hand: dict(pose=d["gt_pose"][i, off * 48: off * 48 + 48], shape=d["gt_shape"][i, off * 10: off * 10 + 10])
            for off, hand in enumerate(("right", "left"))
        }
        annos.append(dict(
            img_path=img_path,
            hand_type=hand_type,
            hand_type_valid=1.0,
            joints_2d=np.concatenate([j2, valid], axis=1),
            joints_3d=np.concatenate([d["gt_j3"][i], valid], axis=1),
            scale=1.0,
            right_hand_param=params["right"] if hand_type != "left" else None,
            left_hand_param=params["left"] if hand_type != "right" else None,
        ))
        preds[img_path] = dict(
            pred_cam_params=d["init_cam"][i],
            pred_shape_params=d["init_shape"][i],
            pred_pose_params=d["init_pose"][i],
            pred_hand_trans=d["init_trans"][i],
            joints_2d=((d["init_j2"][i] + 1.0) * to_pixels).astype(np.float32),
            joints_3d=d["init_j3"][i],
            img_feat=np.abs(rng.randn(1024)).astype(np.float32),
        )
    io_utils.save_pkl(osp.join(root, "anno.pkl"), annos)
    io_utils.save_pkl(osp.join(root, "pred.pkl"), preds)


# the motion-blur point-spread functions of the JPEG runs: (size, angle in degrees)
BLUR_PSFS = ((15, 30.0), (31, 120.0))


def motion_psf(size: int, angle_deg: float) -> np.ndarray:
    """A (size, size) float32 straight-line motion kernel through the centre
    at ``angle_deg``, as long as the kernel is wide, bilinearly splatted and
    normalised to sum 1."""
    k = np.zeros((size, size), np.float64)
    c = (size - 1) / 2.0
    t = np.linspace(-c, c, 8 * size)
    a = np.deg2rad(angle_deg)
    x, y = c + t * np.cos(a), c - t * np.sin(a)
    x0, y0 = np.floor(x).astype(int), np.floor(y).astype(int)
    fx, fy = x - x0, y - y0
    for dy, dx, w in ((0, 0, (1 - fx) * (1 - fy)), (0, 1, fx * (1 - fy)), (1, 0, (1 - fx) * fy), (1, 1, fx * fy)):
        yy, xx = np.clip(y0 + dy, 0, size - 1), np.clip(x0 + dx, 0, size - 1)
        np.add.at(k, (yy, xx), w)
    return (k / k.sum()).astype(np.float32)


def write_blur_kernels(directory: str) -> List[str]:
    """``BLUR_PSFS`` as ``psf_<size>.mat`` files in the reference's schema
    (``PSFs``, a 1 x 1 MATLAB cell holding the kernel); returns their paths."""
    from scipy.io import savemat

    os.makedirs(directory, exist_ok=True)
    paths = []
    for size, angle in BLUR_PSFS:
        cell = np.empty((1, 1), dtype=object)
        cell[0, 0] = motion_psf(size, angle)
        paths.append(osp.join(directory, f"psf_{size}.mat"))
        savemat(paths[-1], {"PSFs": cell})
    return paths


def use_jpeg_images(root: str, jpeg_files: Sequence[str]) -> None:
    """Point a corpus written by ``write_corpus`` at JPEG files: each image
    is replaced by a copy of the first of ``jpeg_files`` with its shape (as
    decoded), ``img_{i:05d}.jpg``, and ``anno.pkl`` and ``pred.pkl`` are
    rewritten to name it."""
    import shutil

    from ihmr_tpu_torch.data.image_io import imread
    from ihmr_tpu_torch.utils import io_utils

    by_shape = {}
    for path in jpeg_files:
        by_shape.setdefault(imread(path).shape[:2], path)
    img_dir = osp.join(root, "hand26m", "image")
    annos = io_utils.load_pkl(osp.join(root, "anno.pkl"))
    preds = io_utils.load_pkl(osp.join(root, "pred.pkl"))
    for i, anno in enumerate(annos):
        png = osp.join(img_dir, anno["img_path"])
        shape = CORPUS_SHAPES[i % len(CORPUS_SHAPES)]
        if shape not in by_shape:
            raise ValueError(f"no JPEG of shape {shape} among {list(jpeg_files)}")
        jpg = anno["img_path"][: -len(".png")] + ".jpg"
        shutil.copyfile(by_shape[shape], osp.join(img_dir, jpg))
        os.remove(png)
        preds[jpg] = preds.pop(anno["img_path"])
        anno["img_path"] = jpg
    io_utils.save_pkl(osp.join(root, "anno.pkl"), annos)
    io_utils.save_pkl(osp.join(root, "pred.pkl"), preds)
