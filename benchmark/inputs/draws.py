"""Seeded inputs of the benchmark, the same tensors for the program and for
the reference.

  * ``substream(seed, *keys)``: a 64-bit seed for one purpose and index,
    from any whole-number ``--seed`` (numpy's SeedSequence);
  * ``encoder_weights``: ResNet-50 and IHMR's head, made on the device in
    one draw (flax's defaults, as the port's ``init_encoder_weights``:
    lecun-normal kernels N(0, 1 / fan_in), zero biases, unit BatchNorm
    scale, zero running means, unit running variances);
  * ``hands``: a frozen copy of the port's ``data/synthetic.py::generate``
    (the ``standard`` family): ground-truth pose N(0, 0.2^2), betas
    N(0, 0.5^2), camera (5, 0, 0) + N(0, 0.02^2) on the translation, trans
    N(0, 0.02^2); initial parameters the truth plus noise (0.15; trans
    0.2 x that), initial keypoints the decoded truth plus N(0, (0.02 x
    0.15)^2) jitter; both hands valid and interacting;
  * ``images``: (B, H, W, 3) on the device, uniform [0, 1) (the OPT cell's,
    as the root bench.py) or N(0, 0.5^2) (the training cells', as the
    port's ``make_baseline_batch``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark.reference import mano
from benchmark.reference.resnet import param_shapes


def substream(seed: int, *keys: int) -> int:
    return int(np.random.SeedSequence([int(seed) % (1 << 64), *keys]).generate_state(1, np.uint64)[0])


def device_generator(device, seed: int, *keys: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(substream(seed, *keys) >> 1)


def encoder_weights(device, seed: int) -> Dict[str, torch.Tensor]:
    spec = param_shapes()
    kernels = [(k, s) for k, (s, kind) in spec.items() if kind == "weight"]
    total = sum(int(np.prod(s)) for _k, s in kernels)
    flat = torch.empty(total, device=device).normal_(generator=device_generator(device, seed, 1))
    out, at = {}, 0
    for k, s in kernels:
        n = int(np.prod(s))
        out[k] = (flat[at:at + n] * (n // s[0]) ** -0.5).reshape(s)
        at += n
    fill = {"bias": 0.0, "bn_bias": 0.0, "bn_mean": 0.0, "bn_weight": 1.0, "bn_var": 1.0}
    for k, (s, kind) in spec.items():
        if kind != "weight":
            out[k] = torch.full(s, fill[kind], device=device)
    return out


def images(device, seed: int, index: int, batch: int, size: int, kind: str) -> torch.Tensor:
    g = device_generator(device, seed, 2, index)
    if kind == "uniform":
        return torch.rand((batch, size, size, 3), generator=g, device=device)
    return torch.randn((batch, size, size, 3), generator=g, device=device) * 0.5


@torch.no_grad()
def hands(model: Dict[str, torch.Tensor], seed: int, index: int, batch: int, noise: float = 0.15) -> Dict[str, torch.Tensor]:
    """Ground truth, initial parameters and keypoints of ``batch`` two-hand
    samples on the hand's device."""
    f32 = np.float32
    rng = np.random.RandomState(substream(seed, 3, index) & 0xFFFFFFFF)
    pose = (rng.randn(batch, 96) * 0.2).astype(f32)
    shape = (rng.randn(batch, 20) * 0.5).astype(f32)
    cam = np.tile(np.array([[5.0, 0.0, 0.0]], f32), (batch, 1))
    cam[:, 1:] += rng.randn(batch, 2).astype(f32) * f32(0.02)
    trans = (rng.randn(batch, 3) * 0.02).astype(f32)
    init_pose = pose + rng.randn(*pose.shape).astype(f32) * f32(noise)
    init_shape = shape + rng.randn(*shape.shape).astype(f32) * f32(noise)
    init_trans = trans + rng.randn(*trans.shape).astype(f32) * f32(noise) * f32(0.2)
    kp = f32(noise * 0.02)
    j3_noise = rng.randn(batch, 42, 3).astype(f32) * kp
    j2_noise = rng.randn(batch, 42, 2).astype(f32) * kp
    dev = model["v_template"].device

    def t(x):
        return torch.as_tensor(x, device=dev)

    gt = {"right_orient": t(pose[:, 0:3]), "right_pose": t(pose[:, 3:48]), "left_orient": t(pose[:, 48:51]),
          "left_pose": t(pose[:, 51:96]), "right_shape": t(shape[:, :10]), "left_shape": t(shape[:, 10:]), "trans": t(trans)}
    _rv, _lv, gt_j3 = mano.decode_mirrored(model, gt)
    gt_j2 = mano.project(gt_j3, t(cam))
    ones, ones1 = torch.ones((batch, 42, 1), device=dev), torch.ones((batch, 1), device=dev)
    init_j3 = gt_j3 + t(j3_noise)
    return {
        "gt_pose": t(pose), "gt_shape": t(shape), "gt_trans": t(trans), "cam": t(cam),
        "init_pose": t(init_pose), "init_shape": t(init_shape), "init_trans": t(init_trans),
        "hand_type_array": torch.ones((batch, 2), device=dev), "hand_type_valid": ones1,
        "joints_2d": torch.cat([gt_j2, ones], -1), "joints_3d": torch.cat([gt_j3, ones], -1),
        "mano_params_weight": torch.ones((batch, 2), device=dev),
        "hand_trans": torch.cat([t(trans), ones1], -1)[:, None, :],
        "init_joints_2d": torch.cat([gt_j2 + t(j2_noise), ones], -1),
        "init_joints_3d": torch.cat([init_j3, ones], -1),
        "init_hand_trans_j": torch.cat([init_j3[:, 21] - init_j3[:, 0], ones1], -1)[:, None, :],
    }


def init_params(h: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The initial parameter groups of ``hands``' draws."""
    pose, shape = h["init_pose"], h["init_shape"]
    return {"cam": h["cam"], "right_orient": pose[:, 0:3], "right_pose": pose[:, 3:48], "left_orient": pose[:, 48:51],
            "left_pose": pose[:, 51:96], "right_shape": shape[:, :10], "left_shape": shape[:, 10:], "trans": h["init_trans"]}


def take(d: Dict[str, torch.Tensor], rows: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {k: v[rows] for k, v in d.items()}
