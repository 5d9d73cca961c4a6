"""The benchmarked workload (port of the pipeline in the root ``bench.py``):
ResNet-50 encoder inference on a batch of 224x224 images, then the full
``opt_default`` refinement (4 stages x 301 Adam steps, collision in the
loop, snapshot filter/select every ``save_mid_freq=10`` steps) of a batch of
synthetic hands, ending in the exact collision metric.

As in ``bench.py`` the refinement starts from the synthetic predictions
(``make_opt_inputs``), not from the encoder's output; the encoder runs so
that inference is part of the measured work. Weights are random from a seed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from ihmr_tpu_torch.data.synthetic import make_opt_inputs
from ihmr_tpu_torch.device import DeviceLike, resolve_device, set_fp32_matmul_precision
from ihmr_tpu_torch.mano.loader import synthetic_mano_model
from ihmr_tpu_torch.mano.model import ManoModel
from ihmr_tpu_torch.models.encoder import InterHandEncoder, build_mean_params, init_encoder_weights
from ihmr_tpu_torch.refine.opt_engine import OptBatch, OptConfig, ParamDict, optimize_batch
from ihmr_tpu_torch.refine.schedule import Stage, opt_default


@dataclass
class BenchInputs:
    encoder: InterHandEncoder
    mean_params: torch.Tensor  # (122,)
    images: torch.Tensor  # (B, H, W, 3) NHWC
    mano: ManoModel
    params: ParamDict
    opt_batch: OptBatch


def make_bench_inputs(
    batch: int = 128,
    seed: int = 0,
    arch: str = "resnet50",
    image_size: int = 224,
    device: DeviceLike = None,
) -> BenchInputs:
    """Seeded encoder, images and synthetic OPT inputs on ``device`` (CUDA
    unless "cpu" is asked for). Sets fp32 matmuls and convolutions (no TF32)."""
    dev = resolve_device(device)
    set_fp32_matmul_precision()
    gen = torch.Generator().manual_seed(seed)
    encoder = InterHandEncoder(arch)
    init_encoder_weights(encoder, gen)
    images = torch.rand((batch, image_size, image_size, 3), generator=gen)
    mano = synthetic_mano_model(device=dev)
    params, opt_batch = make_opt_inputs(mano, batch=batch, seed=seed)
    return BenchInputs(
        encoder=encoder.to(dev).eval(),
        mean_params=build_mean_params(np.zeros(48, np.float32), np.zeros(10, np.float32), dev),
        images=images.to(dev),
        mano=mano,
        params=params,
        opt_batch=opt_batch,
    )


def run_pipeline(
    inputs: BenchInputs,
    strategy: Tuple[Stage, ...] = opt_default,
    config: OptConfig = OptConfig(save_mid_freq=10),
) -> Tuple[ParamDict, Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """Encoder inference + OPT refinement -> (refined params, results,
    encoder params (B, 122), hand_type (B, 2)), what ``bench.py``'s jitted
    pipeline returns."""
    with torch.no_grad():
        pred_params, hand_type = inputs.encoder(inputs.images, inputs.mean_params)
    out_params, results = optimize_batch(inputs.mano, inputs.params, inputs.opt_batch, strategy, config)
    return out_params, results, pred_params, hand_type
