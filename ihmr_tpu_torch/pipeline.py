"""The workloads, end to end.

OPT (port of the pipeline in the root ``bench.py``): ResNet-50 encoder
inference on a batch of 224x224 images, then the full ``opt_default``
refinement (4 stages x 301 Adam steps, collision in the loop, snapshot
filter/select every ``save_mid_freq=10`` steps) of a batch of synthetic
hands, ending in the exact collision metric. As in ``bench.py`` the
refinement starts from the synthetic predictions (``make_opt_inputs``), not
from the encoder's output; the encoder runs so that inference is part of
the measured work. Weights are random from a seed.

MLP (the shapes and seeds of ``scripts/mlp_soak.py``): N=2048 synthetic
samples in 16 batches of 128 (``make_mlp_inputs(seed=100 + i)``), the warm
pass, the full ``mlp_default`` stage training (6 stages, 15 epochs x 16
batches = 240 train steps) and the trained cascade over every batch.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ihmr_tpu_torch.data.synthetic import BatchList, make_mlp_inputs, make_opt_inputs
from ihmr_tpu_torch.device import DeviceLike, resolve_device, set_fp32_matmul_precision
from ihmr_tpu_torch.mano.loader import synthetic_mano_model
from ihmr_tpu_torch.mano.model import ManoModel
from ihmr_tpu_torch.models.encoder import InterHandEncoder, SubNetwork, build_mean_params, init_encoder_weights
from ihmr_tpu_torch.refine.mlp_engine import MLPCaches, flat_params, seed_from_backbone
from ihmr_tpu_torch.refine.opt_engine import OptBatch, OptConfig, ParamDict, optimize_batch
from ihmr_tpu_torch.refine.schedule import Stage, mlp_default, opt_default
from ihmr_tpu_torch.train.mlp import test_mlp_loop, train_mlp_stages, warm_pass


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


@dataclass
class MLPBenchInputs:
    mano: ManoModel
    batches: BatchList  # of MLPBatch
    num_data: int


def make_mlp_bench_inputs(n: int = 2048, batch: int = 128, device: DeviceLike = None) -> MLPBenchInputs:
    """n // batch synthetic MLP batches on ``device`` (CUDA unless "cpu" is
    asked for): batch i is make_mlp_inputs(seed=100 + i), sample indices
    from i * batch."""
    dev = resolve_device(device)
    set_fp32_matmul_precision()
    mano = synthetic_mano_model(device=dev)
    batches = BatchList(
        make_mlp_inputs(mano, batch=batch, seed=100 + i, index_offset=i * batch) for i in range(n // batch)
    )
    return MLPBenchInputs(mano=mano, batches=batches, num_data=len(batches) * batch)


@dataclass
class MLPRun:
    subnets: List[SubNetwork]  # one trained network per stage
    caches: MLPCaches
    stage_stats: List[Dict]
    cascade: List[Dict[str, torch.Tensor]]  # per-batch cascade results
    seconds: Dict[str, float]  # host-clock time of "warm", "train" and "cascade"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_mlp_pipeline(
    inputs: MLPBenchInputs,
    strategy: Tuple[Stage, ...] = mlp_default,
    generator: Optional[torch.Generator] = None,
    print_freq: int = 10,
) -> MLPRun:
    """Warm pass, stage-wise training (with its selection passes) and the
    cascade over every batch; each phase timed on the host clock up to a
    device synchronisation."""
    config = OptConfig()
    dev = inputs.mano.device
    caches = MLPCaches(inputs.num_data, device=dev)
    seconds = {}
    t0 = time.perf_counter()
    warm_pass(inputs.mano, inputs.batches, caches, config)
    _sync(dev)
    seconds["warm"] = time.perf_counter() - t0
    stage_stats: List[Dict] = []
    t0 = time.perf_counter()
    subnets = train_mlp_stages(
        inputs.mano, strategy, inputs.batches, caches, config,
        generator=generator, print_freq=print_freq, stage_stats=stage_stats,
    )
    _sync(dev)
    seconds["train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cascade = test_mlp_loop(inputs.mano, strategy, subnets, inputs.batches, config)
    _sync(dev)
    seconds["cascade"] = time.perf_counter() - t0
    return MLPRun(subnets=subnets, caches=caches, stage_stats=stage_stats, cascade=cascade, seconds=seconds)


# A small MLP run that holds the card against the CPU (chip_smoke.py and
# tests/test_torch_port_cuda.py): mlp_default stages 0, 3 and 5 at one
# epoch, N=4 in two batches of 2, i.e. 6 train steps.
SHORT_MLP_STAGES = (0, 3, 5)
# Largest gaps allowed between two such runs. The same fp32 arithmetic runs
# on both devices (K1 and K2 equal their plain versions); only matmul and
# reduction orders differ. Training moves each weight and residual by about
# 2e-4 (two Adam steps at lr 1e-4). An H100 against the CPU measured
# weights 7.8e-7 apart (where a gradient entry cancels across the batch its
# Adam step amplifies rounding), residuals 2.1e-7, params 0, losses 2.2e-7
# relative. Ten percent of K2's picks shifted by one face moves weights and
# residuals by 3.6e-4 but cached params by only 1.8e-6.
SHORT_MLP_TOL = dict(weights=1e-5, residuals=2e-6, params=1e-6, losses=1e-5)


def run_short_mlp(device: DeviceLike = None) -> Dict[str, list]:
    """The small MLP run on ``device`` -> snapshots on the CPU:
    "params" and "losses", the caches after the warm pass and after each
    selection (4 each); "weights", each trained stage network's state;
    "residuals", each trained network's output on both batches at the
    backbone-seeded params."""
    dev = resolve_device(device)
    config = OptConfig()
    mano = synthetic_mano_model(device=dev)
    loader = BatchList(make_mlp_inputs(mano, batch=2, seed=i, index_offset=2 * i) for i in range(2))
    strategy = tuple(dataclasses.replace(mlp_default[i], epoch=1) for i in SHORT_MLP_STAGES)
    caches = MLPCaches(4, device=dev)
    out: Dict[str, list] = dict(params=[], losses=[])

    def snap(c: MLPCaches) -> None:
        out["params"].append({k: v.cpu().clone() for k, v in c.prev_params.items()})
        out["losses"].append({k: v.cpu().clone() for k, v in c.prev_losses.items()})

    warm_pass(mano, loader, caches, config)
    snap(caches)
    subnets = train_mlp_stages(
        mano, strategy, loader, caches, config, generator=torch.Generator().manual_seed(0), is_main=False, sync_fn=snap
    )
    x = torch.cat([torch.cat([b.img_feat, flat_params(seed_from_backbone(b))], dim=-1) for b in loader])
    with torch.no_grad():
        out["residuals"] = [net(x).cpu() for net in subnets]
    out["weights"] = [{k: v.detach().cpu().clone() for k, v in net.state_dict().items()} for net in subnets]
    return out


def short_mlp_gaps(a: Dict[str, list], b: Dict[str, list]) -> Tuple[Dict[str, float], bool]:
    """Two ``run_short_mlp`` results -> (the largest gap of each kind named
    in SHORT_MLP_TOL, "losses" relative to max(|loss|, 1e-6) and the others
    absolute; whether
    every stage accepted its update for the same samples in both)."""

    def max_gap(xs, ys, rel=False):
        gap = 0.0
        for x, y in zip(xs, ys):
            pairs = zip(x.values(), y.values()) if isinstance(x, dict) else [(x, y)]
            for u, v in pairs:
                d = (u - v).abs() / (v.abs().clamp_min(1e-6) if rel else 1.0)
                gap = max(gap, float(d.max()))
        return gap

    gaps = {k: max_gap(a[k], b[k], rel=k == "losses") for k in SHORT_MLP_TOL}
    strategy = [mlp_default[i] for i in SHORT_MLP_STAGES]
    masks_equal = all(
        torch.equal(*[
            torch.stack([(run["params"][s + 1][k] != run["params"][s][k]).any(-1) for k in stage.update_params]).any(0)
            for run in (a, b)
        ])
        for s, stage in enumerate(strategy)
    )
    return gaps, masks_equal
