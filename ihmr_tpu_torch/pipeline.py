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

Baseline training (the configuration of ``scripts/train_bench.py``):
ResNet-50 at 224x224, B=64, ``TrainConfig()`` (lr 1e-4, cosine decay,
collision loss off) with ``total_epoch=1``, fp32 without TF32, the
synthetic batch ``make_baseline_batch(seed=0, noise=0.1)`` (images
RandomState(0).randn * 0.5), train-mode BatchNorm by ``bn_impl`` ("pallas":
the kernel K3 in each of the 53 BatchNorms); ``train_baseline_loop`` over
one epoch of ``steps`` batches, then one ``eval_step`` (exact collision
metric, the kernel K1).
"""

from __future__ import annotations

import dataclasses
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ihmr_tpu_torch.data.synthetic import BatchList, make_baseline_batch, make_mlp_inputs, make_opt_inputs
from ihmr_tpu_torch.device import DeviceLike, resolve_device, set_fp32_matmul_precision
from ihmr_tpu_torch.mano.loader import mirror_mano_model, synthetic_mano_model
from ihmr_tpu_torch.mano.model import ManoModel
from ihmr_tpu_torch.models.encoder import InterHandEncoder, SubNetwork, build_mean_params, init_encoder_weights
from ihmr_tpu_torch.refine.mlp_engine import MLPCaches, flat_params, seed_from_backbone
from ihmr_tpu_torch.refine.opt_engine import OptBatch, OptConfig, ParamDict, optimize_batch
from ihmr_tpu_torch.refine.schedule import Stage, mlp_default, opt_default
from ihmr_tpu_torch.train.baseline import (
    BaselineBatch,
    BaselineState,
    TrainConfig,
    create_state,
    eval_step,
    set_learning_rate,
    train_step,
)
from ihmr_tpu_torch.train.loops import train_baseline_loop
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


@dataclass
class TrainBenchInputs:
    state: BaselineState
    batch: BaselineBatch
    mano_right: ManoModel
    mano_left: ManoModel  # the exact mirror of the right model
    config: TrainConfig


def make_train_bench_inputs(
    batch: int = 64,
    image_size: int = 224,
    arch: str = "resnet50",
    bn_impl: str = "pallas",
    seed: int = 0,
    device: DeviceLike = None,
) -> TrainBenchInputs:
    """Seeded encoder (random weights, ``init_encoder_weights``), its fresh
    training state and the synthetic batch on ``device`` (CUDA unless "cpu"
    is asked for). Sets fp32 matmuls and convolutions (no TF32)."""
    dev = resolve_device(device)
    set_fp32_matmul_precision()
    encoder = InterHandEncoder(arch, bn_impl=bn_impl)
    init_encoder_weights(encoder, torch.Generator().manual_seed(seed))
    mano_right = synthetic_mano_model(device=dev)
    config = TrainConfig(total_epoch=1)
    mean_params = build_mean_params(np.zeros(48, np.float32), np.zeros(10, np.float32), dev)
    return TrainBenchInputs(
        state=create_state(encoder.to(dev), mean_params, config),
        batch=make_baseline_batch(mano_right, batch, image_size, seed=seed),
        mano_right=mano_right,
        mano_left=mirror_mano_model(mano_right),
        config=config,
    )


@dataclass
class TrainRun:
    step_seconds: float  # host clock over the steps, each ending in a host sync
    total_loss: List[float]  # per step
    eval_metrics: Dict[str, torch.Tensor]  # empty without the eval step
    eval_outputs: Dict[str, Optional[torch.Tensor]]


def run_train_pipeline(
    inputs: TrainBenchInputs, steps: int, checkpoints_dir: Optional[str] = None, evaluate: bool = True
) -> TrainRun:
    """One first epoch of ``steps`` train steps on the batch through
    ``train_baseline_loop`` (at ``config.lr``; the loop writes the ``latest``
    checkpoint to ``checkpoints_dir``, a temporary directory when None),
    then, with ``evaluate``, one ``eval_step``."""
    set_learning_rate(inputs.state, inputs.config.lr)
    stats: List[Dict] = []
    with tempfile.TemporaryDirectory() as tmp:
        train_baseline_loop(
            inputs.state, BatchList([inputs.batch] * steps), inputs.mano_right, inputs.mano_left, inputs.config,
            checkpoints_dir or tmp, print_freq=1 << 30, epoch_stats=stats,
        )
    metrics, outputs = {}, {}
    if evaluate:
        metrics, outputs = eval_step(inputs.state, inputs.batch, inputs.mano_right, inputs.mano_left, inputs.config)
    _sync(inputs.state.mean_params.device)
    return TrainRun(stats[0]["step_seconds"], stats[0]["total_loss"], metrics, outputs)


# A small baseline training that holds the card against the CPU
# (chip_smoke.py and tests/test_torch_port_cuda.py): ResNet-18 at 64x64,
# B=4, bn_impl="pallas" (K3 on the card, its plain version on the CPU), two
# train steps. Bounds are the CPU parity test's
# (tests/test_torch_port_train.py): step-1 metrics 1e-5 relative, running
# statistics 1e-5 (relative above 1); params after one Adam step within
# 1e-6 on PARAMS_SHARE of the entries and within 2 lr, plus the rounding of
# p +- lr, on all (a first Adam step moves each entry by about lr times the
# sign of its gradient, and a gradient entry near 0 may take either sign).
# The step-2 total loss is held to 1e-4 relative, tighter than the parity
# test's 5e-4: card and CPU run the same formulas and, on this input, round
# the few ReLU inputs that lie within fp32 rounding of 0 to the same side.
PARAMS_SHARE = 0.999
SHORT_TRAIN_TOL = dict(metrics=1e-5, stats=1e-5, loss2=1e-4, params=1e-6, params_all=2e-4 * (1 + 1e-3))


def run_short_train(device: DeviceLike = None) -> Dict[str, object]:
    """The small training on ``device`` -> CPU snapshots: "metrics" (step 1),
    "stats" (running statistics after step 1), "params" (after step 1) and
    "loss2" (step 2's total loss)."""
    inputs = make_train_bench_inputs(batch=4, image_size=64, arch="resnet18", device=device)
    state = inputs.state
    _, metrics = train_step(state, inputs.batch, inputs.mano_right, inputs.mano_left, inputs.config)
    snap = {k: v.detach().cpu().clone() for k, v in state.encoder.state_dict().items()}
    names = dict(state.encoder.named_parameters())
    _, metrics2 = train_step(state, inputs.batch, inputs.mano_right, inputs.mano_left, inputs.config)
    return dict(
        metrics={k: float(v) for k, v in metrics.items()},
        stats={k: v for k, v in snap.items() if k.endswith(("running_mean", "running_var"))},
        params={k: v for k, v in snap.items() if k in names},
        loss2=float(metrics2["total_loss"]),
    )


def short_train_gaps(a: Dict[str, object], b: Dict[str, object]) -> Dict[str, float]:
    """Two ``run_short_train`` results -> the gap of each kind named in
    SHORT_TRAIN_TOL: "metrics" and "loss2" relative, "stats" relative above
    1 and absolute below, "params" the largest gap among the PARAMS_SHARE
    closest entries, "params_all" the largest of all."""
    rel = lambda x, y: abs(x - y) / max(abs(y), 1e-12)
    metrics = max(rel(a["metrics"][k], v) for k, v in b["metrics"].items() if v != 0.0)
    stats = max(float(((a["stats"][k] - v).abs() / v.abs().clamp_min(1.0)).max()) for k, v in b["stats"].items())
    diffs = np.concatenate([(a["params"][k] - v).abs().reshape(-1).numpy() for k, v in b["params"].items()])
    return dict(
        metrics=metrics, stats=stats, loss2=rel(a["loss2"], b["loss2"]),
        params=float(np.quantile(diffs, PARAMS_SHARE)), params_all=float(diffs.max()),
    )
