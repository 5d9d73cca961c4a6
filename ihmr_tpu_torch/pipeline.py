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
batches = 240 train steps) and ``test_mlp_loop``, the trained cascade over
every batch ending in an ``Evaluator``.

Baseline training (the configuration of ``scripts/train_bench.py``):
ResNet-50 at 224x224, B=64, ``TrainConfig()`` (lr 1e-4, cosine decay,
collision loss off) with ``total_epoch=1``, fp32 without TF32, the
synthetic batch ``make_baseline_batch(seed=0, noise=0.1)`` (images
RandomState(0).randn * 0.5), train-mode BatchNorm by ``bn_impl`` ("pallas":
the kernel K3 in each of the 53 BatchNorms); ``train_baseline_loop`` over
one epoch of ``steps`` batches, then one ``eval_step`` (exact collision
metric, the kernel K1).

Serving (``scripts/serve_bench.py``'s protocol, ``serve_load`` and the
``SERVE_*`` constants): 8-image octet-stream requests in sequence, a few
JSON and ``.npy`` requests, then 8 client threads of 3 single-image
requests each, against a running ``serve.InferenceServer``.

Tracking (``scripts/tracker_study.py``'s streams, ``make_tracker_frames``
and ``run_tracker``): S streams of the full synthetic hand moving by a
smoothed random walk through ``TwoHandTracker`` (``streaming_strategy``,
``save_mid_freq=5``), each frame's noisy detection blended into the warm
start.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import tempfile
import threading
import time
import urllib.request
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ihmr_tpu_torch.data.synthetic import (
    BatchList,
    decode_gt,
    make_baseline_batch,
    make_mlp_inputs,
    make_opt_inputs,
    opt_inputs,
    opt_raw_batch,
)
from ihmr_tpu_torch.device import DeviceLike, resolve_device, set_fp32_matmul_precision
from ihmr_tpu_torch.eval import Evaluator
from ihmr_tpu_torch.mano.loader import mirror_mano_model, synthetic_mano_model
from ihmr_tpu_torch.mano.model import ManoModel
from ihmr_tpu_torch.models.encoder import InterHandEncoder, SubNetwork, build_mean_params, init_encoder_weights
from ihmr_tpu_torch.refine.mlp_engine import MLPCaches, flat_params, seed_from_backbone
from ihmr_tpu_torch.refine.opt_engine import OptBatch, OptConfig, ParamDict, optimize_batch
from ihmr_tpu_torch.refine.schedule import Stage, mlp_default, opt_default
from ihmr_tpu_torch.refine.tracker import TrackerState, TwoHandTracker, streaming_strategy
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
    evaluator: Evaluator  # test_mlp_loop's, over every sample
    metrics: Dict[str, float]  # the evaluator's metric_dict
    seconds: Dict[str, float]  # host-clock time of "warm", "train" and "cascade" (Evaluator.update included)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_mlp_pipeline(
    inputs: MLPBenchInputs,
    strategy: Tuple[Stage, ...] = mlp_default,
    generator: Optional[torch.Generator] = None,
    print_freq: int = 10,
) -> MLPRun:
    """Warm pass, stage-wise training (with its selection passes) and
    ``test_mlp_loop``, the cascade over every batch ending in an Evaluator
    (whose metrics the run keeps); each phase timed on the host clock up to
    a device synchronisation."""
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
    evaluator = test_mlp_loop(inputs.mano, strategy, subnets, inputs.batches, config)
    _sync(dev)
    seconds["cascade"] = time.perf_counter() - t0
    return MLPRun(
        subnets=subnets, caches=caches, stage_stats=stage_stats, evaluator=evaluator,
        metrics=dict(evaluator.metric_dict()), seconds=seconds,
    )


# A small OPT evaluation that holds the card against the CPU (chip_smoke.py
# and tests/test_torch_port_cuda.py): optimize_loop over 2 raw batches of
# B=2 (make_opt_inputs seeds 0 and 1), every opt_default stage cut to epoch
# 20, save_mid_freq=10. The card-vs-CPU check of a short refinement holds
# params within 2e-4 and collision losses within 1e-3 relative; each metric
# is a mean of joint errors or depths that move with the params by less
# than that (a joint moves by at most ~0.1 x a param gap, against errors of
# ~1e-2), and collision_auc moves by 1/(2 x 1556 x 49) ~ 7e-6 for each
# depth that crosses one of its 50 thresholds. So every metric of
# metric_dict must agree within 1e-3 relative.
SHORT_EVAL_RTOL = 1e-3


def run_short_opt_eval(device: DeviceLike = None) -> Dict[str, float]:
    """The small OPT evaluation on ``device`` -> its ``metric_dict``."""
    from ihmr_tpu_torch.train.loops import optimize_loop

    dev = resolve_device(device)
    mano = synthetic_mano_model(device=dev)
    raws = [opt_raw_batch(*make_opt_inputs(mano, batch=2, seed=s), index_offset=2 * s) for s in range(2)]
    strategy = tuple(dataclasses.replace(s, epoch=20) for s in opt_default)
    evaluator = optimize_loop(mano, raws, None, strategy, OptConfig(save_mid_freq=10), is_main=False)
    return dict(evaluator.metric_dict())


def short_eval_gaps(a: Dict[str, float], b: Dict[str, float]) -> Dict[str, float]:
    """Two ``run_short_opt_eval`` results -> each metric's relative gap."""
    return {k: abs(a[k] - v) / max(abs(v), 1e-12) for k, v in b.items()}


# Small runs of the in-loop collision paths that hold the card against the
# CPU (chip_smoke.py and tests/test_torch_port_cuda.py), each on
# make_opt_inputs(variant="interlocked", batch=4, seed=2) with
# save_mid_freq=2: JAX's per-stage programs with SGD (opt_default's trans,
# orient and shape stages at epoch 7), the two-pass escalation at threshold
# 1e-6 (the orient stage at epoch 4: pass 1 leaves one sample in collision,
# which pass 2 lowers, so the merge takes it) and the grid in the loop (the
# orient stage at epoch 7, res 8, every 4th face, K=1). The same fp32
# arithmetic runs on both devices (K1 equals its plain version); only
# reduction orders differ, which the CPU tests against the JAX package
# bound at <= 2.4e-7 over these horizons. So: params within 2e-4 (the
# slice's bound against JAX), each sample's final collision within 1e-3
# relative, escalation's masks equal.
SHORT_COLLISION_RUNS = {
    "sgd_programs": (dict(save_mid_freq=2, optimizer="sgd", stage_hoist_decode=False), (0, 1, 3), 7),
    "escalation": (dict(save_mid_freq=2, escalate_collision=1e-6), (1,), 4),
    "grid": (dict(save_mid_freq=2, loop_collision_fast=False, collision_backend="grid", grid_res=8,
                  grid_face_subsample=4, grid_num_candidates=1), (1,), 7),
}
SHORT_COLLISION_TOL = dict(params=2e-4, collision_rtol=1e-3)


def run_short_collision_paths(device: DeviceLike = None) -> Dict[str, Dict[str, np.ndarray]]:
    """``SHORT_COLLISION_RUNS`` on ``device`` -> per run its refined params,
    final collision and (escalation) escalated mask, on the host."""
    dev = resolve_device(device)
    mano = synthetic_mano_model(device=dev)
    params, batch = make_opt_inputs(mano, batch=4, seed=2, variant="interlocked")
    out = {}
    for name, (config, stages, epoch) in SHORT_COLLISION_RUNS.items():
        strategy = tuple(dataclasses.replace(opt_default[i], epoch=epoch) for i in stages)
        refined, results = optimize_batch(mano, params, batch, strategy, OptConfig(**config))
        out[name] = {f"param_{k}": v.cpu().numpy() for k, v in refined.items()}
        out[name]["collision"] = results["collision_loss"].cpu().numpy()
        if "escalated" in results:
            out[name]["escalated"] = results["escalated"].cpu().numpy()
    return out


def short_collision_gaps(a: Dict[str, Dict[str, np.ndarray]], b: Dict[str, Dict[str, np.ndarray]]):
    """Two ``run_short_collision_paths`` results -> ({run: (largest param gap,
    largest relative collision gap)}, whether every run is within
    ``SHORT_COLLISION_TOL`` with equal escalation masks)."""
    gaps, ok = {}, True
    for name, ra in a.items():
        rb = b[name]
        param = max(float(np.abs(ra[k] - rb[k]).max()) for k in ra if k.startswith("param_"))
        coll = float((np.abs(ra["collision"] - rb["collision"]) / np.maximum(np.abs(rb["collision"]), 1e-6)).max())
        gaps[name] = (param, coll)
        ok &= param <= SHORT_COLLISION_TOL["params"] and coll <= SHORT_COLLISION_TOL["collision_rtol"]
        ok &= np.array_equal(ra.get("escalated"), rb.get("escalated"))
    return gaps, bool(ok)


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
    dtype: torch.dtype = torch.float32,
) -> TrainBenchInputs:
    """Seeded encoder (random weights, ``init_encoder_weights``; computing in
    ``dtype``, torch.bfloat16 being ``--bf16``), its fresh training state and
    the synthetic batch on ``device`` (CUDA unless "cpu" is asked for). Sets
    fp32 matmuls and convolutions (no TF32)."""
    dev = resolve_device(device)
    set_fp32_matmul_precision()
    encoder = InterHandEncoder(arch, bn_impl=bn_impl, dtype=dtype)
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


# The predict function against a reference of the same dtype on the same
# images (card against CPU, port against JAX): each output within the
# encoder's parity bound, |a - b| <= atol + rtol |b| (tests/test_torch_port_models.py).
PREDICT_TOL = dict(rtol=1e-4, atol=1e-5)
# bf16 outputs cannot be held to a plain bound (bf16 rounds every layer's
# output, and a 1-ulp flip anywhere moves everything after it). The band:
# for each output, max |bf16 under test - bf16 reference| may be at most
# BF16_BAND times max |bf16 reference - fp32 reference| on the same images
# and weights. It holds the card against the CPU and train-mode forwards,
# which round at the same places but sum in other orders (measured ratios
# 0.6-0.8); an encoder computing in fp32 reads about 1 there too, so
# backbone_input_dtypes holds the dtype beside it. Eval-mode outputs against
# JAX's program compiled to round where flax's casts say
# (xla_allow_excess_precision off) are held to BF16_STRICT_BAND: measured
# at most 0.00043 (tests/test_torch_port_bf16.py, test_torch_port_serve.py),
# against about 1 for an fp32 encoder.
BF16_BAND = 2.0
BF16_STRICT_BAND = 0.05


def allclose_ratio(a: np.ndarray, b: np.ndarray, rtol: float, atol: float) -> float:
    """max |a - b| / (atol + rtol |b|): at most 1 where ``np.allclose`` holds."""
    return float(np.max(np.abs(np.asarray(a, np.float64) - b) / (atol + rtol * np.abs(np.asarray(b, np.float64)))))


def max_gaps(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray]) -> Dict[str, float]:
    """max |a[k] - b[k]| of each output."""
    return {k: float(np.max(np.abs(np.asarray(a[k], np.float64) - b[k]))) for k in b}


def bf16_band_ratios(test: Dict[str, np.ndarray], ref16: Dict[str, np.ndarray], ref32: Dict[str, np.ndarray]):
    """Each output's max |test - ref16| over max |ref16 - ref32|: within the
    band where at most BF16_BAND."""
    gap, width = max_gaps(test, ref16), max_gaps(ref16, ref32)
    return {k: gap[k] / max(width[k], 1e-30) for k in ref32}


@contextlib.contextmanager
def backbone_input_dtypes():
    """While open, the dtype of the input of every backbone convolution,
    BatchNorm and ``fc1`` call, in any thread (the broker's included), is
    appended to the list it yields: all bf16 where the bf16 encoder runs."""
    from ihmr_tpu_torch.models.resnet import BatchNorm, Conv2d, Linear

    seen = []

    def hook(module, args):
        if isinstance(module, (BatchNorm, Conv2d, Linear)):
            seen.append(args[0].dtype)

    handle = torch.nn.modules.module.register_module_forward_pre_hook(hook)
    try:
        yield seen
    finally:
        handle.remove()


# A small predict function that holds the card against the CPU (chip_smoke.py
# and tests/test_torch_port_cuda.py): ResNet-18 at 64x64, seeded weights,
# B=4 seeded images, fp32 and bf16.
def run_short_predict(device: DeviceLike = None) -> Dict[str, Dict]:
    """-> {"fp32": outputs, "bf16": outputs} of ``build_encoder_predict_fn``
    on ``device``, and "dtypes": {"fp32": ..., "bf16": ...}, the names of
    the dtypes the backbone's layers took in each (``backbone_input_dtypes``)."""
    from ihmr_tpu_torch.serve import build_encoder_predict_fn

    dev = resolve_device(device)
    set_fp32_matmul_precision()
    images = np.random.RandomState(0).rand(4, 64, 64, 3).astype(np.float32)
    mano = synthetic_mano_model(device=dev)
    mean = build_mean_params(np.zeros(48, np.float32), np.zeros(10, np.float32), dev)
    out = {"dtypes": {}}
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        encoder = InterHandEncoder("resnet18", dtype=dtype)
        init_encoder_weights(encoder, torch.Generator().manual_seed(0))
        with backbone_input_dtypes() as seen:
            out[name] = build_encoder_predict_fn(encoder, mean, mano, 64, dev)(images)
        out["dtypes"][name] = sorted({str(d).replace("torch.", "") for d in seen})
    return out


def post(port: int, body: bytes, ctype: str, timeout: float = 120.0) -> Tuple[float, str, bytes]:
    """POST ``body`` to /predict on localhost -> (seconds, response content
    type, response body); raises (``urllib.error.HTTPError``) unless 200."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict", data=body, headers={"Content-Type": ctype})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        payload = resp.read()
        ctype_out = resp.headers.get("Content-Type")
    return time.perf_counter() - t0, ctype_out, payload


def get_json(port: int, path: str) -> Dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as resp:
        return json.loads(resp.read())


def _npz(payload: bytes) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(payload)) as z:
        return {k: z[k] for k in z.files}


@dataclass
class ServeLoad:
    """Each kind of request: (seconds, images sent, outputs stacked per key)."""

    octet: List[Tuple[float, np.ndarray, Dict[str, np.ndarray]]]
    npy: List[Tuple[float, np.ndarray, Dict[str, np.ndarray]]]
    json: List[Tuple[float, np.ndarray, Dict[str, np.ndarray]]]
    concurrent: List[Tuple[float, np.ndarray, Dict[str, np.ndarray]]]
    concurrent_seconds: float  # wall time of the concurrent part
    stats_before: Dict  # /stats just before the concurrent part
    stats_after: Dict  # and just after it


# scripts/serve_bench.py's load (serve_load): SERVE_SEQUENTIAL octet-stream
# requests of SERVE_IMAGES images of SERVE_SIZE x SERVE_SIZE, SERVE_NPY .npy
# requests of them, SERVE_JSON JSON requests of the first SERVE_JSON_IMAGES
# (JSON's float lists are slow: ~0.1 s an image), then SERVE_THREADS client
# threads of SERVE_PER_THREAD single-image requests each
SERVE_SIZE = 224
SERVE_IMAGES = 8
SERVE_SEQUENTIAL, SERVE_NPY, SERVE_JSON, SERVE_JSON_IMAGES = 30, 5, 3, 3
SERVE_THREADS, SERVE_PER_THREAD = 8, 3


def serve_load(port: int, images: np.ndarray) -> ServeLoad:
    """``scripts/serve_bench.py``'s protocol (the SERVE_* counts) against the
    server on ``port``, ``images`` (N, H, W, 3) being a request's images;
    thread t's j-th single takes image (t * SERVE_PER_THREAD + j) mod N.
    Every request must answer 200."""
    octet = []
    for _ in range(SERVE_SEQUENTIAL):
        dt, ctype, body = post(port, images.tobytes(), "application/octet-stream")
        if ctype != "application/x-npz":
            raise AssertionError(f"octet-stream answered {ctype}")
        octet.append((dt, images, _npz(body)))
    npy = []
    buf = io.BytesIO()
    np.save(buf, images, allow_pickle=False)
    for _ in range(SERVE_NPY):
        dt, _, body = post(port, buf.getvalue(), "application/x-npy")
        npy.append((dt, images, _npz(body)))
    js = []
    sub = images[:SERVE_JSON_IMAGES]
    text = json.dumps({"images": sub.tolist()}).encode()
    for _ in range(SERVE_JSON):
        dt, _, body = post(port, text, "application/json")
        results = json.loads(body)["results"]
        js.append((dt, sub, {k: np.asarray([r[k] for r in results], np.float32) for k in results[0]}))

    stats_before = get_json(port, "/stats")
    concurrent, errors, lock = [], [], threading.Lock()

    def client(t):
        try:
            for j in range(SERVE_PER_THREAD):
                img = images[(t * SERVE_PER_THREAD + j) % len(images)][None]
                dt, _, body = post(port, img.tobytes(), "application/octet-stream")
                with lock:
                    concurrent.append((dt, img, _npz(body)))
        except Exception as e:  # surfaced below
            errors.append(e)

    workers = [threading.Thread(target=client, args=(t,)) for t in range(SERVE_THREADS)]
    t0 = time.perf_counter()
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=300)
    seconds = time.perf_counter() - t0
    if errors or any(w.is_alive() for w in workers) or len(concurrent) != SERVE_THREADS * SERVE_PER_THREAD:
        raise AssertionError(f"concurrent requests failed: {errors[:3]}")
    return ServeLoad(octet, npy, js, concurrent, seconds, stats_before, get_json(port, "/stats"))


def percentile_ms(seconds: List[float], q: float) -> float:
    """``scripts/serve_bench.py``'s percentile, in ms."""
    lat = sorted(seconds)
    return 1e3 * lat[min(len(lat) - 1, max(0, int(q * len(lat)) - 1))]


# scripts/tracker_study.py's motion: the middle of its three per-frame
# pose-delta scales (0.005, 0.02, 0.05) and its detection noise
TRACK_SPEED = 0.02
TRACK_NOISE = 0.15


def make_tracker_frames(mano: ManoModel, streams: int = 64, frames: int = 9, seed: int = 0):
    """Temporally coherent frames of ``streams`` video streams, drawn as
    ``scripts/tracker_study.py`` draws them (its ``batch_and_init``) from
    RandomState(1000 seed + 17): shapes and camera fixed per stream; pose
    and translation follow a smoothed (OU) random walk at TRACK_SPEED; each
    frame's detection is its ground truth plus TRACK_NOISE (translation
    0.2 of it), drawn afresh every frame, and its init joints the ground
    truth's plus 0.02 TRACK_NOISE. -> [(detection params, OptBatch)], one
    per frame, on ``mano``'s device."""
    f32, S = np.float32, streams
    rng = np.random.RandomState(1000 * seed + 17)
    pose = (rng.randn(S, 96) * 0.2).astype(f32)
    shape = (rng.randn(S, 20) * 0.5).astype(f32)
    cam = np.tile(np.array([[5.0, 0.0, 0.0]], f32), (S, 1))
    trans = (rng.randn(S, 3) * 0.02).astype(f32)
    vel, velt = np.zeros((S, 96), f32), np.zeros((S, 3), f32)
    t = lambda x: torch.as_tensor(x, device=mano.device)
    out = []
    for _ in range(frames):
        vel = 0.9 * vel + rng.randn(S, 96).astype(f32)
        velt = 0.9 * velt + rng.randn(S, 3).astype(f32)
        pose = pose + TRACK_SPEED * vel * 0.1
        trans = trans + TRACK_SPEED * velt * 0.01
        _, _, j3, j2 = decode_gt(mano, t(pose), t(shape), t(trans), t(cam))
        det_pose = pose + rng.randn(S, 96).astype(f32) * TRACK_NOISE
        det_shape = shape + rng.randn(S, 20).astype(f32) * TRACK_NOISE
        det_trans = trans + rng.randn(S, 3).astype(f32) * TRACK_NOISE * 0.2
        kp = TRACK_NOISE * 0.02
        init_j3 = j3 + t(rng.randn(*j3.shape).astype(f32) * kp)
        init_j2 = j2 + t(rng.randn(*j2.shape).astype(f32) * kp)
        out.append(opt_inputs(dict(
            gt_pose=t(pose), gt_shape=t(shape), gt_trans=t(trans), gt_j3=j3, gt_j2=j2, init_cam=t(cam),
            init_pose=t(det_pose), init_shape=t(det_shape), init_trans=t(det_trans), init_j3=init_j3, init_j2=init_j2,
        )))
    return out


@dataclass
class TrackerRun:
    state: TrackerState
    frame_seconds: List[float]  # host clock per frame, each ending in a host read
    collision: List[float]  # each frame's final mean collision loss


def run_tracker(tracker: TwoHandTracker, frames, state: Optional[TrackerState] = None) -> TrackerRun:
    """Step ``tracker`` over ``frames`` ((detection params, OptBatch) each),
    blending each frame's detection; without ``state`` it starts from the
    first frame's detection."""
    seconds, collision = [], []
    for params, batch in frames:
        if state is None:
            state = tracker.init(params)
        t0 = time.perf_counter()
        state, res = tracker.step(state, batch, params)
        collision.append(float(res["collision_loss"].mean()))  # a host read: the frame is done
        seconds.append(time.perf_counter() - t0)
    return TrackerRun(state, seconds, collision)


def run_short_tracker(device: DeviceLike = None) -> List[Dict[str, torch.Tensor]]:
    """The small tracker that holds the card against the CPU (chip_smoke.py
    and tests/test_torch_port_cuda.py): B=2 streams of ``make_tracker_frames``
    at seed 1 (one stream's hands interpenetrate in every frame, so the
    collision terms act), two frames of ``streaming_strategy(6)`` and a
    third at the tracker's default schedule (4 x 31 steps: 6 snapshot
    blocks, 3 superblocks and a 1-step tail a stage) -> each frame's refined
    params and EMA on the CPU (keys "ema_<group>" for the EMA)."""
    dev = resolve_device(device)
    mano = synthetic_mano_model(device=dev)
    short = TwoHandTracker(mano, streaming_strategy(6))
    state, out = None, []
    for tracker, (params, batch) in zip((short, short, TwoHandTracker(mano)), make_tracker_frames(mano, 2, 3, seed=1)):
        state = state or tracker.init(params)
        state, _ = tracker.step(state, batch, params)
        out.append({**{k: v.cpu() for k, v in state.params.items()},
                    **{f"ema_{k}": v.cpu() for k, v in state.ema_params.items()}})
    return out


def short_tracker_gap(a: List[Dict[str, torch.Tensor]], b: List[Dict[str, torch.Tensor]]) -> float:
    """The largest |a - b| over two ``run_short_tracker`` results."""
    return max(float((x[k] - y[k]).abs().max()) for x, y in zip(a, b) for k in y)
