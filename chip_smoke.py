"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases (each raises on failure; any failure exits non-zero before the last line):

1. Card and build: the card's name and power limit (nvidia-smi), then every
   kernel of ``ihmr_tpu_torch/csrc`` compiled with nvcc (one process per
   source, started together).
2. Each kernel against its plain PyTorch version on the card, at the shapes
   its main path gives it, with the kernel's device time alone (a CUDA graph
   replay with a cold L2, timing.cold_ms), its time with CUDA events around
   one wrapper call (host latency included), the plain version's (CUDA
   events, median) and the least time the card could take:
   exact_collision (K1): B=128 synthetic hands from make_opt_inputs(seed=0),
   both directions, a random icosphere, and kernel_cases.exact_cases (ties
   across a tile boundary, degenerate triangles, n_tri 1 / 129 / 1538, a
   mesh queried with its own vertices, a block pruned after its first
   tile): max depth error, direction error where both are inside, share of
   equal inside signs;
   nearest_centroid (K2): B=128 hands from make_mlp_inputs(seed=100), both
   directions, an icosphere and kernel_cases.nearest_cases (planted exact
   ties inside a tile and across tiles, an odd centroid count, grid
   duplicates): indices must be 100% equal;
   bn_stats (K3): the ResNet-50 stem input (64, 64, 112, 112), the widest
   (64, 2048, 7, 7), a ragged (3, 5, 7, 11), a bf16 (64, 256, 56, 56), the
   small spatial sizes in bf16 ((64, 2048, 7, 7), (64, 256, 14, 14)), B=1,
   C not a multiple of the channel tile (64, 1025, 14, 14) and a contiguous
   view whose base is not 16-byte aligned (the masked walk): sums against a
   float64 sum (sum x within BN_SUM_TOL of sum |x|, sum x^2 within
   BN_SQ_TOL relative), the same bits on a second launch, one device
   kernel a call (torch.profiler), and the backward against its formula.
3. The OPT path at full width: ResNet-50 encoder at 224x224 and the full
   opt_default (4 x 301 Adam steps, save_mid_freq=10) on B=128 hands with the
   full MANO mesh (778 vertices, 1538 faces), on the default engine (the
   stage-hoisted decode, as in the JAX package). One warm-up run, then a
   timed run with the kernel launch counts zeroed just before it and read
   just after, and its peak device memory. The final pass's depths are
   recomputed with the plain version. Then the two engines against each
   other over 4 x 21 steps: at B=2 the hoisted and the full decode
   (stage_hoist_decode=False) must agree within HOIST_TOL; at B=128 the
   largest gap, the samples above HOIST_TOL and the stage where each
   sample first leaves it are printed; each optimize_batch launches
   exact_collision once with either engine. The shape stage's payload (one
   decode at 21x the batch) is built alone at B=128 for its peak memory.
4. The MLP path at full width: run_mlp_pipeline at N=2048 in 16 batches of
   128 with the full mlp_default (240 train steps, 96 selection batches, the
   cascade over 16 batches). A warm-up of one train step, one selection batch
   and one cascade batch, then one timed run with the launch counts zeroed
   just before it and read just after. The run ends in test_mlp_loop's
   Evaluator (its metric_dict printed); the same cascade is then timed
   without the Evaluator.
5. Baseline training at full width (scripts/train_bench.py's
   configuration): ResNet-50 at 224x224, B=64, TrainConfig(total_epoch=1),
   fp32 without TF32, bn_impl="pallas" (bn_stats, K3, in every train-mode
   BatchNorm). A warm-up of 2 steps (the first captures the train step's
   CUDA graph), then train_baseline_loop over 20 steps under torch.profiler
   with the counts zeroed just before and read just after: 53 K3 device
   kernels a step in the trace (``traced_train``: a replay launches K3 from
   the graph, where its wrapper and counter do not run), 20 graph replays,
   no capture and no run of K3's wrapper; one more step under
   torch.profiler (exactly 53 K3 device kernels: one launch per BatchNorm),
   then one eval_step (one K1
   launch; its depths again through the plain version). The same 20 steps
   with bn_impl="stock", timed. K3's time per step: each BatchNorm input
   shape of one step, kernel against plain version and torch.var_mean, and
   the kernel's share of its bound, per shape and summed. test_baseline_loop on
   the same batch after the 20 steps (one exact_collision launch).
6. Evaluation: optimize_loop over 2 raw batches of B=128
   (make_opt_inputs seeds 0 and 1) with every stage cut to epoch 20 (one
   exact_collision launch per batch); with the MLP's and the baseline's,
   each loop's metric_dict is printed and every metric must be finite.
7. The command line at full width (``python -m ihmr_tpu_torch.cli``, run
   in-process through ``cli.main``) on a corpus of N=256 files written by
   ``data.synthetic.write_corpus`` with the port's PNG writer (256x192 and
   192x256 images in turn, hand types interacting / right / left in turn),
   ResNet-50 at 224x224 and the full synthetic MANO mesh:
   ``IHMR_BN_IMPL=pallas train-baseline`` (B=64, one epoch of 4 steps, random
   flip, rescale and position), ``test-baseline --export_pred`` (B=64),
   ``optimize --export_pseudo_gt`` (B=128, stages cut to epoch 20),
   ``train-mlp --use_opt_params`` (B=128, stages cut to 2 epochs) and
   ``test-mlp`` (B=128). Each command's wall seconds, its split into data
   time (waiting for and converting batches) and the rest, its kernel
   launches from counts zeroed just before it and read just after (asserted
   against what its loop does per batch or step), and its metric_dict
   (finite); train-baseline's images/sec beside phase 5's replayed batch.
   Then ``optimize`` on a 4-sample corpus on the card and on the CPU, the
   metrics within pipeline.SHORT_EVAL_RTOL and the params within
   SMALL_PARAM_TOL; and neither cv2 nor PIL imported.
8. IHMR-Baseline training as ``scripts/train_baseline.sh`` runs it, from
   JPEG files decoded by the port: first the committed fixtures of
   ``tests/data/jpeg/`` against the digests of cv2's results
   (``data.image_cases.check_fixtures``: each JPEG decoded byte for byte;
   warpAffine at the ten angles of random_rotate, BGR <-> HSV and three
   colour jitters byte for byte; filter2D with each PSF within 1 on at most
   1e-4 of the values), and each step's host ms per image (JPEG decode,
   rotation, colour jitter, the HSV conversions, filter2D per PSF, the
   letterbox, the normalization). Then phase 7's corpus (N=256,
   ``write_corpus`` seed 0) with each image a copy of the committed JPEG
   of its shape (``synthetic.use_jpeg_images``), two motion-blur PSFs
   (``synthetic.write_blur_kernels``: 15x15 and 31x31 line kernels, the
   reference's ``.mat`` schema), and ``IHMR_BN_IMPL=pallas train-baseline``
   with every data flag of the launcher (flip, rescale, position, rotation,
   colour jitter, motion blur with ``--blur_kernel_dir``), B=64, one epoch
   of 4 steps: K3's wrapper run 2 x 53 times (the train step's graph warms
   up and is captured at the first step), one capture and a replay a step,
   losses finite, ms/step and images/sec beside phase 7's PNG run and
   phase 5's replayed batch. Then
   ``test-baseline`` on the same files (K1 one a batch, K3 0, metrics
   finite), and neither cv2 nor PIL imported.
9. Serving: ``cli.start_server`` (the serve command up to its blocking
   loop) on the checkpoint phase 7's ``train-baseline`` wrote, ResNet-50 at
   224x224, ``--serve_batch 16``, ``--max_wait_ms 10``, synthetic MANO, on
   an ephemeral port, once in fp32 and once with ``--bf16``; each under
   ``scripts/serve_bench.py``'s protocol (``pipeline.serve_load`` and its
   ``SERVE_*`` counts: 30 sequential 8-image octet-stream requests, 5
   ``.npy`` ones, 3 JSON requests of 3 images, then 8 client threads of 3
   single-image requests): p50 / p95 / max latency per kind, images/sec,
   batch_efficiency, batches against requests under the concurrent load
   (fewer), every response 200, kernel launches 0 from counts zeroed before
   the server starts, every backbone layer's input in the server's dtype
   (``pipeline.backbone_input_dtypes``). Each response against the predict
   function called directly: a whole request (octet-stream, ``.npy``,
   JSON) on the same batch equal bit for bit; a concurrent single, whose
   batch held other threads' images, against its image alone padded: fp32
   within pipeline.PREDICT_TOL, bf16 within the band. The servers' outputs
   on the 8 images against the CPU's (the same checkpoint): fp32 within
   PREDICT_TOL, the bf16 params within the band (pipeline.BF16_BAND; the
   other outputs' band ratios printed), and every bf16 output apart from
   the fp32 server's.
10. Tracking: ``TwoHandTracker`` on S=64 streams of the full mesh
   (``scripts/tracker_study.py``'s S), ``streaming_strategy(30)``,
   ``OptConfig(save_mid_freq=5)``, blend 0.25, smoothing 0.5; the frames
   are ``pipeline.make_tracker_frames``, the study's: hands moving by a
   smoothed random walk at its middle speed, each frame's noisy detection
   blended into the warm start. One warm-up frame, then 8 timed frames:
   tracked hands/sec, ms per frame, peak memory, each frame's final mean
   collision (finite); K1 once per frame, K2 and K3 never.
11. bf16 training: phase 5's replayed batch with the bf16 encoder
   (``--bf16``), bn_impl="pallas", 2 warm-up and 20 timed steps; every
   BatchNorm input bf16 in the warm-up, whose forwards are the graph's
   warm-up and capture (2 x 53: a replay runs no Python hook); in the timed
   steps, as in phase 5, 53 K3 device kernels a step in the trace, 20
   replays, no capture, no wrapper run and no hook; 53 K3 device kernels in
   one more step under torch.profiler; ms/step beside phase 5's fp32; K3
   over one step's 53 shapes in bf16 (cold L2) with its bound, per shape
   and summed.
12. Small inputs held against the CPU: optimize_batch at B=2 with a short
   schedule, pipeline.run_short_opt_eval (optimize_loop at B=2, 4 x 21
   steps), pipeline.run_short_mlp (three stages, one epoch, N=4) and
   pipeline.run_short_train (ResNet-18 at 64x64, B=4, two steps), on the
   card and on the CPU (plain kernel versions) must agree: the metrics
   within pipeline.SHORT_EVAL_RTOL; the MLP's
   trained weights, residuals, cached params and losses within
   pipeline.SHORT_MLP_TOL, accept masks equal; the training's step-1
   metrics, running statistics and params and its step-2 loss within
   pipeline.SHORT_TRAIN_TOL; the predict function (ResNet-18 64x64, B=4) in
   fp32 within pipeline.PREDICT_TOL and in bf16 within the band, every
   backbone layer's input bf16 in the bf16 encoder and each bf16 output
   apart from the fp32 one, with no kernel launched; the tracker (B=2, 2
   frames of streaming_strategy(6) and a third at its default 4 x 31
   steps) within SMALL_PARAM_TOL; and (after phase 13) the in-loop
   collision paths at B=4 (pipeline.run_short_collision_paths: JAX's
   per-stage SGD programs, the two-pass escalation, the grid in the loop)
   within pipeline.SHORT_COLLISION_TOL, escalation masks equal.
13. Every in-loop collision path at full width (run before phase 12's
   small checks): the synthetic MANO hand, B=128, opt_default with each
   stage cut to COLLISION_EPOCH=40 (41 of 301 steps), save_mid_freq=10,
   each run from counts zeroed just before it and read just after, with
   its hands/sec and peak device memory beside the card's name and power
   limit. (a) Escalation at ESCALATE_THRESHOLD=0.5 (warm start 0.5, the
   fast build) on make_opt_inputs(variant="interlocked", seed=0), then on
   the standard family: the flagged count, the bucket, the escalated
   count, pass 1's and the merged mean exact collision; no sample's exact
   collision rises, unflagged samples keep pass 1's bits, K1 launches 2
   when a sample is flagged, else 1. (b) The grid in the loop at JAX's
   default knobs (res 32, K=8, full faces): K1 once. (c) The default
   engine, per-step reselection and tracked positions, in turns (default,
   eager, tracked, tracked, eager, default): K1 once each. (d) K1 in the
   loop (loop_collision_fast=False, stride 1): K1 launches = the 164
   gradient steps + 1; at the run's initial and refined params, K1 at the
   loop's shape (2B=256 queries, every second face: 769) against its plain
   version, and one step's collision gradient with the kernel against the
   same step with the plain version on the card, within 1e-5 of its
   largest entry. Then ``optimize --escalate_collision 0.5`` and
   ``optimize --loop_collision_backend grid`` through the CLI on 16 files
   (write_corpus seed 2), B=8, stages cut to epoch 20: finite metrics.
14. The port's JPEG writer (run before phase 7): ``image_cases.check_encoder``
   encodes seeded noise and ramps at 1x1, 7x9, 15x17, 16x16, 33x65, 224x224
   and 896x448; each file's SHA-256 must be that of the bytes
   ``cv2.imencode(".jpg")`` writes (``tests/data/jpeg/encode_expected.json``);
   host ms per 896x448 encode.
15. Rendering, on phase 7's corpus and checkpoint (after phase 7):
   ``test-baseline --visualize_eval`` (B=64; the 256 renders forked over 16
   workers, under a time limit of RENDER_TIMEOUT so that a hung worker is an
   error; every render must run in a forked worker, none in this process,
   which ``render_results``' serial fallback would use): 256 ``.jpg`` files, each decoding to (896, 448, 3), K1 once a
   batch; render seconds in all and per result; the same results rendered
   one after another must give the same bytes; then ``visualize --results
   <its pkl> --limit 16``: 16 ``.obj`` and 16 ``.jpg`` files, the jpgs
   byte-equal to the rendered ones, no kernel launched.
16. Training visuals: ``train-baseline --display_freq 8 --live_port 0``, one
   epoch of 4 steps on phase 7's corpus (checkpoints in a directory of
   their own, stock BatchNorm): a display every step, five PNG panels each,
   ``index.html`` listing them, a line saying whether loss curves were
   drawn or skipped (no matplotlib), the live monitor answering ``/``,
   ``/losses.json`` (one point a display) and ``/images/<a panel>`` (its
   bytes) over HTTP; K1 once per display.
17. Two processes on the one card: ``test-baseline --rank r --world_size 2``
   (B=64) on phase 7's corpus and checkpoint, each process in its own
   working directory; the shards must be disjoint and cover the 256
   samples; then a gloo rendezvous through ``parallel.dist`` and rank 0's
   ``gather_evaluators``: its metric_dict within pipeline.SHORT_EVAL_RTOL
   of phase 7's single-process test-baseline; K1 twice in each process.
18. The 2-level hierarchy (``loop_collision_cluster=8``) and the merged
   payload builder (the ``IHMR_PAYLOAD_FUSED`` switch, ``pair_select_tris``),
   each in turns with the default engine (default, 2-level, 2-level,
   default, then default, merged, merged, default) at phase 13's shape:
   hands/sec, peak memory and the final mean exact collision of each, K1
   once per run (after phase 13; phase 12's small card-vs-CPU runs include
   the 2-level hierarchy at B=4).
19. Data parallelism (``parallel/mesh.py``; run last): (a) phase 5's
   replayed batch and weights (ResNet-50 224x224, B=64, fp32 without TF32,
   bn_impl="pallas") through ``train/baseline.py::dp_loss_and_grads`` over
   DP_SHARDS=4 shards of 16 on the card (a host thread and a stream each),
   then over ``make_mesh()``, every visible card: the loss, every gradient
   and the running statistics after the step against the one-device step
   on the same batch and weights within ``pipeline.DP_TOL_RESNET50``, K3 53 x the
   shard count from zeroed counts, no gradient crossing streams into a
   parameter (torch's AccumulateGrad warning) (the gaps printed beside the
   one-device step's own repeat and its step on the batch with each pair of
   samples swapped, the step's fp32 rounding floor); the 4-shard step again,
   within ``pipeline.DP_REPEAT_TOL`` of the first, and twice under
   deterministic algorithms, the same bits; K3 on shard 0's 53 BatchNorm
   inputs against a float64 sum and its plain version; the planted faults
   ``DP_PLANTED`` (``pipeline.planted_dp_fault``: the race twice, shard-local
   statistics once), each outside the bounds; ms/step of DP_STEPS=5
   replayed steps after 2 warm-ups, one device and 4 shards in turns. (b)
   ``bench.py``'s OPT workload (B=128, seed 0, opt_default,
   save_mid_freq=10) on sharded params and batch over 4 shards of 32: over
   4 x 21 steps every sample's params within DP_OPT_TOL of the one-device
   run, K1 once a shard; then 4 x 51 steps (DP_TIMED_EPOCH) in turns, one
   device, sharded, sharded, one device (hands/sec and final mean exact
   collision of each), K1 4 in each sharded run, the last one's final
   depths recomputed with K1's plain version.

The run's time in all is printed beside the card's name and power limit.

The next-to-last line is {"kernels": [...]} and the last line
{"ok": true, "device": {...}}. Exits non-zero without a result when CUDA is
unavailable or the ihmr_tpu_torch package is not beside this script.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import signal
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

# H100 SXM published peaks (fp32 outside the tensor cores, HBM3); the card's
# power limit is printed beside them
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# work of one query-triangle pair in the exact kernel (the count the JAX
# package uses: 21.4 GFLOP per call at B=128 with no pruning)
FLOPS_PER_PAIR = 70

# operations of one query-centroid pair in the nearest-centroid kernel:
# 3 mul + 2 add for q.c, the doubling and the subtraction from |c|^2
NEAREST_FLOPS_PER_PAIR = 7

# operations per element of the BatchNorm-statistics kernel: x * x and two adds
BN_FLOPS_PER_ELEMENT = 3
# K3 against a float64 sum of the same input, per channel: the error in
# sum x over sum |x| (a sum near 0 makes a plain relative error meaningless)
# and the relative error in sum x^2; fp32 accumulation of up to 802,816
# values a channel
BN_SUM_TOL = 1e-5
BN_SQ_TOL = 1e-5
TRAIN_STEPS = 20

DEPTH_TOL = 1e-5  # fp32, the same arithmetic on both sides
DIR_TOL = 1e-4  # tie-set averages summed in another order
SIGN_AGREEMENT = 0.999
SMALL_PARAM_TOL = 2e-4  # card vs CPU over a short OPT schedule (the slice test's bound)
HOIST_TOL = 5e-5  # hoisted vs full decode over 4 x 21 steps (the JAX package's bound between its engines)
# the JAX package's engine over the full opt_default at B=128, seed 0, fp32 on
# a CPU (tests/test_torch_port_opt.py's compare_full_schedule): the final mean
# collision loss, a sanity reference for this run's, not a limit
JAX_CPU_FINAL_COLLISION = 0.364552


def log(*args):
    print(*args, flush=True)


# the registry counter of each kernel's launches (ihmr_tpu_torch/profiling.py)
LAUNCH_COUNTERS = {"exact_collision": "k1.launches", "nearest_centroid": "k2.launches", "bn_stats": "k3.launches"}
_counts_at_zero = {}


def zero_counts():
    """Take every kernel's launch count as 0 from here (just before a path's run)."""
    from ihmr_tpu_torch import profiling

    torch.cuda.synchronize()
    _counts_at_zero.clear()
    _counts_at_zero.update(profiling.counters())


def read_counts():
    """Every kernel's launches since ``zero_counts`` (just after a path's run)."""
    from ihmr_tpu_torch import profiling

    torch.cuda.synchronize()
    now = profiling.counters()
    return {name: now.get(c, 0) - _counts_at_zero.get(c, 0) for name, c in LAUNCH_COUNTERS.items()}


GRAPH_COUNTERS = {"captures": "train.graph_captures", "replays": "train.graph_replays"}


def read_graph_counts():
    """The train step graph's captures and replays since ``zero_counts``."""
    from ihmr_tpu_torch import profiling

    now = profiling.counters()
    return {name: now.get(c, 0) - _counts_at_zero.get(c, 0) for name, c in GRAPH_COUNTERS.items()}


def traced_train(fn):
    """``fn()``, train steps on a state whose graph is captured already,
    under torch.profiler -> (its result, every kernel's launches as
    ``read_counts`` gives them but with bn_stats counted among the device
    kernels of the trace, and the graph's captures, replays and K3
    wrapper's runs). A replay launches K3 from the graph, where the wrapper
    and its counter ``k3.launches`` do not run."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    zero_counts()
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(0.01)  # see timing.device_kernels: a kernel right at the start may go unrecorded
        out = fn()
        torch.cuda.synchronize()
        time.sleep(0.01)
    counts = read_counts()
    graph = dict(read_graph_counts(), k3_wrapper=counts["bn_stats"])
    counts["bn_stats"] = sum(1 for e in prof.events()
                             if e.device_type == torch.autograd.DeviceType.CUDA and "bn_stats" in e.name)
    return out, counts, graph


def check_counts(path, counts, **expected):
    """Raise unless each kernel launched as often as the path should."""
    if counts != expected:
        raise AssertionError(f"{path}: kernel launches {counts}, expected {expected}")


def phase_card_and_build():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    from ihmr_tpu_torch.build import build_all

    t0 = time.perf_counter()
    report = build_all()
    log(f"build: {time.perf_counter() - t0:.1f}s for {sorted(report)}")
    for name, info in report.items():
        log(f"  {name}: {info['seconds']:.1f}s\n{info['log'].strip()}")
    return smi


def _compare_exact(q, tri, label, timed=False):
    """Kernel vs plain version on (N, V, 3) queries and (N, F, 9) triangles."""
    from ihmr_tpu_torch.ops import exact_collision as K
    from ihmr_tpu_torch.timing import cold_ms, cuda_ms

    N, V, _ = q.shape
    F = tri.shape[1]
    qp, tp, bounds = K.pad_inputs(q, tri)
    zero_counts()
    depth, dirs = K._launch_kernel(qp, tp, bounds, F)
    torch.cuda.synchronize()
    ref_depth, ref_dirs, evaluated = K.exact_penetration_depth_reference(qp, tp, bounds, F)
    depth, dirs, ref_depth, ref_dirs = depth[:, :V], dirs[:, :V], ref_depth[:, :V], ref_dirs[:, :V]
    err = float((depth - ref_depth).abs().max())
    agree = float(((depth > 0) == (ref_depth > 0)).float().mean())
    both = (depth > 0) & (ref_depth > 0)
    dir_err = float((dirs - ref_dirs)[both].abs().max()) if bool(both.any()) else 0.0
    log(
        f"  [{label}] N={N} V={V} F={F}: max |depth err| {err:.3e} (tol {DEPTH_TOL}), "
        f"dir err where both inside {dir_err:.3e} (tol {DIR_TOL}), inside-sign agreement "
        f"{agree:.6f} (min {SIGN_AGREEMENT}), inside {int((ref_depth > 0).sum())}/{N * V}"
    )
    if not (err <= DEPTH_TOL and dir_err <= DIR_TOL and agree >= SIGN_AGREEMENT):
        raise AssertionError(f"exact_collision kernel disagrees with its plain version ({label})")
    if not timed:
        return None

    # work this run's data needs: real queries x real triangles of every
    # (query block, triangle tile) pair the pruning rule evaluated
    q_real = torch.clamp(V - torch.arange(0, qp.shape[1], K.Q_TILE, device=q.device), max=K.Q_TILE)
    t_real = torch.clamp(F - torch.arange(0, tp.shape[1], K.T_TILE, device=q.device), max=K.T_TILE)
    pairs = float((evaluated.float() * q_real[None, :, None] * t_real[None, None, :]).sum())
    flops = pairs * FLOPS_PER_PAIR
    nbytes = 4 * (N * V * 3 + N * F * 9 + bounds.numel() + N * V + N * V * 3)
    bound_ms = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
    bound_by = "operations" if flops / PEAK_FP32_FLOPS >= nbytes / PEAK_HBM_BYTES else "bytes"
    ms = cold_ms(lambda: K._launch_kernel(qp, tp, bounds, F))
    host_ms = cuda_ms(lambda: K._launch_kernel(qp, tp, bounds, F), 20)
    plain_ms = cuda_ms(lambda: K.exact_penetration_depth_reference(qp, tp, bounds, F), 5)
    log(
        f"  [{label}] kernel {ms:.4f} ms on the device alone (cold L2, graph replay), {host_ms:.4f} ms with "
        f"CUDA events around one wrapper call; plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
        f"{flops / 1e9:.3f} GFLOP evaluated of {N * V * F * FLOPS_PER_PAIR / 1e9:.3f} unpruned, "
        f"{nbytes / 1e6:.2f} MB), library call: none (no single PyTorch call computes this); "
        f"{read_counts()['exact_collision']} kernel launches in this comparison"
    )
    return dict(max_abs_err=err, ms=ms, ms_with_host=host_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def _compare_nearest(q, cent, label, timed=False):
    """Kernel vs plain version on (N, V, 3) queries and (N, F, 3) centroids;
    every index must be equal."""
    from ihmr_tpu_torch.ops import nearest_centroid as NC
    from ihmr_tpu_torch.timing import cold_ms, cuda_ms

    N, V, _ = q.shape
    F = cent.shape[1]
    qp, cp = NC.pad_inputs(q, cent)
    zero_counts()
    idx = NC._launch_kernel(qp, cp, F)
    torch.cuda.synchronize()
    ref = NC.nearest_centroid_reference(qp, cp, F)
    idx, ref = idx[:, :V], ref[:, :V]
    equal = float((idx == ref).float().mean())
    err = float((idx - ref).abs().max())
    log(f"  [{label}] N={N} V={V} F={F}: equal indices {equal:.6f} (must be 1), max |index diff| {err:.0f}, "
        f"{read_counts()['nearest_centroid']} kernel launch in this comparison")
    if equal != 1.0:
        raise AssertionError(f"nearest_centroid kernel disagrees with its plain version ({label})")
    if not timed:
        return None
    # work these inputs need: every real query against every real centroid
    flops = float(N * V * F * NEAREST_FLOPS_PER_PAIR)
    nbytes = 4 * (N * V * 3 + N * F * 4 + N * V)
    bound_ms = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
    bound_by = "operations" if flops / PEAK_FP32_FLOPS >= nbytes / PEAK_HBM_BYTES else "bytes"
    ms = cold_ms(lambda: NC._launch_kernel(qp, cp, F))
    host_ms = cuda_ms(lambda: NC._launch_kernel(qp, cp, F), 50)
    plain_ms = cuda_ms(lambda: NC.nearest_centroid_reference(qp, cp, F), 5)
    c2 = cp[:, :F, 3]
    composition_ms = cuda_ms(lambda: (c2[:, None, :] - 2 * torch.bmm(q, cent.mT)).argmin(-1), 20)
    log(
        f"  [{label}] kernel {ms:.4f} ms on the device alone (cold L2, graph replay), {host_ms:.4f} ms with "
        f"CUDA events around one wrapper call; plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
        f"{flops / 1e9:.3f} GFLOP at {NEAREST_FLOPS_PER_PAIR} flop/pair, {nbytes / 1e6:.2f} MB); "
        f"library call: none (no PyTorch call keeps the tile-mean tie rule)"
    )
    log(f"  [{label}] nearest library composition, not the same function: "
        f"(|c|^2 - 2 * torch.bmm(q, c^T)).argmin(-1) {composition_ms:.4f} ms")
    return dict(max_abs_err=err, ms=ms, ms_with_host=host_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_composition_ms=composition_ms)


def phase_kernels(dev):
    from ihmr_tpu_torch import kernel_cases
    from ihmr_tpu_torch.ops import exact_collision as K
    from ihmr_tpu_torch.ops.nearest_centroid import nearest_centroid

    log("kernels vs plain versions (exact_collision):")
    q, tri = kernel_cases.exact_main_inputs(dev)
    main = _compare_exact(q, tri, "main path B=128, both directions", timed=True)
    num, den = kernel_cases.division_operands(dev)
    diff = int((K.kernel_divide(num, den).view(torch.int32) != K._safe_div(num, den).view(torch.int32)).sum())
    log(f"  [division] the kernel's branch-free division against torch's on {num.numel()} operand pairs: "
        f"{diff} differ in any bit (must be 0)")
    if diff:
        raise AssertionError("the exact_collision kernel's division does not round as torch's")
    sphere_tri = torch.tensor(kernel_cases.sphere_triangles(400), dtype=torch.float32, device=dev)
    gen = torch.Generator(device="cpu").manual_seed(1)
    sq = (torch.randn(4, 1000, 3, generator=gen) * 0.6).to(dev)
    _compare_exact(sq, sphere_tri[None].expand(4, -1, -1).contiguous(), "icosphere")
    for label, q, tri in kernel_cases.exact_cases(dev):
        _compare_exact(q, tri, label)

    log("kernels vs plain versions (nearest_centroid):")
    q, cent = kernel_cases.nearest_main_inputs(dev)
    nearest = _compare_nearest(q, cent, "MLP path B=128, both directions", timed=True)
    sphere_cent = sphere_tri[:-1].reshape(-1, 3, 3).mean(1)  # an odd centroid count
    _compare_nearest(sq, sphere_cent[None].expand(4, -1, -1).contiguous(), "icosphere")
    for label, q, cent, picks in kernel_cases.nearest_cases(dev):
        _compare_nearest(q, cent, label)
        if picks is not None:
            got = nearest_centroid(q, cent)
            if not all(bool((got[n] == p).all()) for n, p in enumerate(picks)):
                raise AssertionError(f"[{label}] picked {got[:, 0].tolist()}, expected {list(picks)}")
            log(f"  [{label}] picks {list(picks)} as the tie rules say")
    return main, nearest


def _bn_rel_errors(s, s2, x):
    """(max over channels of |s - sum x| / sum |x|, of |s2 - sum x^2| / sum
    x^2), the sums taken in float64."""
    dims = (0,) + tuple(range(2, x.dim()))
    x64 = x.double()
    ref_s, ref_q, ref_a = x64.sum(dims), (x64 * x64).sum(dims), x64.abs().sum(dims)
    return (
        float(((s.double() - ref_s).abs() / ref_a.clamp_min(1e-300)).max()),
        float(((s2.double() - ref_q).abs() / ref_q.clamp_min(1e-300)).max()),
    )


def _bn_bound_ms(x):
    """The least time for one K3 call: each input byte read once and both
    (C,) fp32 outputs written once, or BN_FLOPS_PER_ELEMENT per element."""
    nbytes = x.numel() * x.element_size() + 2 * x.shape[1] * 4
    flops = BN_FLOPS_PER_ELEMENT * x.numel()
    return max(nbytes / PEAK_HBM_BYTES, flops / PEAK_FP32_FLOPS) * 1e3, (
        "operations" if flops / PEAK_FP32_FLOPS > nbytes / PEAK_HBM_BYTES else "bytes")


def _time_bn(x):
    """((kernel, plain, torch.var_mean) device ms with a cold L2, the kernel
    with CUDA events around one call) on ``x``."""
    from ihmr_tpu_torch.ops import bn_stats as K3
    from ihmr_tpu_torch.timing import cold_ms, cuda_ms

    dims = (0,) + tuple(range(2, x.dim()))
    fns = (lambda: K3._launch_kernel(x), lambda: K3.bn_stats_reference(x),
           lambda: torch.var_mean(x, dim=dims, correction=0))
    return tuple(cold_ms(f) for f in fns), cuda_ms(fns[0], 10)


def k3_device_kernels(fn):
    """The device kernels whose name holds bn_stats that one ``fn()`` runs,
    counted by torch.profiler (``timing.device_kernels``: the third of three
    calls, each started 10 ms into its profiler step)."""
    from ihmr_tpu_torch.timing import device_kernels

    return sum(1 for name in device_kernels(fn) if "bn_stats" in name)


def _compare_bn(x, label):
    """K3 against a float64 sum and its plain version; determinism; one device
    kernel a call; backward."""
    from ihmr_tpu_torch.ops import bn_stats as K3

    zero_counts()
    s, s2 = K3._launch_kernel(x)
    torch.cuda.synchronize()
    again = []

    def launch():  # keeps the last call's sums
        again[:] = K3._launch_kernel(x)

    per_call = k3_device_kernels(launch)
    ps, ps2 = K3.bn_stats_reference(x)
    k_err, p_err = _bn_rel_errors(s, s2, x), _bn_rel_errors(ps, ps2, x)
    abs_err = max(float((s - ps).abs().max()), float((s2 - ps2).abs().max()))
    same_bits = torch.equal(s, again[0]) and torch.equal(s2, again[1])

    view = (1, x.shape[1]) + (1,) * (x.dim() - 2)
    gen = torch.Generator(device=x.device).manual_seed(0)
    gs, gs2 = torch.randn((2, x.shape[1]), generator=gen, device=x.device)
    xg = x.detach().clone().requires_grad_(True)
    a, b = K3.bn_stats(xg)
    (a * gs + b * gs2).sum().backward()
    ref_gx = (gs.reshape(view) + 2.0 * x.float() * gs2.reshape(view)).to(x.dtype)
    gx_err = float((xg.grad.float() - ref_gx.float()).abs().max() / ref_gx.float().abs().max())
    plan = K3.launch_plan(tuple(x.shape), x.element_size(), x.data_ptr() % 16 == 0)
    log(
        f"  [{label}] {tuple(x.shape)} {str(x.dtype).replace('torch.', '')}, {plan.path} path, "
        f"{'16-byte' if plan.vector else 'masked scalar'} loads, grid {plan.grid}, {plan.slices} slices: "
        f"kernel vs float64: sum err "
        f"{k_err[0]:.3e} of sum|x| (tol {BN_SUM_TOL}), sum-of-squares rel err {k_err[1]:.3e} (tol {BN_SQ_TOL}); "
        f"plain version vs float64: {p_err[0]:.3e}, {p_err[1]:.3e}; max |kernel - plain| {abs_err:.3e}; "
        f"same bits on a second launch: {same_bits}; backward rel err {gx_err:.3e}; "
        f"{read_counts()['bn_stats']} kernel launches in this comparison; device kernels in one call {per_call}"
    )
    failed = [name for name, ok in (
        (f"sum err {k_err[0]:.3e} > {BN_SUM_TOL}", k_err[0] <= BN_SUM_TOL),
        (f"sum-of-squares err {k_err[1]:.3e} > {BN_SQ_TOL}", k_err[1] <= BN_SQ_TOL),
        ("other bits on a second launch", same_bits), (f"backward rel err {gx_err:.3e} > 1e-6", gx_err <= 1e-6),
        (f"{per_call} device kernels in one call", per_call == 1)) if not ok]
    if failed:
        raise AssertionError(f"bn_stats kernel disagrees with its plain version ({label}): {'; '.join(failed)}")
    (ms, plain_ms, lib_ms), ev_ms = _time_bn(x)
    bound_ms, bound_by = _bn_bound_ms(x)
    log(f"  [{label}] device time, cold L2: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.var_mean "
        f"{lib_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}: {x.numel() * x.element_size() / 1e6:.2f} MB); "
        f"kernel with CUDA events around one call (host launch latency included) {ev_ms:.4f} ms")
    return abs_err


def phase_bn_kernel(dev):
    log("kernels vs plain versions (bn_stats):")
    gen = torch.Generator(device=dev).manual_seed(3)
    cases = [
        ("ResNet-50 stem", (64, 64, 112, 112), torch.float32, 0),
        ("ResNet-50 widest", (64, 2048, 7, 7), torch.float32, 0),
        ("ragged", (3, 5, 7, 11), torch.float32, 0),
        ("bf16", (64, 256, 56, 56), torch.bfloat16, 0),
        ("7x7 bf16", (64, 2048, 7, 7), torch.bfloat16, 0),
        ("14x14 bf16", (64, 256, 14, 14), torch.bfloat16, 0),
        ("B=1", (1, 2048, 7, 7), torch.float32, 0),
        ("C not a multiple of the channel tile", (64, 1025, 14, 14), torch.float32, 0),
        ("base not 16-byte aligned", (64, 1024, 14, 14), torch.float32, 1),
    ]
    errs = []
    for label, shape, dtype, offset in cases:
        # a convolution's output; offset 1 moves the contiguous view's base off 16-byte alignment
        flat = (torch.randn((math.prod(shape) + offset,), generator=gen, device=dev) * 2.0 + 0.5).to(dtype)
        errs.append(_compare_bn(flat[offset:].view(shape), label))
        del flat
    return max(errs)


def _k1_plain_err(rv, lv, faces_r, faces_l, depths):
    """Largest gap between a final pass's parity-filtered exact depths and
    the same depths through K1's plain version."""
    from ihmr_tpu_torch.ops import exact_collision as K
    from ihmr_tpu_torch.ops.collision import pair_parity_filter

    B = rv.shape[0]
    q = torch.cat([rv, lv])
    tri = torch.cat([lv[:, faces_l].reshape(B, -1, 9), rv[:, faces_r].reshape(B, -1, 9)])
    qp, tp, bounds = K.pad_inputs(q, tri)
    ref, _, _ = K.exact_penetration_depth_reference(qp, tp, bounds, tri.shape[1])
    ref = ref[:, : q.shape[1]]
    ref = pair_parity_filter(torch.cat([ref[:B], ref[B:]], dim=1), rv, lv, faces_r, faces_l)
    return float((ref - depths).abs().max())


def phase_main_path(dev):
    from ihmr_tpu_torch.pipeline import make_bench_inputs, run_pipeline

    log("OPT path: ResNet-50 224x224 + opt_default (4 x 301 steps) at B=128, full MANO mesh")
    inputs = make_bench_inputs(batch=128, seed=0, arch="resnet50", image_size=224, device=dev)
    log(f"  mesh: {inputs.mano.v_template.shape[0]} vertices, {inputs.mano.faces.shape[0]} faces")
    t0 = time.perf_counter()
    run_pipeline(inputs)
    torch.cuda.synchronize()
    log(f"  warm-up run: {time.perf_counter() - t0:.2f}s")

    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    out_params, results, pred_params, hand_type = run_pipeline(inputs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    B = inputs.images.shape[0]
    log(f"  timed run (default engine, stage-hoisted decode): {dt:.3f}s -> {B / dt:.3f} hands/sec; launches "
        f"{counts}; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    # K1 runs once, on the final exact pass: the in-loop collision is the
    # plain-torch payload path; K2 is MLP-only and the encoder's BatchNorm
    # runs in eval mode (no K3)
    check_counts("the OPT path", counts, exact_collision=1, nearest_centroid=0, bn_stats=0)

    final_coll = float(results["collision_loss"].mean())
    log(f"  final mean collision loss {final_coll:.5f} (the JAX package's engine in fp32 on a CPU: "
        f"{JAX_CPU_FINAL_COLLISION} at seed 0; one discrete flip on one sample moves the mean by ~0.1; sanity only)")
    if pred_params.shape != (B, 122) or hand_type.shape != (B, 2):
        raise AssertionError(f"encoder outputs {tuple(pred_params.shape)} {tuple(hand_type.shape)}")
    tensors = dict(results, pred_params=pred_params, hand_type=hand_type, **{f"param_{k}": v for k, v in out_params.items()})
    bad = [k for k, v in tensors.items() if not bool(torch.isfinite(v).all())]
    if bad:
        raise AssertionError(f"non-finite outputs: {bad}")
    log(f"  all {len(tensors)} outputs finite")

    # the final pass's depths again, through the plain version
    err = _k1_plain_err(results["pred_right_hand_verts"], results["pred_left_hand_verts"], inputs.mano.faces,
                        inputs.mano.faces.flip(-1), results["collision_loss_origin_scale"])
    log(f"  final-pass depths, kernel vs plain: max |err| {err:.3e} (tol {DEPTH_TOL})")
    if err > DEPTH_TOL:
        raise AssertionError("final-pass depths disagree with the plain version")
    return counts, B / dt


def phase_engines(dev):
    """The stage-hoisted engine against the full decode over 4 x 21 steps."""
    from ihmr_tpu_torch.data import make_opt_inputs
    from ihmr_tpu_torch.mano import synthetic_mano_model
    from ihmr_tpu_torch.refine import OptConfig, opt_default, optimize_batch, run_stage
    from ihmr_tpu_torch.refine.opt_engine import _make_stage_forward

    strategy = tuple(dataclasses.replace(s, epoch=20) for s in opt_default)
    configs = {hoist: OptConfig(save_mid_freq=10, stage_hoist_decode=hoist) for hoist in (True, False)}
    mano = synthetic_mano_model(device=dev)
    for B in (2, 128):
        params, batch = make_opt_inputs(mano, batch=B, seed=0)
        outs = {}
        for hoist, config in configs.items():
            zero_counts()
            outs[hoist], _ = optimize_batch(mano, params, batch, strategy, config)
            launches = read_counts()["exact_collision"]
            if launches != 1:
                raise AssertionError(f"optimize_batch (stage_hoist_decode={hoist}) launched exact_collision "
                                     f"{launches} times, not once")
        gap = torch.stack([(outs[True][k] - outs[False][k]).abs().reshape(B, -1).max(1).values for k in params])
        gap = gap.max(0).values.cpu()
        over = [int(i) for i in torch.nonzero(gap > HOIST_TOL).flatten()]
        log(f"engines, B={B}, 4 x 21 steps: hoisted vs full decode params max |gap| {float(gap.max()):.3e} "
            f"(tol {HOIST_TOL}); samples above it {len(over)}/{B}; exact_collision once per optimize_batch with both")
        if B == 2 and float(gap.max()) > HOIST_TOL:
            raise AssertionError("the hoisted and the full-decode engines disagree on the card")
        if over:
            # each stage run by both engines from the same entry params: where a sample first leaves the bound
            entry = params
            for st in strategy:
                ends = {hoist: run_stage(mano, entry, batch, st, config) for hoist, config in configs.items()}
                g = torch.stack([(ends[True][k] - ends[False][k]).abs().reshape(B, -1).max(1).values for k in params])
                g = g.max(0).values.cpu()
                log(f"  stage {'+'.join(st.update_params)} from common entry params: samples above tol "
                    f"{[i for i in over if float(g[i]) > HOIST_TOL]}, max gap {float(g.max()):.3e}")
                entry = ends[True]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fwd = _make_stage_forward(mano, opt_default[3], params)
    torch.cuda.synchronize()
    log(f"  shape-stage payload at B={B} (one decode of {21 * 2 * B} hands): peak "
        f"{(torch.cuda.max_memory_allocated() - base) / 2**20:.1f} MiB above the {base / 2**20:.1f} MiB held before, "
        f"{(torch.cuda.memory_allocated() - base) / 2**20:.1f} MiB kept for the stage")
    del fwd


def phase_mlp_path(dev):
    from ihmr_tpu_torch.data import BatchList
    from ihmr_tpu_torch.pipeline import MLPBenchInputs, make_mlp_bench_inputs, run_mlp_pipeline
    from ihmr_tpu_torch.refine import MLP_DEFAULT_LOSS_WEIGHTS, OptConfig, make_cascade_apply, mlp_default

    log("MLP path: run_mlp_pipeline, N=2048 in 16 batches of 128, full mlp_default (6 stages, 15 epochs)")
    inputs = make_mlp_bench_inputs(n=2048, batch=128, device=dev)
    B = inputs.batches[0].index.shape[0]
    steps = sum(s.epoch for s in mlp_default) * len(inputs.batches)
    t0 = time.perf_counter()
    # warm-up: one train step, one selection batch, one cascade batch
    warm = MLPBenchInputs(inputs.mano, BatchList(inputs.batches[:1]), B)
    run_mlp_pipeline(warm, (dataclasses.replace(mlp_default[0], epoch=1),), print_freq=1)
    torch.cuda.synchronize()
    log(f"  warm-up (one batch, one stage, one epoch): {time.perf_counter() - t0:.2f}s")

    zero_counts()
    t0 = time.perf_counter()
    run = run_mlp_pipeline(inputs, mlp_default, generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    n = inputs.num_data
    sec = run.seconds
    train_rate = steps * B / sec["train"]
    cascade_rate = n / sec["cascade"]
    log(f"  timed run: {dt:.3f}s (warm pass {sec['warm']:.3f}s, training with selection {sec['train']:.3f}s, "
        f"test_mlp_loop: cascade and Evaluator {sec['cascade']:.3f}s)")
    log(f"  training: {train_rate:.3f} samples/sec ({steps} steps x {B}); cascade: {cascade_rate:.3f} hands/sec")
    for stat in run.stage_stats:
        log(f"  stage {stat['stage']} {'+'.join(mlp_default[stat['stage']].update_params)}: accept "
            f"{stat['accepted_frac']:.3f}, {stat['select_loss']} {stat['select_before']:.5f} -> {stat['select_after']:.5f}")
    log("  (docs/MLP_SOAK.md has a TPU run of the JAX package on the same data; a sanity check, not a limit)")
    n_batches = len(inputs.batches)
    k1_expect = n_batches * (1 + len(mlp_default) + len(mlp_default) + 2)  # warm + selections + cascade
    log(f"  launches: {counts}; expected nearest_centroid = train steps {steps}, exact_collision = "
        f"warm {n_batches} + selection {n_batches * len(mlp_default)} + cascade {n_batches * (len(mlp_default) + 2)} "
        f"= {k1_expect}, bn_stats 0")
    check_counts("the MLP path", counts, exact_collision=k1_expect, nearest_centroid=steps, bn_stats=0)
    tensors = {f"cache_{k}": v for k, v in {**run.caches.prev_params, **run.caches.prev_losses}.items()}
    bad = [k for k, v in tensors.items() if not bool(torch.isfinite(v).all())]
    bad += [f"result_{r['data_idx']}_{k}" for r in run.evaluator.pred_results for k, v in r.items()
            if isinstance(v, np.ndarray) and v.dtype.kind == "f" and not np.isfinite(v).all()]
    stats_ok = all(np.isfinite([s["select_before"], s["select_after"]]).all() for s in run.stage_stats)
    if bad or not stats_ok or not bool(run.caches.exists.all()) or len(run.evaluator.pred_results) != n:
        raise AssertionError(f"MLP outputs not finite or not cached: {bad[:5]}")
    log(f"  all {len(tensors)} cached tensors and the {n} Evaluator entries finite, all {n} samples cached")
    md = _check_metrics("test_mlp_loop", run.evaluator)
    if md != run.metrics:
        raise AssertionError("run_mlp_pipeline's metrics are not its Evaluator's")

    cascade = make_cascade_apply(inputs.mano, mlp_default, dict(MLP_DEFAULT_LOSS_WEIGHTS), OptConfig())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for batch in inputs.batches:
            cascade(run.subnets, batch)
    torch.cuda.synchronize()
    bare = time.perf_counter() - t0
    log(f"  the same cascade without the Evaluator: {bare:.3f}s -> {n / bare:.3f} hands/sec "
        f"(with it: {sec['cascade']:.3f}s -> {cascade_rate:.3f} hands/sec)")
    return counts, train_rate, cascade_rate, md


def _check_metrics(label, evaluator):
    """Print an Evaluator's metric_dict; every metric must be finite."""
    md = evaluator.metric_dict()
    log(f"  {label} metric_dict over {len(evaluator.pred_results)} samples: "
        + ", ".join(f"{k} {v:.6f}" for k, v in md.items()))
    if not all(np.isfinite(v) for v in md.values()):
        raise AssertionError(f"{label}: non-finite metrics {dict(md)}")
    return dict(md)


def phase_opt_eval(dev):
    """optimize_loop over two raw batches of B=128, stages cut to epoch 20."""
    from ihmr_tpu_torch.data import make_opt_inputs, opt_raw_batch
    from ihmr_tpu_torch.mano import synthetic_mano_model
    from ihmr_tpu_torch.refine import OptConfig, opt_default
    from ihmr_tpu_torch.train import optimize_loop

    B = 128
    log(f"evaluation: optimize_loop over 2 raw batches of B={B} (make_opt_inputs seeds 0 and 1), opt_default "
        "stages cut to epoch 20")
    mano = synthetic_mano_model(device=dev)
    raws = [opt_raw_batch(*make_opt_inputs(mano, batch=B, seed=s), index_offset=B * s) for s in (0, 1)]
    strategy = tuple(dataclasses.replace(s, epoch=20) for s in opt_default)
    zero_counts()
    t0 = time.perf_counter()
    evaluator = optimize_loop(mano, raws, None, strategy, OptConfig(save_mid_freq=10))
    counts = read_counts()
    log(f"  {time.perf_counter() - t0:.3f}s; launches {counts} (exact_collision expected {len(raws)})")
    check_counts("optimize_loop", counts, exact_collision=len(raws), nearest_centroid=0, bn_stats=0)
    if len(evaluator.pred_results) != B * len(raws):
        raise AssertionError(f"optimize_loop's Evaluator holds {len(evaluator.pred_results)} samples")
    return counts, _check_metrics("optimize_loop", evaluator)


def phase_train_path(dev):
    import tempfile

    from ihmr_tpu_torch.models.resnet import BatchNorm
    from ihmr_tpu_torch.pipeline import make_train_bench_inputs, run_train_pipeline
    from ihmr_tpu_torch.data import baseline_raw_batch
    from ihmr_tpu_torch.train import eval_step, test_baseline_loop

    log(f"baseline training: ResNet-50 224x224, B=64, {TRAIN_STEPS} steps of TrainConfig(total_epoch=1), "
        "fp32 without TF32, bn_impl=pallas (K3)")
    inputs = make_train_bench_inputs(batch=64, image_size=224, arch="resnet50", bn_impl="pallas", device=dev)
    B = inputs.batch.img.shape[0]
    bns = [m for m in inputs.state.encoder.modules() if isinstance(m, BatchNorm)]
    shapes = []
    hooks = [m.register_forward_pre_hook(lambda _m, args: shapes.append(tuple(args[0].shape))) for m in bns]
    t0 = time.perf_counter()
    run_train_pipeline(inputs, 2)
    log(f"  warm-up (2 steps and an eval step): {time.perf_counter() - t0:.2f}s; {len(bns)} BatchNorms")
    for h in hooks:
        h.remove()
    step_shapes = shapes[: len(bns)]

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        run, step_counts, graph = traced_train(
            lambda: run_train_pipeline(inputs, TRAIN_STEPS, checkpoints_dir=tmp, evaluate=False))
        saved = sorted(os.listdir(tmp))
    ms = run.step_seconds / TRAIN_STEPS * 1e3
    log(f"  {TRAIN_STEPS} steps: {ms:.3f} ms/step -> {B / ms * 1e3:.3f} images/sec (host clock over the steps, "
        f"each ending in a host read of its losses; the checkpoint write excluded; under torch.profiler); "
        f"peak device memory allocated (a replay allocates nothing; the graph's pool is reserved) "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; checkpoints {saved}")
    log(f"  total loss {run.total_loss[0]:.5f} -> {run.total_loss[-1]:.5f}")
    log(f"  launches over the steps: {step_counts} (bn_stats: device kernels in the trace, expected {len(bns)} x "
        f"{TRAIN_STEPS}); the train step's graph: {graph}")
    if len(bns) != 53:
        raise AssertionError(f"ResNet-50 holds {len(bns)} BatchNorms, not 53")
    check_counts("the training steps", step_counts, exact_collision=0, nearest_centroid=0, bn_stats=53 * TRAIN_STEPS)
    check_counts("the training steps' graph", graph, captures=0, replays=TRAIN_STEPS, k3_wrapper=0)
    check_step_kernels("fp32", inputs)

    zero_counts()
    metrics, outputs = eval_step(inputs.state, inputs.batch, inputs.mano_right, inputs.mano_left, inputs.config)
    eval_counts = read_counts()
    err = _k1_plain_err(outputs["pred_right_hand_verts"], outputs["pred_left_hand_verts"], inputs.mano_right.faces,
                        inputs.mano_left.faces, outputs["collision_loss_origin_scale"])
    log(f"  eval step: launches {eval_counts}; depths kernel vs plain max |err| {err:.3e} "
        f"(tol {DEPTH_TOL}); inside vertices {int((outputs['collision_loss_origin_scale'] > 0).sum())}; "
        + ", ".join(f"{k} {float(v):.5f}" for k, v in metrics.items()))
    check_counts("the eval step", eval_counts, exact_collision=1, nearest_centroid=0, bn_stats=0)
    if err > DEPTH_TOL:
        raise AssertionError("the eval step's exact collision disagrees with the plain version")
    zero_counts()
    evaluator = test_baseline_loop(
        inputs.state, [baseline_raw_batch(inputs.batch)], None, inputs.mano_right, inputs.mano_left, inputs.config
    )
    loop_counts = read_counts()
    log(f"  test_baseline_loop over the batch: launches {loop_counts} (exact_collision expected 1; BatchNorm in "
        "eval mode)")
    check_counts("test_baseline_loop", loop_counts, exact_collision=1, nearest_centroid=0, bn_stats=0)
    if len(evaluator.pred_results) != B:
        raise AssertionError(f"test_baseline_loop's Evaluator holds {len(evaluator.pred_results)} samples")
    baseline_md = _check_metrics("test_baseline_loop", evaluator)
    buffers = {k: v for k, v in inputs.state.encoder.state_dict().items() if k.endswith(("running_mean", "running_var"))}
    bad = [k for k, v in buffers.items() if not bool(torch.isfinite(v).all())]
    bad += [k for k, v in metrics.items() if not bool(torch.isfinite(v).all())]
    if bad or not np.isfinite(run.total_loss).all():
        raise AssertionError(f"non-finite losses or running statistics: {bad[:5]}")
    log(f"  all {len(run.total_loss)} step losses, {len(metrics)} eval metrics and {len(buffers)} running statistics finite")
    del inputs, run, outputs
    torch.cuda.empty_cache()

    stock = make_train_bench_inputs(batch=64, image_size=224, arch="resnet50", bn_impl="stock", device=dev)
    run_train_pipeline(stock, 2, evaluate=False)
    stock_run = run_train_pipeline(stock, TRAIN_STEPS, evaluate=False)
    stock_ms = stock_run.step_seconds / TRAIN_STEPS * 1e3
    log(f"  bn_impl=stock, the same {TRAIN_STEPS} steps: {stock_ms:.3f} ms/step -> {B / stock_ms * 1e3:.3f} "
        f"images/sec; total loss {stock_run.total_loss[0]:.5f} -> {stock_run.total_loss[-1]:.5f}")
    del stock, stock_run
    torch.cuda.empty_cache()

    train_counts = {name: step_counts[name] + eval_counts[name] for name in step_counts}
    return dict(counts=train_counts, loop_counts=loop_counts, baseline_md=baseline_md, ms_per_step=ms,
                stock_ms_per_step=stock_ms, k3_step=bn_step_times(dev, step_shapes))


def check_step_kernels(label, inputs):
    """A train step under torch.profiler (the third of three more):
    exactly 53 K3 device kernels, one per BatchNorm."""
    from ihmr_tpu_torch.pipeline import run_train_pipeline

    n = k3_device_kernels(lambda: run_train_pipeline(inputs, 1, evaluate=False))
    log(f"  one {label} train step under torch.profiler: {n} bn_stats device kernels (53 BatchNorms, one launch each)")
    if n != 53:
        raise AssertionError(f"{label} train step: {n} bn_stats device kernels, not 53")


def bn_step_times(dev, step_shapes, dtype=torch.float32):
    """K3, its plain version and torch.var_mean over one train step's
    BatchNorm input shapes (random data of ``dtype``), summed: the K3 entry's numbers."""
    log(f"  bn_stats over one train step's BatchNorm inputs (random {str(dtype).replace('torch.', '')} data of each "
        "shape; device time, cold L2):")
    gen = torch.Generator(device=dev).manual_seed(4)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    counts = {}
    for shape in step_shapes:
        counts[shape] = counts.get(shape, 0) + 1
    events = 0.0
    for shape, n in counts.items():
        x = (torch.randn(shape, generator=gen, device=dev) * 2.0 + 0.5).to(dtype)
        (k_ms, p_ms, l_ms), ev_ms = _time_bn(x)
        b_ms, _ = _bn_bound_ms(x)
        for key, v in zip(("ms", "plain_ms", "library_ms", "bound_ms"), (k_ms, p_ms, l_ms, b_ms)):
            tot[key] += n * v
        events += n * ev_ms
        log(f"    {shape} x{n}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, var_mean {l_ms:.4f} ms, bound {b_ms:.4f} ms, "
            f"share of bound {b_ms / k_ms:.3f} (kernel with CUDA events around one call {ev_ms:.4f} ms)")
        del x
    log(f"  per step ({len(step_shapes)} launches): kernel {tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, "
        f"var_mean {tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms (bytes), share of bound "
        f"{tot['bound_ms'] / tot['ms']:.3f}; kernel with CUDA events around each call {events:.4f} ms")
    return dict(tot, bound_by="bytes")


def phase_small_input(dev):
    from ihmr_tpu_torch.data import make_opt_inputs
    from ihmr_tpu_torch.mano import synthetic_mano_model
    from ihmr_tpu_torch.refine import OptConfig, opt_default, optimize_batch

    strategy = tuple(dataclasses.replace(s, epoch=20) for s in opt_default)
    outs = {}
    for device in (dev, torch.device("cpu")):
        mano = synthetic_mano_model(device=device)
        params, batch = make_opt_inputs(mano, batch=2, seed=0)
        outs[device.type] = optimize_batch(mano, params, batch, strategy, OptConfig(save_mid_freq=10))
    (p_gpu, r_gpu), (p_cpu, r_cpu) = outs["cuda"], outs["cpu"]
    err = max(float((p_gpu[k].cpu() - p_cpu[k]).abs().max()) for k in p_cpu)
    coll_gpu, coll_cpu = r_gpu["collision_loss"].cpu(), r_cpu["collision_loss"]
    log(f"small input (B=2, 4 x 21 steps): card vs CPU params max |err| {err:.3e} (tol {SMALL_PARAM_TOL}); "
        f"collision {coll_gpu.tolist()} vs {coll_cpu.tolist()}")
    if err > SMALL_PARAM_TOL or not torch.allclose(coll_gpu, coll_cpu, rtol=1e-3, atol=1e-6):
        raise AssertionError("the card and the CPU disagree on a small input")


def phase_small_eval(dev):
    from ihmr_tpu_torch.pipeline import SHORT_EVAL_RTOL, run_short_opt_eval, short_eval_gaps

    gpu, cpu = run_short_opt_eval(dev), run_short_opt_eval("cpu")
    gaps = short_eval_gaps(gpu, cpu)
    log(f"small OPT evaluation (optimize_loop, 2 batches of B=2, 4 x 21 steps), card vs CPU metric_dict: "
        + ", ".join(f"{k} {gpu[k]:.6f} vs {cpu[k]:.6f} (rel gap {v:.3e})" for k, v in gaps.items())
        + f"; tol {SHORT_EVAL_RTOL} relative")
    if set(gpu) != set(cpu) or any(v > SHORT_EVAL_RTOL for v in gaps.values()):
        raise AssertionError("the card and the CPU disagree on a small OPT evaluation")


def phase_small_mlp(dev):
    from ihmr_tpu_torch.pipeline import SHORT_MLP_TOL, run_short_mlp, short_mlp_gaps

    gaps, masks_equal = short_mlp_gaps(run_short_mlp(dev), run_short_mlp("cpu"))
    log("small MLP input (N=4, 3 stages x 1 epoch), card vs CPU: "
        + ", ".join(f"{k} max gap {v:.3e} (tol {SHORT_MLP_TOL[k]})" for k, v in gaps.items())
        + f"; accept masks equal: {masks_equal}")
    if any(v > SHORT_MLP_TOL[k] for k, v in gaps.items()) or not masks_equal:
        raise AssertionError("the card and the CPU disagree on a small MLP input")


def phase_small_train(dev):
    from ihmr_tpu_torch.pipeline import PARAMS_SHARE, SHORT_TRAIN_TOL, run_short_train, short_train_gaps

    zero_counts()
    gpu = run_short_train(dev)
    launches, graph = read_counts()["bn_stats"], read_graph_counts()
    gaps = short_train_gaps(gpu, run_short_train("cpu"))
    # 20 BatchNorms x (the graph's warm-up run + its capture): a replay launches K3 from the graph
    log(f"small training (ResNet-18 64x64, B=4, 2 steps), card vs CPU: bn_stats wrapper runs {launches} "
        f"(expected 40), the train step's graph {graph} (expected 1 capture, 2 replays); "
        + ", ".join(f"{k} gap {v:.3e} (tol {SHORT_TRAIN_TOL[k]})" for k, v in gaps.items())
        + f" ('params' over the closest {PARAMS_SHARE:.1%} of entries)")
    if launches != 40 or graph != dict(captures=1, replays=2) or any(v > SHORT_TRAIN_TOL[k] for k, v in gaps.items()):
        raise AssertionError("the card and the CPU disagree on a small training run")


CLI_N = 256  # samples of the command line's corpus


def _cli(argv):
    """One command through the port's CLI -> (its summary, launches, wall seconds)."""
    from ihmr_tpu_torch import cli

    zero_counts()
    t0 = time.perf_counter()
    out = cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return out, read_counts(), seconds


def _time_decode(img_dir):
    """Host ms per image of the port's PNG decode, and of its parts."""
    from ihmr_tpu_torch.data import image_io, native

    files = [os.path.join(img_dir, f) for f in sorted(os.listdir(img_dir))]
    blobs = [open(f, "rb").read() for f in files]
    image_io.imread(files[0])  # builds the native library (g++) outside the timing
    t0 = time.perf_counter()
    lines = [image_io.png_scanlines(b) for b in blobs]
    t1 = time.perf_counter()
    for h, w, ch, raw in lines:
        native.png_unfilter(raw, h, w * ch, ch)
    t2 = time.perf_counter()
    for f in files:
        image_io.imread(f)
    t3 = time.perf_counter()
    n = len(files)
    log(f"  PNG decode on this host, {n} images of 256x192 / 192x256: imread {(t3 - t2) / n * 1e3:.4f} ms each "
        f"(chunks and zlib inflate {(t1 - t0) / n * 1e3:.4f} ms, the row filters undone in C "
        f"{(t2 - t1) / n * 1e3:.4f} ms)")


def phase_cli_chain(dev, replayed_ms_per_step, ckpt_dir, work):
    """The five workload commands at full width on a corpus of files written
    under ``work`` (the rendering, visualizer and two-process phases reuse
    it); the checkpoints go to ``ckpt_dir`` (the serving phase serves them).
    Returns (launch counts, train ms/step, the metric_dict of each evaluation)."""
    from ihmr_tpu_torch.data.synthetic import write_corpus
    from ihmr_tpu_torch.refine import mlp_default

    log(f"command line: the five workload commands on N={CLI_N} PNG files, ResNet-50 224x224, full MANO mesh")
    counts = {}
    t0 = time.perf_counter()
    write_corpus(os.path.join(work, "corpus"), CLI_N, seed=0)
    log(f"  corpus written in {time.perf_counter() - t0:.2f}s")
    _time_decode(os.path.join(work, "corpus", "hand26m", "image"))
    common = _corpus_flags(work, ckpt_dir)
    pred, pgt = os.path.join(work, "chain_pred.pkl"), os.path.join(work, "pseudo_gt.pkl")
    cwd = os.getcwd()
    os.chdir(work)  # evaluate_results/ is written under the working directory
    try:
        os.environ["IHMR_BN_IMPL"] = "pallas"
        try:
            train, counts["cli_train"], sec = _cli(
                ["train-baseline", "--batchSize", "64", "--total_epoch", "1", "--save_epoch_freq", "1",
                 "--use_random_flip", "--use_random_rescale", "--use_random_position"] + common)
        finally:
            del os.environ["IHMR_BN_IMPL"]
        (epoch,) = train["epoch_stats"]
        steps = epoch["steps"]
        step_ms = epoch["step_seconds"] / steps * 1e3
        log(f"  train-baseline: {sec:.3f}s wall; {steps} steps, TimeStat data {epoch['data_seconds']:.3f}s, "
            f"forward {epoch['forward_seconds']:.3f}s -> {step_ms:.3f} ms/step, {64e3 / step_ms:.3f} images/sec "
            f"(phase 5's replayed batch in this run: {replayed_ms_per_step:.3f} ms/step, "
            f"{64e3 / replayed_ms_per_step:.3f} images/sec); total loss {epoch['total_loss']}; "
            f"launches {counts['cli_train']}; the train step's graph {read_graph_counts()}")
        # 53 BatchNorms, K3's wrapper run at the graph's warm-up and capture (the first step), the
        # replays launch K3 from the graph; collision loss off, no evaluation
        check_counts("train-baseline", counts["cli_train"], exact_collision=0, nearest_centroid=0, bn_stats=2 * 53)
        check_counts("train-baseline's graph", read_graph_counts(), captures=1, replays=steps)
        if steps != CLI_N // 64 or not np.isfinite(epoch["total_loss"]).all():
            raise AssertionError(f"train-baseline ran {steps} steps, losses {epoch['total_loss']}")

        commands = [
            ("cli_test_baseline", ["test-baseline", "--batchSize", "64", "--export_pred", pred],
             # one eval_step per batch: one exact pass (both directions in one launch), eval-mode BatchNorm
             dict(exact_collision=CLI_N // 64, nearest_centroid=0, bn_stats=0)),
            ("cli_optimize", ["optimize", "--pred_path", pred, "--batchSize", "128", "--stage_epochs", "20",
                              "--export_pseudo_gt", pgt],
             # one optimize_batch per batch, each ending in one exact pass
             dict(exact_collision=CLI_N // 128, nearest_centroid=0, bn_stats=0)),
            ("cli_train_mlp", ["train-mlp", "--pred_path", pred, "--use_opt_params", "--opt_params_path", pgt,
                               "--batchSize", "128", "--stage_epochs", "2"],
             # K2 once per train step (6 stages x 2 epochs x 2 batches); K1 in the warm pass and in each
             # stage's selection pass, once per batch
             dict(exact_collision=(1 + len(mlp_default)) * CLI_N // 128,
                  nearest_centroid=len(mlp_default) * 2 * CLI_N // 128, bn_stats=0)),
            ("cli_test_mlp", ["test-mlp", "--pred_path", pred, "--batchSize", "128"],
             # the cascade per batch: the seed pass, one per stage and the final pass
             dict(exact_collision=(len(mlp_default) + 2) * CLI_N // 128, nearest_centroid=0, bn_stats=0)),
        ]
        metrics = {}
        for path, argv, expected in commands:
            out, counts[path], sec = _cli(argv + common)
            log(f"  {argv[0]}: {sec:.3f}s wall, {out['seconds']:.3f}s in its loops: data {out['data_seconds']:.3f}s, "
                f"the rest (device work and its dispatch, the Evaluator) {out['forward_seconds']:.3f}s; "
                f"launches {counts[path]} (expected {expected})")
            check_counts(argv[0], counts[path], **expected)
            if "evaluator" in out:
                if len(out["evaluator"].pred_results) != CLI_N:
                    raise AssertionError(f"{argv[0]}: {len(out['evaluator'].pred_results)} results")
                metrics[argv[0]] = _check_metrics(argv[0], out["evaluator"])
            else:
                stats = out["stage_stats"]
                log("  " + "; ".join(f"stage {s['stage']} accept {s['accepted_frac']:.3f}" for s in stats))
                if not bool(out["caches"].exists.all()) or not all(np.isfinite(s["select_after"]) for s in stats):
                    raise AssertionError("train-mlp left samples uncached or non-finite")
        written = sorted(os.listdir(os.path.join(work, "evaluate_results")))
        if written != ["baseline", "mlp", "optimize"] or not (os.path.exists(pred) and os.path.exists(pgt)):
            raise AssertionError(f"the command line wrote {written}")
    finally:
        os.chdir(cwd)
    log("  metric_dict of the command line's evaluations: " + json.dumps(metrics))
    return counts, step_ms, metrics


ENCODE_REPS = 20  # timed encodes of the 896x448 case
RENDER_TIMEOUT = 600  # s: a forked render that has not finished by then fails the run (a hung worker)
DISPLAY_FREQ = 8  # samples between training displays in phase 16


def phase_jpeg_encoder(smi):
    """Phase 14: the port's JPEG writer against cv2's bytes, by the committed
    digests, and its host time per 896x448 encode (a render's size)."""
    from ihmr_tpu_torch.data import image_cases, image_io

    t0 = time.perf_counter()
    written = image_cases.check_encoder()
    log(f"JPEG writer: {len(written)} cases ({', '.join(f'{k} {v} B' for k, v in written.items())}) written as the "
        f"bytes cv2.imencode writes (tests/data/jpeg/{image_cases.ENCODE_FILE}), in {time.perf_counter() - t0:.2f}s")
    img = image_cases.encode_inputs()["ramps_896x448"]
    log(f"  host ms per 896x448 encode (quality 95, 4:2:0): "
        f"{_host_ms(lambda: image_io.encode_jpeg(img), ENCODE_REPS):.3f} (on this host, beside {smi})")


class _Hang(BaseException):
    """A block ran past its time limit. Not an ``Exception``: no handler in
    the program under test (``render_results`` catches OSError and ValueError
    to render serially) may take it for an error it can recover from."""


@contextlib.contextmanager
def _time_limit(seconds, what):
    """Raise _Hang in the main thread when the block runs longer."""
    def expire(signum, frame):
        raise _Hang(f"{what} did not finish within {seconds} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _files(d):
    return {n: open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d))}


_RENDER_PIDS = {"dir": None, "one": None}  # set before a render forks, inherited by its workers


def _render_recording_pid(task):
    """``evaluator._render_one_result`` that first leaves a file named by its
    process id in ``_RENDER_PIDS["dir"]`` (module level: the pool pickles it
    by name)."""
    open(os.path.join(_RENDER_PIDS["dir"], str(os.getpid())), "a").close()
    return _RENDER_PIDS["one"](task)


@contextlib.contextmanager
def _forked_render(pid_dir, what):
    """Run the block with every render recorded by process id, then fail
    unless the renders ran in forked workers alone: a pool refused at once,
    or a worker's OSError / ValueError, sends ``render_results`` to its
    serial path in this process, which must not pass for the forked one."""
    from ihmr_tpu_torch.eval import evaluator as EV

    os.makedirs(pid_dir)
    _RENDER_PIDS.update(dir=pid_dir, one=EV._render_one_result)
    EV._render_one_result = _render_recording_pid
    try:
        yield
    finally:
        EV._render_one_result = _RENDER_PIDS["one"]
    pids = {int(n) for n in os.listdir(pid_dir)}
    if not pids or os.getpid() in pids:
        raise AssertionError(f"{what}: renders ran in processes {sorted(pids)}, the main process is {os.getpid()}: "
                             f"the forked path did not carry them all")
    log(f"  {what}: renders ran in {len(pids)} forked worker processes, none in the main process")


def _corpus_flags(work, ckpt_dir):
    return ["--data_root", os.path.join(work, "corpus"), "--anno_path", "anno.pkl", "--synthetic_mano",
            "--checkpoints_dir", ckpt_dir, "--device", "cuda"]


def phase_render(smi, work, ckpt_dir):
    """Phase 15: test-baseline --visualize_eval on phase 7's corpus and
    checkpoint (256 renders forked over 16 workers under a time limit), the
    same results rendered serially, then visualize --limit 16 on its pkl."""
    from ihmr_tpu_torch.data import image_io
    from ihmr_tpu_torch.eval import evaluator as EV
    from ihmr_tpu_torch.utils import io_utils

    renders, inner = [], EV.Evaluator.render_results

    def timed(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = inner(self, *args, **kwargs)
        renders.append(time.perf_counter() - t0)
        return out

    pkl = os.path.join(work, "evaluate_results", "baseline", "hand26m.pkl")
    cwd = os.getcwd()
    os.chdir(work)
    EV.Evaluator.render_results = timed
    try:
        with _forked_render(os.path.join(work, "pids_visualize_eval"), "test-baseline --visualize_eval"), \
                _time_limit(RENDER_TIMEOUT, "test-baseline --visualize_eval"):
            out, counts, seconds = _cli(["test-baseline", "--batchSize", "64", "--visualize_eval"]
                                        + _corpus_flags(work, ckpt_dir))
    finally:
        EV.Evaluator.render_results = inner
        os.chdir(cwd)
    forked = _files(os.path.join(work, "evaluate_results", "baseline", "hand26m", "images"))
    log(f"rendering: test-baseline --visualize_eval on phase 7's {CLI_N} files and checkpoint: {seconds:.3f}s wall, "
        f"render {renders[0]:.3f}s for {len(forked)} results ({renders[0] / max(len(forked), 1) * 1e3:.3f} ms each, "
        f"forked workers), launches {counts} (on {smi})")
    check_counts("test-baseline --visualize_eval", counts, exact_collision=CLI_N // 64, nearest_centroid=0,
                 bn_stats=0)
    shapes = {image_io.decode_jpeg(data, name).shape for name, data in forked.items()}
    if len(forked) != CLI_N or shapes != {(896, 448, 3)}:
        raise AssertionError(f"--visualize_eval wrote {len(forked)} files of shapes {shapes}")
    _check_metrics("test-baseline --visualize_eval", out["evaluator"])

    evaluator = io_utils.load_pkl(pkl)
    t0 = time.perf_counter()
    evaluator.render_results(os.path.join(work, "render_serial"), num_workers=1)
    serial_s = time.perf_counter() - t0
    serial = _files(os.path.join(work, "render_serial"))
    differ = [n for n in forked if serial.get(n) != forked[n]]
    log(f"  the same results rendered one after another: {serial_s:.3f}s ({serial_s / CLI_N * 1e3:.3f} ms each); "
        f"{CLI_N - len(differ)} of {CLI_N} files byte-equal to the forked ones (on {smi})")
    if differ or len(serial) != CLI_N:
        raise AssertionError(f"serial and forked renders differ: {differ[:4]}")

    vis_dir = os.path.join(work, "visualize16")
    with _forked_render(os.path.join(work, "pids_visualize"), "visualize"), _time_limit(RENDER_TIMEOUT, "visualize"):
        out_v, counts_v, seconds_v = _cli(["visualize", "--results", pkl, "--limit", "16", "--out_dir", vis_dir])
    objs, imgs = _files(os.path.join(vis_dir, "objs")), _files(os.path.join(vis_dir, "images"))
    log(f"  visualize --limit 16: {seconds_v:.3f}s, {len(objs)} .obj and {len(imgs)} .jpg files, launches {counts_v} "
        f"(on {smi})")
    check_counts("visualize", counts_v, exact_collision=0, nearest_centroid=0, bn_stats=0)
    if len(objs) != 16 or len(imgs) != 16 or any(forked.get(n) != data for n, data in imgs.items()):
        raise AssertionError("visualize did not write the 16 files test-baseline --visualize_eval rendered")
    return {"cli_visualize_eval": counts, "cli_visualize": counts_v}


def _http_get(port, path):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.status, r.headers["Content-Type"], r.read()


def phase_display(smi, work):
    """Phase 16: train-baseline --display_freq 8 --live_port 0 for one epoch
    of phase 7's corpus (checkpoints in a directory of their own): the
    gallery, its index.html, the loss curves' line and the live monitor
    over HTTP; K1 once per display."""
    ckpt = os.path.join(work, "ckpt_display")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        out, counts, seconds = _cli(["train-baseline", "--batchSize", "64", "--total_epoch", "1", "--display_freq",
                                     str(DISPLAY_FREQ), "--live_port", "0"] + _corpus_flags(work, ckpt))
    finally:
        os.chdir(cwd)
    vis = out["visualizer"]
    try:
        (epoch,) = out["epoch_stats"]
        displays = len(vis._gallery)
        files = sorted(os.listdir(vis.img_dir))
        html = open(os.path.join(vis.web_dir, "index.html")).read()
        log(f"training visuals: train-baseline --display_freq {DISPLAY_FREQ} --live_port 0, {epoch['steps']} steps "
            f"of 64: {seconds:.3f}s wall, steps {epoch['step_seconds']:.3f}s, the rest (displays, checkpoint) "
            f"{seconds - epoch['step_seconds']:.3f}s; {displays} displays, {len(files)} PNG panels, launches {counts} "
            f"(on {smi})")
        if displays != epoch["steps"] or len(files) != 5 * displays or not all(f'src="images/{f}"' in html for f in files):
            raise AssertionError(f"{displays} displays, {len(files)} panels, index.html lists "
                                 f"{sum(f in html for f in files)}")
        curves = os.path.join(vis.web_dir, "loss_curves.png")
        if vis.curves_skipped is not None:
            log(f"  loss curves skipped on this machine: {vis.curves_skipped}")
        elif not os.path.exists(curves):
            raise AssertionError("loss curves neither drawn nor skipped")
        else:
            log("  loss curves drawn (matplotlib present)")
        port = vis.dashboard.port
        page, losses, image = (_http_get(port, p) for p in ("/", "/losses.json", f"/images/{files[0]}"))
        series = json.loads(losses[2])["series"]
        log(f"  live monitor on port {port}: / {page[0]} {page[1]} {len(page[2])} B; /losses.json {losses[0]} with "
            f"{ {k: len(v) for k, v in series.items()} } points; /images/{files[0]} {image[0]} {len(image[2])} B "
            f"(on {smi})")
        want = open(os.path.join(vis.img_dir, files[0]), "rb").read()
        if (page[0], losses[0], image[0]) != (200, 200, 200) or b"live training monitor" not in page[2] \
                or len(series.get("total_loss", [])) != displays or image[2] != want:
            raise AssertionError("the live monitor did not serve the run's page, losses and panels")
    finally:
        vis.dashboard.stop()
    check_counts("train-baseline --display_freq", counts, exact_collision=displays, nearest_centroid=0, bn_stats=0)
    return {"cli_display": counts}


_RANK_WORKER = r"""
import json, os, sys, time
repo, work, port, rank, argv = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4]), json.loads(sys.argv[5])
sys.path.insert(0, repo)
os.makedirs(os.path.join(work, f"rank{rank}"), exist_ok=True)
os.chdir(os.path.join(work, f"rank{rank}"))  # each rank writes its own evaluate_results/
import torch
from ihmr_tpu_torch import cli
from ihmr_tpu_torch import profiling
from ihmr_tpu_torch.parallel import dist
from ihmr_tpu_torch.train import loops

seen, inner = [], loops._to_baseline_batch
def recording(raw, device=None):
    seen.extend(int(i) for i in raw["index"])
    return inner(raw, device)
loops._to_baseline_batch = recording
t0 = time.perf_counter()
out = cli.main(argv + ["--rank", str(rank), "--world_size", "2"])
torch.cuda.synchronize()
seconds = time.perf_counter() - t0
r, w = dist.initialize(f"127.0.0.1:{port}", num_processes=2, process_id=rank)
t1 = time.perf_counter()
merged = dist.gather_evaluators(out["evaluator"], os.path.join(work, "gather"), "test_baseline", r, w)
report = dict(rank=r, world=w, indices=seen, seconds=seconds, gather_seconds=time.perf_counter() - t1,
              launches={name: profiling.counters().get(c, 0) for name, c in
                        dict(exact_collision="k1.launches", nearest_centroid="k2.launches", bn_stats="k3.launches").items()})
if r == 0:
    report["merged"] = dict(n=len(merged.pred_results), unique=len({p["img_path_relative"] for p in merged.pred_results}),
                            metrics=dict(merged.metric_dict()))
dist.barrier("done")
print("RESULT " + json.dumps(report), flush=True)
"""


def phase_two_processes(smi, work, ckpt_dir, single_md):
    """Phase 17: test-baseline --rank r --world_size 2 in two processes on
    the one card, then a gloo rendezvous through parallel.dist and rank 0's
    gather_evaluators; the merged metric_dict against phase 7's
    single-process one."""
    import socket

    from ihmr_tpu_torch.pipeline import SHORT_EVAL_RTOL

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    argv = ["test-baseline", "--batchSize", "64"] + _corpus_flags(work, ckpt_dir)
    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", _RANK_WORKER, repo, work, str(port), str(rank), json.dumps(argv)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for rank in range(2)]
    try:
        outs = [p.communicate(timeout=900) for p in procs]
    finally:
        for p in procs:
            p.kill()
    wall = time.perf_counter() - t0
    reports = []
    for p, (out, err) in zip(procs, outs):
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        if p.returncode != 0 or not lines:
            raise AssertionError(f"a rank failed (exit {p.returncode}):\n{out[-2000:]}\n{err[-4000:]}")
        reports.append(json.loads(lines[-1][len("RESULT "):]))
    shards = [set(r["indices"]) for r in reports]
    merged = reports[0]["merged"]
    gaps = {k: abs(merged["metrics"][k] - v) / max(abs(v), 1e-12) for k, v in single_md.items()}
    log(f"two processes on the one card: test-baseline --rank r --world_size 2, {wall:.3f}s wall for both (ranks "
        f"{reports[0]['seconds']:.3f}s / {reports[1]['seconds']:.3f}s in cli.main, each process's start included in "
        f"the wall time), shards of {len(shards[0])} and {len(shards[1])} samples, gloo gather "
        f"{reports[0]['gather_seconds']:.3f}s; rank 0 merged {merged['n']} results; metric_dict "
        + ", ".join(f"{k} {merged['metrics'][k]:.6f} vs {v:.6f}" for k, v in single_md.items())
        + f"; largest relative gap {max(gaps.values()):.3e} (tol {SHORT_EVAL_RTOL}; on {smi})")
    if shards[0] & shards[1] or shards[0] | shards[1] != set(range(CLI_N)) or merged["unique"] != CLI_N:
        raise AssertionError("the two ranks' shards overlap or do not cover the corpus")
    if set(merged["metrics"]) != set(single_md) or max(gaps.values()) > SHORT_EVAL_RTOL:
        raise AssertionError("the gathered metrics differ from the single process's")
    for r in reports:
        check_counts(f"rank {r['rank']}", r["launches"], exact_collision=CLI_N // 128, nearest_centroid=0, bn_stats=0)
    return {"cli_two_process": {k: sum(r["launches"][k] for r in reports) for k in reports[0]["launches"]}}


def _host_ms(fn, reps):
    """Host ms per call of ``fn`` over ``reps`` calls after one untimed call."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def _time_jpeg_and_augmentations(smi):
    """Host ms per image of the JPEG decode and of each augmentation, on the
    augmentation cases' input (a corpus JPEG letterboxed to 224x224)."""
    import random

    from ihmr_tpu_torch.data import cv_ops, image_io
    from ihmr_tpu_torch.data import preprocess as pp
    from ihmr_tpu_torch.data.image_cases import FIXTURE_DIR, augmentation_input
    from ihmr_tpu_torch.data.synthetic import BLUR_PSFS, CORPUS_SHAPES, motion_psf

    files = [os.path.join(FIXTURE_DIR, f"corpus_{h}x{w}.jpg") for h, w in CORPUS_SHAPES]
    decoded = image_io.imread(files[0])
    src = augmentation_input()
    angles = [180.0 / 10 * i - 90 for i in range(10)]
    rng = random.Random(0)
    times = {
        "JPEG decode (256x192 / 192x256, 4:2:0)": _host_ms(lambda: [image_io.imread(f) for f in files], 64) / 2,
        "rotate_image (warpAffine, the ten angles in turn)": _host_ms(
            lambda: [pp.rotate_image(src, a) for a in angles], 16) / 10,
        "color_jitter": _host_ms(lambda: pp.color_jitter(src, rng), 64),
        "BGR -> HSV": _host_ms(lambda: cv_ops.bgr_to_hsv(src), 64),
        "HSV -> BGR": _host_ms(lambda: cv_ops.hsv_to_bgr(src), 64),
        **{f"filter2d {size}x{size} PSF": _host_ms(lambda k=motion_psf(size, angle): cv_ops.filter2d(src, k), 64)
           for size, angle in BLUR_PSFS},
        "padding_and_resize (256x192 -> 224x224)": _host_ms(
            lambda: pp.padding_and_resize(decoded, np.zeros((42, 3), np.float32), 224), 64),
        "normalize_image": _host_ms(lambda: pp.normalize_image(src), 64),
    }
    log(f"  host ms per image on this card's host ({smi}; numpy {np.__version__}), 224x224x3 unless named: "
        + "; ".join(f"{name} {ms:.4f}" for name, ms in times.items()))
    return times


def phase_cli_jpeg(dev, smi, replayed_ms_per_step, png_ms_per_step):
    """IHMR-Baseline training as scripts/train_baseline.sh runs it, from JPEG
    files: every data flag of the launcher, then test-baseline on the same files."""
    import tempfile

    from ihmr_tpu_torch.data.image_cases import FIXTURE_DIR, check_fixtures
    from ihmr_tpu_torch.data.synthetic import BLUR_PSFS, CORPUS_SHAPES, use_jpeg_images, write_blur_kernels, write_corpus

    checked = check_fixtures()
    log(f"JPEG and augmentations on the card's host: {len(checked['decoded'])} fixtures decode to cv2's bytes "
        f"({', '.join(checked['decoded'])}); {checked['cases']} augmentation cases give cv2's results (warpAffine at "
        f"the ten angles, HSV both ways and three colour jitters byte for byte; filter2D max |diff|, share: "
        + ", ".join(f"{s}x{s} {d} {share:.2e}" for s, (d, share) in checked["filter2d"].items())
        + ", bound 1 on 1e-4)")
    times = _time_jpeg_and_augmentations(smi)
    counts = {}
    with tempfile.TemporaryDirectory() as work:
        root, blur = os.path.join(work, "corpus"), os.path.join(work, "blur_kernel")
        write_corpus(root, CLI_N, seed=0)
        use_jpeg_images(root, [os.path.join(FIXTURE_DIR, f"corpus_{h}x{w}.jpg") for h, w in CORPUS_SHAPES])
        write_blur_kernels(blur)
        log(f"  command line on N={CLI_N} JPEG files (the fixtures, as write_corpus's annotations place them), "
            f"motion-blur PSFs {', '.join(f'{s}x{s} at {a} deg' for s, a in BLUR_PSFS)} in {blur}")
        common = ["--data_root", root, "--anno_path", "anno.pkl", "--synthetic_mano", "--batchSize", "64",
                  "--checkpoints_dir", os.path.join(work, "ckpt"), "--device", "cuda"]
        cwd = os.getcwd()
        os.chdir(work)
        try:
            os.environ["IHMR_BN_IMPL"] = "pallas"
            try:
                # scripts/train_baseline.sh's flags, its epochs cut to one (4 steps)
                train, counts["cli_jpeg_train"], sec = _cli(
                    ["train-baseline", "--lr", "1e-4", "--lr_decay_type", "cosine", "--total_epoch", "1",
                     "--save_epoch_freq", "1", "--use_random_flip", "--use_random_rescale", "--use_random_position",
                     "--use_random_rotation", "--use_color_jittering", "--use_motion_blur", "--blur_kernel_dir", blur]
                    + common)
            finally:
                del os.environ["IHMR_BN_IMPL"]
            (epoch,) = train["epoch_stats"]
            steps = epoch["steps"]
            step_ms = epoch["step_seconds"] / steps * 1e3
            log(f"  train-baseline with every augmentation, JPEG: {sec:.3f}s wall; {steps} steps, TimeStat data "
                f"{epoch['data_seconds']:.3f}s, forward {epoch['forward_seconds']:.3f}s -> {step_ms:.3f} ms/step, "
                f"{64e3 / step_ms:.3f} images/sec, on {smi}; in this run: phase 7's PNG files (flip, rescale, "
                f"position) {png_ms_per_step:.3f} ms/step, {64e3 / png_ms_per_step:.3f} images/sec; phase 5's "
                f"replayed batch {replayed_ms_per_step:.3f} ms/step, {64e3 / replayed_ms_per_step:.3f} images/sec; "
                f"total loss {epoch['total_loss']}; launches {counts['cli_jpeg_train']}; the train step's graph "
                f"{read_graph_counts()}")
            # K3's wrapper at the graph's warm-up and capture, as in phase 7
            check_counts("train-baseline (JPEG)", counts["cli_jpeg_train"], exact_collision=0, nearest_centroid=0,
                         bn_stats=2 * 53)
            check_counts("train-baseline (JPEG)'s graph", read_graph_counts(), captures=1, replays=steps)
            if steps != CLI_N // 64 or not np.isfinite(epoch["total_loss"]).all():
                raise AssertionError(f"train-baseline (JPEG) ran {steps} steps, losses {epoch['total_loss']}")
            out, counts["cli_jpeg_test"], sec = _cli(["test-baseline"] + common)
            log(f"  test-baseline, JPEG: {sec:.3f}s wall, {out['seconds']:.3f}s in its loop: data "
                f"{out['data_seconds']:.3f}s, the rest {out['forward_seconds']:.3f}s; launches {counts['cli_jpeg_test']}")
            # one eval_step per batch: one exact pass, eval-mode BatchNorm
            check_counts("test-baseline (JPEG)", counts["cli_jpeg_test"], exact_collision=CLI_N // 64,
                         nearest_centroid=0, bn_stats=0)
            if len(out["evaluator"].pred_results) != CLI_N:
                raise AssertionError(f"test-baseline (JPEG): {len(out['evaluator'].pred_results)} results")
            _check_metrics("test-baseline (JPEG)", out["evaluator"])
        finally:
            os.chdir(cwd)
    loaded = [m for m in ("cv2", "PIL") if m in sys.modules]
    log(f"  image libraries imported in this run: {loaded or 'none'} (cv2 and PIL must not be); host ms: "
        + json.dumps({k: round(v, 4) for k, v in times.items()}))
    if loaded:
        raise AssertionError(f"{loaded} imported")
    return counts


def phase_cli_small(dev):
    """optimize through the CLI on a 4-sample corpus, card against CPU."""
    import tempfile

    from ihmr_tpu_torch import cli
    from ihmr_tpu_torch.data.synthetic import write_corpus
    from ihmr_tpu_torch.pipeline import SHORT_EVAL_RTOL

    with tempfile.TemporaryDirectory() as work:
        write_corpus(os.path.join(work, "corpus"), 4, seed=1)
        argv = ["optimize", "--data_root", os.path.join(work, "corpus"), "--anno_path", "anno.pkl", "--pred_path",
                "pred.pkl", "--batchSize", "2", "--synthetic_mano", "--stage_epochs", "20"]
        cwd = os.getcwd()
        os.chdir(work)
        try:
            runs = {d: cli.main(argv + ["--device", d])["evaluator"] for d in ("cuda", "cpu")}
        finally:
            os.chdir(cwd)
    gpu, cpu = runs["cuda"], runs["cpu"]
    keys = ("pred_cam_params", "pred_pose_params", "pred_shape_params", "pred_hand_trans")
    err = max(float(np.abs(a[k] - b[k]).max()) for a, b in zip(gpu.pred_results, cpu.pred_results) for k in keys)
    mg, mc = gpu.metric_dict(), cpu.metric_dict()
    gaps = {k: abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-12) for k in mc}
    log(f"command line optimize on 4 samples (B=2, 4 x 21 steps), card vs CPU: params max |err| {err:.3e} "
        f"(tol {SMALL_PARAM_TOL}); metric_dict " + ", ".join(f"{k} {mg[k]:.6f} vs {mc[k]:.6f}" for k in mc)
        + f"; largest relative gap {max(gaps.values()):.3e} (tol {SHORT_EVAL_RTOL})")
    if err > SMALL_PARAM_TOL or set(mg) != set(mc) or any(v > SHORT_EVAL_RTOL for v in gaps.values()):
        raise AssertionError("the card and the CPU disagree on the command line's optimize")
    loaded = [m for m in ("cv2", "PIL") if m in sys.modules]
    log(f"  image libraries imported in this run: {loaded or 'none'} (cv2 and PIL must not be)")
    if loaded:
        raise AssertionError(f"{loaded} imported")


COLLISION_EPOCH = 40  # each opt_default stage cut to 41 steps in phase 13 (the full schedule has 301)
COLLISION_BATCH = 128
LOOP_GRAD_TOL = 1e-5  # K1's in-loop gradient vs the plain version's, of its largest entry (as the CUDA test)
ESCALATE_THRESHOLD = 0.5  # scripts/escalation_bench.py's threshold


def _opt_run(mano, params, batch, config, smi, label):
    """optimize_batch over opt_default cut to COLLISION_EPOCH, from counts
    zeroed just before it and read just after -> (refined params, results,
    launch counts, hands/sec, peak GiB)."""
    from ihmr_tpu_torch.refine import opt_default, optimize_batch

    strategy = tuple(dataclasses.replace(s, epoch=COLLISION_EPOCH) for s in opt_default)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    params_out, results = optimize_batch(mano, params, batch, strategy, config)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    B = batch.hand_type_array.shape[0]
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  {label}: {dt:.3f}s -> {B / dt:.3f} hands/sec, peak device memory {peak:.3f} GiB, launches {counts}, "
        f"final mean collision {float(results['collision_loss'].mean()):.5f} (on {smi})")
    bad = [k for k, v in {**params_out, **results}.items() if not bool(torch.isfinite(v).all())]
    if bad:
        raise AssertionError(f"{label}: non-finite outputs {bad}")
    return params_out, results, counts, B / dt, peak


def _escalation(mano, variant, smi):
    """Part (a) on one family: the escalated run with pass 1 and pass 2
    recorded (``optimize_batch`` is what escalation calls for each pass)."""
    from ihmr_tpu_torch.data import make_opt_inputs
    from ihmr_tpu_torch.refine import OptConfig
    from ihmr_tpu_torch.refine import opt_engine as TE

    params, batch = make_opt_inputs(mano, batch=COLLISION_BATCH, seed=0, variant=variant)
    passes, inner = [], TE.optimize_batch

    def recording(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        torch.cuda.synchronize()
        passes.append((args[2].hand_type_array.shape[0], out, time.perf_counter() - t0))
        return out

    TE.optimize_batch = recording
    try:
        out, res, counts, rate, peak = _opt_run(
            mano, params, batch, OptConfig(save_mid_freq=10, escalate_collision=ESCALATE_THRESHOLD), smi,
            f"escalation on the {variant} family (threshold {ESCALATE_THRESHOLD})")
    finally:
        TE.optimize_batch = inner
    (_, (p1, r1), pass1_s) = passes[0]
    coll1, coll = r1["collision_loss"], res["collision_loss"]
    flagged = int((coll1 > ESCALATE_THRESHOLD).sum())
    esc = res["escalated"].bool()
    bucket = passes[1][0] if len(passes) > 1 else 0
    pass2_s = passes[1][2] if len(passes) > 1 else 0.0
    log(f"    flagged {flagged}/{COLLISION_BATCH}, bucket {bucket}, escalated {int(esc.sum())}; mean exact final collision pass 1 "
        f"{float(coll1.mean()):.5f}, merged {float(coll.mean()):.5f}; pass 1 {pass1_s:.3f}s, pass 2 {pass2_s:.3f}s")
    if len(passes) != (2 if flagged else 1) or (flagged and bucket < flagged):
        raise AssertionError(f"escalation ran {len(passes)} passes (bucket {bucket}) for {flagged} flagged samples")
    if bool((coll > coll1).any()):
        raise AssertionError("escalation raised a sample's exact collision")
    kept = ~esc
    if not all(torch.equal(out[k][kept], p1[k][kept]) for k in out) or not torch.equal(coll[kept], coll1[kept]):
        raise AssertionError("escalation changed a sample it did not escalate")
    if bool((esc & (coll1 <= ESCALATE_THRESHOLD)).any()):
        raise AssertionError("escalation took a sample it did not flag")
    check_counts(f"escalation ({variant})", counts, exact_collision=2 if flagged else 1, nearest_centroid=0,
                 bn_stats=0)
    return counts, dict(flagged=flagged, bucket=bucket, escalated=int(esc.sum()), rate=rate, peak=peak,
                        coll1=float(coll1.mean()), coll=float(coll.mean()))


@contextlib.contextmanager
def _k1_plain_version():
    """K1's wrapper takes its plain version on the card instead of launching
    the kernel (for comparisons only: nothing is counted)."""
    from ihmr_tpu_torch.ops import exact_collision as K

    launch = K._launch_kernel
    K._launch_kernel = lambda q, tri, bounds, n_tri: K.exact_penetration_depth_reference(q, tri, bounds, n_tri)[:2]
    try:
        yield
    finally:
        K._launch_kernel = launch


def _k1_loop_checks(mano, params, batch, config, label):
    """K1 at the shape the loop gives it: both directions of the hands at
    ``params`` against every ``loop_collision_face_subsample``-th face, kernel
    against plain version; then one in-loop step's collision gradient (the
    kernel's forward and its dir-based backward) against the same step with
    the plain version, on the same card and inputs."""
    from ihmr_tpu_torch import kernel_cases
    from ihmr_tpu_torch.refine import compute_losses, forward, opt_default

    fsub = config.loop_collision_face_subsample
    with torch.no_grad():
        rv, lv, _, _ = forward(mano, params)
    q, tri = kernel_cases.hand_pair(mano, rv, lv, fsub)
    _compare_exact(q, tri, f"K1 in the loop, {label}, faces[::{fsub}]")

    def coll_grads():
        leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        _, aux = compute_losses(mano, leaves, batch, opt_default[1].weights, config, in_loop=True)
        grads = torch.autograd.grad(aux["collision_loss"], list(leaves.values()), allow_unused=True)
        return {k: g for k, g in zip(leaves, grads) if g is not None}

    zero_counts()
    kernel = coll_grads()
    launches = read_counts()["exact_collision"]
    with _k1_plain_version():
        plain = coll_grads()
    scale = max(float(g.abs().max()) for g in plain.values())
    err = max(float((kernel[k] - plain[k]).abs().max()) for k in plain)
    log(f"  [K1 in the loop, {label}] one step's collision gradient over {sorted(plain)}: kernel vs plain version "
        f"max |gap| {err:.3e}, largest entry {scale:.3e} (tol {LOOP_GRAD_TOL} of it); {launches} K1 launch")
    if launches != 1 or kernel.keys() != plain.keys() or not err <= LOOP_GRAD_TOL * scale:
        raise AssertionError(f"K1 in the loop ({label}): {launches} launches, gradient gap {err} of {scale}")


def phase_collision_modes(dev, smi):
    """Phase 13: every in-loop collision path at full width."""
    from ihmr_tpu_torch.data import make_opt_inputs
    from ihmr_tpu_torch.mano import synthetic_mano_model
    from ihmr_tpu_torch.refine import OptConfig
    from ihmr_tpu_torch.refine import opt_engine as TE

    log(f"in-loop collision paths: opt_default with every stage cut to epoch {COLLISION_EPOCH} "
        f"({COLLISION_EPOCH + 1} of 301 steps), save_mid_freq=10, B={COLLISION_BATCH}, full MANO mesh, on {smi}")
    mano = synthetic_mano_model(device=dev)
    counts = {}
    for variant in ("interlocked", "standard"):
        counts[f"coll_escalation_{variant}"], _ = _escalation(mano, variant, smi)

    params, batch = make_opt_inputs(mano, batch=COLLISION_BATCH, seed=0)
    grid = OptConfig(save_mid_freq=10, loop_collision_fast=False, collision_backend="grid")
    builds, build_grids = [], TE.pair_grids

    def timed_build(*args, **kwargs):  # the payload rebuilds' share of the run
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = build_grids(*args, **kwargs)
        torch.cuda.synchronize()
        builds.append(time.perf_counter() - t0)
        return out

    TE.pair_grids = timed_build
    try:
        _, _, counts["coll_grid"], _, _ = _opt_run(
            mano, params, batch, grid, smi, "grid in the loop (res 32, K=8, full faces: JAX's default knobs)")
    finally:
        TE.pair_grids = build_grids
    log(f"    {len(builds)} grid builds (both hands of {COLLISION_BATCH} samples each): {sum(builds):.3f}s in all, "
        f"{min(builds):.3f}-{max(builds):.3f}s each")
    check_counts("grid in the loop", counts["coll_grid"], exact_collision=1, nearest_centroid=0, bn_stats=0)

    configs = dict(default=OptConfig(save_mid_freq=10), eager=OptConfig(save_mid_freq=10, loop_collision_lazy_reselect=False),
                   tracked=OptConfig(save_mid_freq=10, loop_collision_freeze_positions=False))
    rates = {name: [] for name in configs}
    for name in ("default", "eager", "tracked", "tracked", "eager", "default"):  # in turns
        _, _, c, rate, _ = _opt_run(mano, params, batch, configs[name], smi, f"{name} (in turns)")
        check_counts(name, c, exact_collision=1, nearest_centroid=0, bn_stats=0)
        rates[name].append(rate)
        counts[f"coll_{name}"] = c
    log("  in turns, hands/sec: " + ", ".join(f"{n} {r[0]:.3f} / {r[1]:.3f}" for n, r in rates.items())
        + f" (on {smi})")
    del counts["coll_default"]

    exact = OptConfig(save_mid_freq=10, loop_collision_fast=False, loop_collision_subsample=1)
    _k1_loop_checks(mano, params, batch, exact, "the run's initial params")
    out, _, counts["coll_k1_loop"], _, _ = _opt_run(mano, params, batch, exact, smi, "K1 in the loop (stride 1)")
    _k1_loop_checks(mano, out, batch, exact, "the run's refined params")
    steps = 4 * (COLLISION_EPOCH + 1)
    check_counts("K1 in the loop", counts["coll_k1_loop"], exact_collision=steps + 1, nearest_centroid=0,
                 bn_stats=0)
    log(f"    K1 launched {counts['coll_k1_loop']['exact_collision']} times: {steps} gradient steps + the final pass")
    return counts


TWO_LEVEL_GROUP = 8  # faces a cluster in phase 18 (the JAX package's default cluster_group)


def phase_two_level(dev, smi):
    """Phase 18: the 2-level hierarchy in the loop (loop_collision_cluster=8)
    and the merged payload builder (IHMR_PAYLOAD_FUSED's switch), each in
    turns with the default engine, at phase 13's shape."""
    from ihmr_tpu_torch.data import make_opt_inputs
    from ihmr_tpu_torch.mano import synthetic_mano_model
    from ihmr_tpu_torch.refine import OptConfig
    from ihmr_tpu_torch.refine import opt_engine as TE

    log(f"2-level hierarchy and merged payload builder: opt_default cut to epoch {COLLISION_EPOCH}, B={COLLISION_BATCH}, "
        f"each in turns with the default engine (on {smi})")
    mano = synthetic_mano_model(device=dev)
    params, batch = make_opt_inputs(mano, batch=COLLISION_BATCH, seed=0)
    configs = {"default": OptConfig(save_mid_freq=10),
               "two_level": OptConfig(save_mid_freq=10, loop_collision_cluster=TWO_LEVEL_GROUP),
               "fused_payload": OptConfig(save_mid_freq=10)}
    switch, builder = TE._PAYLOAD_FUSED, TE.pair_select_tris
    calls = []

    def counting(*args):
        calls.append(args[0].shape[0])
        return builder(*args)

    counts, rates, colls, peaks = {}, {}, {}, {}
    for name in ("default", "two_level", "two_level", "default", "default", "fused_payload", "fused_payload", "default"):
        TE._PAYLOAD_FUSED = name == "fused_payload"
        TE.pair_select_tris = counting
        try:
            _, res, c, rate, peak = _opt_run(mano, params, batch, configs[name], smi, f"{name} (in turns)")
        finally:
            TE._PAYLOAD_FUSED, TE.pair_select_tris = switch, builder
        check_counts(name, c, exact_collision=1, nearest_centroid=0, bn_stats=0)
        rates.setdefault(name, []).append(rate)
        colls.setdefault(name, []).append(float(res["collision_loss"].mean()))
        peaks[name] = max(peaks.get(name, 0.0), peak)
        counts[f"coll_{name}"] = c
    log("  in turns, hands/sec: " + ", ".join(f"{n} " + " / ".join(f"{r:.3f}" for r in v) for n, v in rates.items())
        + "; peak GiB " + ", ".join(f"{n} {v:.3f}" for n, v in peaks.items())
        + "; final mean exact collision " + ", ".join(f"{n} {v[0]:.5f}" for n, v in colls.items()) + f" (on {smi})")
    if not calls:
        raise AssertionError("the merged payload builder never ran")
    log(f"  merged builder calls in the two fused runs: {len(calls)}")
    del counts["coll_default"]
    return counts


def phase_small_collision(dev, smi):
    """The in-loop collision paths at small size, card against CPU."""
    from ihmr_tpu_torch.pipeline import SHORT_COLLISION_TOL, run_short_collision_paths, short_collision_gaps

    gaps, ok = short_collision_gaps(run_short_collision_paths(dev), run_short_collision_paths("cpu"))
    log("collision paths at small size (B=4, interlocked seed 2), card vs CPU (params max |gap|, collision max "
        "relative gap): " + ", ".join(f"{k} {p:.3e} / {c:.3e}" for k, (p, c) in gaps.items())
        + f" (tol {SHORT_COLLISION_TOL}; escalation masks equal: required; on {smi})")
    if not ok:
        raise AssertionError("the card and the CPU disagree on an in-loop collision path")


def phase_cli_collision(dev, smi):
    """optimize through the CLI with --escalate_collision and with the grid, on
    a corpus of 16 files (write_corpus seed 2), B=8, stages cut to epoch 20."""
    from ihmr_tpu_torch.data.synthetic import write_corpus

    counts = {}
    with tempfile.TemporaryDirectory() as work:
        write_corpus(os.path.join(work, "corpus"), 16, seed=2)
        argv = ["optimize", "--data_root", os.path.join(work, "corpus"), "--anno_path", "anno.pkl", "--pred_path",
                "pred.pkl", "--batchSize", "8", "--synthetic_mano", "--stage_epochs", "20", "--device", "cuda"]
        cwd = os.getcwd()
        os.chdir(work)
        try:
            for name, flags in (("cli_escalate", ["--escalate_collision", str(ESCALATE_THRESHOLD)]),
                                ("cli_grid", ["--loop_collision_backend", "grid"])):
                out, counts[name], seconds = _cli(argv + flags)
                md = out["metrics"]
                log(f"  optimize {' '.join(flags)}: {seconds:.2f}s, launches {counts[name]}, metric_dict "
                    + json.dumps(md) + f" (on {smi})")
                if not md or not all(math.isfinite(v) for v in md.values()):
                    raise AssertionError(f"optimize {flags}: metrics {md}")
        finally:
            os.chdir(cwd)
    # 2 batches: K1 once a batch and pass, so 2 to 4 with escalation
    if not 2 <= counts["cli_escalate"]["exact_collision"] <= 4 or counts["cli_grid"]["exact_collision"] != 2:
        raise AssertionError(f"command-line K1 launches {counts}")
    return counts


TRACK_STREAMS, TRACK_FRAMES, TRACK_STEPS = 64, 8, 30  # scripts/tracker_study.py's S; 4 x 31 steps a frame


DP_SHARDS = 4  # shards of the data-parallel runs on the one card (phase 19)
DP_TRAIN_BATCH, DP_IMAGE, DP_ARCH = 64, 224, "resnet50"  # phase 5's replayed batch
DP_STEPS, DP_WARMUP = 5, 2  # timed and warm-up steps of each side of phase 19's training turns
DP_OPT_BATCH = 128  # bench.py's workload
DP_SHORT_EPOCH = 20  # the short horizon: each opt_default stage at 21 steps
DP_OPT_TOL = 5e-5  # sharded vs one-device params over the short horizon (the JAX package's bound between its engines)
# the timed horizon, in turns: each opt_default stage at 51 steps (a sharded
# run of the full schedule on one card takes ~120 s, its threads contending
# for the interpreter lock)
DP_TIMED_EPOCH = 50
DP_OPT_TURNS = ("one device", "sharded", "sharded", "one device")
# planted faults of the data-parallel step that its checks must catch
# (``pipeline.planted_dp_fault``): "race" twice, since it comes out differently each time
DP_PLANTED = ("race", "race", "local")


@contextlib.contextmanager
def _shard0_bn_inputs(out):
    """Record each train-mode BatchNorm input that shard 0 of a mesh sees
    (a global forward pre-hook: the shards call replicas of the encoder on
    threads of their own)."""
    from ihmr_tpu_torch.models.resnet import BatchNorm
    from ihmr_tpu_torch.parallel.mesh import current_shard

    def hook(module, args):
        shard = current_shard()
        if isinstance(module, BatchNorm) and module.training and shard is not None and shard.index == 0:
            out.append(args[0].detach().clone())

    handle = torch.nn.modules.module.register_module_forward_pre_hook(hook)
    try:
        yield out
    finally:
        handle.remove()


@contextlib.contextmanager
def _stream_mismatches(out):
    """Collect torch's warnings that a gradient reached a parameter's
    AccumulateGrad node from another stream than the node's."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        yield out
    out.extend(str(w.message)[:120] for w in caught if "AccumulateGrad" in str(w.message))


def _gap_text(gaps):
    return ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())


def _dp_train(dev, smi):
    """Part (a) of phase 19 -> {path: launch counts}."""
    from ihmr_tpu_torch.ops import bn_stats as K3
    from ihmr_tpu_torch.parallel import make_mesh, replicate, shard_batch
    from ihmr_tpu_torch.pipeline import (
        DP_REPEAT_TOL, DP_TOL_RESNET50, deterministic_algorithms, dp_gaps, dp_grads, dp_within, grad_bits_gap,
        make_train_bench_inputs, one_device_grads, planted_dp_fault,
    )
    from ihmr_tpu_torch.train.baseline import train_step, train_step_dp

    inputs = make_train_bench_inputs(batch=DP_TRAIN_BATCH, image_size=DP_IMAGE, arch=DP_ARCH, bn_impl="pallas",
                                     device=dev)
    B = DP_TRAIN_BATCH
    log(f"data-parallel training: {DP_ARCH} {DP_IMAGE}x{DP_IMAGE}, B={B}, fp32 without TF32, bn_impl=pallas (K3), "
        f"phase 5's replayed batch and weights; the step's loss, gradients and running statistics against the "
        f"one-device step (bounds {DP_TOL_RESNET50}: pipeline.py says why; 'grad' is the largest entry gap in "
        "units of max(1, its tensor's largest |g|), printed beside the same gaps of the one-device step on the "
        "batch with each pair of samples swapped, which only changes the order of its sums)")
    one = one_device_grads(inputs)
    log(f"  one device, again: gaps {_gap_text(dp_gaps(one_device_grads(inputs), one))}; pairs swapped: gaps "
        f"{_gap_text(dp_gaps(one_device_grads(inputs, swapped=True), one))}")
    counts, runs = {}, {}
    meshes = (("dp_train", make_mesh([dev] * DP_SHARDS)), ("dp_train_all_cards", make_mesh()))
    for path, mesh in meshes:
        mismatches = []
        zero_counts()
        with _stream_mismatches(mismatches):
            runs[path] = dp = dp_grads(inputs, mesh)
        counts[path] = read_counts()
        gaps = dp_gaps(dp, one)
        log(f"  {mesh} ({mesh.size} shards of {B // mesh.size}): loss {dp.loss:.6f} vs {one.loss:.6f}; gaps "
            f"{_gap_text(gaps)}; launches {counts[path]}; stream-mismatch warnings {len(mismatches)} (on {smi})")
        check_counts(f"the data-parallel step over {mesh}", counts[path], exact_collision=0, nearest_centroid=0,
                     bn_stats=53 * mesh.size)
        if not dp_within(gaps, DP_TOL_RESNET50):
            raise AssertionError(f"the data-parallel step over {mesh} disagrees with the one-device step: {gaps}")
        if mismatches:
            raise AssertionError(f"the data-parallel step over {mesh}: a gradient crossed streams: {mismatches[0]}")

    # the same step again, recording K3's inputs on shard 0: it must repeat
    # the first within DP_REPEAT_TOL, and K3 agree with its plain version there
    mesh = meshes[0][1]
    acts = []
    with _shard0_bn_inputs(acts):
        again = dp_grads(inputs, mesh)
    spread = dp_gaps(again, runs["dp_train"])
    # and twice under deterministic algorithms, where it must repeat to the bit
    with deterministic_algorithms() as nondeterministic:
        det = [dp_grads(inputs, mesh) for _ in range(2)]
    bits = grad_bits_gap(det[1], det[0])
    log(f"  {DP_SHARDS} shards, again: gaps to the first run {_gap_text(spread)} (bounds {DP_REPEAT_TOL}); twice "
        f"under deterministic algorithms: largest gradient entry gap {bits:.3e}, loss {det[0].loss!r} and "
        f"{det[1].loss!r}, gaps to the first run {_gap_text(dp_gaps(det[0], runs['dp_train']))}; operators without "
        f"a deterministic version: {sorted(set(m[:100] for m in nondeterministic))}")
    if not dp_within(spread, DP_REPEAT_TOL):
        raise AssertionError(f"the data-parallel step does not repeat itself: {spread}")
    if bits != 0.0 or det[0].loss != det[1].loss:
        raise AssertionError(f"the data-parallel step under deterministic algorithms does not repeat to the bit: {bits}")
    worst = (0.0, 0.0, 0.0)
    for x in acts:
        s, s2 = K3._launch_kernel(x)
        ps, ps2 = K3.bn_stats_reference(x)
        k_err = _bn_rel_errors(s, s2, x)
        worst = (max(worst[0], k_err[0]), max(worst[1], k_err[1]),
                 max(worst[2], float((s - ps).abs().max()), float((s2 - ps2).abs().max())))
    log(f"  K3 on shard 0's {len(acts)} BatchNorm inputs ({tuple(acts[0].shape)} .. {tuple(acts[-1].shape)}): "
        f"vs float64 sum err {worst[0]:.3e} of sum|x| (tol {BN_SUM_TOL}), sum-of-squares rel err {worst[1]:.3e} "
        f"(tol {BN_SQ_TOL}); max |kernel - plain| {worst[2]:.3e}")
    if len(acts) != 53 or worst[0] > BN_SUM_TOL or worst[1] > BN_SQ_TOL:
        raise AssertionError(f"K3 on the shards' activations: {len(acts)} inputs, errors {worst}")
    del acts

    # the checks against planted faults: each must come out wrong
    for fault in DP_PLANTED:
        with planted_dp_fault(fault):
            bad = dp_grads(inputs, mesh)
        gaps = dp_gaps(bad, one)
        log(f"  planted fault {fault!r}: gaps {_gap_text(gaps)} -> within the bounds: {dp_within(gaps, DP_TOL_RESNET50)}")
        if dp_within(gaps, DP_TOL_RESNET50):
            raise AssertionError(f"the data-parallel checks pass the planted fault {fault!r}: {gaps}")

    # ms/step of the replayed step, one device and 4 shards on it, in turns
    state_dp, batch_dp = replicate(inputs.state, mesh), shard_batch(inputs.batch, mesh)
    steps = {
        "one device": lambda: train_step(inputs.state, inputs.batch, inputs.mano_right, inputs.mano_left,
                                         inputs.config)[1],
        f"{DP_SHARDS} shards": lambda: train_step_dp(state_dp, batch_dp, inputs.mano_right, inputs.mano_left,
                                                     inputs.config)[1],
    }
    for step in steps.values():
        for _ in range(DP_WARMUP):
            float(step()["total_loss"])
    times = {name: [] for name in steps}
    for name in (*steps, *reversed(steps)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [float(steps[name]()["total_loss"]) for _ in range(DP_STEPS)]
        times[name].append((time.perf_counter() - t0) / DP_STEPS * 1e3)
        if not np.isfinite(losses).all():
            raise AssertionError(f"{name}: non-finite losses {losses}")
    log(f"  ms/step over {DP_STEPS} replayed steps after {DP_WARMUP} warm-ups, in turns (each step ends in a host "
        "read of its loss): " + "; ".join(f"{name} {', '.join(f'{t:.3f}' for t in ts)} -> "
                                          f"{B / min(ts) * 1e3:.3f} images/sec at best" for name, ts in times.items())
        + f" (on {smi})")
    del inputs, state_dp, batch_dp
    torch.cuda.empty_cache()
    return counts


def _dp_opt(dev, smi):
    """Part (b) of phase 19 -> {path: launch counts}."""
    from ihmr_tpu_torch.data import make_opt_inputs
    from ihmr_tpu_torch.mano import synthetic_mano_model
    from ihmr_tpu_torch.parallel import gather_to_host, make_mesh, replicate, shard_batch
    from ihmr_tpu_torch.refine import OptConfig, opt_default, optimize_batch

    mano = synthetic_mano_model(device=dev)
    params, batch = make_opt_inputs(mano, batch=DP_OPT_BATCH, seed=0)
    mesh = make_mesh([dev] * DP_SHARDS)
    sharded = (replicate(mano, mesh), shard_batch(params, mesh), shard_batch(batch, mesh))
    config = OptConfig(save_mid_freq=10)
    B = DP_OPT_BATCH
    log(f"data-parallel IHMR-OPT: bench.py's workload (synthetic hand, make_opt_inputs(seed=0), B={B}, opt_default, "
        f"save_mid_freq=10, hoisted engine) over {mesh}, {DP_SHARDS} shards of {B // DP_SHARDS}")
    counts = {}

    short = tuple(dataclasses.replace(s, epoch=DP_SHORT_EPOCH) for s in opt_default)
    one, _ = optimize_batch(mano, params, batch, short, config)
    zero_counts()
    out, _ = optimize_batch(*sharded, short, config)
    counts["dp_opt_short"] = read_counts()
    out = gather_to_host(out)
    per_sample = np.max([np.abs(out[k] - v.cpu().numpy()).reshape(B, -1).max(axis=1) for k, v in one.items()], axis=0)
    log(f"  {len(short)} x {DP_SHORT_EPOCH + 1} steps: largest per-sample param gap to the one-device run "
        f"{per_sample.max():.3e} (tol {DP_OPT_TOL}), samples above it {int((per_sample > DP_OPT_TOL).sum())}; "
        f"launches {counts['dp_opt_short']}")
    check_counts("the sharded short OPT", counts["dp_opt_short"], exact_collision=DP_SHARDS, nearest_centroid=0,
                 bn_stats=0)
    if per_sample.max() > DP_OPT_TOL:
        raise AssertionError(f"sharded OPT: {int((per_sample > DP_OPT_TOL).sum())} samples leave {DP_OPT_TOL}")

    timed = tuple(dataclasses.replace(s, epoch=DP_TIMED_EPOCH) for s in opt_default)
    rates = {name: [] for name in dict.fromkeys(DP_OPT_TURNS)}
    collision = {name: [] for name in rates}
    for name in DP_OPT_TURNS:
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        if name == "sharded":
            out, results = optimize_batch(*sharded, timed, config)
        else:
            out, results = optimize_batch(mano, params, batch, timed, config)
        torch.cuda.synchronize()
        rates[name].append(B / (time.perf_counter() - t0))
        c = read_counts()
        check_counts(f"the timed OPT ({name})", c, exact_collision=DP_SHARDS if name == "sharded" else 1,
                     nearest_centroid=0, bn_stats=0)
        if name == "sharded":
            counts["dp_opt"] = c
            results = gather_to_host(results)
            rv, lv = (torch.as_tensor(results[k], device=dev) for k in ("pred_right_hand_verts", "pred_left_hand_verts"))
            err = _k1_plain_err(rv, lv, mano.faces, mano.faces.flip(-1),
                                torch.as_tensor(results["collision_loss_origin_scale"], device=dev))
            if err > DEPTH_TOL:
                raise AssertionError(f"sharded OPT: final-pass depths {err:.3e} from K1's plain version")
            bad = [k for k, v in results.items() if not np.isfinite(v).all()]
            if bad:
                raise AssertionError(f"sharded OPT: non-finite outputs {bad}")
        collision[name].append(float(np.mean(np.asarray(results["collision_loss"] if name == "sharded"
                                                        else results["collision_loss"].cpu()))))
    log(f"  {len(timed)} x {DP_TIMED_EPOCH + 1} steps, in turns {DP_OPT_TURNS}: hands/sec " + "; ".join(
        f"{name} {', '.join(f'{r:.3f}' for r in rs)}" for name, rs in rates.items())
        + f"; final mean exact collision {collision}; the last sharded run's final depths through K1's plain "
        f"version {err:.3e} (tol {DEPTH_TOL}); launches {counts['dp_opt']} (on {smi})")
    return counts


def phase_data_parallel(dev, smi):
    """Phase 19: parallel/mesh.py at full width on the card."""
    return {**_dp_train(dev, smi), **_dp_opt(dev, smi)}


def _direct(fn, images, batch):
    """``fn`` on ``images`` padded to ``batch`` with the first image, as the
    broker pads -> the rows of ``images``."""
    pad = np.repeat(images[:1], batch - len(images), axis=0)
    return {k: v[: len(images)] for k, v in fn(np.concatenate([images, pad])).items()}


def _serve_one(dev, ckpt_dir, bf16, images):
    """One server (fp32 or --bf16) under serve_load; its responses against
    the predict function called directly on batches of the same composition."""
    from ihmr_tpu_torch import cli
    from ihmr_tpu_torch import pipeline as P

    label = "bf16" if bf16 else "fp32"
    argv = ["serve", "--checkpoints_dir", ckpt_dir, "--synthetic_mano", "--port", "0", "--device", "cuda",
            "--inputSize", str(P.SERVE_SIZE)]
    zero_counts()
    with P.backbone_input_dtypes() as seen:
        server = cli.start_server(cli.parse_args(argv + (["--bf16"] if bf16 else [])))
        try:
            load = P.serve_load(server.port, images)
        finally:
            server.stop()
    counts = read_counts()
    dtypes = sorted({str(d).replace("torch.", "") for d in seen})
    fn, batch = server.batcher.fn, server.batcher.batch_size
    lat = {kind: [r[0] for r in getattr(load, kind)] for kind in ("octet", "npy", "json", "concurrent")}
    n_seq = len(load.octet) * len(images)
    before, after = load.stats_before, load.stats_after
    batches, requests = after["batches"] - before["batches"], after["requests"] - before["requests"]
    log(f"  [{label}] ResNet-50 {P.SERVE_SIZE}x{P.SERVE_SIZE}, serve_batch {batch}, max_wait_ms 10; launches "
        f"{counts}; {len(seen)} backbone layer inputs, dtypes {dtypes}")
    for kind, n in (("octet", len(images)), ("npy", len(images)), ("json", len(load.json[0][1])), ("concurrent", 1)):
        log(f"  [{label}] {kind:10s} ({len(lat[kind])} requests of {n} image{'s' if n > 1 else ''}): p50 "
            f"{P.percentile_ms(lat[kind], 0.5):.3f} ms, p95 {P.percentile_ms(lat[kind], 0.95):.3f} ms, max "
            f"{max(lat[kind]) * 1e3:.3f} ms")
    seq_rate = n_seq / sum(lat["octet"])
    conc_rate = len(load.concurrent) / load.concurrent_seconds
    log(f"  [{label}] sequential octet-stream: {seq_rate:.3f} images/sec; concurrent ({P.SERVE_THREADS} threads x "
        f"{P.SERVE_PER_THREAD} single images): "
        f"{conc_rate:.3f} images/sec over {load.concurrent_seconds:.3f}s, {batches} batches for {requests} requests; "
        f"batch_efficiency over the whole run {after['batch_efficiency']}")
    check_counts(f"serve ({label})", counts, exact_collision=0, nearest_centroid=0, bn_stats=0)
    if not batches < requests:
        raise AssertionError(f"serve ({label}): {batches} batches for {requests} concurrent requests")
    if dtypes != (["bfloat16"] if bf16 else ["float32"]):
        raise AssertionError(f"serve ({label}): the backbone's layers took {dtypes}")
    # each response against a direct call: the same composition where it is
    # known (a whole request is one batch), else the image alone, padded
    same = _direct(fn, images, batch)
    json_same = _direct(fn, load.json[0][1], batch)
    gaps = {}  # (kind, output) -> (max |diff|, max ratio to PREDICT_TOL)
    for kind in ("octet", "npy", "json", "concurrent"):
        for _, sent, out in getattr(load, kind):
            ref = same if kind in ("octet", "npy") else json_same if kind == "json" else _direct(fn, sent, batch)
            for k, v in out.items():
                g, r = gaps.get((kind, k), (0.0, 0.0))
                gaps[kind, k] = (max(g, float(np.abs(v - ref[k]).max())),
                                 max(r, P.allclose_ratio(v, ref[k], **P.PREDICT_TOL)))
    by_kind = {kind: max(g for (kd, _), (g, _) in gaps.items() if kd == kind) for kind in ("octet", "npy", "json", "concurrent")}
    log(f"  [{label}] responses vs the predict function called directly, max |diff|: same batch composition "
        f"(octet {by_kind['octet']:.3e}, npy {by_kind['npy']:.3e}, json {by_kind['json']:.3e}); concurrent singles "
        f"against the image alone padded with itself {by_kind['concurrent']:.3e}")
    # a request served as one batch is that batch's direct call, bit for bit
    unequal = {kd: g for kd, g in by_kind.items() if kd != "concurrent" and g != 0}
    if unequal:
        raise AssertionError(f"serve ({label}): responses differ from the same batch called directly: {unequal}")
    return dict(label=label, counts=counts, lat=lat, seq_rate=seq_rate, conc_rate=conc_rate, same=same,
                gaps=gaps, stats=after, batches=batches, requests=requests)


def phase_serve(dev, ckpt_dir):
    """The serve command at full width on phase 7's checkpoint, fp32 and --bf16."""
    from ihmr_tpu_torch import cli
    from ihmr_tpu_torch.pipeline import BF16_BAND, PREDICT_TOL, SERVE_IMAGES, SERVE_SIZE
    from ihmr_tpu_torch.pipeline import allclose_ratio, bf16_band_ratios, max_gaps

    log(f"serving: cli.start_server on phase 7's checkpoint ({sorted(os.listdir(ckpt_dir))}), "
        "scripts/serve_bench.py's protocol")
    images = np.random.RandomState(0).rand(SERVE_IMAGES, SERVE_SIZE, SERVE_SIZE, 3).astype(np.float32)
    runs = {bf16: _serve_one(dev, ckpt_dir, bf16, images) for bf16 in (False, True)}
    # the same checkpoint and images on the CPU: the references of the bounds
    cpu = {}
    for bf16 in (False, True):
        args = cli.parse_args(["serve", "--checkpoints_dir", ckpt_dir, "--synthetic_mano", "--device", "cpu",
                               "--inputSize", str(SERVE_SIZE)] + (["--bf16"] if bf16 else []))
        cpu[bf16] = _direct(cli.build_predict(args), images, args.serve_batch)
    fp32_ratio = max(allclose_ratio(runs[False]["same"][k], v, **PREDICT_TOL) for k, v in cpu[False].items())
    band = bf16_band_ratios(runs[True]["same"], cpu[True], cpu[False])
    card_gap = max_gaps(runs[True]["same"], runs[False]["same"])
    log(f"  card vs CPU on the {SERVE_IMAGES} images: fp32 outputs {fp32_ratio:.4f} of PREDICT_TOL {PREDICT_TOL}; "
        f"bf16 band ratios (max |card bf16 - CPU bf16| / max |CPU bf16 - CPU fp32|, at most {BF16_BAND}) "
        + ", ".join(f"{k} {v:.4f}" for k, v in band.items())
        + "; bf16 server vs fp32 server max |diff| " + ", ".join(f"{k} {v:.3e}" for k, v in card_gap.items()))
    # a concurrent single shares its batch with other threads' images, not
    # with copies of itself: it may differ from its direct call at most as
    # the card may differ from the CPU (fp32 within PREDICT_TOL, bf16 within
    # the band); the other kinds are held to equality in _serve_one
    width = max_gaps(cpu[True], cpu[False])
    bad = [(k, r) for (kind, k), (_, r) in runs[False]["gaps"].items() if kind == "concurrent" and r > 1.0]
    bad += [(k, g) for (kind, k), (g, _) in runs[True]["gaps"].items()
            if kind == "concurrent" and g > BF16_BAND * width[k]]
    # the band holds the bf16 params (976 values); the other outputs' ratios
    # are printed: hand_type's width is 16 sigmoids' rounding, a few values.
    # An fp32 encoder would read about 1 on the band too: the dtypes checked
    # in _serve_one and the gap between the two servers tell it
    if fp32_ratio > 1.0 or band["params"] > BF16_BAND or bad or not all(g > 0 for g in card_gap.values()):
        raise AssertionError(f"serving outputs out of bounds: fp32 {fp32_ratio}, band {band}, concurrent {bad[:4]}, "
                             f"bf16 vs fp32 server {card_gap}")
    return runs


def phase_tracker(dev):
    """TwoHandTracker on S=64 coherent streams, as scripts/tracker_study.py runs it."""
    from ihmr_tpu_torch.mano import synthetic_mano_model
    from ihmr_tpu_torch.pipeline import TRACK_NOISE, TRACK_SPEED, make_tracker_frames, run_tracker
    from ihmr_tpu_torch.refine import OptConfig, TwoHandTracker, streaming_strategy

    S, frames = TRACK_STREAMS, TRACK_FRAMES
    mano = synthetic_mano_model(device=dev)
    tracker = TwoHandTracker(mano, streaming_strategy(TRACK_STEPS), OptConfig(save_mid_freq=5), smoothing=0.5,
                             blend_with_detection=0.25)
    inputs = make_tracker_frames(mano, streams=S, frames=frames + 1)
    log(f"tracking: TwoHandTracker, S={S} streams, streaming_strategy({TRACK_STEPS}), save_mid_freq=5, blend 0.25, "
        f"smoothing 0.5, full MANO mesh; pipeline.make_tracker_frames (scripts/tracker_study.py's random walk at "
        f"speed {TRACK_SPEED}, detections its ground truth + {TRACK_NOISE} noise, blended)")
    t0 = time.perf_counter()
    warm = run_tracker(tracker, inputs[:1])
    log(f"  warm-up frame: {time.perf_counter() - t0:.3f}s")
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    run = run_tracker(tracker, inputs[1:], warm.state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    rate = S * frames / wall
    log(f"  {frames} frames: {wall:.3f}s -> {rate:.3f} tracked hands/sec, {wall / frames * 1e3:.3f} ms per frame "
        f"(each {', '.join(f'{x * 1e3:.1f}' for x in run.frame_seconds)} ms); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches {counts}")
    log(f"  final mean collision per frame {[round(c, 6) for c in run.collision]}; frame_idx {run.state.frame_idx}")
    check_counts("the tracker", counts, exact_collision=frames, nearest_centroid=0, bn_stats=0)
    if not np.isfinite(run.collision).all() or run.state.frame_idx != frames + 1:
        raise AssertionError(f"tracker: collision {run.collision}, frame_idx {run.state.frame_idx}")
    bad = [k for k, v in {**run.state.params, **run.state.ema_params}.items() if not bool(torch.isfinite(v).all())]
    if bad:
        raise AssertionError(f"tracker: non-finite params {bad}")
    return counts, rate


def phase_train_bf16(dev, fp32_ms):
    """The replayed batch of phase 5 in bf16 (--bf16), K3 on bf16 activations."""
    from ihmr_tpu_torch.models.resnet import BatchNorm
    from ihmr_tpu_torch.pipeline import make_train_bench_inputs, run_train_pipeline

    log(f"bf16 training: ResNet-50 224x224, B=64, {TRAIN_STEPS} steps, dtype bfloat16 (fp32 master weights), "
        "bn_impl=pallas (K3 on bf16 activations)")
    inputs = make_train_bench_inputs(batch=64, image_size=224, arch="resnet50", bn_impl="pallas", device=dev,
                                     dtype=torch.bfloat16)
    bns = [m for m in inputs.state.encoder.modules() if isinstance(m, BatchNorm)]
    seen = []
    hooks = [m.register_forward_pre_hook(lambda _m, args: seen.append((tuple(args[0].shape), args[0].dtype)))
             for m in bns]
    t0 = time.perf_counter()
    run_train_pipeline(inputs, 2, evaluate=False)
    log(f"  warm-up (2 steps): {time.perf_counter() - t0:.2f}s")
    # the forwards that run in Python are the graph's warm-up and capture, both at the first step
    captured, seen[:] = list(seen), []
    step_shapes = [shape for shape, _ in captured[: len(bns)]]
    run, counts, graph = traced_train(lambda: run_train_pipeline(inputs, TRAIN_STEPS, evaluate=False))
    for h in hooks:
        h.remove()
    ms = run.step_seconds / TRAIN_STEPS * 1e3
    dtypes = [str(d).replace("torch.", "") for _, d in captured]
    log(f"  {TRAIN_STEPS} steps: {ms:.3f} ms/step -> {64e3 / ms:.3f} images/sec (under torch.profiler); fp32 "
        f"(phase 5, same batch, this run) {fp32_ms:.3f} ms/step, bf16/fp32 {ms / fp32_ms:.4f}; total loss "
        f"{run.total_loss[0]:.5f} -> {run.total_loss[-1]:.5f}; launches {counts} (bn_stats: device kernels in the "
        f"trace); the train step's graph {graph}; BatchNorm inputs at the warm-up and capture {len(captured)}, "
        f"dtypes {sorted(set(dtypes))}; in the timed steps {len(seen)}")
    check_counts("bf16 training", counts, exact_collision=0, nearest_centroid=0, bn_stats=53 * TRAIN_STEPS)
    check_counts("bf16 training's graph", graph, captures=0, replays=TRAIN_STEPS, k3_wrapper=0)
    check_step_kernels("bf16", inputs)
    if (dtypes != ["bfloat16"] * (2 * 53) or seen or not np.isfinite(run.total_loss).all()):
        raise AssertionError(f"bf16 training: {len(captured)} BatchNorm inputs of {sorted(set(dtypes))} at the "
                             f"capture, {len(seen)} in the timed steps, losses {run.total_loss}")
    del inputs, run
    torch.cuda.empty_cache()
    return dict(counts=counts, ms_per_step=ms, k3_step=bn_step_times(dev, step_shapes, torch.bfloat16))


def phase_small_serve_track(dev):
    """The predict function and the tracker on small inputs, card against CPU."""
    from ihmr_tpu_torch.pipeline import BF16_BAND, PREDICT_TOL, allclose_ratio, bf16_band_ratios
    from ihmr_tpu_torch.pipeline import run_short_predict, run_short_tracker, short_tracker_gap

    zero_counts()
    gpu = run_short_predict(dev)
    counts = read_counts()
    cpu = run_short_predict("cpu")
    ratio = max(allclose_ratio(gpu["fp32"][k], v, **PREDICT_TOL) for k, v in cpu["fp32"].items())
    band = bf16_band_ratios(gpu["bf16"], cpu["bf16"], cpu["fp32"])
    apart = min(float(np.abs(gpu["bf16"][k] - v).max()) for k, v in gpu["fp32"].items())
    log(f"small predict (ResNet-18 64x64, B=4), card vs CPU: fp32 {ratio:.4f} of PREDICT_TOL; bf16 band ratios "
        + ", ".join(f"{k} {v:.4f}" for k, v in band.items()) + f" (at most {BF16_BAND}); backbone layer input "
        f"dtypes card {gpu['dtypes']}, CPU {cpu['dtypes']}; least max |bf16 - fp32| on the card {apart:.3e}; "
        f"launches {counts}")
    gap = short_tracker_gap(run_short_tracker(dev), run_short_tracker("cpu"))
    log(f"small tracker (B=2, 2 frames of streaming_strategy(6) and one of the default 4 x 31 steps), card vs CPU: "
        f"params and EMA max |diff| {gap:.3e} (tol {SMALL_PARAM_TOL})")
    check_counts("the small predict", counts, exact_collision=0, nearest_centroid=0, bn_stats=0)
    dtypes_ok = gpu["dtypes"] == cpu["dtypes"] == {"fp32": ["float32"], "bf16": ["bfloat16"]}
    if ratio > 1.0 or any(v > BF16_BAND for v in band.values()) or not dtypes_ok or apart == 0 or gap > SMALL_PARAM_TOL:
        raise AssertionError("the card and the CPU disagree on the small predict or tracker")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    from ihmr_tpu_torch.device import resolve_device, set_fp32_matmul_precision

    t_start = time.perf_counter()
    dev = resolve_device("cuda")
    set_fp32_matmul_precision()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    smi = phase_card_and_build()
    k1, k2 = phase_kernels(dev)
    k3_err = phase_bn_kernel(dev)
    opt_counts, _hands_per_sec = phase_main_path(dev)
    phase_engines(dev)
    mlp_counts, _train_rate, _cascade_rate, mlp_md = phase_mlp_path(dev)
    train = phase_train_path(dev)
    opt_eval_counts, opt_eval_md = phase_opt_eval(dev)
    log("metric_dict of the three evaluation loops: " + json.dumps(
        {"optimize_loop": opt_eval_md, "test_baseline_loop": train["baseline_md"], "test_mlp_loop": mlp_md}))
    phase_jpeg_encoder(smi)
    with tempfile.TemporaryDirectory() as ckpt_dir, tempfile.TemporaryDirectory() as work:
        cli_counts, png_ms_per_step, cli_metrics = phase_cli_chain(dev, train["ms_per_step"], ckpt_dir, work)
        cli_counts.update(phase_render(smi, work, ckpt_dir))
        cli_counts.update(phase_display(smi, work))
        cli_counts.update(phase_two_processes(smi, work, ckpt_dir, cli_metrics["test-baseline"]))
        cli_counts.update(phase_cli_jpeg(dev, smi, train["ms_per_step"], png_ms_per_step))
        serve = phase_serve(dev, ckpt_dir)
    tracker_counts, _tracked_per_sec = phase_tracker(dev)
    train_bf16 = phase_train_bf16(dev, train["ms_per_step"])
    collision_counts = phase_collision_modes(dev, smi)
    collision_counts.update(phase_two_level(dev, smi))
    collision_counts.update(phase_cli_collision(dev, smi))
    phase_cli_small(dev)
    phase_small_input(dev)
    phase_small_eval(dev)
    phase_small_mlp(dev)
    phase_small_train(dev)
    phase_small_serve_track(dev)
    phase_small_collision(dev, smi)
    dp_counts = phase_data_parallel(dev, smi)

    log(f"chip_smoke: {time.perf_counter() - t_start:.1f}s in all, kernel builds included, on {smi}")
    print(smi, flush=True)
    # every kernel's count was zeroed just before each path's run and read
    # just after it; "launches" is their sum and "launches_by_path" keeps them
    # apart. K3's count is its wrapper's runs, except on train and
    # train_bf16, where it is the device kernels in the trace of the timed
    # steps (a train step's CUDA graph replay launches K3 with no wrapper
    # run; the CLI's train commands count the wrapper at the graph's warm-up
    # and capture). (opt: the timed OPT run; opt_eval: optimize_loop; mlp: the timed
    # MLP run; train: the 20 train steps and one eval_step; baseline_eval:
    # test_baseline_loop; cli_*: each command of the command line, cli_jpeg_*
    # the two on JPEG files with every augmentation; serve, serve_bf16: each
    # server from its start to its last response; tracker: the 8 timed
    # frames; train_bf16: the 20 bf16 train steps; coll_*: each run of phase
    # 13 and 18, cli_escalate / cli_grid phase 13's two commands;
    # cli_visualize_eval, cli_visualize, cli_display: phases 15-16;
    # cli_two_process: the two ranks of phase 17, counted in each; dp_*:
    # phase 19's data-parallel runs: dp_train the step over 4 shards on the
    # card, dp_train_all_cards over every card, dp_opt_short the short OPT
    # and dp_opt the last timed one over 4 shards). K1's and
    # K2's times are one launch at the main path's shape; K3's are the sum
    # over the 53 launches of one train step ("ms_basis"), fp32 and (the
    # "_bf16" keys) bf16. "ms" is device time alone.
    by_path = dict(opt=opt_counts, opt_eval=opt_eval_counts, mlp=mlp_counts, train=train["counts"],
                   baseline_eval=train["loop_counts"], **cli_counts, serve=serve[False]["counts"],
                   serve_bf16=serve[True]["counts"], tracker=tracker_counts, train_bf16=train_bf16["counts"],
                   **collision_counts, **dp_counts)
    k3_bf16 = {f"{key}_bf16": v for key, v in train_bf16["k3_step"].items()}
    kernels = [
        dict(name="exact_collision", source="ihmr_tpu_torch/csrc/exact_collision.cu",
             replaces="ihmr_tpu/ops/pallas_collision.py:133", library_ms=None,
             ms_basis="device time of one launch at B=128 (both directions) with a cold L2, CUDA graph replay; "
                      "ms_with_host: CUDA events around one wrapper call", **k1),
        dict(name="nearest_centroid", source="ihmr_tpu_torch/csrc/nearest_centroid.cu",
             replaces="ihmr_tpu/ops/pallas_collision.py:351", library_ms=None,
             ms_basis="device time of one launch at B=128 (both directions) with a cold L2, CUDA graph replay; "
                      "ms_with_host: CUDA events around one wrapper call", **k2),
        dict(name="bn_stats", source="ihmr_tpu_torch/csrc/bn_stats.cu", replaces="ihmr_tpu/ops/pallas_bn.py:39",
             max_abs_err=k3_err,
             ms_basis="device time with a cold L2, summed over the 53 launches of one ResNet-50 train step "
                      "at B=64", **train["k3_step"], **k3_bf16),
    ]
    print(json.dumps({"kernels": [
        {"name": k["name"], "route": "cuda", "source": k["source"], "replaces": k["replaces"],
         "launches": sum(c[k["name"]] for c in by_path.values()),
         "launches_by_path": {path: c[k["name"]] for path, c in by_path.items()}, "max_abs_err": k["max_abs_err"],
         "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
         "library_ms": k["library_ms"], "ms_basis": k["ms_basis"],
         **{key: v for key, v in k.items() if key.endswith("_bf16") or key in ("ms_with_host", "library_composition_ms")}}
        for k in kernels
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
