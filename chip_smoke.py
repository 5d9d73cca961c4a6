"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases (each raises on failure; any failure exits non-zero before the last line):

1. Card and build: the card's name and power limit (nvidia-smi), then every
   kernel of ``ihmr_tpu_torch/csrc`` compiled with nvcc (one process per
   source, started together).
2. Each kernel against its plain PyTorch version on the card, at the shapes
   its main path gives it, with kernel and plain times (CUDA events, median)
   and the least time the card could take:
   exact_collision (K1): B=128 synthetic hands from make_opt_inputs(seed=0),
   both directions, plus a random icosphere case: max depth error, direction
   error where both are inside, share of equal inside signs;
   nearest_centroid (K2): B=128 hands from make_mlp_inputs(seed=100), both
   directions, an icosphere and planted exact ties: indices must be 100%
   equal;
   bn_stats (K3): the ResNet-50 stem input (64, 64, 112, 112), the widest
   (64, 2048, 7, 7), a ragged (3, 5, 7, 11) and a bf16 (64, 256, 56, 56):
   sums against a float64 sum (sum x within BN_SUM_TOL of sum |x|, sum x^2
   within BN_SQ_TOL relative), the same bits on a second launch, and the
   backward against its formula.
3. The OPT path at full width: ResNet-50 encoder at 224x224 and the full
   opt_default (4 x 301 Adam steps, save_mid_freq=10) on B=128 hands with the
   full MANO mesh (778 vertices, 1538 faces). One warm-up run, then a timed
   run with the kernel launch counts zeroed just before it and read just
   after. The final pass's depths are recomputed with the plain version.
4. The MLP path at full width: run_mlp_pipeline at N=2048 in 16 batches of
   128 with the full mlp_default (240 train steps, 96 selection batches, the
   cascade over 16 batches). A warm-up of one train step, one selection batch
   and one cascade batch, then one timed run with the launch counts zeroed
   just before it and read just after.
5. Baseline training at full width (scripts/train_bench.py's
   configuration): ResNet-50 at 224x224, B=64, TrainConfig(total_epoch=1),
   fp32 without TF32, bn_impl="pallas" (bn_stats, K3, in every train-mode
   BatchNorm). A warm-up of 2 steps, then train_baseline_loop over 20 steps
   with the launch counts zeroed just before and read just after (53 K3
   launches a step), then one eval_step (one K1 launch; its depths again
   through the plain version). The same 20 steps with bn_impl="stock",
   timed. K3's time per step: each BatchNorm input shape of one step,
   kernel against plain version and torch.var_mean.
6. Small inputs held against the CPU: optimize_batch at B=2 with a short
   schedule, pipeline.run_short_mlp (three stages, one epoch, N=4) and
   pipeline.run_short_train (ResNet-18 at 64x64, B=4, two steps), on the
   card and on the CPU (plain kernel versions) must agree: the MLP's
   trained weights, residuals, cached params and losses within
   pipeline.SHORT_MLP_TOL, accept masks equal; the training's step-1
   metrics, running statistics and params and its step-2 loss within
   pipeline.SHORT_TRAIN_TOL.

The next-to-last line is {"kernels": [...]} and the last line
{"ok": true, "device": {...}}. Exits non-zero without a result when CUDA is
unavailable or the ihmr_tpu_torch package is not beside this script.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

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


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` on the card (CUDA events), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def _compare_exact(q, tri, label):
    """Kernel vs plain version on (N, V, 3) queries and (N, F, 9) triangles."""
    from ihmr_tpu_torch.ops import exact_collision as K

    N, V, _ = q.shape
    F = tri.shape[1]
    qp, tp, bounds = K.pad_inputs(q, tri)
    K.reset_launch_count()
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

    # work this run's data needs: real queries x real triangles of every
    # (query block, triangle tile) pair the pruning rule evaluated
    q_real = torch.clamp(V - torch.arange(0, qp.shape[1], K.Q_TILE, device=q.device), max=K.Q_TILE)
    t_real = torch.clamp(F - torch.arange(0, tp.shape[1], K.T_TILE, device=q.device), max=K.T_TILE)
    pairs = float((evaluated.float() * q_real[None, :, None] * t_real[None, None, :]).sum())
    flops = pairs * FLOPS_PER_PAIR
    nbytes = 4 * (N * V * 3 + N * F * 9 + bounds.numel() + N * V + N * V * 3)
    bound_ms = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
    bound_by = "operations" if flops / PEAK_FP32_FLOPS >= nbytes / PEAK_HBM_BYTES else "bytes"
    ms = cuda_ms(lambda: K._launch_kernel(qp, tp, bounds, F), 20)
    plain_ms = cuda_ms(lambda: K.exact_penetration_depth_reference(qp, tp, bounds, F), 5)
    log(
        f"  [{label}] kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
        f"{flops / 1e9:.3f} GFLOP evaluated of {N * V * F * FLOPS_PER_PAIR / 1e9:.3f} unpruned, "
        f"{nbytes / 1e6:.2f} MB), library call: none (no single PyTorch call computes this); "
        f"{K.launch_count} kernel launches in this comparison"
    )
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def _compare_nearest(q, cent, label, timed=False):
    """Kernel vs plain version on (N, V, 3) queries and (N, F, 3) centroids;
    every index must be equal."""
    from ihmr_tpu_torch.ops import nearest_centroid as NC

    N, V, _ = q.shape
    F = cent.shape[1]
    qp, cp = NC.pad_inputs(q, cent)
    NC.reset_launch_count()
    idx = NC._launch_kernel(qp, cp, F)
    torch.cuda.synchronize()
    ref = NC.nearest_centroid_reference(qp, cp, F)
    idx, ref = idx[:, :V], ref[:, :V]
    equal = float((idx == ref).float().mean())
    err = float((idx - ref).abs().max())
    log(f"  [{label}] N={N} V={V} F={F}: equal indices {equal:.6f} (must be 1), max |index diff| {err:.0f}, "
        f"{NC.launch_count} kernel launch in this comparison")
    if equal != 1.0:
        raise AssertionError(f"nearest_centroid kernel disagrees with its plain version ({label})")
    if not timed:
        return None
    # work these inputs need: every real query against every real centroid
    flops = float(N * V * F * NEAREST_FLOPS_PER_PAIR)
    nbytes = 4 * (N * V * 3 + N * F * 4 + N * V)
    bound_ms = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
    bound_by = "operations" if flops / PEAK_FP32_FLOPS >= nbytes / PEAK_HBM_BYTES else "bytes"
    ms = cuda_ms(lambda: NC._launch_kernel(qp, cp, F), 50)
    plain_ms = cuda_ms(lambda: NC.nearest_centroid_reference(qp, cp, F), 5)
    c2 = cp[:, :F, 3]
    composition_ms = cuda_ms(lambda: (c2[:, None, :] - 2 * torch.bmm(q, cent.mT)).argmin(-1), 20)
    log(
        f"  [{label}] kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
        f"{flops / 1e9:.3f} GFLOP at {NEAREST_FLOPS_PER_PAIR} flop/pair, {nbytes / 1e6:.2f} MB); "
        f"library call: none (no PyTorch call keeps the tile-mean tie rule)"
    )
    log(f"  [{label}] nearest library composition, not the same function: "
        f"(|c|^2 - 2 * torch.bmm(q, c^T)).argmin(-1) {composition_ms:.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def phase_kernels(dev):
    from ihmr_tpu_torch.data import make_opt_inputs
    from ihmr_tpu_torch.mano import synthetic_mano_model
    from ihmr_tpu_torch.mano.loader import _convex_hull_faces, _fibonacci_sphere
    from ihmr_tpu_torch.refine import forward

    log("kernels vs plain versions (exact_collision):")
    mano = synthetic_mano_model(device=dev)
    params, _ = make_opt_inputs(mano, batch=128, seed=0)
    with torch.no_grad():
        rv, lv, _, _ = forward(mano, params)
    faces_r, faces_l = mano.faces, mano.faces.flip(-1)
    B = rv.shape[0]
    q = torch.cat([rv, lv]).contiguous()
    tri = torch.cat([lv[:, faces_l].reshape(B, -1, 9), rv[:, faces_r].reshape(B, -1, 9)]).contiguous()
    main = _compare_exact(q, tri, "main path B=128, both directions")

    pts = _fibonacci_sphere(400)
    sphere_tri = torch.tensor(pts[_convex_hull_faces(pts)].reshape(-1, 9), dtype=torch.float32, device=dev)
    gen = torch.Generator(device="cpu").manual_seed(1)
    sq = (torch.randn(4, 1000, 3, generator=gen) * 0.6).to(dev)
    _compare_exact(sq, sphere_tri[None].expand(4, -1, -1).contiguous(), "icosphere")

    from ihmr_tpu_torch.data import make_mlp_inputs
    from ihmr_tpu_torch.ops.collision import _centroids
    from ihmr_tpu_torch.refine.mlp_engine import seed_from_backbone

    log("kernels vs plain versions (nearest_centroid):")
    batch = make_mlp_inputs(mano, batch=128, seed=100)
    with torch.no_grad():
        rv, lv, _, _ = forward(mano, seed_from_backbone(batch))
    q = torch.cat([rv, lv]).contiguous()
    cent = _centroids(torch.cat([lv[:, faces_l], rv[:, faces_r]])).contiguous()
    nearest = _compare_nearest(q, cent, "MLP path B=128, both directions", timed=True)
    sphere_cent = sphere_tri[:-1].reshape(-1, 3, 3).mean(1)  # an odd centroid count
    _compare_nearest(sq, sphere_cent[None].expand(4, -1, -1).contiguous(), "icosphere")
    tie = torch.rand((2, 300, 3), generator=gen).to(dev) * 5 + 5
    target = torch.tensor([0.1, -0.2, 0.3], device=dev)
    tie[0, [3, 10]] = target  # one tile: the mean index, (3 + 10) / 2 -> 6
    tie[1, [5, 200]] = target  # two tiles: the first stays -> 5
    tq = target + (torch.rand((2, 20, 3), generator=gen).to(dev) - 0.5) * 0.02
    from ihmr_tpu_torch.ops.nearest_centroid import nearest_centroid

    picks = nearest_centroid(tq, tie)
    _compare_nearest(tq, tie, "planted ties")
    if not (bool((picks[0] == 6).all()) and bool((picks[1] == 5).all())):
        raise AssertionError(f"planted ties picked {picks[:, 0].tolist()}, expected [6, 5]")
    log("  [planted ties] picks 6 and 5 as the tie rules say")
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


def cold_ms(fn, n: int = 10) -> float:
    """Device milliseconds per call of ``fn`` with a cold L2 cache: n calls,
    each after a 128 MB write that evicts the card's 50 MB L2, captured as
    one CUDA graph (so no host launch latency between them), less the same
    graph without ``fn``."""
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()

    def replay_ms(body):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n):
                body()
        graph.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    both = replay_ms(lambda: (flush.zero_(), fn()))
    only = replay_ms(flush.zero_)
    return max(both - only, 0.0) / n


def _time_bn(x):
    """((kernel, plain, torch.var_mean) device ms with a cold L2, the kernel
    with CUDA events around one call) on ``x``."""
    from ihmr_tpu_torch.ops import bn_stats as K3

    dims = (0,) + tuple(range(2, x.dim()))
    fns = (lambda: K3._launch_kernel(x), lambda: K3.bn_stats_reference(x),
           lambda: torch.var_mean(x, dim=dims, correction=0))
    return tuple(cold_ms(f) for f in fns), cuda_ms(fns[0], 10)


def _compare_bn(x, label):
    """K3 against a float64 sum and its plain version; determinism; backward."""
    from ihmr_tpu_torch.ops import bn_stats as K3

    K3.reset_launch_count()
    s, s2 = K3._launch_kernel(x)
    again = K3._launch_kernel(x)
    torch.cuda.synchronize()
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
    log(
        f"  [{label}] {tuple(x.shape)} {str(x.dtype).replace('torch.', '')}: kernel vs float64: sum err "
        f"{k_err[0]:.3e} of sum|x| (tol {BN_SUM_TOL}), sum-of-squares rel err {k_err[1]:.3e} (tol {BN_SQ_TOL}); "
        f"plain version vs float64: {p_err[0]:.3e}, {p_err[1]:.3e}; max |kernel - plain| {abs_err:.3e}; "
        f"same bits on a second launch: {same_bits}; backward rel err {gx_err:.3e}; "
        f"{K3.launch_count} kernel launches in this comparison"
    )
    if not (k_err[0] <= BN_SUM_TOL and k_err[1] <= BN_SQ_TOL and same_bits and gx_err <= 1e-6):
        raise AssertionError(f"bn_stats kernel disagrees with its plain version ({label})")
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
        ("ResNet-50 stem", (64, 64, 112, 112), torch.float32),
        ("ResNet-50 widest", (64, 2048, 7, 7), torch.float32),
        ("ragged", (3, 5, 7, 11), torch.float32),
        ("bf16", (64, 256, 56, 56), torch.bfloat16),
    ]
    errs = []
    for label, shape, dtype in cases:
        x = (torch.randn(shape, generator=gen, device=dev) * 2.0 + 0.5).to(dtype)  # a convolution's output
        errs.append(_compare_bn(x, label))
        del x
    return max(errs)


def phase_main_path(dev):
    from ihmr_tpu_torch.ops import exact_collision as K
    from ihmr_tpu_torch.ops.collision import pair_parity_filter
    from ihmr_tpu_torch.pipeline import make_bench_inputs, run_pipeline

    from ihmr_tpu_torch.ops import nearest_centroid as NC

    log("OPT path: ResNet-50 224x224 + opt_default (4 x 301 steps) at B=128, full MANO mesh")
    inputs = make_bench_inputs(batch=128, seed=0, arch="resnet50", image_size=224, device=dev)
    log(f"  mesh: {inputs.mano.v_template.shape[0]} vertices, {inputs.mano.faces.shape[0]} faces")
    t0 = time.perf_counter()
    run_pipeline(inputs)
    torch.cuda.synchronize()
    log(f"  warm-up run: {time.perf_counter() - t0:.2f}s")

    K.reset_launch_count()
    NC.reset_launch_count()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_params, results, pred_params, hand_type = run_pipeline(inputs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = K.launch_count
    B = inputs.images.shape[0]
    log(f"  timed run: {dt:.3f}s -> {B / dt:.3f} hands/sec; exact_collision launches {launches}, "
        f"nearest_centroid launches {NC.launch_count} (not on this path)")
    # K1 runs once, on the final exact pass: the in-loop collision is the
    # plain-torch payload path, and NC stays at 0
    if launches != 1 or NC.launch_count != 0:
        raise AssertionError("the OPT path did not launch each kernel the expected number of times")

    final_coll = float(results["collision_loss"].mean())
    log(f"  final mean collision loss {final_coll:.5f} (a TPU run of the JAX package gave 0.19499 at seed 0; sanity only)")
    if pred_params.shape != (B, 122) or hand_type.shape != (B, 2):
        raise AssertionError(f"encoder outputs {tuple(pred_params.shape)} {tuple(hand_type.shape)}")
    tensors = dict(results, pred_params=pred_params, hand_type=hand_type, **{f"param_{k}": v for k, v in out_params.items()})
    bad = [k for k, v in tensors.items() if not bool(torch.isfinite(v).all())]
    if bad:
        raise AssertionError(f"non-finite outputs: {bad}")
    log(f"  all {len(tensors)} outputs finite")

    # the final pass's depths again, through the plain version
    rv, lv = results["pred_right_hand_verts"], results["pred_left_hand_verts"]
    faces_r, faces_l = inputs.mano.faces, inputs.mano.faces.flip(-1)
    q = torch.cat([rv, lv])
    tri = torch.cat([lv[:, faces_l].reshape(B, -1, 9), rv[:, faces_r].reshape(B, -1, 9)])
    qp, tp, bounds = K.pad_inputs(q, tri)
    ref, _, _ = K.exact_penetration_depth_reference(qp, tp, bounds, tri.shape[1])
    ref = ref[:, : q.shape[1]]
    ref = pair_parity_filter(torch.cat([ref[:B], ref[B:]], dim=1), rv, lv, faces_r, faces_l)
    err = float((ref - results["collision_loss_origin_scale"]).abs().max())
    log(f"  final-pass depths, kernel vs plain: max |err| {err:.3e} (tol {DEPTH_TOL})")
    if err > DEPTH_TOL:
        raise AssertionError("final-pass depths disagree with the plain version")
    return launches, B / dt


def phase_mlp_path(dev):
    from ihmr_tpu_torch.data import BatchList
    from ihmr_tpu_torch.ops import exact_collision as K
    from ihmr_tpu_torch.ops import nearest_centroid as NC
    from ihmr_tpu_torch.pipeline import MLPBenchInputs, make_mlp_bench_inputs, run_mlp_pipeline
    from ihmr_tpu_torch.refine import mlp_default

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

    K.reset_launch_count()
    NC.reset_launch_count()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = run_mlp_pipeline(inputs, mlp_default, generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    k1, k2 = K.launch_count, NC.launch_count
    n = inputs.num_data
    sec = run.seconds
    train_rate = steps * B / sec["train"]
    cascade_rate = n / sec["cascade"]
    log(f"  timed run: {dt:.3f}s (warm pass {sec['warm']:.3f}s, training with selection {sec['train']:.3f}s, "
        f"cascade {sec['cascade']:.3f}s)")
    log(f"  training: {train_rate:.3f} samples/sec ({steps} steps x {B}); cascade: {cascade_rate:.3f} hands/sec")
    for stat in run.stage_stats:
        log(f"  stage {stat['stage']} {'+'.join(mlp_default[stat['stage']].update_params)}: accept "
            f"{stat['accepted_frac']:.3f}, {stat['select_loss']} {stat['select_before']:.5f} -> {stat['select_after']:.5f}")
    log("  (docs/MLP_SOAK.md has a TPU run of the JAX package on the same data; a sanity check, not a limit)")
    n_batches = len(inputs.batches)
    k1_expect = n_batches * (1 + len(mlp_default) + len(mlp_default) + 2)  # warm + selections + cascade
    log(f"  launches: nearest_centroid {k2} (train steps {steps}), exact_collision {k1} "
        f"(warm {n_batches} + selection {n_batches * len(mlp_default)} + cascade {n_batches * (len(mlp_default) + 2)} "
        f"= {k1_expect})")
    if k2 != steps or k1 != k1_expect:
        raise AssertionError("the MLP path did not launch each kernel the expected number of times")
    tensors = {f"cascade_{i}_{k}": v for i, r in enumerate(run.cascade) for k, v in r.items() if v.is_floating_point()}
    tensors.update({f"cache_{k}": v for k, v in {**run.caches.prev_params, **run.caches.prev_losses}.items()})
    bad = [k for k, v in tensors.items() if not bool(torch.isfinite(v).all())]
    stats_ok = all(np.isfinite([s["select_before"], s["select_after"]]).all() for s in run.stage_stats)
    if bad or not stats_ok or not bool(run.caches.exists.all()):
        raise AssertionError(f"MLP outputs not finite or not cached: {bad[:5]}")
    log(f"  all {len(tensors)} outputs finite, all {n} samples cached")
    return k1, k2, train_rate, cascade_rate


def phase_train_path(dev):
    import tempfile

    from ihmr_tpu_torch.models.resnet import BatchNorm
    from ihmr_tpu_torch.ops import bn_stats as K3
    from ihmr_tpu_torch.ops import exact_collision as K
    from ihmr_tpu_torch.ops import nearest_centroid as NC
    from ihmr_tpu_torch.ops.collision import pair_parity_filter
    from ihmr_tpu_torch.pipeline import make_train_bench_inputs, run_train_pipeline
    from ihmr_tpu_torch.train import eval_step

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
        for mod in (K3, K, NC):
            mod.reset_launch_count()
        torch.cuda.synchronize()
        run = run_train_pipeline(inputs, TRAIN_STEPS, checkpoints_dir=tmp, evaluate=False)
        k3, k2, k1 = K3.launch_count, NC.launch_count, K.launch_count
        saved = sorted(os.listdir(tmp))
    ms = run.step_seconds / TRAIN_STEPS * 1e3
    log(f"  {TRAIN_STEPS} steps: {ms:.3f} ms/step -> {B / ms * 1e3:.3f} images/sec (host clock over the steps, "
        f"each ending in a host read of its losses; the checkpoint write excluded); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; checkpoints {saved}")
    log(f"  total loss {run.total_loss[0]:.5f} -> {run.total_loss[-1]:.5f}")
    log(f"  launches over the steps: bn_stats {k3} (expected {len(bns)} x {TRAIN_STEPS}), nearest_centroid {k2}, "
        f"exact_collision {k1}")
    if len(bns) != 53 or k3 != 53 * TRAIN_STEPS or k2 != 0 or k1 != 0:
        raise AssertionError("the training steps did not launch each kernel the expected number of times")

    K.reset_launch_count()
    metrics, outputs = eval_step(inputs.state, inputs.batch, inputs.mano_right, inputs.mano_left, inputs.config)
    torch.cuda.synchronize()
    eval_k1 = K.launch_count
    rv, lv = outputs["pred_right_hand_verts"], outputs["pred_left_hand_verts"]
    faces_r, faces_l = inputs.mano_right.faces, inputs.mano_left.faces
    q = torch.cat([rv, lv])
    tri = torch.cat([lv[:, faces_l].reshape(B, -1, 9), rv[:, faces_r].reshape(B, -1, 9)])
    qp, tp, bounds = K.pad_inputs(q, tri)
    ref, _, _ = K.exact_penetration_depth_reference(qp, tp, bounds, tri.shape[1])
    ref = ref[:, : q.shape[1]]
    ref = pair_parity_filter(torch.cat([ref[:B], ref[B:]], dim=1), rv, lv, faces_r, faces_l)
    err = float((ref - outputs["collision_loss_origin_scale"]).abs().max())
    log(f"  eval step: exact_collision launches {eval_k1}; depths kernel vs plain max |err| {err:.3e} "
        f"(tol {DEPTH_TOL}); inside vertices {int((ref > 0).sum())}; "
        + ", ".join(f"{k} {float(v):.5f}" for k, v in metrics.items()))
    if eval_k1 != 1 or err > DEPTH_TOL:
        raise AssertionError("the eval step's exact collision disagrees or was not launched once")
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

    return dict(k3=k3, k1=eval_k1, ms_per_step=ms, stock_ms_per_step=stock_ms, k3_step=bn_step_times(dev, step_shapes))


def bn_step_times(dev, step_shapes):
    """K3, its plain version and torch.var_mean over one train step's
    BatchNorm input shapes (random data), summed: the K3 entry's numbers."""
    log("  bn_stats over one train step's BatchNorm inputs (random data of each shape; device time, cold L2):")
    gen = torch.Generator(device=dev).manual_seed(4)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    counts = {}
    for shape in step_shapes:
        counts[shape] = counts.get(shape, 0) + 1
    events = 0.0
    for shape, n in counts.items():
        x = torch.randn(shape, generator=gen, device=dev) * 2.0 + 0.5
        (k_ms, p_ms, l_ms), ev_ms = _time_bn(x)
        b_ms, _ = _bn_bound_ms(x)
        for key, v in zip(("ms", "plain_ms", "library_ms", "bound_ms"), (k_ms, p_ms, l_ms, b_ms)):
            tot[key] += n * v
        events += n * ev_ms
        log(f"    {shape} x{n}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, var_mean {l_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"(kernel with CUDA events around one call {ev_ms:.4f} ms)")
        del x
    log(f"  per step ({len(step_shapes)} launches): kernel {tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, "
        f"var_mean {tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms (bytes); kernel with CUDA events "
        f"around each call {events:.4f} ms")
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


def phase_small_mlp(dev):
    from ihmr_tpu_torch.pipeline import SHORT_MLP_TOL, run_short_mlp, short_mlp_gaps

    gaps, masks_equal = short_mlp_gaps(run_short_mlp(dev), run_short_mlp("cpu"))
    log("small MLP input (N=4, 3 stages x 1 epoch), card vs CPU: "
        + ", ".join(f"{k} max gap {v:.3e} (tol {SHORT_MLP_TOL[k]})" for k, v in gaps.items())
        + f"; accept masks equal: {masks_equal}")
    if any(v > SHORT_MLP_TOL[k] for k, v in gaps.items()) or not masks_equal:
        raise AssertionError("the card and the CPU disagree on a small MLP input")


def phase_small_train(dev):
    from ihmr_tpu_torch.ops import bn_stats as K3
    from ihmr_tpu_torch.pipeline import PARAMS_SHARE, SHORT_TRAIN_TOL, run_short_train, short_train_gaps

    K3.reset_launch_count()
    gpu = run_short_train(dev)
    launches = K3.launch_count
    gaps = short_train_gaps(gpu, run_short_train("cpu"))
    log(f"small training (ResNet-18 64x64, B=4, 2 steps), card vs CPU: bn_stats launches {launches} (expected 40); "
        + ", ".join(f"{k} gap {v:.3e} (tol {SHORT_TRAIN_TOL[k]})" for k, v in gaps.items())
        + f" ('params' over the closest {PARAMS_SHARE:.1%} of entries)")
    if launches != 40 or any(v > SHORT_TRAIN_TOL[k] for k, v in gaps.items()):
        raise AssertionError("the card and the CPU disagree on a small training run")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    from ihmr_tpu_torch.device import resolve_device, set_fp32_matmul_precision

    dev = resolve_device("cuda")
    set_fp32_matmul_precision()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    smi = phase_card_and_build()
    k1, k2 = phase_kernels(dev)
    k3_err = phase_bn_kernel(dev)
    opt_k1, _hands_per_sec = phase_main_path(dev)
    mlp_k1, mlp_k2, _train_rate, _cascade_rate = phase_mlp_path(dev)
    train = phase_train_path(dev)
    phase_small_input(dev)
    phase_small_mlp(dev)
    phase_small_train(dev)

    print(smi, flush=True)
    # each path's counts were zeroed before its own timed run; "launches" is
    # their sum and "launches_by_path" keeps them apart. K1's and K2's times
    # are one launch at the main path's shape; K3's are the sum over the 53
    # launches of one train step ("ms_basis").
    kernels = [
        dict(name="exact_collision", source="ihmr_tpu_torch/csrc/exact_collision.cu",
             replaces="ihmr_tpu/ops/pallas_collision.py:133",
             by_path=dict(opt=opt_k1, mlp=mlp_k1, train=train["k1"]), library_ms=None, **k1),
        dict(name="nearest_centroid", source="ihmr_tpu_torch/csrc/nearest_centroid.cu",
             replaces="ihmr_tpu/ops/pallas_collision.py:351",
             by_path=dict(opt=0, mlp=mlp_k2, train=0), library_ms=None, **k2),
        dict(name="bn_stats", source="ihmr_tpu_torch/csrc/bn_stats.cu", replaces="ihmr_tpu/ops/pallas_bn.py:39",
             by_path=dict(opt=0, mlp=0, train=train["k3"]), max_abs_err=k3_err,
             ms_basis="device time with a cold L2, summed over the 53 launches of one ResNet-50 train step "
                      "at B=64", **train["k3_step"]),
    ]
    print(json.dumps({"kernels": [
        {"name": k["name"], "route": "cuda", "source": k["source"], "replaces": k["replaces"],
         "launches": sum(k["by_path"].values()), "launches_by_path": k["by_path"], "max_abs_err": k["max_abs_err"],
         "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
         "library_ms": k["library_ms"], **({"ms_basis": k["ms_basis"]} if "ms_basis" in k else {})}
        for k in kernels
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
