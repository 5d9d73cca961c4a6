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
   (64, 2048, 7, 7), a ragged (3, 5, 7, 11) and a bf16 (64, 256, 56, 56):
   sums against a float64 sum (sum x within BN_SUM_TOL of sum |x|, sum x^2
   within BN_SQ_TOL relative), the same bits on a second launch, and the
   backward against its formula.
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
   BatchNorm). A warm-up of 2 steps, then train_baseline_loop over 20 steps
   with the launch counts zeroed just before and read just after (53 K3
   launches a step), then one eval_step (one K1 launch; its depths again
   through the plain version). The same 20 steps with bn_impl="stock",
   timed. K3's time per step: each BatchNorm input shape of one step,
   kernel against plain version and torch.var_mean. test_baseline_loop on
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
8. Small inputs held against the CPU: optimize_batch at B=2 with a short
   schedule, pipeline.run_short_opt_eval (optimize_loop at B=2, 4 x 21
   steps), pipeline.run_short_mlp (three stages, one epoch, N=4) and
   pipeline.run_short_train (ResNet-18 at 64x64, B=4, two steps), on the
   card and on the CPU (plain kernel versions) must agree: the metrics
   within pipeline.SHORT_EVAL_RTOL; the MLP's
   trained weights, residuals, cached params and losses within
   pipeline.SHORT_MLP_TOL, accept masks equal; the training's step-1
   metrics, running statistics and params and its step-2 loss within
   pipeline.SHORT_TRAIN_TOL.

The run's time in all is printed beside the card's name and power limit.

The next-to-last line is {"kernels": [...]} and the last line
{"ok": true, "device": {...}}. Exits non-zero without a result when CUDA is
unavailable or the ihmr_tpu_torch package is not beside this script.
"""

from __future__ import annotations

import dataclasses
import json
import os
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
HOIST_TOL = 5e-5  # hoisted vs full decode over 4 x 21 steps (the JAX package's bound between its engines)
# the JAX package's engine over the full opt_default at B=128, seed 0, fp32 on
# a CPU (tests/test_torch_port_opt.py's compare_full_schedule): the final mean
# collision loss, a sanity reference for this run's, not a limit
JAX_CPU_FINAL_COLLISION = 0.364552


def log(*args):
    print(*args, flush=True)


def _kernel_modules():
    from ihmr_tpu_torch.ops import bn_stats, exact_collision, nearest_centroid

    return {"exact_collision": exact_collision, "nearest_centroid": nearest_centroid, "bn_stats": bn_stats}


def zero_counts():
    """Set every kernel's launch count to 0 (just before a path's run)."""
    torch.cuda.synchronize()
    for mod in _kernel_modules().values():
        mod.reset_launch_count()


def read_counts():
    """Every kernel's launch count (just after a path's run)."""
    torch.cuda.synchronize()
    return {name: mod.launch_count for name, mod in _kernel_modules().items()}


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
        f"{K.launch_count} kernel launches in this comparison"
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
    return dict(max_abs_err=err, ms=ms, ms_with_host=host_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


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
    return counts, B / dt


def phase_engines(dev):
    """The stage-hoisted engine against the full decode over 4 x 21 steps."""
    from ihmr_tpu_torch.data import make_opt_inputs
    from ihmr_tpu_torch.mano import synthetic_mano_model
    from ihmr_tpu_torch.ops import exact_collision as K
    from ihmr_tpu_torch.refine import OptConfig, opt_default, optimize_batch, run_stage
    from ihmr_tpu_torch.refine.opt_engine import _make_stage_forward

    strategy = tuple(dataclasses.replace(s, epoch=20) for s in opt_default)
    configs = {hoist: OptConfig(save_mid_freq=10, stage_hoist_decode=hoist) for hoist in (True, False)}
    mano = synthetic_mano_model(device=dev)
    for B in (2, 128):
        params, batch = make_opt_inputs(mano, batch=B, seed=0)
        outs = {}
        for hoist, config in configs.items():
            K.reset_launch_count()
            outs[hoist], _ = optimize_batch(mano, params, batch, strategy, config)
            torch.cuda.synchronize()
            if K.launch_count != 1:
                raise AssertionError(f"optimize_batch (stage_hoist_decode={hoist}) launched exact_collision "
                                     f"{K.launch_count} times, not once")
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
    from ihmr_tpu_torch.ops import exact_collision as K
    from ihmr_tpu_torch.ops.collision import pair_parity_filter
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
        zero_counts()
        run = run_train_pipeline(inputs, TRAIN_STEPS, checkpoints_dir=tmp, evaluate=False)
        step_counts = read_counts()
        saved = sorted(os.listdir(tmp))
    ms = run.step_seconds / TRAIN_STEPS * 1e3
    log(f"  {TRAIN_STEPS} steps: {ms:.3f} ms/step -> {B / ms * 1e3:.3f} images/sec (host clock over the steps, "
        f"each ending in a host read of its losses; the checkpoint write excluded); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; checkpoints {saved}")
    log(f"  total loss {run.total_loss[0]:.5f} -> {run.total_loss[-1]:.5f}")
    log(f"  launches over the steps: {step_counts} (bn_stats expected {len(bns)} x {TRAIN_STEPS})")
    if len(bns) != 53:
        raise AssertionError(f"ResNet-50 holds {len(bns)} BatchNorms, not 53")
    check_counts("the training steps", step_counts, exact_collision=0, nearest_centroid=0, bn_stats=53 * TRAIN_STEPS)

    zero_counts()
    metrics, outputs = eval_step(inputs.state, inputs.batch, inputs.mano_right, inputs.mano_left, inputs.config)
    eval_counts = read_counts()
    rv, lv = outputs["pred_right_hand_verts"], outputs["pred_left_hand_verts"]
    faces_r, faces_l = inputs.mano_right.faces, inputs.mano_left.faces
    q = torch.cat([rv, lv])
    tri = torch.cat([lv[:, faces_l].reshape(B, -1, 9), rv[:, faces_r].reshape(B, -1, 9)])
    qp, tp, bounds = K.pad_inputs(q, tri)
    ref, _, _ = K.exact_penetration_depth_reference(qp, tp, bounds, tri.shape[1])
    ref = ref[:, : q.shape[1]]
    ref = pair_parity_filter(torch.cat([ref[:B], ref[B:]], dim=1), rv, lv, faces_r, faces_l)
    err = float((ref - outputs["collision_loss_origin_scale"]).abs().max())
    log(f"  eval step: launches {eval_counts}; depths kernel vs plain max |err| {err:.3e} "
        f"(tol {DEPTH_TOL}); inside vertices {int((ref > 0).sum())}; "
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


def phase_cli_chain(dev, replayed_ms_per_step):
    """The five workload commands at full width on a corpus of files."""
    import tempfile

    from ihmr_tpu_torch.data.synthetic import write_corpus
    from ihmr_tpu_torch.refine import mlp_default

    log(f"command line: the five workload commands on N={CLI_N} PNG files, ResNet-50 224x224, full MANO mesh")
    counts = {}
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        write_corpus(os.path.join(work, "corpus"), CLI_N, seed=0)
        log(f"  corpus written in {time.perf_counter() - t0:.2f}s")
        _time_decode(os.path.join(work, "corpus", "hand26m", "image"))
        common = ["--data_root", os.path.join(work, "corpus"), "--anno_path", "anno.pkl", "--synthetic_mano",
                  "--checkpoints_dir", os.path.join(work, "ckpt"), "--device", "cuda"]
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
                f"launches {counts['cli_train']}")
            # 53 BatchNorms a step, each one K3 launch; collision loss off, no evaluation
            check_counts("train-baseline", counts["cli_train"], exact_collision=0, nearest_centroid=0,
                         bn_stats=53 * steps)
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
    cli_counts = phase_cli_chain(dev, train["ms_per_step"])
    phase_cli_small(dev)
    phase_small_input(dev)
    phase_small_eval(dev)
    phase_small_mlp(dev)
    phase_small_train(dev)

    log(f"chip_smoke: {time.perf_counter() - t_start:.1f}s in all, kernel builds included, on {smi}")
    print(smi, flush=True)
    # every kernel's count was zeroed just before each path's run and read
    # just after it; "launches" is their sum and "launches_by_path" keeps them
    # apart (opt: the timed OPT run; opt_eval: optimize_loop; mlp: the timed
    # MLP run; train: the 20 train steps and one eval_step; baseline_eval:
    # test_baseline_loop; cli_*: each command of the command line). K1's and
    # K2's times are one launch at the main path's shape; K3's are the sum
    # over the 53 launches of one train step ("ms_basis"). "ms" is device
    # time alone.
    by_path = dict(opt=opt_counts, opt_eval=opt_eval_counts, mlp=mlp_counts, train=train["counts"],
                   baseline_eval=train["loop_counts"], **cli_counts)
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
                      "at B=64", **train["k3_step"]),
    ]
    print(json.dumps({"kernels": [
        {"name": k["name"], "route": "cuda", "source": k["source"], "replaces": k["replaces"],
         "launches": sum(c[k["name"]] for c in by_path.values()),
         "launches_by_path": {path: c[k["name"]] for path, c in by_path.items()}, "max_abs_err": k["max_abs_err"],
         "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
         "library_ms": k["library_ms"], "ms_basis": k["ms_basis"],
         **({"ms_with_host": k["ms_with_host"]} if "ms_with_host" in k else {})}
        for k in kernels
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
