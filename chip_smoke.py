"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases (each raises on failure; any failure exits non-zero before the last line):

1. Card and build: the card's name and power limit (nvidia-smi), then every
   kernel of ``ihmr_tpu_torch/csrc`` compiled with nvcc (one process per
   source, started together).
2. Each kernel against its plain PyTorch version on the card, at the shapes
   the main path gives it (B=128 synthetic hands from make_opt_inputs(seed=0),
   both directions, plus a random icosphere case): max depth error, direction
   error where both are inside, share of equal inside signs, kernel and plain
   times (CUDA events, median), and the least time the card could take.
3. The main path at full width: ResNet-50 encoder at 224x224 and the full
   opt_default (4 x 301 Adam steps, save_mid_freq=10) on B=128 hands with the
   full MANO mesh (778 vertices, 1538 faces). One warm-up run, then a timed
   run with the kernel launch counts zeroed just before it and read just
   after. The final pass's depths are recomputed with the plain version.
4. A small input held against the CPU: optimize_batch at B=2 with a short
   schedule on the card and on the CPU (plain kernel version) must agree.

The next-to-last line is {"kernels": [...]} and the last line
{"ok": true, "device": {...}}. Exits non-zero without a result when CUDA is
unavailable or the ihmr_tpu_torch package is not beside this script.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import torch

# H100 SXM published peaks (fp32 outside the tensor cores, HBM3); the card's
# power limit is printed beside them
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# work of one query-triangle pair in the exact kernel (the count the JAX
# package uses: 21.4 GFLOP per call at B=128 with no pruning)
FLOPS_PER_PAIR = 70

DEPTH_TOL = 1e-5  # fp32, the same arithmetic on both sides
DIR_TOL = 1e-4  # tie-set averages summed in another order
SIGN_AGREEMENT = 0.999
SMALL_PARAM_TOL = 2e-4  # card vs CPU over a short schedule (the slice test's bound)


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
    return main


def phase_main_path(dev):
    from ihmr_tpu_torch.ops import exact_collision as K
    from ihmr_tpu_torch.ops.collision import pair_parity_filter
    from ihmr_tpu_torch.pipeline import make_bench_inputs, run_pipeline

    log("main path: ResNet-50 224x224 + opt_default (4 x 301 steps) at B=128, full MANO mesh")
    inputs = make_bench_inputs(batch=128, seed=0, arch="resnet50", image_size=224, device=dev)
    log(f"  mesh: {inputs.mano.v_template.shape[0]} vertices, {inputs.mano.faces.shape[0]} faces")
    t0 = time.perf_counter()
    run_pipeline(inputs)
    torch.cuda.synchronize()
    log(f"  warm-up run: {time.perf_counter() - t0:.2f}s")

    K.reset_launch_count()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_params, results, pred_params, hand_type = run_pipeline(inputs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = K.launch_count
    B = inputs.images.shape[0]
    log(f"  timed run: {dt:.3f}s -> {B / dt:.3f} hands/sec; exact_collision launches {launches}")
    if launches < 1:
        raise AssertionError("the main path never launched the exact_collision kernel")

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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    from ihmr_tpu_torch.device import resolve_device, set_fp32_matmul_precision

    dev = resolve_device("cuda")
    set_fp32_matmul_precision()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    smi = phase_card_and_build()
    k1 = phase_kernels(dev)
    launches, hands_per_sec = phase_main_path(dev)
    phase_small_input(dev)

    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "exact_collision",
        "route": "cuda",
        "source": "ihmr_tpu_torch/csrc/exact_collision.cu",
        "replaces": "ihmr_tpu/ops/pallas_collision.py:133",
        "launches": launches,
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
