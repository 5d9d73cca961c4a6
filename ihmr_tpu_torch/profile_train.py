"""Where the time of a baseline train step goes on the card.

    python -m ihmr_tpu_torch.profile_train [--batch 64] [--steps 10] [--bn_impl pallas] [--bf16]

Runs the training workload of ``pipeline.py`` at full width (ResNet-50 at
224x224, B images, ``TrainConfig(total_epoch=1)``, fp32 without TF32, or
with ``--bf16`` the encoder computing in bf16 as the CLI's ``--bf16`` does,
train-mode BatchNorm by ``--bn_impl``), after a two-step warm-up:

  * host-clock ms per step over ``--steps`` steps of ``train_baseline_loop``
    (each step ends in a host read of its losses);
  * one profiled step under ``torch.profiler`` (CPU + CUDA): device busy
    time (the union of kernel intervals) against the step's wall time, i.e.
    the device's idle share, kernel launches, the launches of the
    BatchNorm-statistics kernel K3 (counted by the wrapper and as device
    kernels whose name holds ``bn_stats``), K3's device time and its share
    of the busy time, and the kernels with the most device time.

Prints a readable report and, last, one JSON line with the numbers. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from ihmr_tpu_torch.profile_opt import _device_busy


def main():
    from ihmr_tpu_torch.ops import bn_stats as K3
    from ihmr_tpu_torch.pipeline import make_train_bench_inputs, run_train_pipeline
    from ihmr_tpu_torch.train import train_step

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--bn_impl", default="pallas", choices=["stock", "fused", "pallas"])
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--bf16", action="store_true", help="the encoder in bf16 (the CLI's --bf16)")
    args = ap.parse_args()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    inputs = make_train_bench_inputs(batch=args.batch, bn_impl=args.bn_impl, device="cuda", dtype=dtype)
    run_train_pipeline(inputs, 2, evaluate=False)  # warm-up
    run = run_train_pipeline(inputs, args.steps, evaluate=False)
    ms = run.step_seconds / args.steps * 1e3

    def step():
        _, metrics = train_step(inputs.state, inputs.batch, inputs.mano_right, inputs.mano_left, inputs.config)
        return torch.stack(list(metrics.values())).tolist()

    step()
    torch.cuda.synchronize()
    K3.reset_launch_count()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, n_kernels, by_name = _device_busy(prof)

    print(f"card: {smi}; batch {args.batch}, bn_impl {args.bn_impl}, {'bf16' if args.bf16 else 'fp32'}")
    print(f"{args.steps} steps: {ms:.3f} ms/step -> {args.batch / ms * 1e3:.3f} images/sec")
    print(
        f"profiled step: wall {wall * 1e3:.2f} ms, device busy {busy * 1e3:.2f} ms, idle share "
        f"{1 - busy / wall:.3f}, {n_kernels} kernels, bn_stats launches {K3.launch_count}"
    )
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[: args.top]
    for name, (sec, cnt) in top:
        print(f"  {sec * 1e3:9.3f} ms {cnt:6d}x  {name[:110]}")
    k3_ms = sum(sec for name, (sec, _) in by_name.items() if "bn_stats" in name) * 1e3
    k3_kernels = sum(cnt for name, (_, cnt) in by_name.items() if "bn_stats" in name)
    print(f"  bn_stats: {k3_kernels} device kernels, {k3_ms:.3f} ms of device time in the step, "
          f"{k3_ms / (busy * 1e3):.4f} of the busy time")
    print(json.dumps({
        "card": smi, "batch": args.batch, "bn_impl": args.bn_impl, "bf16": args.bf16, "ms_per_step": ms,
        "images_per_sec": args.batch / ms * 1e3, "profiled_wall_ms": wall * 1e3, "device_busy_ms": busy * 1e3,
        "idle_share": 1 - busy / wall, "kernels_per_step": n_kernels, "bn_stats_launches": K3.launch_count,
        "bn_stats_device_ms": k3_ms, "bn_stats_device_kernels": k3_kernels, "bn_stats_busy_share": k3_ms / (busy * 1e3),
        "top_kernels_ms": [[name, sec * 1e3] for name, (sec, _) in top[:8]],
    }))


if __name__ == "__main__":
    main()
