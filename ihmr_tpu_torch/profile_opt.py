"""Where the time of the benchmarked workload goes on the card.

    python -m ihmr_tpu_torch.profile_opt [--batch 128] [--epoch 20]

Runs the ``pipeline.py`` workload at full width (ResNet-50 at 224x224,
B hands, the full MANO mesh) with every ``opt_default`` stage cut to
``--epoch`` epochs (the per-step work is unchanged; only the step count is
cut), after one warm-up run:

  * host-clock time of the encoder, of each stage (per step) and of the
    final exact-metric pass, each ending in ``torch.cuda.synchronize()``;
  * one run under ``torch.profiler`` (CPU + CUDA): device busy time (the
    union of kernel intervals) against the run's wall time, i.e. the
    device's idle share, kernel launches per step, and the kernels with the
    most device time.

Prints a readable report and, last, one JSON line with the numbers. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import subprocess
import time

import torch

from ihmr_tpu_torch.refine.opt_engine import OptConfig, compute_losses, forward, optimize_batch, run_stage
from ihmr_tpu_torch.refine.schedule import OPT_DEFAULT_LOSS_WEIGHTS, opt_default


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _device_busy(prof):
    """(busy seconds, kernel count, {kernel name: (seconds, count)}) from the
    profiler's CUDA kernel events."""
    spans, by_name = [], collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        by_name[e.name][0] += (end - start) * 1e-6
        by_name[e.name][1] += 1
    spans.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy * 1e-6, len(spans), by_name


def main():
    from ihmr_tpu_torch.pipeline import make_bench_inputs

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--epoch", type=int, default=20, help="epochs per stage (opt_default has 300)")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    inputs = make_bench_inputs(batch=args.batch, seed=0, device="cuda")
    strategy = tuple(dataclasses.replace(s, epoch=args.epoch) for s in opt_default)
    config = OptConfig(save_mid_freq=10)
    steps = sum(s.epoch + 1 for s in strategy)

    def full():
        with torch.no_grad():
            inputs.encoder(inputs.images, inputs.mean_params)
        return optimize_batch(inputs.mano, inputs.params, inputs.opt_batch, strategy, config)

    _, warm = _timed(full)
    with torch.no_grad():
        _, enc_s = _timed(lambda: inputs.encoder(inputs.images, inputs.mean_params))
    params, stage_s = inputs.params, []
    for st in strategy:
        params, dt = _timed(lambda: run_stage(inputs.mano, params, inputs.opt_batch, st, config))
        stage_s.append(dt)

    def final_pass():
        with torch.no_grad():
            return compute_losses(
                inputs.mano, params, inputs.opt_batch, dict(OPT_DEFAULT_LOSS_WEIGHTS), config,
                outputs=forward(inputs.mano, params),
            )

    _, final_s = _timed(final_pass)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, wall = _timed(full)
    busy, n_kernels, by_name = _device_busy(prof)

    print(f"card: {smi}; batch {args.batch}, {steps} steps ({args.epoch} epochs x {len(strategy)} stages)")
    print(f"warm-up run {warm:.3f}s; encoder {enc_s * 1e3:.2f} ms; final exact pass {final_s * 1e3:.2f} ms")
    for st, dt in zip(strategy, stage_s):
        print(f"  stage {'+'.join(st.update_params)}: {dt:.3f}s, {dt / (st.epoch + 1) * 1e3:.2f} ms/step")
    print(
        f"profiled run: wall {wall:.3f}s, device busy {busy:.3f}s, idle share {1 - busy / wall:.3f}, "
        f"{n_kernels} kernels ({n_kernels / steps:.0f} per step)"
    )
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[: args.top]
    for name, (sec, cnt) in top:
        print(f"  {sec * 1e3:9.2f} ms {cnt:7d}x  {name[:110]}")
    print(json.dumps({
        "card": smi, "batch": args.batch, "steps": steps,
        "encoder_ms": enc_s * 1e3, "final_pass_ms": final_s * 1e3,
        "stage_ms_per_step": [dt / (st.epoch + 1) * 1e3 for st, dt in zip(strategy, stage_s)],
        "profiled_wall_s": wall, "device_busy_s": busy, "idle_share": 1 - busy / wall,
        "kernels_per_step": n_kernels / steps,
        "top_kernels_ms": [[name, sec * 1e3] for name, (sec, _) in top[:5]],  # full names: prefixes collide
    }))


if __name__ == "__main__":
    main()
