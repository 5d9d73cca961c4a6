"""Where the time of the MLP workload goes on the card.

    python -m ihmr_tpu_torch.profile_mlp [--n 2048] [--batch 128]

Builds the ``pipeline.py`` MLP inputs (N samples in batches of B, the full
MANO mesh), runs the warm pass, then measures each kind of work the
workload repeats, each after one untimed call:

  * a train step (stage 3 of ``mlp_default``, the pose stage, one epoch over
    every batch), a selection pass over every batch, and the cascade over
    every batch: host-clock time per batch, ending in
    ``torch.cuda.synchronize()``;
  * the same three under ``torch.profiler`` (CPU + CUDA): device busy time
    (the union of kernel intervals) against wall time, i.e. the device's
    idle share, kernel launches per batch, and the kernels with the most
    device time.

Prints a readable report and, last, one JSON line with the numbers. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from ihmr_tpu_torch.profile_opt import _device_busy, _timed
from ihmr_tpu_torch.refine.adam import Adam
from ihmr_tpu_torch.refine.mlp_engine import MLPCaches, make_cascade_apply
from ihmr_tpu_torch.refine.opt_engine import OptConfig
from ihmr_tpu_torch.refine.schedule import MLP_DEFAULT_LOSS_WEIGHTS, mlp_default
from ihmr_tpu_torch.train.mlp import init_stage_subnetwork, make_stage_select_step, make_stage_train_step, warm_pass


def main():
    from ihmr_tpu_torch.pipeline import make_mlp_bench_inputs

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    inputs = make_mlp_bench_inputs(n=args.n, batch=args.batch, device="cuda")
    mano, batches, config = inputs.mano, inputs.batches, OptConfig()
    caches = MLPCaches(inputs.num_data, device="cuda")
    warm_pass(mano, batches, caches, config)

    stage = mlp_default[3]
    gen = torch.Generator().manual_seed(0)
    subnet = init_stage_subnetwork(stage, gen, torch.device("cuda"))
    adam = Adam(dict(subnet.named_parameters()), lr_last=True)
    step = make_stage_train_step(mano, stage, config)
    select = make_stage_select_step(mano, stage, config)
    subnets = [init_stage_subnetwork(s, gen, torch.device("cuda")) for s in mlp_default]
    cascade = make_cascade_apply(mano, mlp_default, dict(MLP_DEFAULT_LOSS_WEIGHTS), config)

    def train_epoch():
        for b in batches:
            _feat, prev, _losses = caches.retrieve(b.index)
            metrics = step(subnet, adam, b, prev, stage.lr)
            torch.stack(list(metrics.values())).tolist()  # the loop's one host sync per step

    def select_pass():
        for b in batches:
            _feat, prev, losses = caches.retrieve(b.index)
            select(subnet, b, prev, losses)

    def cascade_pass():
        for b in batches:
            cascade(subnets, b)

    parts = {"train step": train_epoch, "selection batch": select_pass, "cascade batch": cascade_pass}
    report = {}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for name, fn in parts.items():
        _timed(fn)  # untimed call
        _, sec = _timed(fn)
        with torch.profiler.profile(activities=acts) as prof:
            _, wall = _timed(fn)
        busy, n_kernels, by_name = _device_busy(prof)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[: args.top]
        report[name] = dict(
            ms=sec / len(batches) * 1e3, profiled_wall_s=wall, device_busy_s=busy, idle_share=1 - busy / wall,
            kernels_per_batch=n_kernels / len(batches), top=top,
        )

    print(f"card: {smi}; N={inputs.num_data} in {len(batches)} batches of {args.batch}; train steps of stage "
          f"{'+'.join(stage.update_params)}")
    for name, r in report.items():
        print(f"{name}: {r['ms']:.2f} ms; profiled: wall {r['profiled_wall_s']:.3f}s, device busy "
              f"{r['device_busy_s']:.3f}s, idle share {r['idle_share']:.3f}, {r['kernels_per_batch']:.0f} kernels per batch")
        for kname, (sec, cnt) in r["top"]:
            print(f"  {sec * 1e3:9.2f} ms {cnt:7d}x  {kname[:110]}")
    print(json.dumps({
        "card": smi, "n": inputs.num_data, "batch": args.batch,
        **{name.replace(" ", "_"): {k: v for k, v in r.items() if k != "top"} | {
            "top_kernels_ms": [[kname, sec * 1e3] for kname, (sec, _) in r["top"][:5]]}
           for name, r in report.items()},
    }))


if __name__ == "__main__":
    main()
