"""The readings that set the data-parallel step's bounds (``pipeline.DP_TOL``,
``DP_TOL_RESNET50`` and ``DP_REPEAT_TOL``).

    python -m ihmr_tpu_torch.dp_bounds [--size resnet50 resnet18] [--races 4] [--device cuda]

For each size, the replayed training batch and seeded weights with
``bn_impl="pallas"`` (ResNet-50 at 224x224, B=64 over 4 shards on one card,
as ``chip_smoke.py`` phase 19 runs it; ResNet-18 at 64x64, B=8 over 2
shards, as ``tests/test_torch_port_mesh_cuda.py`` does):

1. the one-device step again, and on the batch with each pair of samples
   swapped (the same sums in other orders), against the one-device step;
2. the DP step three times: its gaps to the one-device step and between
   its runs;
3. the one-device and the DP step twice each under
   ``pipeline.deterministic_algorithms``: the largest gradient entry gap
   between the two runs (0.0: the same bits);
4. the planted faults (``pipeline.planted_dp_fault``): "race" ``--races``
   times, "local" once, against the one-device step, and the race's runs
   against its first.

A bound is sound when it passes every reading of 2 and fails every reading
of 4. Prints each reading beside the bounds, and last one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from ihmr_tpu_torch.device import resolve_device, set_fp32_matmul_precision
from ihmr_tpu_torch.parallel import make_mesh
from ihmr_tpu_torch.pipeline import (
    DP_REPEAT_TOL,
    DP_TOL,
    DP_TOL_RESNET50,
    deterministic_algorithms,
    dp_gaps,
    dp_grads,
    dp_within,
    grad_bits_gap,
    make_train_bench_inputs,
    one_device_grads,
    planted_dp_fault,
)

SIZES = {  # arch: (batch, image size, shards, bounds)
    "resnet50": (64, 224, 4, DP_TOL_RESNET50),
    "resnet18": (8, 64, 2, DP_TOL),
}


def _text(gaps):
    return ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())


def study(arch: str, dev: torch.device, races: int) -> dict:
    batch, size, shards, tol = SIZES[arch]
    print(f"{arch} {size}x{size}, B={batch} over {shards} shards; bounds {tol}, repeat {DP_REPEAT_TOL}", flush=True)
    inputs = make_train_bench_inputs(batch=batch, image_size=size, arch=arch, bn_impl="pallas", device=dev)
    mesh = make_mesh([dev] * shards)
    one = one_device_grads(inputs)
    out = dict(one_again=dp_gaps(one_device_grads(inputs), one),
               swapped=dp_gaps(one_device_grads(inputs, swapped=True), one))
    runs = [dp_grads(inputs, mesh) for _ in range(3)]
    out["dp"] = [dp_gaps(r, one) for r in runs]
    out["dp_repeat"] = [dp_gaps(r, runs[0]) for r in runs[1:]]
    with deterministic_algorithms() as nondeterministic:
        det_one = [one_device_grads(inputs) for _ in range(2)]
        det_dp = [dp_grads(inputs, mesh) for _ in range(2)]
    out["deterministic_bits"] = dict(one=grad_bits_gap(det_one[1], det_one[0]), dp=grad_bits_gap(det_dp[1], det_dp[0]))
    out["nondeterministic_ops"] = sorted(set(m[:100] for m in nondeterministic))
    planted = {"race": [], "local": []}
    for fault in ("race",) * races + ("local",):
        with planted_dp_fault(fault):
            planted[fault].append(dp_grads(inputs, mesh))
    for fault, runs_f in planted.items():
        out[fault] = [dp_gaps(r, one) for r in runs_f]
    out["race_repeat"] = [dp_gaps(r, planted["race"][0]) for r in planted["race"][1:]]
    for key in ("one_again", "swapped"):
        print(f"  one device, {key.replace('_', ' ')}: {_text(out[key])}")
    for i, g in enumerate(out["dp"]):
        print(f"  DP run {i}: {_text(g)} -> within the bounds: {dp_within(g, tol)}")
    for i, g in enumerate(out["dp_repeat"]):
        print(f"  DP run {i + 1} against run 0: {_text(g)} -> within the repeat bounds: {dp_within(g, DP_REPEAT_TOL)}")
    print(f"  under deterministic algorithms, largest gradient entry gap between two runs: "
          f"{out['deterministic_bits']}; operators without a deterministic version: {out['nondeterministic_ops']}")
    for fault in ("race", "local"):
        for g in out[fault]:
            print(f"  planted {fault!r}: {_text(g)} -> within the bounds: {dp_within(g, tol)}")
    for i, g in enumerate(out["race_repeat"]):
        print(f"  planted 'race' run {i + 1} against its run 0: {_text(g)} -> within the repeat bounds: "
              f"{dp_within(g, DP_REPEAT_TOL)}")
    del inputs
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--size", nargs="+", choices=sorted(SIZES), default=["resnet50", "resnet18"])
    ap.add_argument("--races", type=int, default=4, help="runs of the planted race")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu (where the race only reorders some sums)")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    set_fp32_matmul_precision()
    card = None
    if dev.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True).stdout.strip()
    print(f"device {dev} {card or ''}", flush=True)
    print(json.dumps(dict(card=card, **{arch: study(arch, dev, args.races) for arch in args.size})))


if __name__ == "__main__":
    main()
