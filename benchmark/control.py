"""The control of a cell's check, and its planted faults, on the card.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 [--faults]

The control is the plain reference put in the program's place and computed
in the precision just below the configuration's: float32 with TF32 on, where
the configuration states float32 without it. Its outputs go through the
cell's own comparison with the float32 reference, at the cell's own size,
and each number is printed beside its limit; the control must fail at least
one of them. With ``--faults`` the planted faults of the cell follow, each
in the reference put in the program's place:

  * OPT: half of the batch left out of the refinement (those hands keep
    their initial parameters); one hand's exact depths altered where they
    are produced; every Adam step returning its state unchanged;
  * training: half of the batch left out, the loss a mean over the rest.
    (A state left unchanged reads 1 by the update comparison and needs no
    run.)

One JSON line per seed and case goes to standard output. The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH.parent))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.inputs import draws, mano_hand  # noqa: E402
from benchmark.reference import opt as ref_opt  # noqa: E402
from benchmark.reference import resnet as ref_resnet  # noqa: E402
from benchmark.reference import train as ref_train  # noqa: E402


def tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def opt_outputs(config, params, hand, seed, index, h, device, half=False, frozen=False, alter=False):
    """The reference in the program's place -> (refined, results, pred, hand_type)."""
    B = h["gt_pose"].shape[0]
    weights = draws.encoder_weights(device, seed)
    images = draws.images(device, seed, index, B, config["image_size"], "uniform")
    blk = params["check_block"]
    with torch.no_grad():
        outs = [ref_resnet.encoder(weights, images[s:s + blk], ref_resnet.mean_params(device)) for s in range(0, B, blk)]
    del weights, images
    pred, hand_type = torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])
    init = draws.init_params(h)
    if frozen:
        refined = {k: v.clone() for k, v in init.items()}
    else:
        rows = torch.arange(B // 2 if half else B, device=device)
        sub = draws.take(h, rows)
        part = ref_opt.optimize(hand, draws.init_params(sub), sub, config["stages"], config["opt_config"], B)
        refined = {k: torch.cat([part[k], init[k][len(rows):]]) for k in init}
    fp = ref_opt.final_pass(hand, refined, h, config["final_weights"], blk)
    depths = fp["depths"].clone()
    if alter:
        depths[B // 3, 100] += 1e-2
    results = {"pred_right_hand_verts": fp["right_verts"], "pred_left_hand_verts": fp["left_verts"],
               "pred_joints_3d": fp["joints_3d"], "collision_loss_origin_scale": depths,
               **{k: fp[k] for k in ("total_loss", "joints_2d_loss", "joints_3d_loss", "hand_trans_loss")}}
    return refined, results, pred, hand_type


def opt_case(mod, config, params, seed, device, case):
    hand = mano_hand.tensors(device)
    h = draws.hands(hand, seed, 0, params["batch"])
    tf32(case == "control")
    outs = opt_outputs(config, params, hand, seed, 0, h, device, half=case == "half_batch",
                       frozen=case == "state_unchanged", alter=case == "answer_altered")
    tf32(False)
    gaps = mod.compare(config, params, hand, seed, 0, h, *outs, device)
    gaps.pop("_final")
    return gaps


def train_case(mod, config, params, seed, device, case):
    drv = mod.Driver(config, params, seed, device)
    drv.hand = mano_hand.tensors(device)
    p = params["label_sets"]
    batches = [drv.batch_dict(i, drv.labels(i % p)) for i in range(params["check_steps"])]
    if case == "half_batch":
        half = params["batch"] // 2
        batches = [{k: v[:half] for k, v in b.items()} for b in batches]
    weights = draws.encoder_weights(device, seed)
    tf32(case == "control")
    out = ref_train.run_steps(weights, batches, drv.hand, config["lr"], config["loss_weights"])
    tf32(False)
    prog = {
        "loss": out["loss"],
        "grad1": {k: float(torch.linalg.vector_norm(g.double())) for k, g in out["grad1"].items()},
        "change": {k: float(torch.linalg.vector_norm((v - weights[k]).double())) for k, v in out["params"].items()},
        "running1": {k: float(torch.linalg.vector_norm(v.double())) for k, v in out["running1"].items()},
    }
    del out
    return mod.compare(drv, prog)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    workload, config = harness.cell_files(args.workload, BENCH)
    mod = harness.load_file(BENCH / "traffic" / f"{workload['driver']}.py", "control_driver")
    device = torch.device(args.device)
    params = workload["params"]
    is_opt = workload["driver"] == "opt_batches"
    cases = ["control"]
    if args.faults:
        cases += ["half_batch", "answer_altered", "state_unchanged"] if is_opt else ["half_batch"]
    for seed in args.seeds:
        for case in cases:
            t = time.perf_counter()
            gaps = (opt_case if is_opt else train_case)(mod, config, params, seed, device, case)
            failed = [k for k, v in gaps.items() if k in params["limits"] and v > params["limits"][k]]
            print(json.dumps({"workload": args.workload, "seed": seed, "case": case, "gaps": gaps, "fails": failed,
                              "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
