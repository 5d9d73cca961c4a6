"""Where the stage-hoisted OPT engine and the full decode part over the full schedule.

    python -m ihmr_tpu_torch.engine_drift [--batch 128] [--seed 0] [--tol 5e-5] [--device cuda]
        [--threads N] [--epoch E]

The two engines (``OptConfig()`` and ``OptConfig(stage_hoist_decode=False)``)
compute the same function up to fp32 rounding. Over the full ``opt_default``
(4 x 301 Adam steps) their results part on some samples; this script finds
where and names the discrete choice that flips first.

1. Chained: ``optimize_batch`` with each engine from the same inputs; the
   final params' largest gap per sample, the samples above ``--tol`` and the
   final collision losses.
2. Stage by stage: both engines run each stage from the same entry params
   (the hoisted engine's result of the stage before), with every optimizer
   step's params and each discrete choice the step's gradient depends on
   recorded: every payload rebuild's nearest-face picks (the bf16 rank of
   ``pair_indices``); every step's in-loop contact set (the live queries
   with a positive depth against the frozen triangles); the signs of the
   2D joint residuals under the L1 self-consistency loss (its gradient is
   the residual's sign); the kinks of the finger prior (the signs of
   ``|C1|`` and of ``min(0, C2)``); and, for each query in contact, the
   region of its frozen triangle (face, edge or vertex) that holds its
   closest point (the depth's gradient follows it). Per sample that leaves ``--tol`` at
   some step: the first such step, the first step where each kind of
   choice differs between the engines, the first of those and the gap just
   before it, and whether the stage's snapshot choice differs.

Prints a readable report and, last, one JSON line with the numbers (also
written to ``chiprun_out/engine_drift.json`` when that directory exists).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import time

import torch

from ihmr_tpu_torch.data import make_opt_inputs
from ihmr_tpu_torch.device import resolve_device, set_fp32_matmul_precision
from ihmr_tpu_torch.losses import losses as L
from ihmr_tpu_torch.mano import synthetic_mano_model
from ihmr_tpu_torch.refine import opt_engine as TE
from ihmr_tpu_torch.refine.schedule import opt_default


def closest_regions(p: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    """The region of each triangle that holds the closest point to p, by the
    predicates of ``ops.collision.point_triangle_closest`` in its priority
    order: 0 face, 1 edge bc, 2 edge ac, 3 edge ab, 4 vertex c, 5 b, 6 a."""
    a, b, c = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
    ab, ac = b - a, c - a
    ap, bp, cp = p - a, p - b, p - c
    d1, d2 = (ab * ap).sum(-1), (ac * ap).sum(-1)
    d3, d4 = (ab * bp).sum(-1), (ac * bp).sum(-1)
    d5, d6 = (ab * cp).sum(-1), (ac * cp).sum(-1)
    va, vb, vc = d3 * d6 - d5 * d4, d5 * d2 - d1 * d6, d1 * d4 - d3 * d2
    region = torch.zeros(d1.shape, dtype=torch.int8, device=p.device)
    for code, inside in enumerate((
        (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0), (vb <= 0) & (d2 >= 0) & (d6 <= 0),
        (vc <= 0) & (d1 >= 0) & (d3 <= 0), (d6 >= 0) & (d5 <= d6), (d3 >= 0) & (d4 <= d3), (d1 <= 0) & (d2 <= 0),
    ), start=1):
        region = torch.where(inside, torch.tensor(code, dtype=torch.int8, device=p.device), region)
    return region


class Recorder:
    """Per-step params, per-rebuild picks and per-step contact sets of one
    ``run_stage`` call, taken through the engine module's own names."""

    def __init__(self):
        self.steps = []  # {group: (B, d)} after each optimizer step
        self.picks = []  # (step, idx_r, idx_l) at each payload rebuild
        self.contacts = []  # (B, 2*Vq) bool, one per gradient evaluation
        self.regions = []  # (B, 2*Vq) int8: closest_regions of the queries in contact, -1 elsewhere
        self.l1_signs = []  # (B, 84) signs of the 2D residuals, one per evaluation
        self.finger_signs = []  # (B, 20) signs of C1 and C2 < 0, one per evaluation

    @contextlib.contextmanager
    def patched(self):
        rec = self
        names = ("Adam", "SGD", "pair_indices", "pair_depths_at_tris")
        saved = {n: getattr(TE, n) for n in names}
        saved_losses = {n: getattr(L, n) for n in ("joints_2d_loss", "finger_reg_loss")}

        def recording(base):
            class Recording(base):
                def step(self, params, grads, lr):
                    out = super().step(params, grads, lr)
                    rec.steps.append({k: v.detach().clone() for k, v in out.items()})
                    return out

            return Recording

        def pair_indices(*args):
            idx = saved["pair_indices"](*args)
            rec.picks.append((len(rec.steps), *(i.clone() for i in idx)))
            return idx

        def pair_depths_at_tris(q_r, q_l, tri_r, tri_l, **kwargs):
            depths = saved["pair_depths_at_tris"](q_r, q_l, tri_r, tri_l, **kwargs)
            rec.contacts.append((depths > 0).detach().clone())
            with torch.no_grad():
                region = torch.cat([closest_regions(q_r, tri_r), closest_regions(q_l, tri_l)], dim=1)
            rec.regions.append(torch.where(depths > 0, region, torch.full_like(region, -1)))
            return depths

        def joints_2d_loss(gt, pred, weight):
            sign = torch.sign(gt - pred) * (weight > 0)
            rec.l1_signs.append(sign.detach().reshape(sign.shape[0], -1).to(torch.int8))
            return saved_losses["joints_2d_loss"](gt, pred, weight)

        def finger_reg_loss(joints_3d):
            c1, c2 = L.finger_terms(joints_3d.detach())
            rec.finger_signs.append(torch.cat([torch.sign(c1), (c2 < 0).to(c1.dtype)], dim=1).to(torch.int8))
            return saved_losses["finger_reg_loss"](joints_3d)

        try:
            TE.Adam, TE.SGD = recording(saved["Adam"]), recording(saved["SGD"])
            TE.pair_indices, TE.pair_depths_at_tris = pair_indices, pair_depths_at_tris
            L.joints_2d_loss, L.finger_reg_loss = joints_2d_loss, finger_reg_loss
            yield
        finally:
            for n, v in saved.items():
                setattr(TE, n, v)
            for n, v in saved_losses.items():
                setattr(L, n, v)


def _sample_gap(a, b, keys, B):
    """Per-sample largest |a - b| over the groups ``keys`` -> (B,)."""
    return torch.stack([(a[k] - b[k]).abs().reshape(B, -1).max(1).values for k in keys]).max(0).values


def _snapshot_choice(entry, rec, best, groups, freq, B):
    """Per sample, the snapshot step whose params the stage kept (-1: none
    equal, which cannot happen in the block engine)."""
    choice = torch.full((B,), -1, dtype=torch.long, device=best[groups[0]].device)
    n = len(rec.steps)
    for j0 in range(0, n, freq):
        snap = entry if j0 == 0 else rec.steps[j0 - 1]
        same = torch.stack([(snap[k] == best[k]).all(-1) for k in groups]).all(0)
        choice = torch.where(same & (choice < 0), torch.full_like(choice, j0), choice)
    return choice


def stage_drift(mano, entry, batch, stage, tol):
    """Both engines through one stage from ``entry`` -> (report dict, the
    hoisted engine's result)."""
    B = batch.hand_type_array.shape[0]
    groups = list(stage.update_params)
    recs, outs = {}, {}
    for hoist in (True, False):
        recs[hoist] = Recorder()
        with recs[hoist].patched():
            # eager steps: the recorder patches names that a captured step would call only once
            outs[hoist] = TE.run_stage(mano, entry, batch, stage, TE.OptConfig(stage_hoist_decode=hoist), _graph=False)
    rh, rf = recs[True], recs[False]
    gaps = torch.stack([_sample_gap(a, b, groups, B) for a, b in zip(rh.steps, rf.steps)])  # (steps, B)
    none = gaps.new_zeros((1, B), dtype=torch.long)  # a stage without in-loop collision
    pick_diff = torch.stack([(a[1] != b[1]).sum(1) + (a[2] != b[2]).sum(1) for a, b in zip(rh.picks, rf.picks)]
                            or [none[0]])  # (rebuilds, B)
    pick_steps = [p[0] for p in rh.picks] or [0]
    def per_step(a, b):  # (evaluations, B) counts of differing choices
        return torch.stack([(x != y).sum(1) for x, y in zip(a, b)] or [none[0]])

    contact_diff = per_step(rh.contacts, rf.contacts)
    region_diff = per_step(rh.regions, rf.regions)
    l1_diff = per_step(rh.l1_signs, rf.l1_signs)
    finger_diff = per_step(rh.finger_signs, rf.finger_signs)
    freq = TE.OptConfig().save_mid_freq
    choice = {h: _snapshot_choice(entry, recs[h], outs[h], groups, freq, B) for h in (True, False)}
    end_gap = _sample_gap(outs[True], outs[False], groups, B)

    gaps, pick_diff, contact_diff, region_diff, l1_diff, finger_diff, end_gap = (
        t.cpu() for t in (gaps, pick_diff, contact_diff, region_diff, l1_diff, finger_diff, end_gap))
    samples = []
    for b in range(B):
        over = torch.nonzero(gaps[:, b] > tol).flatten()
        if not len(over) and end_gap[b] <= tol:
            continue
        first_over = int(over[0]) if len(over) else None
        picks_at = torch.nonzero(pick_diff[:, b]).flatten()
        first_pick = int(picks_at[0]) if len(picks_at) else None
        events = []
        if first_pick is not None:
            # a rebuild at step s picks the triangles of the steps from s on
            events.append((pick_steps[first_pick], "nearest-face pick", int(pick_diff[first_pick, b])))
        first_at = {}
        for kind, diff in (("contact set", contact_diff), ("closest-point region", region_diff),
                           ("L1 residual sign", l1_diff), ("finger-prior sign", finger_diff)):
            at = torch.nonzero(diff[:, b]).flatten()
            if len(at):
                # evaluation t's choices drive the update of step t
                first_at[kind] = int(at[0])
                events.append((int(at[0]), kind, int(diff[at[0], b])))
        events.sort()
        first = events[0] if events else None
        samples.append(dict(
            sample=b,
            first_step_over_tol=first_over,
            end_gap=float(end_gap[b]),
            max_gap=float(gaps[:, b].max()),
            first_pick_flip_step=pick_steps[first_pick] if first_pick is not None else None,
            first_flip_step_by_kind=first_at,
            gap_before_first_over=None if not first_over else float(gaps[first_over - 1, b]),
            first_event=None if first is None else dict(step=first[0], kind=first[1], queries=first[2]),
            gap_before_first_event=None if first is None or first[0] == 0 else float(gaps[first[0] - 1, b]),
            snapshot_hoisted=int(choice[True][b]),
            snapshot_full=int(choice[False][b]),
        ))
    report = dict(
        stage="+".join(groups),
        steps=len(rh.steps),
        samples_over_tol_at_end=int((end_gap > tol).sum()),
        samples_over_tol_at_any_step=int((gaps > tol).any(0).sum()),
        max_end_gap=float(end_gap.max()),
        rebuilds=len(rh.picks),
        samples_with_pick_flips=int((pick_diff > 0).any(0).sum()),
        samples_with_contact_flips=int((contact_diff > 0).any(0).sum()),
        samples_with_region_flips=int((region_diff > 0).any(0).sum()),
        samples_with_l1_sign_flips=int((l1_diff > 0).any(0).sum()),
        samples_with_finger_sign_flips=int((finger_diff > 0).any(0).sum()),
        samples=samples,
    )
    return report, outs[True]


def _print_stage(r, tol):
    print(f"stage {r['stage']} ({r['steps']} steps, {r['rebuilds']} payload rebuilds): samples above {tol} at the "
          f"end {r['samples_over_tol_at_end']}, at any step {r['samples_over_tol_at_any_step']}; largest end gap "
          f"{r['max_end_gap']:.3e}; samples whose choices differ at some step: nearest-face picks "
          f"{r['samples_with_pick_flips']}, contact sets {r['samples_with_contact_flips']}, closest-point regions "
          f"{r['samples_with_region_flips']}, L1 residual signs "
          f"{r['samples_with_l1_sign_flips']}, finger-prior signs {r['samples_with_finger_sign_flips']}")
    for s in r["samples"]:
        ev = s["first_event"]
        ev_txt = "no discrete difference" if ev is None else (
            f"first difference: {ev['kind']} at step {ev['step']} ({ev['queries']} choices), gap before it "
            f"{s['gap_before_first_event'] if s['gap_before_first_event'] is not None else 0.0:.3e}")
        print(f"  sample {s['sample']}: first step above tol {s['first_step_over_tol']} (gap the step before "
              f"{s['gap_before_first_over'] or 0.0:.3e}), end gap {s['end_gap']:.3e} (max {s['max_gap']:.3e}); "
              f"{ev_txt}; first step per kind {s['first_flip_step_by_kind']}, pick {s['first_pick_flip_step']}; "
              f"snapshot kept hoisted {s['snapshot_hoisted']} / full {s['snapshot_full']}")


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tol", type=float, default=5e-5)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--threads", type=int, default=None, help="torch CPU threads")
    ap.add_argument("--epoch", type=int, default=None, help="cut every stage to this many epochs (default: full)")
    args = ap.parse_args()
    if args.threads:
        torch.set_num_threads(args.threads)
    dev = resolve_device(args.device)
    set_fp32_matmul_precision()
    card = None
    if dev.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True).stdout.strip()
    print(f"device {dev} {card or ''}; B={args.batch}, seed {args.seed}, opt_default, tol {args.tol}"
          + ("" if args.epoch is None else f", stages cut to epoch {args.epoch}"), flush=True)
    mano = synthetic_mano_model(device=dev)
    params, batch = make_opt_inputs(mano, batch=args.batch, seed=args.seed)
    B = args.batch
    strategy = opt_default if args.epoch is None else tuple(dataclasses.replace(s, epoch=args.epoch) for s in opt_default)
    steps = "+".join(str(s.epoch + 1) for s in strategy)

    t0 = time.perf_counter()
    chained = {h: TE.optimize_batch(mano, params, batch, strategy, TE.OptConfig(stage_hoist_decode=h))
               for h in (True, False)}
    gap = _sample_gap(chained[True][0], chained[False][0], list(params), B).cpu()
    coll = {h: chained[h][1]["collision_loss"].cpu() for h in (True, False)}
    over = gap[gap > args.tol]
    chain = dict(
        samples_over_tol=int(len(over)), samples_over_1e_4=int((gap > 1e-4).sum()),
        median_gap_over_tol=float(over.median()) if len(over) else 0.0, max_gap=float(gap.max()),
        mean_collision_hoisted=float(coll[True].mean()), mean_collision_full=float(coll[False].mean()),
        max_collision_gap=float((coll[True] - coll[False]).abs().max()),
    )
    print(f"chained, {steps} steps ({time.perf_counter() - t0:.1f}s): final params above {args.tol} on "
          f"{chain['samples_over_tol']}/{B} samples (above 1e-4: {chain['samples_over_1e_4']}), median of those "
          f"{chain['median_gap_over_tol']:.3e}, largest {chain['max_gap']:.3e}; mean collision hoisted "
          f"{chain['mean_collision_hoisted']:.6f}, full {chain['mean_collision_full']:.6f}, largest per-sample gap "
          f"{chain['max_collision_gap']:.3e}", flush=True)

    stages, entry = [], params
    for stage in strategy:
        r, entry = stage_drift(mano, entry, batch, stage, args.tol)
        _print_stage(r, args.tol)
        stages.append(r)
    events = [s["first_event"]["kind"] if s["first_event"] else "none" for r in stages for s in r["samples"]]
    summary = {kind: events.count(kind) for kind in sorted(set(events))}
    print(f"first discrete difference of each sample that left tol, over the stages: {summary}")
    out = dict(device=str(dev), card=card, batch=B, seed=args.seed, tol=args.tol, steps=steps, chained=chain,
               first_event_kinds=summary, stages=stages, seconds=time.perf_counter() - t0)
    if os.path.isdir("chiprun_out"):
        with open(os.path.join("chiprun_out", "engine_drift.json"), "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(dict(out, stages=[{k: v for k, v in r.items() if k != "samples"} for r in stages])), flush=True)


if __name__ == "__main__":
    main()
