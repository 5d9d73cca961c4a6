"""Two-pass collision escalation (port of ihmr_tpu/refine/escalation.py): the
reference's grid field for the samples that need it, the fast engine for
the rest.

  pass 1  the whole batch refines with ``optimize_batch`` at the config
          without escalation; its final pass gives each sample's EXACT
          collision (the per-sample ``collision_loss``).
  flag    samples whose exact collision exceeds ``escalate_collision``,
          worst first.
  pass 2  the flagged samples, padded with the worst one to a power-of-two
          bucket (``_bucket_size``), re-refine with the grid in the loop
          (``grid_config``): by default from pass-1's params with every
          stage's steps scaled by ``escalate_warm_start`` (``warm_strategy``),
          else from the initial params with the whole schedule.
  merge   a flagged sample takes its pass-2 result only where that lowered
          its exact collision (keep-best), so escalation never raises a
          sample's collision; ``results["escalated"]`` marks those samples.

The bucket is part of the numbers: the loss is a batch mean, so the bucket
size scales each sample's gradient (SGD feels it, and Adam through its
eps), as in the JAX package. Pass 1's per-sample collision comes to the
host once, for the flag decision; the merge stays on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ihmr_tpu_torch.mano.model import ManoModel
from ihmr_tpu_torch.refine.schedule import Stage

_MIN_BUCKET = 8


def _bucket_size(n: int, batch: int) -> int:
    """The smallest power of two >= n (at least ``_MIN_BUCKET``), at most
    the batch."""
    b = _MIN_BUCKET
    while b < n:
        b *= 2
    return min(b, batch)


def grid_config(config):
    """The pass-2 config: the grid in the loop at full sampling, no
    alternation, the grid rebuilt every block (``reselect_every_blocks=1``:
    staler grids resolve interlocks worse in the JAX package's study). With
    ``escalate_fast_build`` (the default) the build is K=1 over every second
    face, on a focused res-24 lattice, whatever the ``grid_*`` knobs say."""
    cfg = config.replace(
        loop_collision_fast=False,
        collision_backend="grid",
        loop_collision_subsample=1,
        loop_collision_face_subsample=1,
        loop_collision_alternate=False,
        escalate_collision=0.0,
        escalate_warm_start=0.0,
        reselect_every_blocks=1,
    )
    if config.escalate_fast_build:
        cfg = cfg.replace(grid_num_candidates=1, grid_face_subsample=2, grid_focus=True, grid_res=24)
    return cfg


def warm_strategy(strategy: Tuple[Stage, ...], frac: float) -> Tuple[Stage, ...]:
    """Every stage's step count scaled by ``frac``, at least 1 epoch (a stage
    never vanishes, so its filter/select guard still runs)."""
    return tuple(dataclasses.replace(s, epoch=max(1, int(round(s.epoch * frac)))) for s in strategy)


def optimize_batch_escalated(
    model: ManoModel,
    params_init: Dict[str, torch.Tensor],
    batch,
    strategy: Tuple[Stage, ...],
    config,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """``optimize_batch`` with grid escalation (``config.escalate_collision``
    > 0): the same (params, results) plus ``results["escalated"]``, a (B,)
    int32 mask of the samples whose result came from pass 2. Per-sample
    entries are merged; scalars (``total_loss``) stay pass 1's."""
    from ihmr_tpu_torch.refine.opt_engine import optimize_batch

    params1, results1 = optimize_batch(model, params_init, batch, strategy, config.replace(escalate_collision=0.0))
    coll1 = results1["collision_loss"]  # (B,) exact final collision
    device, bsz = coll1.device, coll1.shape[0]
    coll1_host = coll1.cpu()
    flagged = torch.nonzero(coll1_host > config.escalate_collision).flatten()
    escalated = torch.zeros(bsz, dtype=torch.int32, device=device)
    if flagged.numel() == 0:
        return params1, {**results1, "escalated": escalated}

    # worst first, so an overflow past the batch would keep the deepest
    flagged = flagged[torch.argsort(-coll1_host[flagged], stable=True)]
    k = flagged.numel()
    bucket = _bucket_size(k, bsz)
    idx = torch.cat([flagged, flagged[:1].expand(max(0, bucket - k))])[:bucket].to(device)

    def take(tree):
        return {key: x[idx] for key, x in tree.items()}

    warm = float(config.escalate_warm_start)
    init2 = take(params1) if warm > 0.0 else take(params_init)
    strategy2 = warm_strategy(strategy, warm) if warm > 0.0 else strategy
    batch2 = type(batch)(**{f.name: getattr(batch, f.name)[idx] for f in dataclasses.fields(batch)})
    params2, results2 = optimize_batch(model, init2, batch2, strategy2, grid_config(config))

    rows = torch.arange(k, device=device)
    better = results2["collision_loss"][:k] < coll1[idx[:k]]
    win, rows = idx[:k][better], rows[better]
    escalated[win] = 1

    def merge(mine, theirs):
        out = mine.clone()
        out[win] = theirs[rows].to(out.dtype)
        return out

    merged_params = {key: merge(x, params2[key]) for key, x in params1.items()}
    merged_results = {
        key: merge(x, results2[key]) if x.dim() >= 1 and x.shape[0] == bsz and key in results2 else x
        for key, x in results1.items()
    }
    merged_results["escalated"] = escalated
    return merged_params, merged_results
