"""IHMR-MLP stage-wise training and full-cascade evaluation (port of
ihmr_tpu/train/mlp.py).

(a) ``warm_pass``: a no-grad pass caches the baseline-seeded predictions and
losses of every sample; (b) ``train_mlp_stages``: per stage a fresh
SubNetwork and Adam, a few epochs of retrieve -> stage-MLP residual -> loss
-> step, with a per-epoch cosine learning rate; then a no-grad selection
pass accepts or rejects the update per sample and writes the survivors back
to the caches; (c) ``test_mlp_loop``: the full cascade per batch.

A loader is any iterable of MLPBatches with ``len`` and ``set_epoch``
(``data.BatchList``). With a ``checkpoints_dir`` each trained stage network
is saved as ``latest_net_mlp_stage_{k:02d}.pth`` (``train/checkpoint.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ihmr_tpu_torch.mano.model import ManoModel
from ihmr_tpu_torch.models.encoder import SubNetwork, init_subnetwork_weights
from ihmr_tpu_torch.refine.adam import Adam
from ihmr_tpu_torch.refine.mlp_engine import (
    _FILTER_KEY,
    _TRACKED,
    MLPBatch,
    MLPCaches,
    apply_stage_mlp,
    compute_losses,
    make_cascade_apply,
    seed_from_backbone,
    select_better_params,
)
from ihmr_tpu_torch.refine.opt_engine import OptConfig, ParamDict
from ihmr_tpu_torch.refine.schedule import MLP_DEFAULT_LOSS_WEIGHTS, Stage
from ihmr_tpu_torch.train import checkpoint as ckpt
from ihmr_tpu_torch.train.stats import LossStat

_MLP_LOSS_NAMES = (
    "total_loss",
    "joints_2d_loss",
    "joints_3d_loss",
    "mano_pose_loss",
    "mano_shape_loss",
    "hand_trans_loss",
    "shape_reg_loss",
    "shape_residual_loss",
    "collision_loss",
)

# the cosine decay's denominator: the reference's global epoch count
LR_TOTAL_EPOCH = 100


def init_stage_subnetwork(stage: Stage, generator: torch.Generator, device: torch.device) -> SubNetwork:
    """A stage's fresh SubNetwork with seeded initial weights, on ``device``."""
    net = SubNetwork(stage.update_dim)
    init_subnetwork_weights(net, generator)
    return net.to(device)


def make_stage_train_step(model: ManoModel, stage: Stage, config: OptConfig):
    """(subnet, adam, batch, cached prev params, lr) -> metrics: one Adam step
    of the stage network on the stage's weighted loss, collision on the fast
    in-loop backend. The network's parameters are updated in place."""
    weights = stage.weights

    def step(subnet: SubNetwork, adam: Adam, batch: MLPBatch, prev_params: ParamDict, lr: float):
        p = apply_stage_mlp(subnet, stage, batch.img_feat, prev_params)
        total, aux = compute_losses(model, p, batch, weights, config, in_loop=True)
        params = dict(subnet.named_parameters())
        grads = torch.autograd.grad(total, list(params.values()))
        new = adam.step({k: v.detach() for k, v in params.items()}, dict(zip(params, grads)), lr)
        with torch.no_grad():
            for k, v in params.items():
                v.copy_(new[k])
        metrics = {k: aux[k].detach() for k in _MLP_LOSS_NAMES if k != "total_loss"}
        metrics["total_loss"] = total.detach()
        return metrics

    return step


def make_stage_select_step(model: ManoModel, stage: Stage, config: OptConfig):
    """(subnet, batch, prev params, prev losses) -> (params, tracked losses) to
    write back to the caches: the stage update, accepted or rejected per
    sample, scored at the default loss weights on the exact backend."""
    weights = dict(MLP_DEFAULT_LOSS_WEIGHTS)

    @torch.no_grad()
    def select(subnet: SubNetwork, batch: MLPBatch, prev_params: ParamDict, prev_losses: Dict[str, torch.Tensor]):
        p_new = apply_stage_mlp(subnet, stage, batch.img_feat, prev_params)
        _, aux = compute_losses(model, p_new, batch, weights, config)
        cur_losses = {k: aux[k] for k in _TRACKED}
        return select_better_params(stage, p_new, cur_losses, prev_params, prev_losses)

    return select


@torch.no_grad()
def warm_pass(model: ManoModel, loader, caches: MLPCaches, config: OptConfig) -> None:
    """Fill the caches with the backbone-seeded predictions and losses."""
    weights = dict(MLP_DEFAULT_LOSS_WEIGHTS)
    for batch in loader:
        p = seed_from_backbone(batch)
        _, aux = compute_losses(model, p, batch, weights, config)
        caches.save(batch.index, batch.img_feat, p, aux)


def train_mlp_stages(
    model: ManoModel,
    strategy: Sequence[Stage],
    loader,
    caches: MLPCaches,
    config: OptConfig,
    generator: Optional[torch.Generator] = None,
    is_main: bool = True,
    sync_fn: Optional[Callable[[MLPCaches], None]] = None,
    print_freq: int = 10,
    stage_stats: Optional[List[Dict]] = None,
    checkpoints_dir: Optional[str] = None,
) -> List[SubNetwork]:
    """Stage-wise training -> the trained SubNetwork of every stage.

    Each stage's network comes from ``init_stage_subnetwork`` drawing on
    ``generator`` (seed 0 when None). Its Adam step count runs through the
    whole stage; with ``lr_decay_type="cosine"`` the learning rate of epoch
    e (from 1) is 0.5 * (1 + cos(pi * e / LR_TOTAL_EPOCH)) * stage.lr, where
    ``LR_TOTAL_EPOCH`` is the global epoch count (100), so the decay is
    nearly flat inside a 2-5 epoch stage, as in the reference. The update
    is optax's Adam (``Adam(lr_last=True)``).

    Prints running-average losses every ``print_freq`` batches and, per
    stage, the share of samples that accepted the update and the mean select
    loss before and after the selection pass; those also go to
    ``stage_stats`` when given. ``sync_fn(caches)`` runs after every
    selection pass. The main process saves each trained network to
    ``checkpoints_dir`` when one is given."""
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    device = caches.exists.device
    subnets = []
    for stage_id, stage in enumerate(strategy):
        subnet = init_stage_subnetwork(stage, generator, device)
        adam = Adam(dict(subnet.named_parameters()), lr_last=True)
        step = make_stage_train_step(model, stage, config)
        loss_stat = LossStat(len(loader), names=_MLP_LOSS_NAMES)
        for epoch in range(1, stage.epoch + 1):
            lr = stage.lr
            if stage.lr_decay_type == "cosine":
                lr = float(0.5 * (1.0 + np.cos(np.pi * epoch / LR_TOTAL_EPOCH)) * stage.lr)
            loader.set_epoch(epoch)
            loss_stat.set_epoch(epoch)
            printed_last = False
            for batch_idx, batch in enumerate(loader):
                _feat, prev_params, _losses = caches.retrieve(batch.index)
                metrics = step(subnet, adam, batch, prev_params, lr)
                values = torch.stack(list(metrics.values())).tolist()  # one host sync per step
                loss_stat.update(dict(zip(metrics, values)), int(batch.index.shape[0]))
                printed_last = (batch_idx + 1) % print_freq == 0
                if is_main and printed_last:
                    print(f"stage:{stage_id:02d} ", end="")
                    loss_stat.print_loss(batch_idx + 1)
            if is_main and not printed_last:
                print(f"stage:{stage_id:02d} ", end="")
                loss_stat.print_loss(len(loader))

        select = make_stage_select_step(model, stage, config)
        sel_key = _FILTER_KEY[stage.select_loss]
        accepted = torch.zeros((), dtype=torch.int64, device=device)
        sel_before = torch.zeros((), device=device)
        sel_after = torch.zeros((), device=device)
        total_n = 0
        for batch in loader:
            feat, prev_params, prev_losses = caches.retrieve(batch.index)
            p_sel, sel_losses = select(subnet, batch, prev_params, prev_losses)
            # a sample accepted the update iff one of the stage's groups changed
            changed = torch.stack([(p_sel[k] != prev_params[k]).any(-1) for k in stage.update_params]).any(0)
            accepted += changed.sum()
            total_n += changed.shape[0]
            sel_before += prev_losses[sel_key].sum()
            sel_after += sel_losses[sel_key].sum()
            caches.save(batch.index, feat, p_sel, sel_losses)
        if sync_fn is not None:
            sync_fn(caches)
        n = max(total_n, 1)
        stat = dict(
            stage=stage_id,
            accepted_frac=int(accepted) / n,
            select_loss=stage.select_loss,
            select_before=float(sel_before) / n,
            select_after=float(sel_after) / n,
        )
        if stage_stats is not None:
            stage_stats.append(stat)
        if is_main:
            print(
                f"stage:{stage_id:02d} SELECT accept={stat['accepted_frac']:.3f} "
                f"{stage.select_loss}: {stat['select_before']:.5f} -> {stat['select_after']:.5f}",
                flush=True,
            )
        subnets.append(subnet)
        if checkpoints_dir and is_main:
            ckpt.save_network(checkpoints_dir, subnet.state_dict(), "mlp", "latest", stage_id=stage_id)
    return subnets


def test_mlp_loop(
    model: ManoModel,
    strategy: Sequence[Stage],
    subnets: Sequence[SubNetwork],
    loader,
    config: OptConfig,
) -> List[Dict[str, torch.Tensor]]:
    """The full cascade over every batch of ``loader`` -> one results dict
    per batch (the cascade's outputs plus ``index``). The JAX loop feeds
    these to its ``Evaluator``, which is not ported yet (the ``eval/``
    slice)."""
    cascade = make_cascade_apply(model, strategy, dict(MLP_DEFAULT_LOSS_WEIGHTS), config)
    out = []
    for batch in loader:
        _params, results = cascade(subnets, batch)
        out.append(dict(results, index=batch.index))
    return out


test_mlp_loop.__test__ = False  # not a pytest test
