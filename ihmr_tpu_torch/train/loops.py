"""The baseline training loop (port of ``train_baseline_loop`` in
ihmr_tpu/train/loops.py).

A loader is any iterable of ``BaselineBatch``es with ``len`` and
``set_epoch`` (``data.BatchList``). Not ported yet: the visualizer hook
(``utils/``) and ``test_baseline_loop`` (the ``Evaluator``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ihmr_tpu_torch.mano.model import ManoModel
from ihmr_tpu_torch.refine.adam import Adam
from ihmr_tpu_torch.train import checkpoint as ckpt
from ihmr_tpu_torch.train.baseline import (
    BaselineState,
    TrainConfig,
    learning_rate_for_epoch,
    set_learning_rate,
    train_step,
)
from ihmr_tpu_torch.train.stats import LossStat, TimeStat


def _state_info(state: BaselineState, epoch: int) -> Dict:
    adam = state.adam
    return {"epoch": epoch, "lr": state.lr, "adam": {"t": adam.t, "m": adam.m, "v": adam.v}}


def save_state(checkpoints_dir: str, state: BaselineState, epoch: int, label: str) -> None:
    """The encoder (weights and running statistics) as ``{label}_net_baseline.pth``
    and the epoch, learning rate and Adam state as ``{label}_info.pth``."""
    ckpt.save_network(checkpoints_dir, state.encoder.state_dict(), "baseline", label)
    ckpt.save_info(checkpoints_dir, _state_info(state, epoch), label)


def resume_state(checkpoints_dir: str, state: BaselineState, config: TrainConfig, label: str = "latest") -> int:
    """Load the ``label`` checkpoint into ``state`` (encoder, Adam, learning
    rate) and return the epoch to start from: the saved epoch + 1, or 1 when
    there is no checkpoint. The learning rate is the schedule's value after
    the saved epoch, the one a run that had not stopped would use."""
    weights = ckpt.load_network(checkpoints_dir, "baseline", label)
    info = ckpt.load_info(checkpoints_dir, label)
    if weights is None or info is None:
        return 1
    state.encoder.load_state_dict(weights, strict=True)
    dev = state.mean_params.device
    adam = Adam({}, lr_last=True)
    adam.m = {k: v.to(dev) for k, v in info["adam"]["m"].items()}
    adam.v = {k: v.to(dev) for k, v in info["adam"]["v"].items()}
    adam.t = int(info["adam"]["t"])
    if set(adam.m) != set(dict(state.encoder.named_parameters())):
        raise KeyError("the checkpoint's Adam state does not cover the encoder's parameters")
    state.adam = adam
    epoch = int(info["epoch"])
    state.epoch = epoch
    set_learning_rate(state, learning_rate_for_epoch(config, epoch))
    return epoch + 1


def train_baseline_loop(
    state: BaselineState,
    loader,
    mano_right: ManoModel,
    mano_left: ManoModel,
    config: TrainConfig,
    checkpoints_dir: str,
    start_epoch: int = 1,
    print_freq: int = 2048,
    save_epoch_freq: int = 5,
    is_main: bool = True,
    epoch_stats: Optional[List[Dict]] = None,
) -> BaselineState:
    """Epochs ``start_epoch`` .. ``config.total_epoch``: a train step per
    batch at the epoch's learning rate, running losses printed every
    ``print_freq`` samples, then (main process) the epoch's time split, a
    checkpoint every ``save_epoch_freq`` epochs and the ``latest`` one, and
    the next epoch's learning rate (the first epoch runs at ``state.lr``).

    Each step's losses are read to the host in one transfer, which also ends
    the step's device work, so ``TimeStat``'s forward time is the steps'
    time. ``epoch_stats``, when given, receives per epoch: "epoch",
    "step_seconds" (data + forward time, the checkpoint excluded), "steps"
    and "total_loss" (each step's)."""
    loss_stat = LossStat(len(loader))
    time_stat = TimeStat(config.total_epoch)
    for epoch in range(start_epoch, config.total_epoch + 1):
        loader.set_epoch(epoch)
        loss_stat.set_epoch(epoch)
        time_stat.epoch_init(epoch)
        printed = 0
        step_losses = []
        for i, batch in enumerate(loader):
            time_stat.stat_data_time()
            state, metrics = train_step(state, batch, mano_right, mano_left, config)
            values = dict(zip(metrics, torch.stack(list(metrics.values())).tolist()))  # one host sync per step
            time_stat.stat_forward_time()
            n = int(batch.img.shape[0])
            step_losses.append(values["total_loss"])
            loss_stat.update(values, n=n)
            printed += n
            if is_main and printed >= print_freq:
                loss_stat.print_loss(i)
                printed = 0
            time_stat.stat_visualize_time()
        if epoch_stats is not None:
            epoch_stats.append(dict(
                epoch=epoch, step_seconds=time_stat.data_time + time_stat.forward_time,
                steps=len(step_losses), total_loss=step_losses,
            ))
        if is_main:
            time_stat.print_stat()
            if epoch % save_epoch_freq == 0:
                save_state(checkpoints_dir, state, epoch, str(epoch))
            save_state(checkpoints_dir, state, epoch, "latest")
        lr = learning_rate_for_epoch(config, epoch)
        set_learning_rate(state, lr)
        state.epoch = epoch
        if is_main:
            print(f"Current Learning Rate:{lr:.2E}", flush=True)
    return state
