"""The run loops (port of ihmr_tpu/train/loops.py): baseline training, the
baseline evaluation and the IHMR-OPT runner, the last two ending in an
``Evaluator``.

``train_baseline_loop`` takes a loader of ``BaselineBatch``es with ``len``
and ``set_epoch`` (``data.BatchList``, or a dataset's ``BatchLoader`` behind
``BatchAdapter(loader, _to_baseline_batch, device)``); the MLP loops take
``MLPBatch``es the same way (``_to_mlp_batch``). ``test_baseline_loop`` and
``optimize_loop`` take, as the JAX loops do, any iterable of raw batch
dicts with the datasets' keys (numpy arrays; ``_to_baseline_batch`` and
``_to_opt_batch`` say which) and a ``dataset`` whose ``data_list`` names the
samples (None: the Evaluator names them by index). With a ``visualizer``
(``utils.visualizer.Visualizer``) the training loop renders the training
panels every ``display_freq`` samples on the main process.
"""

from __future__ import annotations

import os.path as osp
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ihmr_tpu_torch.device import DeviceLike, resolve_device
from ihmr_tpu_torch.eval import Evaluator, evaluator_for, results_to_host
from ihmr_tpu_torch.mano.model import ManoModel
from ihmr_tpu_torch.refine.adam import Adam
from ihmr_tpu_torch.refine.mlp_engine import MLPBatch
from ihmr_tpu_torch.refine.opt_engine import OptBatch, OptConfig, ParamDict, optimize_batch, params_from_init
from ihmr_tpu_torch.refine.schedule import Stage
from ihmr_tpu_torch.train import checkpoint as ckpt
from ihmr_tpu_torch.train.baseline import (
    BaselineBatch,
    BaselineState,
    TrainConfig,
    eval_step,
    learning_rate_for_epoch,
    set_learning_rate,
    train_step,
)
from ihmr_tpu_torch.train.stats import LossStat, OptTimeStat, TimeStat
from ihmr_tpu_torch.utils import io_utils


def _to_baseline_batch(batch: Dict[str, np.ndarray], device: DeviceLike = None) -> BaselineBatch:
    """A raw baseline-dataset batch (img, hand_type_array, hand_type_valid,
    joints_2d, joints_3d, mano_pose, mano_betas, mano_params_weight,
    hand_trans, do_flip) as a BaselineBatch on ``device``."""
    dev = resolve_device(device)

    def t(key):
        return torch.as_tensor(np.asarray(batch[key]), device=dev)

    return BaselineBatch(
        img=t("img"),
        hand_type_array=t("hand_type_array"),
        hand_type_valid=t("hand_type_valid"),
        joints_2d=t("joints_2d"),
        joints_3d=t("joints_3d"),
        gt_pose_params=t("mano_pose"),
        gt_shape_params=t("mano_betas"),
        mano_params_weight=t("mano_params_weight"),
        hand_trans=t("hand_trans"),
        do_flip=t("do_flip"),
    )


def _to_opt_batch(batch: Dict[str, np.ndarray], device: DeviceLike = None) -> Tuple[ParamDict, OptBatch]:
    """A raw OPT-dataset batch (the baseline's predictions init_cam,
    init_pose_params, init_shape_params, init_hand_trans, init_joints_2d,
    init_joints_3d, init_hand_trans_j and the ground truth of
    ``_to_baseline_batch`` without img and do_flip) as (initial params,
    OptBatch) on ``device``."""
    dev = resolve_device(device)

    def t(key):
        return torch.as_tensor(np.asarray(batch[key]), device=dev)

    params = params_from_init(t("init_cam"), t("init_pose_params"), t("init_shape_params"), t("init_hand_trans"))
    opt_batch = OptBatch(
        hand_type_array=t("hand_type_array"),
        hand_type_valid=t("hand_type_valid"),
        joints_2d=t("joints_2d"),
        joints_3d=t("joints_3d"),
        gt_pose_params=t("mano_pose"),
        gt_shape_params=t("mano_betas"),
        mano_params_weight=t("mano_params_weight"),
        hand_trans=t("hand_trans"),
        init_joints_2d=t("init_joints_2d"),
        init_joints_3d=t("init_joints_3d"),
        init_hand_trans_j=t("init_hand_trans_j"),
    )
    return params, opt_batch


def _to_mlp_batch(batch: Dict[str, np.ndarray], device: DeviceLike = None) -> MLPBatch:
    """A raw MLP-dataset batch (the keys of ``_to_opt_batch`` without
    init_hand_trans_j, plus img_feat and index) as an MLPBatch on ``device``."""
    dev = resolve_device(device)

    def t(key):
        return torch.as_tensor(np.asarray(batch[key]), device=dev)

    init_trans = np.asarray(batch["init_hand_trans"])
    return MLPBatch(
        hand_type_array=t("hand_type_array"),
        hand_type_valid=t("hand_type_valid"),
        joints_2d=t("joints_2d"),
        joints_3d=t("joints_3d"),
        gt_pose_params=t("mano_pose"),
        gt_shape_params=t("mano_betas"),
        mano_params_weight=t("mano_params_weight"),
        hand_trans=t("hand_trans"),
        img_feat=t("img_feat"),
        init_joints_2d=t("init_joints_2d"),
        init_joints_3d=t("init_joints_3d"),
        init_cam=t("init_cam"),
        init_pose_params=t("init_pose_params"),
        init_shape_params=t("init_shape_params"),
        init_hand_trans=torch.as_tensor(init_trans.reshape(init_trans.shape[0], -1)[:, :3], device=dev),
        index=torch.as_tensor(np.asarray(batch["index"], np.int64), device=dev),
    )


class BatchAdapter:
    """A loader of raw dataset batches (``data.BatchLoader``) seen as the
    loader a loop takes: each batch passed through ``convert(raw, device)``
    (``_to_baseline_batch``, ``_to_mlp_batch``; None: the raw dict as it is),
    with the wrapped loader's ``len``, ``set_epoch`` and ``batch_size``.
    ``data_seconds`` adds up the host time spent waiting for batches and
    converting them, over every pass."""

    def __init__(self, loader, convert: Optional[Callable] = None, device: DeviceLike = None):
        self.loader = loader
        self.convert = convert
        self.device = resolve_device(device) if convert is not None else None
        self.data_seconds = 0.0

    def __len__(self) -> int:
        return len(self.loader)

    @property
    def batch_size(self) -> int:
        return self.loader.batch_size

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t0 = time.perf_counter()
            try:
                raw = next(it)
            except StopIteration:
                self.data_seconds += time.perf_counter() - t0
                return
            batch = raw if self.convert is None else self.convert(raw, self.device)
            self.data_seconds += time.perf_counter() - t0
            yield batch


@torch.no_grad()
def _display(visualizer, state, batch, mano_right, mano_left, config, epoch, i, steps, values) -> None:
    """The training loop's visualizer hook: one eval_step, the first sample's
    panels written, the step's losses added to the curves."""
    from ihmr_tpu_torch.utils.train_visuals import visuals_from_eval_outputs

    _metrics, outputs = eval_step(state, batch, mano_right, mano_left, config)
    visuals = visuals_from_eval_outputs(
        batch, {k: v for k, v in outputs.items() if v is not None}, mano_right.faces, mano_left.faces,
        input_size=int(batch.img.shape[1]),
    )
    visualizer.display_current_results(visuals, epoch, i)
    visualizer.plot_current_errors(epoch + i / max(steps, 1), values)


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
    visualizer=None,
    display_freq: int = 0,
) -> BaselineState:
    """Epochs ``start_epoch`` .. ``config.total_epoch``: a train step per
    batch at the epoch's learning rate, running losses printed every
    ``print_freq`` samples, then (main process) the epoch's time split, a
    checkpoint every ``save_epoch_freq`` epochs and the ``latest`` one, and
    the next epoch's learning rate (the first epoch runs at ``state.lr``).

    Each step's losses are read to the host in one transfer, which also ends
    the step's device work, so ``TimeStat``'s forward time is the steps'
    time. ``epoch_stats``, when given, receives per epoch: "epoch",
    "step_seconds" (data + forward time, the checkpoint excluded), its split
    "data_seconds" / "forward_seconds" (``TimeStat``), "steps" and
    "total_loss" (each step's).

    With ``visualizer`` and ``display_freq`` > 0 the main process, every
    ``display_freq`` samples, runs one ``eval_step`` on the step's batch (one
    exact collision pass), builds the panels of its first sample
    (``utils.train_visuals.visuals_from_eval_outputs``), writes them
    (``display_current_results``) and adds the step's losses to the curves
    at epoch + i / len(loader); ``TimeStat`` counts that as visualize time."""
    loss_stat = LossStat(len(loader))
    time_stat = TimeStat(config.total_epoch)
    for epoch in range(start_epoch, config.total_epoch + 1):
        loader.set_epoch(epoch)
        loss_stat.set_epoch(epoch)
        time_stat.epoch_init(epoch)
        printed = 0
        displayed = 0
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
            if is_main and visualizer is not None and display_freq > 0:
                displayed += n
                if displayed >= display_freq:
                    displayed = 0
                    _display(visualizer, state, batch, mano_right, mano_left, config, epoch, i, len(loader), values)
            time_stat.stat_visualize_time()
        if epoch_stats is not None:
            epoch_stats.append(dict(
                epoch=epoch, step_seconds=time_stat.data_time + time_stat.forward_time,
                data_seconds=time_stat.data_time, forward_seconds=time_stat.forward_time,
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


@torch.no_grad()
def test_baseline_loop(
    state: BaselineState,
    loader,
    dataset,
    mano_right: ManoModel,
    mano_left: ManoModel,
    config: TrainConfig,
) -> Evaluator:
    """The encoder's evaluation: an ``eval_step`` per raw batch (running
    BatchNorm statistics, the exact collision metric), its outputs and the
    batch's ``do_flip`` fed to an ``Evaluator`` under the batch's ``index``."""
    evaluator = evaluator_for(dataset, mano_right.faces, mano_left.faces)
    dev = state.mean_params.device
    for raw in loader:
        _metrics, outputs = eval_step(state, _to_baseline_batch(raw, dev), mano_right, mano_left, config)
        evaluator.update(np.asarray(raw["index"]), dict(outputs, do_flip=np.asarray(raw["do_flip"])))
    return evaluator


test_baseline_loop.__test__ = False  # not a pytest test


def optimize_loop(
    mano_right: ManoModel,
    loader,
    dataset,
    strategy: Sequence[Stage],
    config: OptConfig,
    left_faces: Optional[torch.Tensor] = None,
    is_main: bool = True,
    obj_dump_dir: Optional[str] = None,
) -> Evaluator:
    """The IHMR-OPT runner: ``optimize_batch`` per raw batch, its results fed
    to an ``Evaluator`` (no sample flipped), with ``OptTimeStat``'s
    throughput and ETA printed by the main process. ``left_faces`` defaults
    to the mirrored winding of the right model's faces.

    ``obj_dump_dir``: when set, the main process writes the first sample of
    each batch as a two-hand ``iter_{k:04d}.obj`` after refinement."""
    faces_l = left_faces if left_faces is not None else mano_right.faces.flip(-1)
    evaluator = evaluator_for(dataset, mano_right.faces, faces_l)
    strategy = tuple(strategy)
    time_stat = OptTimeStat(len(loader), samples_per_iter=getattr(loader, "batch_size", None))
    for raw in loader:
        time_stat.opt_iter_start()
        params, opt_batch = _to_opt_batch(raw, mano_right.device)
        _out_params, results = optimize_batch(mano_right, params, opt_batch, strategy, config)
        results = results_to_host(results)
        results["do_flip"] = np.zeros(len(raw["index"]), np.int32)
        evaluator.update(np.asarray(raw["index"]), results)
        if obj_dump_dir is not None and is_main:
            rv0 = results["pred_right_hand_verts"][0]
            lv0 = results["pred_left_hand_verts"][0]
            verts = np.concatenate([rv0, lv0], axis=0)
            faces = np.concatenate([evaluator.right_faces, evaluator.left_faces + rv0.shape[0]], axis=0)
            io_utils.save_mesh_to_obj(osp.join(obj_dump_dir, f"iter_{time_stat.iter_count:04d}.obj"), verts, faces)
        time_stat.opt_iter_end()
        time_stat.samples_per_iter = time_stat.samples_per_iter or len(raw["index"])
        if is_main:
            time_stat.print_stat()
    if is_main:
        time_stat.print_stat(opt_complete=True)
    return evaluator


def print_metrics(evaluator: Evaluator, tag: str):
    for metric, value in evaluator.metric_dict().items():
        print(f"{metric} : {value:.3f} ({tag})", flush=True)
