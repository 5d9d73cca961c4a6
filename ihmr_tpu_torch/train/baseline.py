"""IHMR-Baseline: encoder forward, loss, and the train and eval steps (port of
ihmr_tpu/train/baseline.py).

The encoder splits its 122-d prediction, prediction and ground truth are
decoded through the two MANO models (``two_hand_decode``), and the total
loss sums the weighted handedness BCE, 2D L1, root-aligned 3D L2, Rodrigues
pose L2, shape L1, translation L2, shape symmetry and, when configured, the
collision loss.

State: the JAX package threads params, BatchNorm statistics and the optax
state through a pure jitted step. Here the encoder module holds the
parameters and the running statistics, updated in place, and ``Adam``
(``refine/adam.py``, optax's rounding order ``lr_last=True``) holds the
moments over the encoder's named parameters and the step count. The
learning rate is a plain field (``state.lr``), as optax's
``inject_hyperparams`` keeps it in the state, and ``set_learning_rate``
sets it between steps.

The step as one CUDA graph (``train_step``): with the collision loss off,
the whole step (forward, losses, backward and Adam) is a function of static
tensors (``_StaticStep``): the batch is copied into buffers of its layout,
Adam updates the parameters and both moments in place, and it reads the
learning rate and the step's two bias-correction factors from 0-dim device
tensors that the host fills before each call (``fill_``, no host-device
synchronisation) from ``state.lr`` and ``state.adam.t``. On a card that
function is captured at the first step (``refine/opt_graph.StepGraph``,
counters ``train.graph_captures`` / ``train.graph_replays``, span
``train.replay``) into a memory pool of its own and replayed at every step,
so a step costs the host one launch for its ~6900 kernels; off the card it
is called directly. The graph is kept in the state (``graphs``), so
dropping the state frees the capture's memory, and is rebuilt when the
batch's layout, the configuration or a tensor the step reads is another.
With the collision loss on (payloads of data-dependent shapes, which a
capture cannot take) the same function runs eagerly on every device, on
the caller's batch and never captured.

Train-mode BatchNorm is flax's (``models/resnet.py::BatchNorm``); with
``bn_impl="pallas"`` every one of them launches the kernel K3. ``eval_step``
runs the exact collision metric with the ray-parity filter: backend "auto"
is the exact kernel K1 on every device, as it is in JAX on the TPU.

Data parallel (``dp_loss_and_grads``, ``train_step_dp``): the JAX package's
train step on a sharded batch with replicated params, one program over the
global batch. Here each shard of the mesh (``parallel.mesh.Mesh.map``) runs
the forward and the loss of its part on its device, reading the primary
encoder's parameters through differentiable copies; its BatchNorms sum
their statistics over the shards. Every loss term is a plain batch mean, so
the global loss is the sum of the shard losses weighted by their shares of
the batch, and one ``autograd.grad`` of it gives the global gradient on the
primary's parameters.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ihmr_tpu_torch.core.projection import orthographic_project
from ihmr_tpu_torch.losses import losses as L
from ihmr_tpu_torch.mano.layer import HandParams, two_hand_decode
from ihmr_tpu_torch.mano.model import ManoModel
from ihmr_tpu_torch.models.encoder import InterHandEncoder
from ihmr_tpu_torch.ops.collision import collision_loss
from ihmr_tpu_torch.parallel.mesh import Replicated, Sharded, current_shard, replicate
from ihmr_tpu_torch.profiling import count, span
from ihmr_tpu_torch.refine import opt_graph
from ihmr_tpu_torch.refine.adam import Adam, adam_update_, bias_factors


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-4
    lr_decay_type: str = "cosine"
    total_epoch: int = 20
    joints_2d_loss_weight: float = 10.0
    joints_3d_loss_weight: float = 10.0
    pose_param_weight: float = 10.0
    shape_param_weight: float = 10.0
    trans_loss_weight: float = 10.0
    shape_reg_loss_weight: float = 0.1
    collision_loss_weight: float = 1.0
    use_collision_loss: bool = False
    use_hand_rotation: bool = False
    sdf_robustifier: Optional[float] = None
    num_candidates: int = 8


@dataclass
class BaselineBatch:
    """One training batch."""

    img: torch.Tensor  # (B, H, W, 3) normalized to [-1, 1]
    hand_type_array: torch.Tensor  # (B, 2)
    hand_type_valid: torch.Tensor  # (B, 1)
    joints_2d: torch.Tensor  # (B, 42, 3)
    joints_3d: torch.Tensor  # (B, 42, 4)
    gt_pose_params: torch.Tensor  # (B, 96)
    gt_shape_params: torch.Tensor  # (B, 20)
    mano_params_weight: torch.Tensor  # (B, 2)
    hand_trans: torch.Tensor  # (B, 1, 4)
    do_flip: torch.Tensor  # (B,)


@dataclass
class BaselineState:
    encoder: InterHandEncoder  # parameters and BatchNorm running statistics
    adam: Adam  # moments over encoder.named_parameters()
    mean_params: torch.Tensor  # (122,)
    lr: float
    epoch: int = 0
    # the train step's graph, kept with its layout (``train_step``); not a field
    # that copies of the state (``replicate``) carry
    graphs: Dict = field(default_factory=dict, init=False, repr=False, compare=False)


def create_state(encoder: InterHandEncoder, mean_params: torch.Tensor, config: TrainConfig) -> BaselineState:
    """A fresh training state around ``encoder`` (weights as given: seeded
    ``init_encoder_weights``, ``convert.encoder_from_jax`` or a checkpoint)."""
    return BaselineState(
        encoder=encoder,
        adam=Adam(dict(encoder.named_parameters()), lr_last=True),
        mean_params=mean_params,
        lr=config.lr,
    )


def learning_rate_for_epoch(config: TrainConfig, epoch: int) -> float:
    """The reference's schedules: cosine over ``total_epoch``, the 20-epoch
    stage decay (/10 at 15 and at 17), or none."""
    if config.lr_decay_type == "cosine":
        return float(0.5 * (1.0 + np.cos(np.pi * epoch / config.total_epoch)) * config.lr)
    if config.lr_decay_type == "stage":
        if config.total_epoch != 20:
            raise ValueError("stage decay expects 20 epochs")
        lr = config.lr
        for boundary in (15, 17):
            if epoch >= boundary:
                lr /= 10.0
        return lr
    if config.lr_decay_type != "none":
        raise ValueError(f"unknown lr_decay_type {config.lr_decay_type!r}")
    return config.lr


def set_learning_rate(state: BaselineState, lr: float) -> BaselineState:
    state.lr = float(lr)
    return state


def forward_and_loss(
    encoder: InterHandEncoder,
    mean_params: torch.Tensor,
    batch: BaselineBatch,
    mano_right: ManoModel,
    mano_left: ManoModel,
    config: TrainConfig,
    train: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict[str, Optional[torch.Tensor]]]:
    """-> (total loss, metrics, outputs). The encoder runs in the mode it is
    in (``train_step`` and ``eval_step`` set it); ``train=False`` also
    returns the 1024-d feature and always computes the origin-scale
    collision depths for the metrics."""
    if train:
        pred_params, pred_hand_type = encoder(batch.img, mean_params)
        img_feat = None
    else:
        pred_params, pred_hand_type, img_feat = encoder(batch.img, mean_params, return_features=True)

    with span("train.losses"):
        hp = HandParams.from_flat(pred_params)
        pred_rv, pred_lv, pred_j3 = two_hand_decode(mano_right, mano_left, hp.pose_params, hp.shape_params, hp.trans)
        pred_j2 = orthographic_project(pred_j3, hp.cam)
        gt_rv, gt_lv, _ = two_hand_decode(
            mano_right, mano_left, batch.gt_pose_params, batch.gt_shape_params, batch.hand_trans[:, 0, :3]
        )

        m: Dict[str, torch.Tensor] = {}
        m["hand_type_loss"] = L.hand_type_loss(batch.hand_type_array, pred_hand_type, batch.hand_type_valid)
        total = m["hand_type_loss"]
        j2d, _ = L.joints_2d_loss(batch.joints_2d[:, :, :2], pred_j2, batch.joints_2d[:, :, 2:3])
        m["joints_2d_loss"] = j2d * config.joints_2d_loss_weight
        total = total + m["joints_2d_loss"]
        j3d, _ = L.joints_3d_loss(batch.joints_3d[:, :, :3], pred_j3, batch.joints_3d[:, :, 3:4])
        m["joints_3d_loss"] = j3d * config.joints_3d_loss_weight
        total = total + m["joints_3d_loss"]
        w = batch.mano_params_weight
        rot = config.use_hand_rotation
        pose_r = L.mano_pose_loss(batch.gt_pose_params[:, :48], hp.pose_params[:, :48], w[:, 0:1], rot)
        pose_l = L.mano_pose_loss(batch.gt_pose_params[:, 48:], hp.pose_params[:, 48:], w[:, 1:2], rot)
        m["mano_pose_loss"] = (pose_r + pose_l) * config.pose_param_weight
        total = total + m["mano_pose_loss"]
        shape_r = L.mano_shape_loss(batch.gt_shape_params[:, :10], hp.shape_params[:, :10], w[:, 0:1])
        shape_l = L.mano_shape_loss(batch.gt_shape_params[:, 10:], hp.shape_params[:, 10:], w[:, 1:2])
        m["mano_shape_loss"] = (shape_r + shape_l) * config.shape_param_weight
        total = total + m["mano_shape_loss"]
        trans = L.hand_trans_loss(batch.hand_trans[:, :, :3], hp.trans, batch.hand_trans[:, :, 3:4])
        m["hand_trans_loss"] = trans * config.trans_loss_weight
        total = total + m["hand_trans_loss"]
        reg, _ = L.shape_reg_loss(hp.shape_params)
        m["shape_reg_loss"] = reg * config.shape_reg_loss_weight
        total = total + m["shape_reg_loss"]

        coll_origin = None
        if config.use_collision_loss or not train:
            coll, _, coll_origin = collision_loss(
                pred_rv, pred_lv, mano_right.faces, mano_left.faces, batch.hand_type_array,
                robustifier=config.sdf_robustifier if train else None,
                num_candidates=config.num_candidates,
                # the metric applies the ray-parity filter; the training gradient
                # keeps the reference's local-sign profile
                parity_filter=not train,
            )
            m["collision_loss"] = coll * config.collision_loss_weight
            if config.use_collision_loss:
                total = total + m["collision_loss"]
        else:
            m["collision_loss"] = torch.zeros((), device=total.device)

        m["total_loss"] = total
        outputs = {
            "pred_params": pred_params,
            "pred_hand_type": pred_hand_type,
            "pred_cam_params": hp.cam,
            "pred_pose_params": hp.pose_params,
            "pred_shape_params": hp.shape_params,
            "pred_hand_trans": hp.trans,
            "pred_right_hand_verts": pred_rv,
            "pred_left_hand_verts": pred_lv,
            "gt_right_hand_verts": gt_rv,
            "gt_left_hand_verts": gt_lv,
            "pred_joints_3d": pred_j3,
            "pred_joints_2d": pred_j2,
            "gt_joints_3d": batch.joints_3d,
            "collision_loss_origin_scale": coll_origin,
            "img_feat": img_feat,
        }
        return total, m, outputs


def train_step(
    state: BaselineState,
    batch: BaselineBatch,
    mano_right: ManoModel,
    mano_left: ManoModel,
    config: TrainConfig,
) -> Tuple[BaselineState, Dict[str, torch.Tensor]]:
    """One Adam step at ``state.lr`` on the total loss, with train-mode
    BatchNorm (batch statistics; running statistics updated in place).
    Returns (state, metrics); the metrics are detached device tensors of
    their own. With the collision loss off, one replay of the step's CUDA
    graph on a card (module docstring); eagerly with it on."""
    with span("train.step"):
        count("train.steps")
        state.encoder.train()
        t = state.adam.t + 1
        if config.use_collision_loss:
            step = _StaticStep(state, batch, mano_right, mano_left, config)
            step.load(state.lr, t)
            out = step()
        else:
            layout = _StaticStep.layout(state, batch, mano_right, mano_left, config)
            graph = opt_graph.cached("train_step", layout, lambda: _StaticStep.graph(
                state, batch, mano_right, mano_left, config), store=state.graphs)
            step = graph.fn
            step.load(state.lr, t, batch)
            # a copy, so that a caller may keep a step's metrics past the next replay
            out = graph.replay().clone()
        state.adam.t = t
        return state, dict(zip(step.names, out.unbind()))


class _StaticStep:
    """``train_step``'s work over static tensors, the function that one
    ``opt_graph.StepGraph`` captures (or that runs directly, with the
    collision loss): the forward and the losses on ``batch`` (for a graph,
    buffers that ``load`` copies each step's batch into), ``autograd.grad``
    of the total, and ``adam_update_`` in place on the encoder's parameters
    and the state's moments at the learning rate and bias corrections that
    ``load`` fills in. Returns the metrics stacked (names in ``names``).
    Holds no reference to the state, whose ``graphs`` hold it: dropping the
    state frees the graph at once, not at a garbage collection."""

    def __init__(self, state: BaselineState, batch: BaselineBatch, mano_right, mano_left, config: TrainConfig):
        self.encoder, self.mean_params, self.config = state.encoder, state.mean_params, config
        self.mano = (mano_right, mano_left)
        self.batch = batch
        self.params = dict(state.encoder.named_parameters())
        self.m, self.v = dict(state.adam.m), dict(state.adam.v)
        device = state.mean_params.device
        self.lr, *self.corr = (torch.zeros((), dtype=torch.float32, device=device) for _ in range(3))
        self.cuda, self.lr_last = device.type == "cuda", state.adam.lr_last
        self.names: List[str] = []

    @staticmethod
    def layout(state: BaselineState, batch: BaselineBatch, mano_right, mano_left, config: TrainConfig) -> tuple:
        """What a capture bakes in: the batch's shapes, strides, dtypes and
        devices, the configuration, and the objects whose tensors it reads
        and writes (by identity: the graph holds them, so an id is not
        reused while it is kept). A parameter or buffer replaced inside the
        encoder, not copied into, is not seen."""
        tensors = tuple((k, tuple(x.shape), x.stride(), x.dtype, x.device) for k, x in _batch_fields(batch))
        held = (state.encoder, state.mean_params, mano_right, mano_left, *state.adam.m.values(),
                *state.adam.v.values())
        return tensors, config, tuple(map(id, held))

    @classmethod
    def graph(cls, state, batch, mano_right, mano_left, config) -> opt_graph.StepGraph:
        buffers = BaselineBatch(**{k: torch.empty_strided(x.size(), x.stride(), dtype=x.dtype, device=x.device)
                                   for k, x in _batch_fields(batch)})
        step = cls(state, buffers, mano_right, mano_left, config)
        written = [*(p.detach() for p in step.params.values()), *step.m.values(), *step.v.values(),
                   *state.encoder.buffers()]
        return opt_graph.StepGraph(step, written, state.mean_params.device, name="train", shared_pool=False)

    def load(self, lr: float, t: int, batch: Optional[BaselineBatch] = None) -> None:
        """The learning rate, the bias corrections of Adam's ``t``-th step
        and ``batch`` (where given) into the static tensors, without a host
        sync."""
        for k, x in _batch_fields(batch) if batch is not None else ():
            getattr(self.batch, k).copy_(x)
        self.lr.fill_(lr)
        for c, f in zip(self.corr, bias_factors(t, self.cuda).tolist()):
            c.fill_(f)

    def __call__(self) -> torch.Tensor:
        total, metrics, _ = forward_and_loss(
            self.encoder, self.mean_params, self.batch, *self.mano, self.config, train=True
        )
        with span("train.backward"):
            grads = torch.autograd.grad(total, list(self.params.values()))
        with span("train.adam"):
            adam_update_(self.params, dict(zip(self.params, grads)), self.m, self.v, self.corr, self.lr, self.lr_last)
        self.names = list(metrics)
        return torch.stack([v.detach() for v in metrics.values()])


def _batch_fields(batch: BaselineBatch):
    return [(f.name, getattr(batch, f.name)) for f in fields(BaselineBatch)]


def _adam_update(state: BaselineState, grads: Dict[str, torch.Tensor]) -> None:
    """One Adam step at ``state.lr`` on the encoder's parameters, in place."""
    with span("train.adam"), torch.no_grad():
        params = dict(state.encoder.named_parameters())
        new = state.adam.step({k: v.detach() for k, v in params.items()}, grads, state.lr)
        for k, v in params.items():
            v.copy_(new[k])


def dp_loss_and_grads(
    state: Replicated,
    batch: Sharded,
    mano_right,
    mano_left,
    config: TrainConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The data-parallel train step's loss and gradients, without the update
    -> (total loss, metrics, {parameter name: gradient}), all on the primary
    encoder's device.

    ``state``: ``replicate(state, mesh)`` of a ``BaselineState``; its
    ``primary`` holds the parameters and the running statistics, each copy's
    encoder is the module (with no weights of its own) that the shard calls
    with the primary's tensors. ``batch``: ``shard_batch(batch, mesh)``. The
    MANO models: replicated, or replicated here. Train-mode BatchNorm takes
    the global batch's moments and updates the primary's running statistics
    once."""
    mesh = batch.mesh
    mano_right, mano_left = (m if isinstance(m, Replicated) else replicate(m, mesh) for m in (mano_right, mano_left))
    primary = state.primary
    params = dict(primary.encoder.named_parameters())
    buffers = dict(primary.encoder.named_buffers())
    home = next(iter(params.values())).device
    # every shard reads the parameters through its own differentiable read
    # made here, on the caller's stream, so that the terms of a parameter's
    # gradient are summed on that one stream (``parallel.mesh._reader_view``)
    reads = mesh.reads(params)

    def shard_loss(copy: BaselineState, part: BaselineBatch, mano_r, mano_l):
        shard = current_shard()
        # the running statistics: shard 0's BatchNorms update them, the
        # others' do not read them in train mode
        tensors = {**reads[shard.index], **{k: b.to(shard.device) for k, b in buffers.items()}}
        encoder = copy.encoder.train()

        def call(*args, **kwargs):
            return torch.func.functional_call(encoder, tensors, args, kwargs)

        total, metrics, _ = forward_and_loss(call, copy.mean_params, part, mano_r, mano_l, config, train=True)
        return total, metrics, tensors

    outs = mesh.map(shard_loss, state, batch, mano_right, mano_left)
    with torch.no_grad():  # shard 0's statistics, where its device is not the primary's
        for k, b in buffers.items():
            if outs[0][2][k] is not b:
                b.copy_(outs[0][2][k])
    rows = batch.rows()
    weights = [n / sum(rows) for n in rows]
    total = sum(w * t.to(home) for w, (t, _, _) in zip(weights, outs))
    metrics = {k: sum(w * m[k].detach().to(home) for w, (_, m, _) in zip(weights, outs)) for k in outs[0][1]}
    grads = torch.autograd.grad(total, list(params.values()))
    return total.detach(), metrics, dict(zip(params, grads))


def train_step_dp(
    state: Replicated,
    batch: Sharded,
    mano_right,
    mano_left,
    config: TrainConfig,
) -> Tuple[Replicated, Dict[str, torch.Tensor]]:
    """``train_step`` over a mesh: the global batch's loss and gradients
    (``dp_loss_and_grads``), then one Adam step at ``primary.lr`` on the
    primary's parameters, which every shard reads at its next step. Returns
    (state, metrics) as ``train_step``."""
    _, metrics, grads = dp_loss_and_grads(state, batch, mano_right, mano_left, config)
    _adam_update(state.primary, grads)
    return state, metrics


@torch.no_grad()
def eval_step(
    state: BaselineState,
    batch: BaselineBatch,
    mano_right: ManoModel,
    mano_left: ManoModel,
    config: TrainConfig,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, Optional[torch.Tensor]]]:
    """No-grad forward with the running statistics and the origin-scale
    collision depths for the metrics -> (metrics, outputs). Leaves the
    encoder in eval mode."""
    _, metrics, outputs = forward_and_loss(
        state.encoder.eval(), state.mean_params, batch, mano_right, mano_left, config, train=False
    )
    return metrics, outputs
