"""Command-line entry points (port of ihmr_tpu/cli.py).

    python -m ihmr_tpu_torch.cli train-baseline --data_root ... --anno_path ...
    python -m ihmr_tpu_torch.cli test-baseline  --test_epoch latest --export_pred pred.pkl
    python -m ihmr_tpu_torch.cli optimize       --pred_path pred.pkl --export_pseudo_gt pgt.pkl
    python -m ihmr_tpu_torch.cli train-mlp      --pred_path pred.pkl --use_opt_params --opt_params_path pgt.pkl
    python -m ihmr_tpu_torch.cli test-mlp       --pred_path pred.pkl

The JAX package's subcommands and flags with the same defaults and the same
outputs: ``evaluate_results/<command>/<dataset>.pkl`` (the pickled
Evaluator, relative to the working directory), the printed metrics, the
prediction and pseudo-GT pkls of ``--export_pred`` / ``--export_pseudo_gt``
and checkpoints under ``--checkpoints_dir`` (the port's own ``.pth``
files). Data are read through ``ihmr_tpu_torch.data``; ``--model_root``
names a directory with ``MANO_RIGHT.pkl``, ``MANO_LEFT.pkl`` and,
optionally, ``mean_mano_params.pkl`` (without it, or with
``--synthetic_mano``, the synthetic hand).

One flag is new: ``--device`` (default ``cuda``; ``cpu`` runs on the CPU,
the kernels through their plain versions). Train-mode BatchNorm statistics
follow ``IHMR_BN_IMPL`` as in the JAX package (``stock``, ``fused``, or
``pallas``: the kernel K3). The JAX package's XLA compile cache and
backend probe have no counterpart. ``visualize``, ``serve`` and the flags
whose paths are not ported yet raise, naming their ROADMAP.md item.

``main(argv)`` returns the command's summary (a dict: ``seconds``,
``data_seconds``, ``forward_seconds`` and the command's Evaluator,
``metrics`` or training statistics).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import os.path as osp
import time
from typing import Dict, List, Optional

import numpy as np

# what each refused subcommand or flag waits for: its ROADMAP.md item
_ROADMAP = {
    "augment": "ROADMAP.md Queue 1, item 1 (rotation, colour-jitter and motion-blur augmentations)",
    "collision": "ROADMAP.md Queue 1, item 3 (the other in-loop collision paths)",
    "bf16": "ROADMAP.md Queue 1, item 4 (bf16 training)",
    "utils": "ROADMAP.md Queue 1, item 5 (utils/: rendering, the visualizer and the live monitor)",
    "serve": "ROADMAP.md Queue 1, item 6 (serve and the tracker)",
    "multicard": "ROADMAP.md Queue 1, the slice with more than one card (parallel/, --rank/--world_size)",
}


def _refuse(what: str, key: str):
    raise NotImplementedError(f"{what} is not ported yet: {_ROADMAP[key]}")


def _check_flags(args) -> None:
    """Raise on every flag whose path the port does not have yet."""
    if getattr(args, "bf16", False):
        _refuse("--bf16", "bf16")
    if getattr(args, "rank", 0) > 0 or getattr(args, "world_size", 1) > 1:
        _refuse("--rank > 0 / --world_size > 1", "multicard")
    if getattr(args, "display_freq", 0) > 0 or getattr(args, "live_port", -1) >= 0:
        _refuse("--display_freq > 0 / --live_port >= 0", "utils")
    if getattr(args, "visualize_eval", False):
        _refuse("--visualize_eval", "utils")
    for flag in ("use_random_rotation", "use_color_jittering", "use_motion_blur"):
        if getattr(args, flag, False):
            _refuse(f"--{flag}", "augment")
    if getattr(args, "loop_collision_backend", "fast") == "grid":
        _refuse("--loop_collision_backend grid", "collision")
    if getattr(args, "escalate_collision", 0.0) > 0:
        _refuse("--escalate_collision > 0", "collision")
    for flag in ("loop_collision_eager_reselect", "loop_collision_track_positions"):
        if getattr(args, flag, False):
            _refuse(f"--{flag}", "collision")


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("--data_root", default="")
    p.add_argument("--model_root", default="", help="MANO pkl + mean params dir")
    p.add_argument("--param_root", default="")
    p.add_argument("--anno_path", default="", help="annotation pkl path (relative to data_root)")
    p.add_argument("--pred_path", default="", help="prediction pkl path (relative to data_root)")
    p.add_argument("--batchSize", type=int, default=64)
    p.add_argument("--inputSize", type=int, default=224)
    p.add_argument("--checkpoints_dir", default="./checkpoints")
    p.add_argument("--strategy", default="opt_default")
    p.add_argument("--main_encoder", default="resnet50")
    p.add_argument("--bf16", action="store_true", help="not ported yet (raises)")
    p.add_argument("--synthetic_mano", action="store_true", help="use synthetic MANO assets (no licensed files)")
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--world_size", type=int, default=1)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")


def _device(args):
    from ihmr_tpu_torch.device import resolve_device, set_fp32_matmul_precision

    dev = resolve_device(args.device)
    set_fp32_matmul_precision()
    return dev


def _load_mano(args, dev):
    """(right, left) MANO models on ``dev``. The pkls' hands_mean is dropped,
    as the JAX CLI drops it: every command there discards it too."""
    from ihmr_tpu_torch.mano import load_mano_pair, mirror_mano_model, synthetic_mano_model

    if args.synthetic_mano or not args.model_root:
        right = synthetic_mano_model(device=dev)
        return right, mirror_mano_model(right)
    pair = load_mano_pair(args.model_root, device=dev)
    return pair["right"][0], pair["left"][0]


def _mean_params(args, dev):
    from ihmr_tpu_torch.models.encoder import build_mean_params
    from ihmr_tpu_torch.utils import io_utils

    mean_file = osp.join(args.model_root, "mean_mano_params.pkl") if args.model_root else ""
    if mean_file and osp.exists(mean_file):
        vals = io_utils.load_pkl(mean_file)
        return build_mean_params(np.asarray(vals["mean_pose"]), np.asarray(vals["mean_betas"]), dev)
    return build_mean_params(np.zeros(48, np.float32), np.zeros(10, np.float32), dev)


def _bn_impl() -> str:
    """The JAX package's switch (ihmr_tpu/models/resnet.py) read the same way."""
    return os.environ.get("IHMR_BN_IMPL", "fused" if os.environ.get("IHMR_FUSED_BN") == "1" else "stock")


def _encoder(args, dev):
    """The encoder with seeded random weights (seed 0), on ``dev``."""
    import torch

    from ihmr_tpu_torch.models.encoder import InterHandEncoder, init_encoder_weights

    encoder = InterHandEncoder(arch=args.main_encoder, bn_impl=_bn_impl())
    init_encoder_weights(encoder, torch.Generator().manual_seed(0))
    return encoder.to(dev)


def _data_config(args, **kwargs):
    from ihmr_tpu_torch.data import DataConfig

    return DataConfig(
        data_root=args.data_root, param_root=args.param_root, anno_path=args.anno_path,
        batch_size=args.batchSize, world_size=args.world_size, **kwargs,
    )


def _strategy(args):
    from ihmr_tpu_torch.refine import strategies

    strategy = strategies[args.strategy]
    if getattr(args, "stage_epochs", None) is not None:
        strategy = tuple(dataclasses.replace(s, epoch=args.stage_epochs) for s in strategy)
    return strategy


def _save_evaluator(evaluator, command: str, dataset) -> None:
    from ihmr_tpu_torch.utils import io_utils

    evaluator.remove_redunc()
    io_utils.save_pkl(osp.join("evaluate_results", command, f"{dataset.name}.pkl"), evaluator)


def _summary(seconds: float, data_seconds: float, **extra) -> Dict:
    return dict(seconds=seconds, data_seconds=data_seconds, forward_seconds=seconds - data_seconds, **extra)


def cmd_train_baseline(args):
    from ihmr_tpu_torch.data import BaselineDataset, BatchLoader, ComposeDataset
    from ihmr_tpu_torch.train import TrainConfig, create_state
    from ihmr_tpu_torch.train import checkpoint as ckpt
    from ihmr_tpu_torch.train.loops import BatchAdapter, _to_baseline_batch, resume_state, train_baseline_loop

    dev = _device(args)
    cfg = _data_config(
        args, input_size=args.inputSize, is_train=True,
        use_random_flip=args.use_random_flip, use_random_rescale=args.use_random_rescale,
        use_random_position=args.use_random_position, blur_kernel_dir=args.blur_kernel_dir,
    )
    # a comma list of annotation pkls -> composed multi-dataset training
    anno_paths = [p for p in args.anno_path.split(",") if p]
    if len(anno_paths) > 1:
        members = []
        for ap in anno_paths:
            ds = BaselineDataset(dataclasses.replace(cfg, anno_path=ap))
            ds.load_data()
            members.append(ds)
        dataset = ComposeDataset(members)
    else:
        dataset = BaselineDataset(cfg)
        dataset.load_data()
    loader = BatchAdapter(
        BatchLoader(dataset, args.batchSize, rank=args.rank, world_size=args.world_size, shuffle=True, drop_last=True),
        _to_baseline_batch, dev,
    )
    mano_right, mano_left = _load_mano(args, dev)
    config = TrainConfig(
        lr=args.lr, lr_decay_type=args.lr_decay_type, total_epoch=args.total_epoch,
        use_collision_loss=args.use_collision_loss, use_hand_rotation=args.use_hand_rotation,
        sdf_robustifier=args.sdf_robustifier,
    )
    encoder = _encoder(args, dev)
    state = create_state(encoder, _mean_params(args, dev), config)
    start_epoch = 1
    if args.continue_train:
        start_epoch = resume_state(args.checkpoints_dir, state, config)
        if start_epoch > 1:
            print(f"resume from epoch {start_epoch}")
    elif args.pretrain_weights:
        backbone = encoder.main_encoder
        backbone.load_state_dict(ckpt.import_torch_resnet(args.pretrain_weights, backbone.state_dict()))
        print(f"Loaded pretrained backbone from {args.pretrain_weights}")
    epoch_stats: List[Dict] = []
    t0 = time.perf_counter()
    state = train_baseline_loop(
        state, loader, mano_right, mano_left, config, args.checkpoints_dir, start_epoch=start_epoch,
        print_freq=args.print_freq, save_epoch_freq=args.save_epoch_freq, is_main=args.rank <= 0,
        epoch_stats=epoch_stats,
    )
    seconds = time.perf_counter() - t0
    data = sum(e["data_seconds"] for e in epoch_stats)
    return dict(_summary(seconds, data), state=state, epoch_stats=epoch_stats,
                step_forward_seconds=sum(e["forward_seconds"] for e in epoch_stats))


def cmd_test_baseline(args):
    from ihmr_tpu_torch.data import BaselineDataset, BatchLoader
    from ihmr_tpu_torch.train import TrainConfig, create_state
    from ihmr_tpu_torch.train import checkpoint as ckpt
    from ihmr_tpu_torch.train.loops import BatchAdapter, print_metrics, test_baseline_loop

    dev = _device(args)
    dataset = BaselineDataset(_data_config(args, input_size=args.inputSize))
    dataset.load_data()
    loader = BatchAdapter(BatchLoader(dataset, args.batchSize, rank=args.rank, world_size=args.world_size))
    mano_right, mano_left = _load_mano(args, dev)
    config = TrainConfig()
    encoder = _encoder(args, dev)
    weights = ckpt.load_network(args.checkpoints_dir, "baseline", args.test_epoch)
    if weights is None:
        raise FileNotFoundError(f"no checkpoint '{args.test_epoch}' in {args.checkpoints_dir}")
    encoder.load_state_dict(weights, strict=True)
    state = create_state(encoder, _mean_params(args, dev), config)

    t0 = time.perf_counter()
    evaluator = test_baseline_loop(state, loader, dataset, mano_right, mano_left, config)
    seconds = time.perf_counter() - t0
    _save_evaluator(evaluator, "baseline", dataset)
    if args.export_pred:
        # the prediction pkl read by `optimize` / `train-mlp` (--pred_path)
        from ihmr_tpu_torch.eval.export import evaluator_to_prediction_pkl

        evaluator_to_prediction_pkl(evaluator, args.export_pred)
        print(f"exported prediction pkl -> {args.export_pred}")
    print_metrics(evaluator, f"epoch {args.test_epoch}")
    return _summary(seconds, loader.data_seconds, evaluator=evaluator, metrics=dict(evaluator.metric_dict()))


def cmd_optimize(args):
    from ihmr_tpu_torch.data import BatchLoader, OPTDataset
    from ihmr_tpu_torch.refine import OptConfig
    from ihmr_tpu_torch.train.loops import BatchAdapter, optimize_loop, print_metrics

    dev = _device(args)
    dataset = OPTDataset(_data_config(args, pred_path=args.pred_path))
    dataset.load_data()
    loader = BatchAdapter(BatchLoader(dataset, args.batchSize, rank=args.rank, world_size=args.world_size))
    mano_right, mano_left = _load_mano(args, dev)
    config = OptConfig(
        optimizer=args.optimizer,
        save_mid_freq=args.save_mid_freq,
        loop_collision_subsample=args.loop_collision_subsample,
        loop_collision_face_subsample=args.loop_collision_face_subsample,
        stage_hoist_decode=not args.no_stage_hoist,
    )
    t0 = time.perf_counter()
    evaluator = optimize_loop(
        mano_right, loader, dataset, _strategy(args), config,
        left_faces=mano_left.faces, is_main=args.rank <= 0, obj_dump_dir=args.obj_dump_dir,
    )
    seconds = time.perf_counter() - t0
    _save_evaluator(evaluator, "optimize", dataset)
    if args.export_pseudo_gt:
        # refined params as MLP pseudo-GT (`train-mlp --use_opt_params --opt_params_path`)
        from ihmr_tpu_torch.eval.export import evaluator_to_opt_pseudo_gt

        evaluator_to_opt_pseudo_gt(evaluator, args.export_pseudo_gt)
        print(f"exported OPT pseudo-GT -> {args.export_pseudo_gt}")
    print_metrics(evaluator, "optimize")
    return _summary(seconds, loader.data_seconds, evaluator=evaluator, metrics=dict(evaluator.metric_dict()))


def cmd_train_mlp(args):
    from ihmr_tpu_torch.data import BatchLoader, MLPDataset
    from ihmr_tpu_torch.refine import MLPCaches, OptConfig
    from ihmr_tpu_torch.train.loops import BatchAdapter, _to_mlp_batch
    from ihmr_tpu_torch.train.mlp import train_mlp_stages, warm_pass

    dev = _device(args)
    cfg = _data_config(
        args, pred_path=args.pred_path, is_train=True, use_opt_params=args.use_opt_params,
        opt_params_path=args.opt_params_path,
    )
    dataset = MLPDataset(cfg)
    dataset.load_data()
    loader = BatchAdapter(BatchLoader(dataset, args.batchSize, rank=args.rank, world_size=args.world_size),
                          _to_mlp_batch, dev)
    mano_right, _mano_left = _load_mano(args, dev)
    caches = MLPCaches(num_data=len(dataset), device=dev)
    config = OptConfig(robustifier=args.sdf_robustifier)
    stage_stats: List[Dict] = []
    t0 = time.perf_counter()
    warm_pass(mano_right, loader, caches, config)
    subnets = train_mlp_stages(
        mano_right, _strategy(args), loader, caches, config,
        checkpoints_dir=args.checkpoints_dir, is_main=args.rank <= 0, stage_stats=stage_stats,
    )
    seconds = time.perf_counter() - t0
    return _summary(seconds, loader.data_seconds, subnets=subnets, caches=caches, stage_stats=stage_stats)


def cmd_test_mlp(args):
    from ihmr_tpu_torch.data import BatchLoader, MLPDataset
    from ihmr_tpu_torch.models.encoder import SubNetwork
    from ihmr_tpu_torch.refine import OptConfig
    from ihmr_tpu_torch.train import checkpoint as ckpt
    from ihmr_tpu_torch.train.loops import BatchAdapter, _to_mlp_batch, print_metrics
    from ihmr_tpu_torch.train.mlp import test_mlp_loop

    dev = _device(args)
    dataset = MLPDataset(_data_config(args, pred_path=args.pred_path))
    dataset.load_data()
    loader = BatchAdapter(BatchLoader(dataset, args.batchSize, rank=args.rank, world_size=args.world_size),
                          _to_mlp_batch, dev)
    mano_right, mano_left = _load_mano(args, dev)
    strategy = _strategy(args)
    subnets = []
    for stage_id, stage in enumerate(strategy):
        weights = ckpt.load_network(args.checkpoints_dir, "mlp", args.test_epoch, stage_id=stage_id)
        if weights is None:
            raise FileNotFoundError(f"no stage {stage_id} checkpoint '{args.test_epoch}' in {args.checkpoints_dir}")
        net = SubNetwork(stage.update_dim)
        net.load_state_dict(weights, strict=True)
        subnets.append(net.to(dev))
    t0 = time.perf_counter()
    evaluator = test_mlp_loop(
        mano_right, strategy, subnets, loader, OptConfig(), dataset=dataset, left_faces=mano_left.faces,
    )
    seconds = time.perf_counter() - t0
    _save_evaluator(evaluator, "mlp", dataset)
    print_metrics(evaluator, f"mlp epoch {args.test_epoch}")
    return _summary(seconds, loader.data_seconds, evaluator=evaluator, metrics=dict(evaluator.metric_dict()))


def cmd_visualize(args):
    _refuse("the visualize command (mesh rendering)", "utils")


def cmd_serve(args):
    _refuse("the serve command", "serve")


COMMANDS = ("train-baseline", "test-baseline", "optimize", "train-mlp", "test-mlp", "visualize", "serve")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="ihmr_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("train-baseline")
    _add_common(p)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr_decay_type", choices=["none", "stage", "cosine"], default="cosine")
    p.add_argument("--total_epoch", type=int, default=20)
    p.add_argument("--print_freq", type=int, default=2048)
    p.add_argument("--display_freq", type=int, default=0, help="not ported yet (raises when > 0)")
    p.add_argument("--live_port", type=int, default=-1, help="not ported yet (raises when >= 0)")
    p.add_argument("--save_epoch_freq", type=int, default=5)
    p.add_argument("--use_collision_loss", action="store_true")
    p.add_argument("--use_hand_rotation", action="store_true",
                   help="include global orient in the rodrigues pose loss")
    p.add_argument("--sdf_robustifier", type=float, default=None)
    p.add_argument("--continue_train", action="store_true")
    p.add_argument("--pretrain_weights", default=None, help="torchvision-layout ResNet .pth for the backbone")
    for flag in (
        "use_random_flip", "use_random_rescale", "use_random_position",
        "use_random_rotation", "use_color_jittering", "use_motion_blur",
    ):
        p.add_argument(f"--{flag}", action="store_true")
    p.add_argument("--blur_kernel_dir", default="")
    p.set_defaults(func=cmd_train_baseline)

    p = sub.add_parser("test-baseline")
    _add_common(p)
    p.add_argument("--test_epoch", default="latest")
    p.add_argument("--visualize_eval", action="store_true", help="not ported yet (raises)")
    p.add_argument("--export_pred", default="",
                   help="write the prediction pkl consumed by optimize/train-mlp")
    p.set_defaults(func=cmd_test_baseline)

    p = sub.add_parser("optimize")
    _add_common(p)
    p.add_argument("--optimizer", choices=["adam", "sgd"], default="adam")
    p.add_argument("--save_mid_freq", type=int, default=10)
    p.add_argument("--stage_epochs", type=int, default=None,
                   help="override every stage's step count (fast runs/smoke tests)")
    p.add_argument("--loop_collision_subsample", type=int, default=2,
                   help="in-loop collision query-vertex stride (1 = every vertex)")
    p.add_argument("--loop_collision_face_subsample", type=int, default=2,
                   help="in-loop collision target-face stride over the Morton-sorted faces")
    p.add_argument("--loop_collision_eager_reselect", action="store_true", help="not ported yet (raises)")
    p.add_argument("--loop_collision_track_positions", action="store_true", help="not ported yet (raises)")
    p.add_argument("--no_stage_hoist", action="store_true",
                   help="the full decode every step instead of the stage-hoisted engine")
    p.add_argument("--escalate_collision", type=float, default=0.0, help="not ported yet (raises when > 0)")
    p.add_argument("--loop_collision_backend", choices=["fast", "grid"], default="fast",
                   help="'fast' = nearest-face (the default); 'grid' is not ported yet (raises)")
    p.add_argument("--obj_dump_dir", default=None,
                   help="dump each batch's first refined sample as .obj here")
    p.add_argument("--export_pseudo_gt", default="",
                   help="write OPT refined params as MLP pseudo-GT pkl")
    p.set_defaults(func=cmd_optimize)

    p = sub.add_parser("train-mlp")
    _add_common(p)
    p.add_argument("--use_opt_params", action="store_true")
    p.add_argument("--opt_params_path", default="",
                   help="OPT pseudo-GT pkl from `optimize --export_pseudo_gt`")
    p.add_argument("--sdf_robustifier", type=float, default=None)
    p.add_argument("--stage_epochs", type=int, default=None,
                   help="override every stage's epoch count (smoke tests)")
    p.set_defaults(func=cmd_train_mlp, strategy="mlp_default")

    p = sub.add_parser("test-mlp")
    _add_common(p)
    p.add_argument("--test_epoch", default="latest")
    p.set_defaults(func=cmd_test_mlp, strategy="mlp_default")

    p = sub.add_parser("visualize", help="not ported yet (raises)")
    p.add_argument("--results", required=True)
    p.add_argument("--out_dir", default=None)
    p.add_argument("--limit", type=int, default=None)
    p.set_defaults(func=cmd_visualize)

    p = sub.add_parser("serve", help="not ported yet (raises)")
    _add_common(p)
    p.add_argument("--test_epoch", default="latest")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--serve_batch", type=int, default=16)
    p.add_argument("--max_wait_ms", type=float, default=10.0)
    p.set_defaults(func=cmd_serve)
    return parser


def main(argv: Optional[List[str]] = None) -> Dict:
    args = build_parser().parse_args(argv)
    _check_flags(args)
    return args.func(args)


if __name__ == "__main__":
    main()
