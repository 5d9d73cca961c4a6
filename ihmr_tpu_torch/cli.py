"""Command-line entry points (port of ihmr_tpu/cli.py).

    python -m ihmr_tpu_torch.cli train-baseline --data_root ... --anno_path ...
    python -m ihmr_tpu_torch.cli test-baseline  --test_epoch latest --export_pred pred.pkl
    python -m ihmr_tpu_torch.cli optimize       --pred_path pred.pkl --export_pseudo_gt pgt.pkl
    python -m ihmr_tpu_torch.cli train-mlp      --pred_path pred.pkl --use_opt_params --opt_params_path pgt.pkl
    python -m ihmr_tpu_torch.cli test-mlp       --pred_path pred.pkl
    python -m ihmr_tpu_torch.cli serve          --test_epoch latest --port 8080 [--bf16]
    python -m ihmr_tpu_torch.cli visualize      --results evaluate_results/baseline/<dataset>.pkl

The JAX package's subcommands and flags with the same defaults and the same
outputs: ``evaluate_results/<command>/<dataset>.pkl`` (the pickled
Evaluator, relative to the working directory), the printed metrics, the
prediction and pseudo-GT pkls of ``--export_pred`` / ``--export_pseudo_gt``
and checkpoints under ``--checkpoints_dir`` (the port's own ``.pth``
files). ``serve`` answers HTTP requests (``ihmr_tpu_torch.serve``) with the
``baseline`` checkpoint of ``--test_epoch``. ``--bf16`` selects the bf16
encoder (``models.resnet``: bf16 convolutions, BatchNorm outputs and fc1
over fp32 parameters) in ``train-baseline``, ``test-baseline`` and
``serve``; the other commands accept it and ignore it, as the JAX CLI
does. Data are read through ``ihmr_tpu_torch.data``; ``--model_root``
names a directory with ``MANO_RIGHT.pkl``, ``MANO_LEFT.pkl`` and,
optionally, ``mean_mano_params.pkl`` (without it, or with
``--synthetic_mano``, the synthetic hand).

``visualize`` renders a saved Evaluator pkl of the port (``.jpg`` per
result, ``utils/vis.py``) and writes its meshes as ``.obj``, on the host;
``test-baseline --visualize_eval`` renders its results the same way, and
``train-baseline --display_freq N`` writes training panels every N samples
under ``<checkpoints_dir>/web`` (``--live_port P``: the live monitor of
``utils/live_dashboard.py`` on port P, 0 = a free one), on rank 0 only.

Several processes (``--rank r --world_size n``, one process per rank):
each reads its rank's shard of the dataset (padded to ``batchSize *
world_size``, as the JAX package pads), only rank 0 writes checkpoints and
visuals, and every rank writes its own evaluation pkl; the command line
starts no process group, as the JAX one does not (``parallel/dist.py``
gathers results over gloo).

One flag is new: ``--device`` (default ``cuda``; ``cpu`` runs on the CPU,
the kernels through their plain versions). Train-mode BatchNorm statistics
follow ``IHMR_BN_IMPL`` as in the JAX package (``stock``, ``fused``, or
``pallas``: the kernel K3). The JAX package's XLA compile cache and
backend probe have no counterpart.

``main(argv)`` returns the command's summary (a dict: ``seconds``,
``data_seconds``, ``forward_seconds`` and the command's Evaluator,
``metrics`` or training statistics); ``serve`` blocks until interrupted.
``start_server(parse_args(argv))`` builds, warms up and starts the server
that ``serve`` runs, and returns it; ``build_predict`` builds its predict
function alone.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import os.path as osp
import time
from typing import Dict, List, Optional

import numpy as np

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
    p.add_argument("--bf16", action="store_true",
                   help="train-baseline, test-baseline, serve: backbone convs, BatchNorm outputs and fc1 compute "
                        "in bfloat16 over fp32 parameters (fp32 BatchNorm statistics, fp32 losses and heads)")
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
    """The encoder with seeded random weights (seed 0), on ``dev``, computing
    in bf16 with ``--bf16``."""
    import torch

    from ihmr_tpu_torch.models.encoder import InterHandEncoder, init_encoder_weights

    dtype = torch.bfloat16 if args.bf16 else torch.float32
    encoder = InterHandEncoder(arch=args.main_encoder, bn_impl=_bn_impl(), dtype=dtype)
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
        use_random_position=args.use_random_position, use_random_rotation=args.use_random_rotation,
        use_color_jittering=args.use_color_jittering, use_motion_blur=args.use_motion_blur,
        blur_kernel_dir=args.blur_kernel_dir,
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
    visualizer = None
    if args.rank <= 0 and (args.display_freq > 0 or args.live_port >= 0):
        from ihmr_tpu_torch.utils.visualizer import Visualizer

        visualizer = Visualizer(args.checkpoints_dir, live_port=args.live_port)
    epoch_stats: List[Dict] = []
    t0 = time.perf_counter()
    state = train_baseline_loop(
        state, loader, mano_right, mano_left, config, args.checkpoints_dir, start_epoch=start_epoch,
        print_freq=args.print_freq, save_epoch_freq=args.save_epoch_freq, is_main=args.rank <= 0,
        epoch_stats=epoch_stats, visualizer=visualizer, display_freq=args.display_freq,
    )
    seconds = time.perf_counter() - t0
    data = sum(e["data_seconds"] for e in epoch_stats)
    # the live monitor (visualizer.dashboard) keeps serving until its stop()
    return dict(_summary(seconds, data), state=state, epoch_stats=epoch_stats, visualizer=visualizer,
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
    if args.visualize_eval:
        evaluator.render_results(osp.join("evaluate_results", "baseline", dataset.name, "images"))
    if args.export_pred:
        # the prediction pkl read by `optimize` / `train-mlp` (--pred_path)
        from ihmr_tpu_torch.eval.export import evaluator_to_prediction_pkl

        evaluator_to_prediction_pkl(evaluator, args.export_pred)
        print(f"exported prediction pkl -> {args.export_pred}")
    print_metrics(evaluator, f"epoch {args.test_epoch}")
    return _summary(seconds, loader.data_seconds, evaluator=evaluator, metrics=dict(evaluator.metric_dict()))


def optimize_config(args):
    """The ``optimize`` command's OptConfig, built from its flags as the JAX
    CLI builds it."""
    from ihmr_tpu_torch.refine import OptConfig

    grid = args.loop_collision_backend == "grid"
    return OptConfig(
        optimizer=args.optimizer,
        save_mid_freq=args.save_mid_freq,
        loop_collision_subsample=args.loop_collision_subsample,
        loop_collision_face_subsample=args.loop_collision_face_subsample,
        loop_collision_lazy_reselect=not args.loop_collision_eager_reselect,
        loop_collision_freeze_positions=not args.loop_collision_track_positions,
        loop_collision_fast=not grid,
        collision_backend="grid" if grid else "auto",
        stage_hoist_decode=not args.no_stage_hoist,
        escalate_collision=args.escalate_collision,
    )


def cmd_optimize(args):
    from ihmr_tpu_torch.data import BatchLoader, OPTDataset
    from ihmr_tpu_torch.train.loops import BatchAdapter, optimize_loop, print_metrics

    dev = _device(args)
    dataset = OPTDataset(_data_config(args, pred_path=args.pred_path))
    dataset.load_data()
    loader = BatchAdapter(BatchLoader(dataset, args.batchSize, rank=args.rank, world_size=args.world_size))
    mano_right, mano_left = _load_mano(args, dev)
    config = optimize_config(args)
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
    """Render every prediction of a saved Evaluator pkl to jpg + obj, on the
    host: ``<out_dir>/objs`` and ``<out_dir>/images`` (default: the pkl's
    path without its extension)."""
    from ihmr_tpu_torch.utils import io_utils

    evaluator = io_utils.load_pkl(args.results)
    base = args.out_dir or osp.join(osp.dirname(args.results), osp.basename(args.results).rsplit(".", 1)[0])
    obj_dir = osp.join(base, "objs")
    img_dir = osp.join(base, "images")
    io_utils.build_dir(obj_dir)
    io_utils.build_dir(img_dir)
    t0 = time.perf_counter()
    evaluator.export_objs(obj_dir, limit=args.limit)
    evaluator.render_results(img_dir, limit=args.limit)
    n = min(len(evaluator.pred_results), args.limit or 10**9)
    print(f"wrote {n} objs to {obj_dir} and {n} renders to {img_dir}")
    return dict(seconds=time.perf_counter() - t0, obj_dir=obj_dir, img_dir=img_dir)


def build_predict(args):
    """The serve command's predict function (``serve.build_encoder_predict_fn``)
    on ``--device``: the encoder (``--bf16``: the bf16 one) with the
    ``baseline`` checkpoint of ``--test_epoch``, loaded as test-baseline
    loads it, or seeded random weights, with a warning, when there is none."""
    from ihmr_tpu_torch.serve import build_encoder_predict_fn
    from ihmr_tpu_torch.train import checkpoint as ckpt

    dev = _device(args)
    mano_right, _ = _load_mano(args, dev)
    encoder = _encoder(args, dev)
    weights = ckpt.load_network(args.checkpoints_dir, "baseline", args.test_epoch)
    if weights is not None:
        encoder.load_state_dict(weights, strict=True)
        print(f"serving checkpoint '{args.test_epoch}' from {args.checkpoints_dir}")
    else:
        print("WARNING: no checkpoint found — serving a randomly-initialized encoder")
    return build_encoder_predict_fn(encoder, _mean_params(args, dev), mano_right, args.inputSize, dev)


def start_server(args):
    """The serve command up to its blocking loop: ``build_predict``, one
    warm-up call on a zero batch, and the micro-batching HTTP server started
    on ``--port`` (0: a free port). Returns the running
    ``serve.InferenceServer``; its ``stop()`` ends it."""
    import numpy as np

    from ihmr_tpu_torch.serve import InferenceServer, MicroBatcher

    predict = build_predict(args)
    # the first call builds the cuDNN plans and the caching allocator's pool;
    # it must not count against a request's deadline
    t0 = time.perf_counter()
    predict(np.zeros((args.serve_batch, args.inputSize, args.inputSize, 3), np.float32))
    print(f"warmup: {time.perf_counter() - t0:.1f}s", flush=True)
    shape = (args.inputSize, args.inputSize, 3)
    server = InferenceServer(MicroBatcher(predict, args.serve_batch, max_wait_ms=args.max_wait_ms, input_shape=shape),
                             shape)
    server.start(args.port)
    return server


def cmd_serve(args):
    """Batched inference serving: ``start_server``, then wait for Ctrl-C."""
    server = start_server(args)
    print("POST /predict, GET /healthz, GET /stats — Ctrl-C to stop", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()


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
    p.add_argument("--display_freq", type=int, default=0,
                   help="render training visuals every N samples (rank 0)")
    p.add_argument("--live_port", type=int, default=-1,
                   help=">=0: serve the live loss/visuals monitor on this port (0 = a free one; rank 0)")
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
    p.add_argument("--blur_kernel_dir", default="", help="directory of .mat point-spread functions (PSFs)")
    p.set_defaults(func=cmd_train_baseline)

    p = sub.add_parser("test-baseline")
    _add_common(p)
    p.add_argument("--test_epoch", default="latest")
    p.add_argument("--visualize_eval", action="store_true", help="render predictions to jpg after evaluation")
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
    p.add_argument("--loop_collision_eager_reselect", action="store_true",
                   help="recompute the nearest-face selection every step instead of once per snapshot period")
    p.add_argument("--loop_collision_track_positions", action="store_true",
                   help="take the selected triangles' positions every step instead of freezing them per block")
    p.add_argument("--no_stage_hoist", action="store_true",
                   help="the full decode every step instead of the stage-hoisted engine")
    p.add_argument("--escalate_collision", type=float, default=0.0,
                   help="two-pass grid escalation threshold: samples whose final exact collision exceeds it "
                        "re-refine with the grid in the loop and keep that result where it lowered their "
                        "exact collision (0 = off)")
    p.add_argument("--loop_collision_backend", choices=["fast", "grid"], default="fast",
                   help="'fast' = nearest-face (the default); 'grid' = the reference's 32^3 penetration "
                        "grid, sampled trilinearly")
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

    p = sub.add_parser("visualize", help="render a saved Evaluator pkl to jpg + obj")
    p.add_argument("--results", required=True)
    p.add_argument("--out_dir", default=None)
    p.add_argument("--limit", type=int, default=None)
    p.set_defaults(func=cmd_visualize)

    p = sub.add_parser("serve", help="batched inference HTTP server")
    _add_common(p)
    p.add_argument("--test_epoch", default="latest")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--serve_batch", type=int, default=16, help="micro-batch size (every batch is padded to it)")
    p.add_argument("--max_wait_ms", type=float, default=10.0, help="max time to wait filling a micro-batch")
    p.set_defaults(func=cmd_serve)
    return parser


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    main()
