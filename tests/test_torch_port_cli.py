"""The port's command line alone, on the CPU (``--device cpu``), in-process.

A 4-sample corpus (``tests/test_data.py::_write_synthetic_corpus``), the
synthetic MANO hand, ResNet-18 at 64x64, batches of 2: the JAX CLI's chain
train-baseline -> test-baseline --export_pred -> optimize --export_pseudo_gt
-> train-mlp --use_opt_params -> test-mlp must write the files the JAX CLI
writes (checkpoints, ``evaluate_results/<command>/hand26m.pkl``, the
prediction and pseudo-GT pkls) with finite metrics; every refused flag and
subcommand raises naming its ROADMAP.md item; without ``--device cpu`` and
without a card the CLI raises. The chain runs once per module (~60 s on one
core, most of it the exact collision's plain version in the MLP passes).
"""

import math
import os
import os.path as osp

import numpy as np
import pytest
import torch

from ihmr_tpu_torch import cli
from ihmr_tpu_torch.utils import io_utils
from tests.test_data import _write_synthetic_corpus
from tests.torch_threads import one_torch_thread  # noqa: F401


def _common(root, ckpt):
    return [
        "--data_root", root, "--anno_path", "anno.pkl", "--batchSize", "2", "--synthetic_mano",
        "--inputSize", "64", "--main_encoder", "resnet18", "--checkpoints_dir", ckpt, "--device", "cpu",
    ]


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The five workload commands in order; returns (work dir, common flags, summaries)."""
    work = str(tmp_path_factory.mktemp("port_cli"))
    root = osp.join(work, "corpus")
    _write_synthetic_corpus(root, n=4)
    common = _common(root, osp.join(work, "ckpt"))
    pred, pgt = osp.join(work, "chain_pred.pkl"), osp.join(work, "opt_pseudo_gt.pkl")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        out = {
            "train-baseline": cli.main(
                ["train-baseline", "--total_epoch", "1", "--save_epoch_freq", "1", "--use_random_flip",
                 "--use_random_rescale", "--use_random_position"] + common),
            "test-baseline": cli.main(["test-baseline", "--export_pred", pred] + common),
            "optimize": cli.main(
                ["optimize", "--pred_path", pred, "--stage_epochs", "2", "--save_mid_freq", "1",
                 "--export_pseudo_gt", pgt] + common),
            "train-mlp": cli.main(
                ["train-mlp", "--pred_path", pred, "--use_opt_params", "--opt_params_path", pgt,
                 "--stage_epochs", "1"] + common),
            "test-mlp": cli.main(["test-mlp", "--pred_path", pred] + common),
        }
    finally:
        os.chdir(cwd)
    return work, common, out


def test_help_lists_the_seven_commands(capsys):
    with pytest.raises(SystemExit) as exit_info:
        cli.main(["--help"])
    assert exit_info.value.code == 0
    text = capsys.readouterr().out
    for command in ("train-baseline", "test-baseline", "optimize", "train-mlp", "test-mlp", "visualize", "serve"):
        assert command in text
    assert set(cli.COMMANDS) == {"train-baseline", "test-baseline", "optimize", "train-mlp", "test-mlp",
                                 "visualize", "serve"}


def test_chain_writes_the_jax_cli_files(chain):
    work, _, _ = chain
    ckpt = osp.join(work, "ckpt")
    expected = ["1_net_baseline.pth", "1_info.pth", "latest_net_baseline.pth", "latest_info.pth"]
    expected += [f"latest_net_mlp_stage_{k:02d}.pth" for k in range(6)]
    assert set(expected) <= set(os.listdir(ckpt))
    for command in ("baseline", "optimize", "mlp"):
        evaluator = io_utils.load_pkl(osp.join(work, "evaluate_results", command, "hand26m.pkl"))
        assert len(evaluator.pred_results) == 4  # padding removed
    pred = io_utils.load_pkl(osp.join(work, "chain_pred.pkl"))
    assert sorted(pred) == [f"img_{i:03d}.png" for i in range(4)]
    assert {"pred_cam_params", "pred_shape_params", "pred_pose_params", "pred_hand_trans", "joints_2d",
            "joints_3d", "img_feat"} <= set(pred["img_000.png"])
    assert pred["img_000.png"]["img_feat"].shape == (1024,)
    pgt = io_utils.load_pkl(osp.join(work, "opt_pseudo_gt.pkl"))
    assert set(pgt["img_001.png"]) == {"opt_pose_params", "opt_shape_params", "opt_hand_trans"}


@pytest.mark.parametrize("command", ["test-baseline", "optimize", "test-mlp"])
def test_chain_metrics_are_finite(chain, command):
    _, _, out = chain
    metrics = out[command]["metrics"]
    assert {"mpjpe_3d", "inter_mpjpe_3d", "collision_ave", "collision_max", "collision_auc"} <= set(metrics)
    assert all(math.isfinite(v) for v in metrics.values()), metrics
    assert out[command]["seconds"] >= out[command]["data_seconds"] >= 0.0


def test_chain_training_summaries(chain):
    _, _, out = chain
    train = out["train-baseline"]
    (epoch,) = train["epoch_stats"]
    assert epoch["steps"] == 2 and all(math.isfinite(v) for v in epoch["total_loss"])
    assert train["data_seconds"] > 0.0 and train["step_forward_seconds"] > 0.0
    mlp = out["train-mlp"]
    assert len(mlp["subnets"]) == 6 and bool(mlp["caches"].exists.all())
    assert all(math.isfinite(s["select_after"]) for s in mlp["stage_stats"])


def test_continue_train_and_pretrained_backbone(chain, capsys):
    """--continue_train resumes after the saved epoch (train_loops.resume_state);
    --pretrain_weights loads a torchvision-layout backbone before training."""
    work, common, _ = chain
    cwd = os.getcwd()
    os.chdir(work)
    try:
        out = cli.main(["train-baseline", "--total_epoch", "2", "--continue_train"] + common)
        assert [e["epoch"] for e in out["epoch_stats"]] == [2]
        assert "resume from epoch 2" in capsys.readouterr().out
        from ihmr_tpu_torch.models.encoder import InterHandEncoder

        state = InterHandEncoder("resnet18").main_encoder.state_dict()
        pth = osp.join(work, "resnet18_torchvision.pth")
        torch.save({k: v for k, v in state.items()}, pth)
        other = common[: common.index("--checkpoints_dir") + 1] + [osp.join(work, "ckpt_pre"), "--device", "cpu"]
        cli.main(["train-baseline", "--total_epoch", "1", "--pretrain_weights", pth] + other)
        assert f"Loaded pretrained backbone from {pth}" in capsys.readouterr().out
    finally:
        os.chdir(cwd)


REFUSED = [
    (["visualize", "--results", "x.pkl"], "item 5"),
    (["serve"], "item 6"),
    (["train-baseline", "--bf16"], "item 4"),
    (["train-baseline", "--rank", "1", "--world_size", "2"], "more than one card"),
    (["optimize", "--world_size", "2"], "more than one card"),
    (["train-baseline", "--display_freq", "8"], "item 5"),
    (["train-baseline", "--live_port", "0"], "item 5"),
    (["test-baseline", "--visualize_eval"], "item 5"),
    (["train-baseline", "--use_random_rotation"], "item 1"),
    (["train-baseline", "--use_color_jittering"], "item 1"),
    (["train-baseline", "--use_motion_blur"], "item 1"),
    (["optimize", "--loop_collision_backend", "grid"], "item 3"),
    (["optimize", "--escalate_collision", "0.5"], "item 3"),
    (["optimize", "--loop_collision_eager_reselect"], "item 3"),
    (["optimize", "--loop_collision_track_positions"], "item 3"),
]


@pytest.mark.parametrize("argv,item", REFUSED, ids=[" ".join(a) for a, _ in REFUSED])
def test_refused_flags_name_their_roadmap_item(argv, item):
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1") as err:
        cli.main(argv + ["--device", "cpu"] if argv[0] != "visualize" else argv)
    assert item in str(err.value)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal on a machine without a card")
def test_default_device_needs_a_card(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["optimize", "--data_root", str(tmp_path), "--anno_path", "anno.pkl", "--pred_path", "pred.pkl"])


def test_bn_impl_follows_the_environment(monkeypatch):
    monkeypatch.delenv("IHMR_BN_IMPL", raising=False)
    monkeypatch.delenv("IHMR_FUSED_BN", raising=False)
    assert cli._bn_impl() == "stock"
    monkeypatch.setenv("IHMR_FUSED_BN", "1")
    assert cli._bn_impl() == "fused"
    monkeypatch.setenv("IHMR_BN_IMPL", "pallas")
    assert cli._bn_impl() == "pallas"
    parser = cli.build_parser()
    args = parser.parse_args(["test-baseline", "--device", "cpu", "--main_encoder", "resnet18"])
    encoder = cli._encoder(args, torch.device("cpu"))
    assert {m.bn_impl for m in encoder.modules() if hasattr(m, "bn_impl")} == {"pallas"}
    assert all(bool(torch.isfinite(p).all()) for p in encoder.parameters())
