"""The command line's rendering, visualizer and multi-process flags on the CPU,
against what the JAX package writes for the same results.

A 5-sample corpus (``tests/test_data.py::_write_synthetic_corpus``: 120x90
PNGs), the synthetic hand, ResNet-18 at 64x64, batches of 2, in-process:

  * ``train-baseline --display_freq 2 --live_port 0`` (one epoch, 2 steps):
    the gallery's PNGs have the pixels and ``index.html`` the text that the
    JAX package's ``visuals_from_eval_outputs`` + ``Visualizer`` write for
    the same eval_step outputs (recorded from the port's hook), and the
    live monitor's ``/`` and ``/losses.json`` are the bytes of a JAX
    ``LiveDashboard`` holding the same loss history;
  * ``test-baseline --visualize_eval``: every ``.jpg`` the bytes the JAX
    package's ``render_results`` writes for the same results;
  * ``visualize --results <that pkl>``: the ``.obj`` and ``.jpg`` files of
    the JAX command (``ihmr_tpu.cli.cmd_visualize``) on a JAX Evaluator
    holding the same results;
  * ``--rank r --world_size 2`` on ``test-baseline``, ``optimize`` and
    ``train-baseline``: the samples each run reads are those the JAX
    package's ``BatchLoader`` gives rank r over its dataset padded to
    batch x world_size (train: shuffled, epoch 1, last batch dropped); a
    rank above 0 writes no checkpoint, every rank its evaluation pkl. JAX's
    ``OPTDataset`` reads through its native letterbox, built privately for
    this module (``tests/torch_port_native.py``).
"""

import argparse
import json
import os
import os.path as osp
import types
import urllib.request

import cv2
import numpy as np
import pytest

from ihmr_tpu import cli as jcli
from ihmr_tpu.data import BaselineDataset, BatchLoader, DataConfig, OPTDataset
from ihmr_tpu.eval.evaluator import Evaluator as JEvaluator
from ihmr_tpu.utils import io_utils as jio
from ihmr_tpu.utils import train_visuals as JTV
from ihmr_tpu.utils.live_dashboard import LiveDashboard as JDashboard
from ihmr_tpu.utils.visualizer import Visualizer as JVisualizer
from ihmr_tpu_torch import cli
from ihmr_tpu_torch.train import loops
from ihmr_tpu_torch.utils import io_utils
from ihmr_tpu_torch.utils import train_visuals
from tests.test_data import _write_synthetic_corpus
from tests.torch_port_native import private_jax_native  # noqa: F401
from tests.torch_threads import one_torch_thread  # noqa: F401

N = 5


def _common(root, ckpt):
    return ["--data_root", root, "--anno_path", "anno.pkl", "--batchSize", "2", "--synthetic_mano", "--inputSize", "64",
            "--main_encoder", "resnet18", "--checkpoints_dir", ckpt, "--device", "cpu"]


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("port_cli_vis"))
    _write_synthetic_corpus(osp.join(work, "corpus"), n=N)
    return work


@pytest.fixture(scope="module")
def trained(work):
    """train-baseline with the visualizer hook and the live monitor; the
    hook's inputs recorded."""
    calls = []
    inner = train_visuals.visuals_from_eval_outputs

    def recording(batch, outputs, right_faces, left_faces, idx=0, input_size=224):
        calls.append(dict(img=batch.img.numpy().copy(), joints_2d=batch.joints_2d.numpy().copy(),
                          outputs={k: v.numpy().copy() for k, v in outputs.items()}, input_size=input_size))
        return inner(batch, outputs, right_faces, left_faces, idx, input_size)

    train_visuals.visuals_from_eval_outputs = recording
    cwd = os.getcwd()
    os.chdir(work)
    try:
        out = cli.main(["train-baseline", "--total_epoch", "1", "--display_freq", "2", "--live_port", "0"]
                       + _common(osp.join(work, "corpus"), osp.join(work, "ckpt")))
    finally:
        os.chdir(cwd)
        train_visuals.visuals_from_eval_outputs = inner
    yield out, calls
    out["visualizer"].dashboard.stop()


def test_display_freq_writes_the_jax_gallery(trained, work, tmp_path):
    out, calls = trained
    vis = out["visualizer"]
    assert [(e["epoch"], e["iter"]) for e in vis._gallery] == [(1, 0), (1, 1)] and len(calls) == 2
    from ihmr_tpu_torch.mano import synthetic_mano_model

    faces = synthetic_mano_model(device="cpu").faces.numpy()
    ref = JVisualizer(str(tmp_path), name=vis.name)
    for entry, call in zip(vis._gallery, calls):
        visuals = JTV.visuals_from_eval_outputs(
            types.SimpleNamespace(img=call["img"], joints_2d=call["joints_2d"]), call["outputs"], faces,
            np.ascontiguousarray(faces[:, ::-1]), input_size=call["input_size"])
        ref.display_current_results(visuals, entry["epoch"], entry["iter"])
    names = sorted(os.listdir(ref.img_dir))
    assert names == sorted(os.listdir(vis.img_dir)) and len(names) == 10
    for name in names:
        np.testing.assert_array_equal(cv2.imread(osp.join(vis.img_dir, name)), cv2.imread(osp.join(ref.img_dir, name)))
    assert open(osp.join(vis.web_dir, "index.html")).read() == open(osp.join(ref.web_dir, "index.html")).read()
    assert vis.web_dir == osp.join(work, "ckpt", "web")
    steps = out["epoch_stats"][0]["steps"]
    assert [x for x, _ in vis._loss_history["total_loss"]] == [1 + i / steps for i in range(2)]


def test_live_port_serves_the_jax_monitor(trained, tmp_path):
    out, _ = trained
    dash = out["visualizer"].dashboard
    ref = JDashboard(dash.web_dir, name=dash.name)
    for name, series in out["visualizer"]._loss_history.items():
        for step, value in series:
            ref.update(step, {name: value})
    ref.start(0)
    try:
        bodies = {}
        for key, port in (("port", dash.port), ("jax", ref.port)):
            bodies[key] = [urllib.request.urlopen(f"http://127.0.0.1:{port}{p}", timeout=10).read()
                           for p in ("/", "/losses.json")]
    finally:
        ref.stop()
    assert bodies["port"] == bodies["jax"]
    losses = json.loads(bodies["port"][1])
    assert len(losses["series"]["total_loss"]) == 2 and len(losses["images"]) == 6


@pytest.fixture(scope="module")
def tested(trained, work):
    cwd = os.getcwd()
    os.chdir(work)
    try:
        out = cli.main(["test-baseline", "--visualize_eval"] + _common(osp.join(work, "corpus"), osp.join(work, "ckpt")))
    finally:
        os.chdir(cwd)
    return out


def _jax_evaluator(ours):
    ref = JEvaluator(ours.data_list, image_root=ours.image_root, dataset_name=ours.dataset_name,
                     input_size=ours.input_size, right_faces=ours.right_faces, left_faces=ours.left_faces)
    ref.pred_results = [dict(r) for r in ours.pred_results]
    return ref


def _files(d):
    return {n: open(osp.join(d, n), "rb").read() for n in sorted(os.listdir(d))}


def test_visualize_eval_renders_what_jax_renders(tested, work, tmp_path):
    evaluator = tested["evaluator"]
    img_dir = osp.join(work, "evaluate_results", "baseline", "hand26m", "images")
    _jax_evaluator(evaluator).render_results(str(tmp_path))
    ours, ref = _files(img_dir), _files(tmp_path)
    assert list(ours) == list(ref) == [f"img_{i:03d}.jpg" for i in range(N)]
    assert all(ours[n] == ref[n] for n in ours)


def test_visualize_writes_what_jax_writes(tested, work, tmp_path):
    results = osp.join(work, "evaluate_results", "baseline", "hand26m.pkl")
    out = cli.main(["visualize", "--results", results, "--out_dir", str(tmp_path / "port"), "--limit", "3"])
    assert out["img_dir"] == str(tmp_path / "port" / "images")
    jpkl = str(tmp_path / "jax.pkl")
    jio.save_pkl(jpkl, _jax_evaluator(io_utils.load_pkl(results)))
    jcli.cmd_visualize(argparse.Namespace(results=jpkl, out_dir=str(tmp_path / "jax"), limit=3))
    for sub in ("objs", "images"):
        ours, ref = _files(tmp_path / "port" / sub), _files(tmp_path / "jax" / sub)
        assert list(ours) == list(ref) and len(ours) == 3, sub
        assert all(ours[n] == ref[n] for n in ours), sub


def _jax_shard(work, dataset_cls, rank, train=False, **extra):
    cfg = DataConfig(data_root=osp.join(work, "corpus"), anno_path="anno.pkl", batch_size=2, world_size=2,
                     input_size=64, is_train=train, **extra)
    ds = dataset_cls(cfg)
    ds.load_data()
    loader = BatchLoader(ds, 2, rank=rank, world_size=2, shuffle=train, drop_last=train)
    loader.set_epoch(1)
    return [int(i) for b in loader for i in b["index"]]


@pytest.mark.parametrize("command,rank", [("test-baseline", 1), ("optimize", 0), ("train-baseline", 1)])
def test_rank_reads_the_jax_loaders_shard(private_jax_native, tested, work, tmp_path, monkeypatch, command, rank):
    seen = []
    convert = "_to_opt_batch" if command == "optimize" else "_to_baseline_batch"
    inner = getattr(loops, convert)

    def recording(raw, device=None):
        seen.extend(int(i) for i in raw["index"])
        return inner(raw, device)

    monkeypatch.setattr(loops, convert, recording)
    ckpt = str(tmp_path / "ckpt")
    if command != "train-baseline":
        os.makedirs(ckpt)
        for name in os.listdir(osp.join(work, "ckpt")):  # test-baseline reads the trained checkpoint
            if name.endswith(".pth"):
                os.link(osp.join(work, "ckpt", name), osp.join(ckpt, name))
    argv = [command, "--rank", str(rank), "--world_size", "2"] + _common(osp.join(work, "corpus"), ckpt)
    extra = {}
    if command == "optimize":
        argv += ["--pred_path", "pred.pkl", "--stage_epochs", "1", "--save_mid_freq", "1"]
        extra = dict(pred_path="pred.pkl")
    elif command == "train-baseline":
        argv += ["--total_epoch", "1"]
    monkeypatch.chdir(tmp_path)
    out = cli.main(argv)
    dataset_cls = OPTDataset if command == "optimize" else BaselineDataset
    want = _jax_shard(work, dataset_cls, rank, train=command == "train-baseline", **extra)
    assert seen == want and len(want) >= 2
    if command == "train-baseline":
        assert out["epoch_stats"][0]["steps"] == len(want) // 2
        assert not (osp.isdir(ckpt) and any(f.endswith(".pth") for f in os.listdir(ckpt)))  # only rank 0 saves
    else:
        name = "baseline" if command == "test-baseline" else "optimize"
        saved = io_utils.load_pkl(str(tmp_path / "evaluate_results" / name / "hand26m.pkl"))
        # the padding's repeats removed by image path
        paths = [r["img_path_relative"] for r in saved.pred_results]
        assert len(paths) == len(set(paths)) and set(paths) == {saved.data_list[i]["img_path"] for i in want}
