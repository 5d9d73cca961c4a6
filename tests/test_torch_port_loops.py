"""The run loops that end in an Evaluator: ``optimize_loop`` and
``test_baseline_loop`` (``test_mlp_loop`` is held in
tests/test_torch_port_mlp.py, on the slice's trained networks).

Each loop runs over raw dataset-schema batches on the CPU. Its per-batch
results must equal a direct call of the engine it wraps on the same batch
(``optimize_batch``, ``eval_step``: the same code on the same inputs, so
bit for bit), and its Evaluator must equal a JAX ``Evaluator`` fed those
results as numpy arrays (entries equal, ``metric_dict`` within 1e-9
relative). ``optimize_loop``: 2 batches of B=2, every ``opt_default``
stage cut to epoch 2 with ``save_mid_freq=1``, one .obj per batch.
``test_baseline_loop``: ResNet-18 at 64x64, B=2, one sample flipped.
No JAX program is compiled here.
"""

import dataclasses

import numpy as np
import torch

from ihmr_tpu.eval.evaluator import Evaluator as JEvaluator
from ihmr_tpu_torch.data import baseline_raw_batch, make_opt_inputs, opt_raw_batch
from ihmr_tpu_torch.mano import synthetic_mano_model
from ihmr_tpu_torch.pipeline import make_train_bench_inputs
from ihmr_tpu_torch.refine import OptConfig, opt_default, optimize_batch
from ihmr_tpu_torch.train import eval_step, optimize_loop, print_metrics, test_baseline_loop
from ihmr_tpu_torch.train.loops import _to_baseline_batch, _to_opt_batch
from ihmr_tpu_torch.utils import io_utils
from tests.test_torch_port_eval import _assert_entries_equal, _assert_metrics_close
from tests.torch_threads import one_torch_thread  # noqa: F401


class Dataset:
    """A dataset's sample list, as the loops read it."""

    def __init__(self, n):
        self.data_list = [dict(img_path=f"cap{i // 2}/image{i:05d}.jpg") for i in range(n)]
        self.name = "synthetic"


def _host(results):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in results.items()}


def test_raw_batch_round_trip():
    mano = synthetic_mano_model(device="cpu")
    params, batch = make_opt_inputs(mano, batch=2, seed=0)
    raw = opt_raw_batch(params, batch, index_offset=4)
    np.testing.assert_array_equal(raw["index"], [4, 5])
    p2, b2 = _to_opt_batch(raw, "cpu")
    for k in params:
        assert torch.equal(p2[k], params[k]), k
    for f in dataclasses.fields(batch):
        assert torch.equal(getattr(b2, f.name), getattr(batch, f.name)), f.name
    inputs = make_train_bench_inputs(batch=2, image_size=32, arch="resnet18", device="cpu")
    bb = _to_baseline_batch(baseline_raw_batch(inputs.batch), "cpu")
    for f in dataclasses.fields(bb):
        assert torch.equal(getattr(bb, f.name), getattr(inputs.batch, f.name)), f.name


def test_optimize_loop(tmp_path, capsys):
    mano = synthetic_mano_model(device="cpu")
    raws = [opt_raw_batch(*make_opt_inputs(mano, batch=2, seed=s), index_offset=2 * s) for s in range(2)]
    strategy = tuple(dataclasses.replace(s, epoch=2) for s in opt_default)
    config = OptConfig(save_mid_freq=1)
    dataset = Dataset(4)
    evaluator = optimize_loop(mano, raws, dataset, strategy, config, obj_dump_dir=str(tmp_path))
    assert "hands/sec" in capsys.readouterr().out

    ref = JEvaluator(dataset.data_list, dataset_name="synthetic")
    for k, raw in enumerate(raws):
        _, results = optimize_batch(mano, *_to_opt_batch(raw, "cpu"), strategy, config)
        results = _host(results)
        results["do_flip"] = np.zeros(2, np.int32)
        ref.update(raw["index"], results)
        # one mesh per batch: its first sample, both hands
        verts, faces = io_utils.load_obj(str(tmp_path / f"iter_{k:04d}.obj"))
        want = np.concatenate([results["pred_right_hand_verts"][0], results["pred_left_hand_verts"][0]])
        np.testing.assert_allclose(verts, want, atol=1e-6)
        assert faces.shape == (2 * mano.faces.shape[0], 3)
    assert len(list(tmp_path.iterdir())) == len(raws)
    _assert_entries_equal(evaluator.pred_results, ref.pred_results)
    _assert_metrics_close(evaluator.metric_dict(), ref.metric_dict())
    md = evaluator.metric_dict()
    assert all(np.isfinite(v) for v in md.values()) and md["collision_max"] > 0
    print_metrics(evaluator, "opt")
    assert "collision_auc" in capsys.readouterr().out


def test_baseline_evaluation_loop():
    inputs = make_train_bench_inputs(batch=2, image_size=64, arch="resnet18", device="cpu")
    raw = baseline_raw_batch(inputs.batch, index_offset=1)
    raw["do_flip"] = np.array([0, 1], np.int32)
    dataset = Dataset(3)
    evaluator = test_baseline_loop(inputs.state, [raw], dataset, inputs.mano_right, inputs.mano_left, inputs.config)

    _, outputs = eval_step(inputs.state, _to_baseline_batch(raw, "cpu"), inputs.mano_right, inputs.mano_left,
                           inputs.config)
    outputs = _host(outputs)
    outputs["do_flip"] = raw["do_flip"]
    ref = JEvaluator(dataset.data_list, dataset_name="synthetic")
    ref.update(raw["index"], outputs)
    _assert_entries_equal(evaluator.pred_results, ref.pred_results)
    _assert_metrics_close(evaluator.metric_dict(), ref.metric_dict())
    assert set(evaluator.metric_dict()) >= {"mpjpe_3d", "collision_auc", "hand_type_acc"}
    assert [r["img_path_relative"] for r in evaluator.pred_results] == [d["img_path"] for d in dataset.data_list[1:]]
