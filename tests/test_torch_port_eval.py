"""The evaluation slice (``core/procrustes.py``, ``eval/``, ``utils/io_utils.py``)
against the JAX package's numpy code on the same seeded inputs.

Procrustes and the metric math: 1e-10 absolute (float64 on both sides).
The Evaluator is fed one set of seeded results (some samples flipped, the
padding duplicates of a last batch, a handedness head, image features and
all four vertex keys; as torch tensors for the port and numpy arrays for
JAX): every ``pred_results`` entry equal and ``metric_dict`` within 1e-9
relative, before and after ``remove_redunc``. ``ResultStat`` prints and
keeps the same bests. The exporters write pkl files of the same keys,
dtypes and values, and each package reads the other's.
"""

import numpy as np
import pytest
import torch

from ihmr_tpu.core import procrustes as JP
from ihmr_tpu.eval import export as JX
from ihmr_tpu.eval import metrics as JMet
from ihmr_tpu.eval.evaluator import Evaluator as JEvaluator
from ihmr_tpu.eval.result_stat import ResultStat as JResultStat
from ihmr_tpu.utils import io_utils as jio
from ihmr_tpu_torch.core import procrustes as TP
from ihmr_tpu_torch.eval import Evaluator, ResultStat, results_to_host
from ihmr_tpu_torch.eval import export as TX
from ihmr_tpu_torch.eval import metrics as TMet
from ihmr_tpu_torch.utils import io_utils as tio
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("n", [3, 21, 42])
def test_procrustes_matches_jax(n):
    rng = np.random.RandomState(n)
    a, b = rng.randn(n, 3), rng.randn(n, 3) * 0.7 + 0.1
    for name in ("similarity_align", "no_rot_align"):
        np.testing.assert_allclose(getattr(TP, name)(a, b), getattr(JP, name)(a, b), atol=1e-10, rtol=0, err_msg=name)
    np.testing.assert_allclose(TP.similarity_align(a.T, b.T), JP.similarity_align(a.T, b.T), atol=1e-10, rtol=0)


def test_metrics_match_jax():
    rng = np.random.RandomState(0)
    for trial in range(6):
        pred, gt = rng.randn(42, 3) * 0.05, rng.randn(42, 3) * 0.05
        valid = (rng.rand(42, 1) > 0.2 * trial).astype(np.float32)
        scale = float(rng.rand() + 0.5)
        np.testing.assert_allclose(
            TMet.single_joints_error(pred, gt, valid, scale), JMet.single_joints_error(pred, gt, valid, scale),
            atol=1e-10, rtol=0,
        )
        for use_rot in (False, True):
            ours = TMet.single_pa_inter_joints_error(pred, gt, valid, scale, use_rot)
            ref = JMet.single_pa_inter_joints_error(pred, gt, valid, scale, use_rot)
            assert len(ours) == len(ref)
            np.testing.assert_allclose(ours, ref, atol=1e-10, rtol=0)
    col = np.abs(rng.randn(5000)) * 6.0
    assert abs(TMet.collision_auc(col) - JMet.collision_auc(col)) <= 1e-10
    for hand_type in ("interacting", "right"):
        for valid in (0.0, 1.0):
            for pred in ([0.7, 0.6], [0.7, 0.2], [0.3, 0.9]):
                assert TMet.hand_type_accuracy(hand_type, valid, np.array(pred)) == JMet.hand_type_accuracy(
                    hand_type, valid, np.array(pred)
                )


def _seeded_results(n=6, seed=0):
    """One batch of results as the loops produce them (numpy)."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    res = dict(
        pred_cam_params=rng.randn(n, 3).astype(f32),
        pred_shape_params=rng.randn(n, 20).astype(f32),
        pred_pose_params=rng.randn(n, 96).astype(f32),
        pred_hand_trans=rng.randn(n, 3).astype(f32),
        pred_joints_3d=(rng.randn(n, 42, 3) * 0.05).astype(f32),
        pred_joints_2d=rng.randn(n, 42, 2).astype(f32),
        gt_joints_3d=np.concatenate(
            [(rng.randn(n, 42, 3) * 0.05).astype(f32), (rng.rand(n, 42, 1) > 0.1).astype(f32)], -1
        ),
        collision_loss_origin_scale=np.maximum(rng.randn(n, 1556) * 0.003, 0).astype(f32),
        pred_hand_type=rng.rand(n, 2).astype(f32),
        img_feat=np.abs(rng.randn(n, 1024)).astype(f32),
        do_flip=np.array([0, 1, 0, 1, 1, 0][:n], np.int32),
    )
    for key in ("pred_right_hand_verts", "pred_left_hand_verts", "gt_right_hand_verts", "gt_left_hand_verts"):
        res[key] = (rng.randn(n, 778, 3) * 0.05).astype(f32)
    return res


DATA_LIST = [
    dict(img_path=f"seq{i // 3}/cam0/image{i:04d}.jpg", hand_type="interacting" if i % 4 else "right",
         hand_type_valid=1.0 if i != 2 else 0.0, scale=0.5 + 0.1 * i)
    for i in range(10)
]


def _fill(ev_cls, faces, to_torch):
    ev = ev_cls(DATA_LIST, image_root="/data", right_faces=faces, left_faces=faces[:, ::-1].copy())
    for b, idx in enumerate(([0, 1, 2, 3, 4, 5], [6, 7, 8, 9, 0, 0])):  # the last batch padded with sample 0
        res = _seeded_results(seed=b)
        if to_torch:
            res = {k: torch.as_tensor(v) for k, v in res.items()}
            idx = torch.tensor(idx)
        ev.update(idx, res)
    return ev


def _assert_entries_equal(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert sorted(a) == sorted(b)
        for k in b:
            if isinstance(b[k], np.ndarray):
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k


def _assert_metrics_close(ours, ref):
    assert list(ours) == list(ref)
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-9, atol=0, err_msg=k)


@pytest.fixture(scope="module")
def evaluators():
    faces = np.random.RandomState(1).randint(0, 778, (1538, 3))
    return _fill(Evaluator, faces, True), _fill(JEvaluator, faces, False), faces


def test_evaluator_matches_jax(evaluators):
    ours, ref, _ = evaluators
    _assert_entries_equal(ours.pred_results, ref.pred_results)
    _assert_metrics_close(ours.metric_dict(), ref.metric_dict())
    ours.remove_redunc()
    ref.remove_redunc()
    assert len(ours.pred_results) == len(DATA_LIST)
    _assert_entries_equal(ours.pred_results, ref.pred_results)
    _assert_metrics_close(ours.metric_dict(), ref.metric_dict())
    assert "hand_type_acc" in ours.metric_dict()


def test_evaluator_without_handedness_and_gather(evaluators):
    _, _, faces = evaluators
    res = {k: v for k, v in _seeded_results(4, seed=3).items() if k not in ("pred_hand_type", "img_feat")}
    ours, ref = Evaluator([], right_faces=faces, left_faces=faces), JEvaluator([], right_faces=faces, left_faces=faces)
    ours.update(np.arange(4), res, save_verts=False)
    ref.update(np.arange(4), res, save_verts=False)
    ours.gather_pred(ours.pred_results[:2])
    ref.gather_pred(ref.pred_results[:2])
    _assert_entries_equal(ours.pred_results, ref.pred_results)
    _assert_metrics_close(ours.metric_dict(), ref.metric_dict())
    assert "hand_type_acc" not in ours.metric_dict()
    ours.clear()
    assert ours.pred_results == [] and np.isnan(ours.mpjpe_3d)


def test_results_to_host_one_copy_per_dtype():
    res = {"a": torch.arange(6.0).reshape(2, 3), "b": torch.ones(()), "c": torch.arange(4), "d": None,
           "e": np.zeros(2)}
    out = results_to_host(res)
    np.testing.assert_array_equal(out["a"], res["a"].numpy())
    assert out["b"].shape == () and out["c"].dtype == np.int64 and out["d"] is None and out["e"] is res["e"]


def test_export_objs_and_render(evaluators, tmp_path):
    ours, ref, _ = evaluators
    ours.export_objs(str(tmp_path / "port"), limit=2)
    ref.export_objs(str(tmp_path / "jax"), limit=2)
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir()) and len(names) == 2
    for name in names:
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
        v, f = tio.load_obj(str(tmp_path / "port" / name))
        assert v.shape == (1556, 3) and f.shape == (3076, 3)
    with pytest.raises(NotImplementedError, match="utils/"):
        ours.render_results(str(tmp_path / "vis"))


def _assert_pkl_equal(a, b):
    assert sorted(a) == sorted(b)
    for key in b:
        if isinstance(b[key], dict):
            _assert_pkl_equal(a[key], b[key])
        else:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_exports_match_jax(evaluators, tmp_path):
    ours, ref, _ = evaluators
    key0 = ref.pred_results[0]["img_path_relative"]
    j2d = {key0: np.ones((42, 2), np.float32)}
    feats = {key0: np.full(1024, 2.0, np.float32)}
    for kwargs in (dict(), dict(joints_2d=j2d, img_feats=feats)):
        a = TX.evaluator_to_prediction_pkl(ours, str(tmp_path / "port_pred.pkl"), **kwargs)
        b = JX.evaluator_to_prediction_pkl(ref, str(tmp_path / "jax_pred.pkl"), **kwargs)
        _assert_pkl_equal(a, b)
        # each package reads the other's file
        _assert_pkl_equal(jio.load_pkl(str(tmp_path / "port_pred.pkl")), tio.load_pkl(str(tmp_path / "jax_pred.pkl")))
    a = TX.evaluator_to_opt_pseudo_gt(ours, str(tmp_path / "port_gt.pkl"))
    b = JX.evaluator_to_opt_pseudo_gt(ref, str(tmp_path / "jax_gt.pkl"))
    _assert_pkl_equal(a, b)
    _assert_pkl_equal(jio.load_pkl(str(tmp_path / "port_gt.pkl")), tio.load_pkl(str(tmp_path / "jax_gt.pkl")))
    annos_t, annos_j = [dict(d) for d in DATA_LIST], [dict(d) for d in DATA_LIST]
    TX.merge_opt_pseudo_gt_into_annotations(annos_t, a)
    JX.merge_opt_pseudo_gt_into_annotations(annos_j, b)
    for x, y in zip(annos_t, annos_j):
        assert sorted(x) == sorted(y)


def test_result_stat_matches_jax(capsys):
    ours, ref = ResultStat(), JResultStat()
    outs = []
    for stat in (ours, ref):
        rng = np.random.RandomState(2)
        for epoch in range(1, 5):
            for metric, _t, _s in stat.RESULT_INFO:
                stat.update(metric, epoch, float(rng.rand()))
            stat.print_current_result(epoch)
            assert isinstance(stat.achieve_better(), bool)
        stat.print_best_results()
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert ours.best_results == ref.best_results and ours.get_best_results == ref.get_best_results
