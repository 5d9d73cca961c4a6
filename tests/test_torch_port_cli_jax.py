"""``optimize`` through both command lines, in-process, on the same corpus
and prediction pkl: the port's CLI (``--device cpu``) against the JAX
package's, B=2, ``--stage_epochs 2 --save_mid_freq 1``, ``opt_default``
(``tests/test_torch_port_cli_jax_cam.py`` runs ``opt_with_cam``, in a file of
its own so that xdist's loadfile puts the two JAX compiles on two workers).

The JAX CLI runs with ``ihmr_tpu.ops.collision`` on its TPU branch
(``tests/test_torch_port_nearest.py::jax_tpu_branch``): on the CPU its
"auto" final collision backend would be the K-candidate XLA path, while
the port's (and JAX's on the TPU) is the exact kernel, here JAX's Pallas
kernel in interpret mode. The JAX side compiles for ~80 s on one core.

Bounds: refined params (the Evaluator's cam / pose / shape / trans, and the
exported pseudo-GT pkl) within 2e-4 absolute; ``metric_dict`` within 1e-3
relative; the same samples, in the same order, under the same keys.
"""

import os
import os.path as osp

import numpy as np
import pytest

from ihmr_tpu import cli as jax_cli
from ihmr_tpu_torch import cli
from ihmr_tpu_torch.utils import io_utils
from tests.test_data import _write_synthetic_corpus
from tests.test_torch_port_nearest import jax_tpu_branch
from tests.torch_threads import one_torch_thread  # noqa: F401

PARAM_TOL = 2e-4
METRIC_RTOL = 1e-3
PARAM_KEYS = ("pred_cam_params", "pred_pose_params", "pred_shape_params", "pred_hand_trans")


def run_both(work: str, strategy: str):
    """Both CLIs' ``optimize`` on one 4-sample corpus -> {"jax": ..., "port": ...},
    each (Evaluator read back from evaluate_results, pseudo-GT pkl)."""
    root = osp.join(work, "corpus")
    _write_synthetic_corpus(root, n=4)
    argv = ["optimize", "--data_root", root, "--anno_path", "anno.pkl", "--pred_path", "pred.pkl", "--batchSize", "2",
            "--synthetic_mano", "--stage_epochs", "2", "--save_mid_freq", "1", "--strategy", strategy]
    out = {}
    cwd = os.getcwd()
    try:
        for name in ("jax", "port"):
            run_dir = osp.join(work, name)
            os.makedirs(run_dir)
            os.chdir(run_dir)
            pgt = osp.join(run_dir, "pseudo_gt.pkl")
            if name == "jax":
                with jax_tpu_branch():
                    jax_cli.main(argv + ["--export_pseudo_gt", pgt])
            else:
                cli.main(argv + ["--export_pseudo_gt", pgt, "--device", "cpu"])
            evaluator = io_utils.load_pkl(osp.join(run_dir, "evaluate_results", "optimize", "hand26m.pkl"))
            out[name] = (evaluator, io_utils.load_pkl(pgt))
    finally:
        os.chdir(cwd)
    return out


def check_params(runs):
    (jax_ev, jax_pgt), (ev, pgt) = runs["jax"], runs["port"]
    assert [r["img_path_relative"] for r in ev.pred_results] == [r["img_path_relative"] for r in jax_ev.pred_results]
    assert len(ev.pred_results) == 4
    gap = 0.0
    for ours, ref in zip(ev.pred_results, jax_ev.pred_results):
        for key in PARAM_KEYS:
            gap = max(gap, float(np.abs(np.asarray(ours[key]) - np.asarray(ref[key])).max()))
    assert gap <= PARAM_TOL, gap
    assert sorted(pgt) == sorted(jax_pgt)
    for img, entry in pgt.items():
        assert set(entry) == set(jax_pgt[img])
        for key, value in entry.items():
            np.testing.assert_allclose(value, jax_pgt[img][key], rtol=0, atol=PARAM_TOL, err_msg=f"{img} {key}")
    return gap


def check_metrics(runs):
    ours, ref = runs["port"][0].metric_dict(), runs["jax"][0].metric_dict()
    assert list(ours) == list(ref)
    for key in ref:
        np.testing.assert_allclose(ours[key], ref[key], rtol=METRIC_RTOL, atol=0, err_msg=key)


def check_result_keys(runs):
    for ours, ref in zip(runs["port"][0].pred_results, runs["jax"][0].pred_results):
        assert set(ours) == set(ref)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_both(str(tmp_path_factory.mktemp("cli_jax_opt_default")), "opt_default")


def test_refined_params_match_jax(runs):
    check_params(runs)


def test_metric_dict_matches_jax(runs):
    check_metrics(runs)


def test_evaluator_entries_match_jax(runs):
    check_result_keys(runs)
