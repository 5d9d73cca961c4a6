"""The pieces around the in-loop collision paths, against the JAX package:

  * the synthetic benchmark families (``make_opt_inputs(variant=...)``:
    standard, interlocked, grazing, single) from one seed: params equal
    (grazing's translation within 1e-5: it is placed from the decoded
    hands' boxes; measured 1.5e-8), every OptBatch array within 1e-5 (fp32
    decode; measured <= 3.0e-7);
  * the escalation helpers ``_bucket_size``, ``warm_strategy`` and
    ``grid_config``: equal to JAX's;
  * the ``optimize`` command: its four collision flags build JAX's
    OptConfig, and ``--escalate_collision`` and the eager / tracked flags
    run end to end on a 4-sample corpus on the CPU with finite metrics
    (``--loop_collision_backend grid`` runs on the card in chip_smoke.py:
    its default 32^3 K=8 build costs ~5 s a hand on one CPU core).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from ihmr_tpu.data.synthetic import make_opt_inputs as jax_make_opt_inputs
from ihmr_tpu.mano.loader import synthetic_mano_model as jax_synthetic
from ihmr_tpu.refine import escalation as JX
from ihmr_tpu.refine import opt_engine as JE
from ihmr_tpu.refine import schedule as JS
from ihmr_tpu_torch import cli
from ihmr_tpu_torch.data.synthetic import VARIANTS, make_opt_inputs, write_corpus
from ihmr_tpu_torch.mano import synthetic_mano_model
from ihmr_tpu_torch.refine import OptBatch, OptConfig, escalation, opt_default, opt_with_cam
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("variant", VARIANTS)
def test_synthetic_variants_match_jax(variant):
    jp, jb = jax_make_opt_inputs(jax_synthetic(), batch=4, seed=3, variant=variant)
    tp, tb = make_opt_inputs(synthetic_mano_model(device="cpu"), batch=4, seed=3, variant=variant)
    for k in jp:
        atol = 1e-5 if (variant, k) == ("grazing", "trans") else 0.0
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0, atol=atol, err_msg=k)
    gap = max(float(np.abs(getattr(tb, f.name).numpy() - np.asarray(getattr(jb, f.name))).max())
              for f in dataclasses.fields(OptBatch))
    print(f"{variant}: OptBatch {gap:.3g} from JAX's")
    assert gap <= 1e-5
    assert tb.hand_type_array[:, 1].eq(0.0 if variant == "single" else 1.0).all()


def test_interlocked_flag_is_the_interlocked_variant():
    model = synthetic_mano_model(device="cpu")
    a, _ = make_opt_inputs(model, batch=2, seed=1, interlocked=True)
    b, _ = make_opt_inputs(model, batch=2, seed=1, variant="interlocked")
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_escalation_helpers_match_jax():
    for n in range(1, 300):
        for batch in (2, 4, 128, 256):
            assert escalation._bucket_size(n, batch) == JX._bucket_size(n, batch), (n, batch)
    for ours, ref in ((opt_default, JS.opt_default), (opt_with_cam, JS.opt_with_cam)):
        for frac in (0.5, 0.3, 0.001):
            assert [dataclasses.astuple(s) for s in escalation.warm_strategy(ours, frac)] == [
                dataclasses.astuple(s) for s in JX.warm_strategy(ref, frac)]
    for kw in (dict(), dict(escalate_fast_build=False, grid_res=16, loop_collision_alternate=True)):
        ours, ref = escalation.grid_config(OptConfig(escalate_collision=0.3, **kw)), JX.grid_config(
            JE.OptConfig(escalate_collision=0.3, **kw))
        for f in dataclasses.fields(OptConfig):
            assert getattr(ours, f.name) == getattr(ref, f.name), f.name
        assert ours.grid_in_loop() and not ours.lazy_active()


FLAGS = ["--loop_collision_backend", "grid", "--escalate_collision", "0.5", "--loop_collision_eager_reselect",
         "--loop_collision_track_positions", "--no_stage_hoist", "--optimizer", "sgd"]


def test_optimize_flags_build_the_jax_config():
    args = cli.build_parser().parse_args(["optimize"] + FLAGS)
    config = cli.optimize_config(args)
    # ihmr_tpu/cli.py's mapping of the same flags
    want = JE.OptConfig(
        optimizer="sgd", save_mid_freq=10, loop_collision_subsample=2, loop_collision_face_subsample=2,
        loop_collision_lazy_reselect=False, loop_collision_freeze_positions=False, loop_collision_fast=False,
        collision_backend="grid", stage_hoist_decode=False, escalate_collision=0.5,
    )
    for f in dataclasses.fields(OptConfig):
        assert getattr(config, f.name) == getattr(want, f.name), f.name
    assert cli.optimize_config(cli.build_parser().parse_args(["optimize"])) == OptConfig()


def test_optimize_runs_the_collision_flags(tmp_path):
    root = str(tmp_path / "corpus")
    write_corpus(root, 4, seed=1)
    argv = ["optimize", "--data_root", root, "--anno_path", "anno.pkl", "--pred_path", "pred.pkl", "--batchSize",
            "2", "--synthetic_mano", "--stage_epochs", "1", "--save_mid_freq", "2", "--device", "cpu"]
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        runs = {
            "escalation": cli.main(argv + ["--escalate_collision", "1e-6"]),
            "eager, tracked": cli.main(argv + ["--loop_collision_eager_reselect", "--loop_collision_track_positions"]),
        }
    finally:
        os.chdir(cwd)
    for name, out in runs.items():
        metrics = out["metrics"]
        print(f"optimize ({name}): {metrics}")
        assert metrics and all(np.isfinite(v) for v in metrics.values()), name
