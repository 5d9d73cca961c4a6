"""The slice as a whole: the port's OPT refinement against the JAX package's.

Same seed, same inputs: ``make_opt_inputs`` parity, the OPT losses at every
stage's weights, then ``optimize_batch`` at B=2 with every ``opt_default``
stage cut to epoch=20 (21 steps = one superblock of two snapshot blocks plus
a one-step tail block with its own payload) and ``save_mid_freq=10``, against
JAX ``OptConfig(save_mid_freq=10, collision_backend="pallas")`` (the exact
kernel in interpret mode for the final metric). Both run their default
engine, the stage-hoisted one. Tolerances: final params
2e-4 absolute (as tests/test_ref_e2e_opt.py holds the JAX engine to the
reference), final collision loss 1e-3 relative; inputs 1e-5 absolute (fp32
decode), losses 1e-5 relative. The JAX side compiles for ~80 s on one CPU
core, so it runs once per module.

The streaming tracker (``refine/tracker.py``) against JAX's
``TwoHandTracker`` over 3 frames at B=2 (``make_opt_inputs`` seeds 0, 1, 2;
the last two frames blend their detection into the warm start) with
``streaming_strategy(20)`` and ``save_mid_freq=10``: the schedule and the
config of the run above, so JAX reuses its compile. Refined params, the
EMA and the smoothed output within 2e-4, the final collision loss within
1e-3 relative, ``frame_idx`` equal. The tracker's default schedule shape
(``save_mid_freq=5`` with a tail block) is in
``tests/test_torch_port_tracker_jax.py``, a compile of its own.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ihmr_tpu.data.synthetic import make_opt_inputs as jax_make_opt_inputs
from ihmr_tpu.mano.loader import synthetic_mano_model as jax_synthetic
from ihmr_tpu.refine import opt_engine as JE
from ihmr_tpu.refine import schedule as JS
from ihmr_tpu.refine import tracker as JT
from ihmr_tpu_torch.data import make_opt_inputs
from ihmr_tpu_torch.mano import synthetic_mano_model
from ihmr_tpu_torch.refine import (
    OptBatch,
    OptConfig,
    TwoHandTracker,
    compute_losses,
    opt_default,
    optimize_batch,
    streaming_strategy,
)
from ihmr_tpu_torch.refine import opt_engine as TE
from ihmr_tpu_torch.refine import schedule as TS
from tests.torch_threads import one_torch_thread  # noqa: F401

B, EPOCH = 2, 20


def T(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module")
def jax_inputs():
    model = jax_synthetic()
    params, batch = jax_make_opt_inputs(model, batch=B, seed=0)
    return model, params, batch


@pytest.fixture(scope="module")
def torch_inputs(jax_inputs):
    """The JAX arrays, as torch tensors (so the engines see identical inputs)."""
    _, params, batch = jax_inputs
    tb = OptBatch(**{f.name: T(getattr(batch, f.name)) for f in dataclasses.fields(OptBatch)})
    return synthetic_mano_model(device="cpu"), {k: T(v) for k, v in params.items()}, tb


def _short(strategy):
    return tuple(dataclasses.replace(s, epoch=EPOCH) for s in strategy)


@pytest.fixture(scope="module")
def jax_result(jax_inputs):
    model, params, batch = jax_inputs
    cfg = JE.OptConfig(save_mid_freq=10, collision_backend="pallas")
    # committed, like the refined params a tracker frame starts from: jit keys
    # its cache on that, and the tracker test reuses this compile
    params = jax.device_put(params, jax.devices()[0])
    out, res = JE.optimize_batch(model, params, batch, _short(JS.opt_default), cfg)
    return jax.tree_util.tree_map(np.asarray, (out, res))


def test_schedule_matches_jax():
    assert len(opt_default) == len(JS.opt_default)
    for ours, ref in zip(opt_default, JS.opt_default):
        assert dataclasses.astuple(ours) == dataclasses.astuple(ref)
    assert TS.OPT_DEFAULT_LOSS_WEIGHTS == JS.OPT_DEFAULT_LOSS_WEIGHTS
    assert TS.check_valid_loss("collision_loss") and not TS.check_valid_loss("joints_3d_loss")
    with pytest.raises(ValueError):
        TS.Stage(("trans",), (("joints_2d_loss", 1.0),), 1e-3, 1, (("joints_3d_loss", "+0"),), "collision_loss")


def test_opt_config_defaults_and_unported_paths():
    ours, ref = OptConfig(), JE.OptConfig()
    for f in dataclasses.fields(OptConfig):
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    # the 2-level hierarchy is the one path not ported
    with pytest.raises(NotImplementedError):
        OptConfig(loop_collision_cluster=2)
    with pytest.raises(NotImplementedError):
        OptConfig(collision_backend="2level")
    # every other in-loop path constructs (the K-candidate, grid and exact
    # backends, per-step reselection, tracked positions, parity-alternating
    # queries, escalation, the grid knobs), and so do SGD and the full decode
    # alone or together (JAX's per-stage programs)
    for ok in (
        dict(collision_backend="xla"), dict(num_candidates=4), dict(loop_collision_fast=False),
        dict(loop_collision_alternate=True), dict(escalate_collision=1.0), dict(loop_collision_lazy_reselect=False),
        dict(loop_collision_freeze_positions=False), dict(grid_res=16), dict(collision_backend="grid", grid_focus=True),
        dict(escalate_warm_start=0.0, escalate_fast_build=False, grid_face_subsample=4, grid_num_candidates=2),
        dict(stage_hoist_decode=False), dict(optimizer="sgd"), dict(stage_hoist_decode=False, optimizer="sgd"),
    ):
        cfg = OptConfig(**ok)
        for name, value in ok.items():
            assert getattr(cfg, name) == value, name
        ref = JE.OptConfig(**ok)
        assert (cfg.lazy_active(), cfg.grid_in_loop()) == (ref.lazy_active(), ref.grid_in_loop()), ok
    assert OptConfig().replace(grid_res=8) == OptConfig(grid_res=8)
    with pytest.raises(ValueError):
        OptConfig(optimizer="rmsprop")


def test_make_opt_inputs_parity(jax_inputs):
    _, jp, jb = jax_inputs
    tp, tb = make_opt_inputs(synthetic_mano_model(device="cpu"), batch=B, seed=0)
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]), err_msg=k)
    for f in dataclasses.fields(OptBatch):
        np.testing.assert_allclose(getattr(tb, f.name).numpy(), np.asarray(getattr(jb, f.name)), atol=1e-5, err_msg=f.name)


@pytest.fixture(scope="module")
def payloads(jax_inputs, torch_inputs):
    """The block-frozen in-loop collision payload, built by both engines."""
    jm, jp, _ = jax_inputs
    tm, tp, _ = torch_inputs
    jcfg = JE.OptConfig(save_mid_freq=10)
    payload = jax.jit(lambda p: JE._lazy_coll_payload(jm, p, jcfg, (None,), "tris")[0])(jp)
    return payload, TE._lazy_coll_payload(tm, tp, OptConfig(), (None,), "tris")[0]


def test_in_loop_payload_matches_jax(payloads):
    payload, tpayload = payloads
    for ours, ref in zip(tpayload, payload):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("stage", range(4))
def test_in_loop_losses_and_gradients(jax_inputs, torch_inputs, payloads, stage):
    """Every stage's weights, against the block-frozen payload of the JAX engine."""
    jm, jp, jb = jax_inputs
    tm, tp, tb = torch_inputs
    st = JS.opt_default[stage]
    jcfg = JE.OptConfig(save_mid_freq=10)
    payload, tpayload = payloads

    def jloss(sub):
        return JE.compute_losses(jm, {**jp, **sub}, jb, st.weights, jcfg, in_loop=True, coll_tris=payload)

    (jtot, jaux), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))({k: jp[k] for k in st.update_params})
    leaves = {k: tp[k].clone().requires_grad_(True) for k in st.update_params}
    ttot, taux = compute_losses(tm, {**tp, **leaves}, tb, st.weights, OptConfig(), in_loop=True, coll_tris=tpayload)
    tgrad = torch.autograd.grad(ttot, list(leaves.values()))
    np.testing.assert_allclose(ttot.item(), float(jtot), rtol=1e-5)
    for key in ("joints_3d_loss_p_batch", "joints_2d_loss_p_batch", "collision_loss_batch"):
        np.testing.assert_allclose(taux[key].detach().numpy(), np.asarray(jaux[key]), rtol=1e-5, atol=1e-7)
    for k, g in zip(leaves, tgrad):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrad[k]), rtol=1e-4, atol=1e-5 * float(np.abs(jgrad[k]).max()))


def test_optimize_batch_matches_jax(torch_inputs, jax_result):
    tm, tp, tb = torch_inputs
    jout, jres = jax_result
    out, res = optimize_batch(tm, tp, tb, _short(opt_default), OptConfig(save_mid_freq=10))
    for k in jout:
        np.testing.assert_allclose(out[k].numpy(), jout[k], atol=2e-4, err_msg=k)
    assert jres["collision_loss"].max() > 0  # the exact, parity-filtered metric saw contact
    np.testing.assert_allclose(res["collision_loss"].numpy(), jres["collision_loss"], rtol=1e-3, atol=1e-6)
    assert set(res) == set(jres)
    for k in ("total_loss", "joints_3d_loss", "joints_2d_loss", "hand_trans_loss"):
        np.testing.assert_allclose(res[k].numpy(), jres[k], rtol=1e-3, err_msg=k)
    for k in ("pred_right_hand_verts", "pred_left_hand_verts", "pred_joints_3d"):
        assert res[k].shape == jres[k].shape and torch.isfinite(res[k]).all()


def test_full_decode_engine_matches_jax(torch_inputs, jax_result):
    """The port's ``stage_hoist_decode=False`` engine against the same JAX
    run (its hoisted engine, which the JAX package holds to its fused engine
    within 5e-5), at the bounds above."""
    tm, tp, tb = torch_inputs
    jout, jres = jax_result
    out, res = optimize_batch(tm, tp, tb, _short(opt_default), OptConfig(save_mid_freq=10, stage_hoist_decode=False))
    for k in jout:
        np.testing.assert_allclose(out[k].numpy(), jout[k], atol=2e-4, err_msg=k)
    np.testing.assert_allclose(res["collision_loss"].numpy(), jres["collision_loss"], rtol=1e-3, atol=1e-6)


def run_trackers(jax_tracker, tracker, jm, seeds):
    """Both trackers over the frames ``make_opt_inputs(jm, B, seed)`` of
    ``seeds`` (the port on the same arrays as tensors), from the first
    frame's params; every frame after the first blends its own params in as
    the detection. -> per frame, (JAX state, results) and the port's, numpy."""
    jax_out, out = [], []
    jstate = state = None
    for i, seed in enumerate(seeds):
        jp, jb = jax_make_opt_inputs(jm, batch=B, seed=seed)
        tp = {k: T(v) for k, v in jp.items()}
        tb = OptBatch(**{f.name: T(getattr(jb, f.name)) for f in dataclasses.fields(OptBatch)})
        if i == 0:
            # committed like every later frame's warm start (the refined params
            # of a jitted step), so that all frames share one compile
            jp = jax.device_put(jp, jax.devices()[0])
            jstate, state = jax_tracker.init(jp), tracker.init(tp)
        jstate, jres = jax_tracker.step(jstate, jb, jp if i else None)
        state, res = tracker.step(state, tb, tp if i else None)
        jax_out.append(jax.tree_util.tree_map(np.asarray, (jstate.params, jstate.ema_params, int(jstate.frame_idx), jres)))
        out.append(jax.tree_util.tree_map(lambda x: x.numpy() if isinstance(x, torch.Tensor) else x,
                                          (state.params, state.ema_params, state.frame_idx, res)))
    return jax_out, out


def assert_trackers_agree(jax_out, out):
    """Refined params, EMA and smoothed output within 2e-4, final collision
    1e-3 relative, frame_idx equal, the same result keys, every frame."""
    for (jparams, jema, jidx, jres), (params, ema, idx, res) in zip(jax_out, out):
        assert idx == jidx
        assert set(res) == set(jres)
        for k in jparams:
            np.testing.assert_allclose(params[k], jparams[k], atol=2e-4, err_msg=k)
            np.testing.assert_allclose(ema[k], jema[k], atol=2e-4, err_msg=k)
            np.testing.assert_allclose(res["smoothed_params"][k], jres["smoothed_params"][k], atol=2e-4, err_msg=k)
        np.testing.assert_allclose(res["collision_loss"], jres["collision_loss"], rtol=1e-3, atol=1e-6)
    assert [o[2] for o in out] == [1, 2, 3]


def test_tracker_matches_jax(jax_inputs, torch_inputs, jax_result):
    """Three frames with a detection blend; frame 1 is ``jax_result``'s run."""
    jm = jax_inputs[0]
    jtracker = JT.TwoHandTracker(jm, strategy=JT.streaming_strategy(EPOCH),
                                 config=JE.OptConfig(save_mid_freq=10, collision_backend="pallas"))
    tracker = TwoHandTracker(torch_inputs[0], strategy=streaming_strategy(EPOCH), config=OptConfig(save_mid_freq=10))
    assert JT.streaming_strategy(EPOCH) == _short(JS.opt_default)  # the same static arguments: no new compile
    jax_out, out = run_trackers(jtracker, tracker, jm, (0, 1, 2))
    for k in jax_result[0]:
        np.testing.assert_array_equal(jax_out[0][0][k], jax_result[0][k])
    assert_trackers_agree(jax_out, out)


def compare_full_schedule(batch: int, seed: int, threads, stage_hoist_decode: bool = True) -> None:
    """Both packages over the FULL opt_default (4 x 301 steps) on the same
    inputs, JAX on its default (stage-hoisted) engine and the port on the
    engine ``stage_hoist_decode`` selects; the port runs once per torch CPU
    thread count in ``threads`` (the count changes the order of torch's CPU
    sums). Prints, per run, the largest parameter difference per sample and
    both final collision losses. Too slow for the test tier; run from the
    repo root:

        JAX_PLATFORMS=cpu python -m tests.test_torch_port_opt --batch 8 --threads 1 2 8 [--no_stage_hoist]
    """
    import time

    jm = jax_synthetic()
    jp, jb = jax_make_opt_inputs(jm, batch=batch, seed=seed)
    t0 = time.perf_counter()
    cfg = JE.OptConfig(save_mid_freq=10, collision_backend="pallas")
    jout, jres = jax.tree_util.tree_map(np.asarray, JE.optimize_batch(jm, jp, jb, JS.opt_default, cfg))
    jcoll = jres["collision_loss"]
    print(f"B={batch} seed={seed}, 4 x 301 steps; JAX {time.perf_counter() - t0:.1f}s (with compile); "
          f"port stage_hoist_decode={stage_hoist_decode}")
    print(f"  JAX final collision loss per sample {jcoll.tolist()}, mean {jcoll.mean():.6f}")
    tb = OptBatch(**{f.name: T(getattr(jb, f.name)) for f in dataclasses.fields(OptBatch)})
    for n in threads:
        torch.set_num_threads(n)
        t0 = time.perf_counter()
        out, res = optimize_batch(
            synthetic_mano_model(device="cpu"), {k: T(v) for k, v in jp.items()}, tb, opt_default,
            OptConfig(stage_hoist_decode=stage_hoist_decode),
        )
        dt = time.perf_counter() - t0
        err = np.max([np.abs(out[k].numpy() - jout[k]).reshape(batch, -1).max(1) for k in jout], axis=0)
        coll = res["collision_loss"].numpy()
        print(f"port, {n} CPU threads ({dt:.1f}s): final params max |port - JAX| per sample {err.tolist()}")
        print(f"  port final collision loss per sample {coll.tolist()}, mean {coll.mean():.6f}, "
              f"max |diff| {np.abs(coll - jcoll).max():.3e}")


if __name__ == "__main__":
    import argparse

    jax.config.update("jax_platforms", "cpu")
    ap = argparse.ArgumentParser(description="full-schedule parity of the port's OPT engine with the JAX engine")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--threads", type=int, nargs="+", default=[1])
    ap.add_argument("--no_stage_hoist", action="store_true", help="run the port's full-decode engine")
    args = ap.parse_args()
    compare_full_schedule(args.batch, args.seed, args.threads, not args.no_stage_hoist)
