"""The OPT engine as the JAX package ships it: the stage-hoisted decode.

Payloads: each of the port's stage-hoist payload pairs (identity orient,
pose, shape affine; and the trans/cam stage's forward, which decodes once)
against JAX's jitted function on the same B=2 inputs, evaluated at params
far from those the payload was built at. Bounds are the JAX package's own
between its hoisted forwards and its full decode
(tests/test_opt_engine.py::TestStageHoist): trans 2e-6, orient 5e-6, shape
2e-5, pose 5e-6 absolute.

Stage forwards: for every stage of ``opt_default`` and ``opt_with_cam``,
``_make_stage_forward`` against the port's full ``forward`` at the same
bounds, on the forward and on the gradients of the stage's in-loop loss
with respect to its groups (the bound taken relative to the largest
gradient entry when that exceeds 1); a stage that updates a shaping group
with orient gets no hoist (None), as in JAX.

Engines: the port's hoisted engine against its full decode at B=2 over
4 x 21 steps with ``save_mid_freq=10``, for Adam and SGD: final params
within 5e-5, the JAX package's bound between its engines
(tests/test_opt_engine.py:577,606,631). For Adam the full decode is
``stage_hoist_decode=False``; SGD without the hoist, and a strategy whose
stages differ in epoch or losses (``opt_with_cam``), select the JAX
package's per-stage programs, which the port does not have and refuses, so
there the full decode is the same engine with every stage forward taken
away (``_make_stage_forward`` returning None).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ihmr_tpu.data.synthetic import make_opt_inputs as jax_make_opt_inputs
from ihmr_tpu.mano import layer as JL
from ihmr_tpu.mano.loader import synthetic_mano_model as jax_synthetic
from ihmr_tpu.refine import opt_engine as JE
from ihmr_tpu.refine import schedule as JS
from ihmr_tpu_torch.mano import layer as TL
from ihmr_tpu_torch.mano import synthetic_mano_model
from ihmr_tpu_torch.refine import OptBatch, OptConfig, compute_losses, forward, opt_default, opt_with_cam, optimize_batch
from ihmr_tpu_torch.refine import opt_engine as TE
from tests.torch_threads import one_torch_thread  # noqa: F401

B = 2
BOUND = dict(trans=2e-6, orient=5e-6, pose=5e-6, shape=2e-5)
OUTPUTS = ("rv", "lv", "j3d", "j2d")


def T(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module")
def inputs():
    jm = jax_synthetic()
    jp, jb = jax_make_opt_inputs(jm, batch=B, seed=0)
    tb = OptBatch(**{f.name: T(getattr(jb, f.name)) for f in dataclasses.fields(OptBatch)})
    tp = {k: T(v) for k, v in jp.items()}
    return jm, {k: np.asarray(v) for k, v in jp.items()}, synthetic_mano_model(device="cpu"), tp, tb


def _far(params, kind):
    """Params far from ``params`` in the groups a ``kind`` stage updates
    (the perturbations of the JAX package's hoist tests)."""
    p = dict(params)
    if kind == "trans":
        rng = np.random.RandomState(3)
        p["trans"] = params["trans"] + rng.randn(*params["trans"].shape).astype(np.float32) * np.float32(0.05)
        p["cam"] = params["cam"] * np.float32(1.1)
    elif kind == "orient":
        rng = np.random.RandomState(4)
        for k in ("right_orient", "left_orient"):
            p[k] = params[k] + rng.randn(*params[k].shape).astype(np.float32)
        p["trans"] = params["trans"] * np.float32(0.7)
    elif kind == "shape":
        rng = np.random.RandomState(5)
        for k in ("right_shape", "left_shape"):
            p[k] = params[k] + rng.randn(*params[k].shape).astype(np.float32) * np.float32(1.5)
        p["trans"] = params["trans"] * np.float32(1.3)
    else:
        rng = np.random.RandomState(6)
        for k in ("right_pose", "left_pose"):
            p[k] = params[k] + rng.randn(*params[k].shape).astype(np.float32) * np.float32(0.5)
    return p


def _jax_payload_decode(jm, kind):
    """JAX's payload pair for ``kind`` as one jitted (entry params, far
    params) -> (rv, lv, joints)."""

    def run(pe, p):
        if kind == "trans":
            stage = JS.opt_default[0]
            return JE._make_stage_forward(jm, stage, pe)(p)[:3]
        if kind == "orient":
            payload = JL.two_hand_identity_orient_payload(
                jm, pe["right_pose"], pe["left_pose"], pe["right_shape"], pe["left_shape"]
            )
            return JL.two_hand_decode_from_identity(*payload, p["right_orient"], p["left_orient"], p["trans"])
        if kind == "pose":
            payload = JL.two_hand_pose_payload(
                jm, pe["right_orient"], pe["left_orient"], pe["right_shape"], pe["left_shape"]
            )
            return JL.two_hand_decode_from_pose_payload(jm, payload, p["right_pose"], p["left_pose"], p["trans"])
        base, basis = JL.two_hand_shape_affine_payload(
            jm, pe["right_orient"], pe["left_orient"], pe["right_pose"], pe["left_pose"],
            pe["right_shape"], pe["left_shape"],
        )
        return JL.two_hand_decode_from_shape_affine(
            base, basis, pe["right_shape"], pe["left_shape"], p["right_shape"], p["left_shape"], p["trans"]
        )

    return jax.jit(run)


def _torch_payload_decode(tm, kind, pe, p):
    if kind == "trans":
        return TE._make_stage_forward(tm, opt_default[0], pe)(p)[:3]
    if kind == "orient":
        payload = TL.two_hand_identity_orient_payload(
            tm, pe["right_pose"], pe["left_pose"], pe["right_shape"], pe["left_shape"]
        )
        return TL.two_hand_decode_from_identity(*payload, p["right_orient"], p["left_orient"], p["trans"])
    if kind == "pose":
        payload = TL.two_hand_pose_payload(
            tm, pe["right_orient"], pe["left_orient"], pe["right_shape"], pe["left_shape"]
        )
        return TL.two_hand_decode_from_pose_payload(tm, payload, p["right_pose"], p["left_pose"], p["trans"])
    base, basis = TL.two_hand_shape_affine_payload(
        tm, pe["right_orient"], pe["left_orient"], pe["right_pose"], pe["left_pose"], pe["right_shape"], pe["left_shape"]
    )
    return TL.two_hand_decode_from_shape_affine(
        base, basis, pe["right_shape"], pe["left_shape"], p["right_shape"], p["left_shape"], p["trans"]
    )


@pytest.mark.parametrize("kind", ["trans", "orient", "pose", "shape"])
def test_payload_matches_jax(inputs, kind):
    jm, jp, tm, tp, _ = inputs
    far = _far(jp, kind)
    jarr = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    want = _jax_payload_decode(jm, kind)(jarr(jp), jarr(far))
    with torch.no_grad():
        got = _torch_payload_decode(tm, kind, tp, {k: T(v) for k, v in far.items()})
    for g, w, name in zip(got, want, OUTPUTS):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=BOUND[kind], err_msg=name)


def _kind(stage):
    up = set(stage.update_params)
    if up <= {"trans", "cam"}:
        return "trans"
    for kind in ("orient", "shape", "pose"):
        if up <= {f"right_{kind}", f"left_{kind}", "trans", "cam"}:
            return kind
    return None


STAGES = {"+".join(s.update_params): s for s in opt_default + opt_with_cam}


@pytest.mark.parametrize("name", sorted(STAGES))
def test_stage_forward_matches_full_decode(inputs, name):
    """Forward and in-loop gradients of the hoisted stage forward against
    the full decode, at params far from the stage's entry params."""
    _, jp, tm, tp, tb = inputs
    stage = STAGES[name]
    kind = _kind(stage)
    fwd = TE._make_stage_forward(tm, stage, tp)
    assert fwd is not None
    far = {k: T(v) for k, v in _far(jp, kind).items()}
    with torch.no_grad():
        for g, w, out in zip(fwd(far), forward(tm, far), OUTPUTS):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=BOUND[kind], err_msg=out)

    config = OptConfig()
    payload = TE._lazy_coll_payload(tm, far, config)[0]

    def grads(fwd_fn):
        leaves = {k: far[k].clone().requires_grad_(True) for k in stage.update_params}
        total, _ = compute_losses(
            tm, {**far, **leaves}, tb, stage.weights, config, in_loop=True, coll_tris=payload, fwd_fn=fwd_fn
        )
        return dict(zip(leaves, torch.autograd.grad(total, list(leaves.values()))))

    got, want = grads(fwd), grads(None)
    for k in stage.update_params:
        scale = max(1.0, float(want[k].abs().max()))
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=BOUND[kind] * scale, err_msg=k)


def test_stage_forward_is_none_without_a_hoist(inputs):
    _, _, tm, tp, _ = inputs
    base = opt_default[0]
    for groups in (("right_orient", "right_shape"), ("left_orient", "left_pose"), ("right_pose", "left_shape")):
        stage = dataclasses.replace(base, update_params=groups)
        assert TE._make_stage_forward(tm, stage, tp) is None
        assert JE._make_stage_forward(None, JS.Stage(**dataclasses.asdict(stage)), None) is None


def _gap(a, b):
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def _full_decode(monkeypatch, run):
    """``run()`` with every stage forward taken away: the hoisted engine's
    own blocks on the full decode."""
    with monkeypatch.context() as m:
        m.setattr(TE, "_make_stage_forward", lambda *args: None)
        return run()


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_hoisted_engine_matches_full_decode(inputs, optimizer, monkeypatch):
    _, _, tm, tp, tb = inputs
    strategy = tuple(dataclasses.replace(s, epoch=20) for s in opt_default)
    config = OptConfig(save_mid_freq=10, optimizer=optimizer)
    p_h, r_h = optimize_batch(tm, tp, tb, strategy, config)
    if optimizer == "adam":
        p_f, r_f = optimize_batch(tm, tp, tb, strategy, dataclasses.replace(config, stage_hoist_decode=False))
    else:
        p_f, r_f = _full_decode(monkeypatch, lambda: optimize_batch(tm, tp, tb, strategy, config))
    assert _gap(p_h, p_f) <= 5e-5
    assert _gap(p_h, tp) > 1e-3  # the engines moved the params
    np.testing.assert_allclose(r_h["collision_loss"].numpy(), r_f["collision_loss"].numpy(), rtol=1e-3, atol=1e-6)


def test_opt_with_cam_runs_hoisted(inputs, monkeypatch):
    """The 100-step cam stage of opt_with_cam (cut to 4 epochs here) runs
    with the decode hoisted, and matches the full decode. Its stages differ
    in their losses, so without the hoist the JAX package runs per-stage
    programs, and so does the port (``run_stage_program``; held to JAX in
    tests/test_torch_port_programs_cam.py)."""
    _, _, tm, tp, tb = inputs
    strategy = tuple(dataclasses.replace(s, epoch=4) for s in opt_with_cam)
    assert TE._make_stage_forward(tm, strategy[-1], tp) is not None
    config = OptConfig(save_mid_freq=2)
    p_h, _ = optimize_batch(tm, tp, tb, strategy, config)
    p_f, _ = _full_decode(monkeypatch, lambda: optimize_batch(tm, tp, tb, strategy, config))
    calls, program = [], TE.run_stage_program
    with monkeypatch.context() as m:
        m.setattr(TE, "run_stage_program", lambda *a: calls.append(a[3]) or program(*a))
        p_p, _ = optimize_batch(tm, tp, tb, strategy, dataclasses.replace(config, stage_hoist_decode=False))
    assert calls == list(strategy)
    assert all(bool(torch.isfinite(v).all()) for v in p_p.values()) and not torch.allclose(p_p["cam"], tp["cam"])
    assert all(bool(torch.isfinite(v).all()) for v in p_h.values())
    assert not torch.allclose(p_h["cam"], tp["cam"])
    assert _gap(p_h, p_f) <= 5e-5
