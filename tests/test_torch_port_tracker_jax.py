"""The streaming tracker at its own defaults against the JAX package's:
``TwoHandTracker`` with ``OptConfig(save_mid_freq=5)`` (JAX's with
``collision_backend="pallas"``, the exact kernel in interpret mode, for
the final metric), ``streaming_strategy(6)``: 7 steps a stage, one
snapshot block of 5 steps and a 2-step tail block with its own payload,
the shape of the default 31-step stages (6 blocks, 3 superblocks and a
1-step tail). 3 frames at B=2 (``make_opt_inputs`` seeds 0, 1, 2; frames 2
and 3 blend their detection in), the bounds of
``tests/test_torch_port_opt.py``: refined params, EMA and smoothed output
2e-4, final collision 1e-3 relative, ``frame_idx`` equal. In a file of its
own: the JAX engine compiles this schedule for ~60 s on one CPU core.

``pipeline.make_tracker_frames`` (the frames ``chip_smoke.py`` tracks)
against ``scripts/tracker_study.py``'s draws, its ``batch_and_init`` and
random walk written out here on the JAX package's decode: the detections
equal, the ground-truth and init joints within 1e-5 (the decode's
rounding), at 3 streams over 4 frames.
"""

import jax
import jax.numpy as jnp
import numpy as np

from ihmr_tpu.data.synthetic import _decode as jax_decode
from ihmr_tpu.mano import synthetic_mano_model as jax_synthetic
from ihmr_tpu.refine import opt_engine as JE
from ihmr_tpu.refine import tracker as JT
from ihmr_tpu_torch.mano import synthetic_mano_model
from ihmr_tpu_torch.pipeline import TRACK_NOISE, TRACK_SPEED, make_tracker_frames
from ihmr_tpu_torch.refine import OptConfig, TwoHandTracker, streaming_strategy
from ihmr_tpu_torch.refine import tracker as TT
from tests.test_torch_port_opt import assert_trackers_agree, jax_inputs, run_trackers, torch_inputs  # noqa: F401
from tests.torch_threads import one_torch_thread  # noqa: F401


def test_tracker_defaults_match_jax():
    ours, ref = TT.TwoHandTracker.__init__.__defaults__, JT.TwoHandTracker.__init__.__defaults__
    assert ours[0] is ref[0] is None and ours[2:] == ref[2:] == (0.5, 0.25)
    assert ours[1] == OptConfig(save_mid_freq=5) and ref[1] == JE.OptConfig(save_mid_freq=5)
    assert streaming_strategy() == TT.streaming_strategy(30)
    assert [(s.update_params, s.epoch) for s in streaming_strategy(6)] == [
        (s.update_params, s.epoch) for s in JT.streaming_strategy(6)]


def test_tracker_default_schedule_matches_jax(jax_inputs, torch_inputs):
    jm = jax_inputs[0]
    jtracker = JT.TwoHandTracker(jm, strategy=JT.streaming_strategy(6),
                                 config=JE.OptConfig(save_mid_freq=5, collision_backend="pallas"))
    tracker = TwoHandTracker(torch_inputs[0], strategy=streaming_strategy(6))
    assert_trackers_agree(*run_trackers(jtracker, tracker, jm, (0, 1, 2)))


def _study_frames(S, frames, seed=0, speed=TRACK_SPEED, noise=TRACK_NOISE):
    """scripts/tracker_study.py's motion and batch_and_init, as it draws them
    -> per frame (detection params, gt joints 3D, gt joints 2D, init joints
    3D, init joints 2D), numpy."""
    model = jax_synthetic()
    rng = np.random.RandomState(1000 * seed + 17)
    pose = (rng.randn(S, 96) * 0.2).astype(np.float32)
    shape = (rng.randn(S, 20) * 0.5).astype(np.float32)
    cam = np.tile(np.array([[5.0, 0.0, 0.0]], np.float32), (S, 1))
    trans = (rng.randn(S, 3) * 0.02).astype(np.float32)
    vel = np.zeros((S, 96), np.float32)
    velt = np.zeros((S, 3), np.float32)
    out = []
    for _ in range(frames):
        vel = 0.9 * vel + rng.randn(S, 96).astype(np.float32)
        velt = 0.9 * velt + rng.randn(S, 3).astype(np.float32)
        pose = pose + speed * vel * 0.1
        trans = trans + speed * velt * 0.01
        _, _, j3, j2 = jax_decode(model, jnp.asarray(pose), jnp.asarray(shape), jnp.asarray(trans), jnp.asarray(cam))
        det_pose = pose + rng.randn(S, 96).astype(np.float32) * noise
        det_shape = shape + rng.randn(S, 20).astype(np.float32) * noise
        det_trans = trans + rng.randn(S, 3).astype(np.float32) * noise * 0.2
        kp = noise * 0.02
        init_j3 = j3 + rng.randn(*j3.shape).astype(np.float32) * kp
        init_j2 = j2 + rng.randn(*j2.shape).astype(np.float32) * kp
        det = JE.params_from_init(cam, det_pose, det_shape, det_trans)
        out.append((jax.tree_util.tree_map(np.asarray, det), *map(np.asarray, (j3, j2, init_j3, init_j2))))
    return out


def test_tracker_frames_are_the_studys():
    ours = make_tracker_frames(synthetic_mano_model(device="cpu"), streams=3, frames=4)
    for (params, batch), (det, j3, j2, init_j3, init_j2) in zip(ours, _study_frames(3, 4)):
        assert set(params) == set(det)
        for k in det:
            np.testing.assert_array_equal(params[k].numpy(), det[k], err_msg=k)
        for got, ref in ((batch.joints_3d, j3), (batch.joints_2d, j2), (batch.init_joints_3d, init_j3),
                         (batch.init_joints_2d, init_j2)):
            np.testing.assert_allclose(got[..., :-1].numpy(), ref, rtol=0, atol=1e-5)
