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

Outside Tier-1, both trackers at the study's width (``chip_smoke.py``'s
tracking phase: S=64 streams of ``make_tracker_frames``,
``streaming_strategy(30)``, ``save_mid_freq=5``), fp32 on the CPU, each on
its own state; per frame the largest final-params gap, both mean final
collisions and the streams above 2e-4 (``tests/test_ref_e2e_opt.py``'s
bound on OPT's full schedule); ``--lockstep`` names, for each such stream,
the first discrete choice where it left 5e-5 (the lockstep runner of
``tests/test_torch_port_opt_lockstep.py`` over that frame):

    JAX_PLATFORMS=cpu python -m tests.test_torch_port_tracker_jax --streams 64 --frames 9
        [--threads N] [--out FILE] [--lockstep]
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ihmr_tpu.data.synthetic import _decode as jax_decode
from ihmr_tpu.mano import synthetic_mano_model as jax_synthetic
from ihmr_tpu.refine import opt_engine as JE
from ihmr_tpu.refine import tracker as JT
from ihmr_tpu_torch.mano import synthetic_mano_model
from ihmr_tpu_torch.pipeline import TRACK_NOISE, TRACK_SPEED, make_tracker_frames
from ihmr_tpu_torch.refine import OptConfig, TwoHandTracker, streaming_strategy
from ihmr_tpu_torch.refine import tracker as TT
from tests.test_torch_port_opt import assert_trackers_agree, jax_inputs, run_trackers, torch_inputs  # noqa: F401
from tests.test_torch_port_opt_lockstep import TOL, _gap, lockstep_stages
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


BOUND = 2e-4  # final params: tests/test_ref_e2e_opt.py's bound on OPT's full schedule


def compare_study(streams: int, frames: int, seed: int = 0, steps: int = 30, log=print):
    """Both trackers, each on its own state, over ``make_tracker_frames(streams,
    frames, seed)`` with ``streaming_strategy(steps)`` and ``save_mid_freq=5``
    (JAX's final collision on the exact kernel, interpreted), fp32 on the CPU,
    every frame blending its detection as ``pipeline.run_tracker`` does ->
    (a report dict: per frame the largest final-params gap, both mean final
    collisions and the streams above BOUND; per stream the first frame above
    BOUND and above the lockstep runner's TOL; per frame both warm starts
    and both batches, for ``explain_streams``). The detections and batches
    are the port's arrays, given to JAX as they are."""
    jm, tm = jax_synthetic(), synthetic_mano_model(device="cpu")
    jtracker = JT.TwoHandTracker(jm, strategy=JT.streaming_strategy(steps),
                                 config=JE.OptConfig(save_mid_freq=5, collision_backend="pallas"))
    tracker = TwoHandTracker(tm, strategy=streaming_strategy(steps), config=OptConfig(save_mid_freq=5))
    jstate = state = None
    per_frame, first_over, first_over_tol, replay = [], {}, {}, []
    seconds = {"jax": 0.0, "port": 0.0}
    for f, (tp, tb) in enumerate(make_tracker_frames(tm, streams=streams, frames=frames, seed=seed)):
        jp = {k: jnp.asarray(v.numpy()) for k, v in tp.items()}
        jb = JE.OptBatch(**{fl.name: jnp.asarray(getattr(tb, fl.name).numpy())
                            for fl in dataclasses.fields(JE.OptBatch)})
        if f == 0:
            # committed like every later frame's warm start, so that all frames share one compile
            jstate, state = jtracker.init(jax.device_put(jp, jax.devices()[0])), tracker.init(tp)
        b = jtracker.blend  # each side's warm start, computed as its step computes it
        with torch.no_grad():
            replay.append(({k: np.asarray((1.0 - b) * jstate.params[k] + b * jp[k]) for k in jp},
                           {k: ((1.0 - b) * state.params[k] + b * tp[k]).numpy() for k in tp}, jb, tb))
        t0 = time.perf_counter()
        jstate, jres = jtracker.step(jstate, jb, jp)
        jparams = jax.tree_util.tree_map(np.asarray, jstate.params)
        jcoll = np.asarray(jres["collision_loss"])
        t1 = time.perf_counter()
        state, res = tracker.step(state, tb, tp)
        params = {k: v.numpy() for k, v in state.params.items()}
        coll = res["collision_loss"].numpy()
        t2 = time.perf_counter()
        seconds["jax"] += t1 - t0
        seconds["port"] += t2 - t1
        gaps = _gap(jparams, params, list(params))
        ema_gap = float(_gap(jax.tree_util.tree_map(np.asarray, jstate.ema_params),
                             {k: v.numpy() for k, v in state.ema_params.items()}, list(params)).max())
        over = {int(s): float(gaps[s]) for s in np.nonzero(gaps > BOUND)[0]}
        for s in over:
            first_over.setdefault(s, f)
        for s in np.nonzero(gaps > TOL)[0]:
            first_over_tol.setdefault(int(s), f)
        row = dict(frame=f, max_gap=float(gaps.max()), median_gap=float(np.median(gaps)), ema_max_gap=ema_gap,
                   collision_jax=float(jcoll.mean()), collision_port=float(coll.mean()),
                   collision_max_rel_gap=float(np.max(np.abs(coll - jcoll) / np.maximum(np.abs(jcoll), 1e-6))),
                   streams_over_bound=over, seconds_jax=t1 - t0, seconds_port=t2 - t1)
        per_frame.append(row)
        log(f"frame {f}: largest params gap {row['max_gap']:.3e} (median {row['median_gap']:.3e}, EMA "
            f"{ema_gap:.3e}); mean final collision JAX {row['collision_jax']:.6f} port {row['collision_port']:.6f}; "
            f"streams above {BOUND:g}: {({s: float(f'{g:.3e}') for s, g in over.items()}) or 'none'}; "
            f"JAX {t1 - t0:.1f} s, port {t2 - t1:.1f} s", flush=True)
    assert state.frame_idx == int(jstate.frame_idx) == frames
    return dict(streams=streams, frames=frames, seed=seed, steps_per_stage=steps, bound=BOUND,
                max_gap=max(r["max_gap"] for r in per_frame),
                streams_over_bound_at_end=len(per_frame[-1]["streams_over_bound"]),
                streams_ever_over_bound=len(first_over), first_frame_over_bound=first_over,
                first_frame_over_tol=first_over_tol, seconds=seconds, per_frame=per_frame), replay


def explain_streams(report, replay, steps: int = 30, log=print):
    """For every stream above BOUND: the lockstep runner
    (``tests/test_torch_port_opt_lockstep.py``) over the frame where it first
    left TOL, each side from its own warm start through its own stages, as
    its tracker ran that frame -> {stream: the first stage where it leaves
    TOL there, its verdict and first differing choice}."""
    jm, tm = jax_synthetic(), synthetic_mano_model(device="cpu")
    over = sorted(report["first_frame_over_bound"])
    frames = sorted({report["first_frame_over_tol"][s] for s in over})
    out = {}
    for f in frames:
        jwarm, twarm, jb, tb = replay[f]
        log(f"lockstep, frame {f}:", flush=True)
        stages = lockstep_stages(jm, tm, jwarm, jb, tb, JT.streaming_strategy(steps), save_mid_freq=5,
                                 port_entry=twarm)
        for s in (s for s in over if report["first_frame_over_tol"][s] == f):
            hits = [(r["stage"], x) for r in stages for x in r["samples"] if x["sample"] == s]
            stage, x = hits[0]
            out[s] = dict(frame=f, stage=stage, verdict=x["verdict"], first_choice=x["first_choice"],
                          first_eval_over_tol=x["first_eval_over_tol"], end_gap=x["end_gap"],
                          drift_grad_gap=x["drift_grad_gap"])
    return out


if __name__ == "__main__":
    import argparse
    import json

    jax.config.update("jax_platforms", "cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--streams", type=int, default=64)
    ap.add_argument("--frames", type=int, default=9)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--threads", type=int, default=None, help="torch CPU threads")
    ap.add_argument("--out", default=None, help="write the report as JSON here")
    ap.add_argument("--lockstep", action="store_true",
                    help="name each stream's first differing choice with the lockstep runner")
    args = ap.parse_args()
    if args.threads:
        torch.set_num_threads(args.threads)

    def save(report):
        if args.out:
            with open(args.out, "w") as fh:
                json.dump(report, fh, indent=1)

    report, replay = compare_study(args.streams, args.frames, args.seed)
    save(report)  # kept should the lockstep fail
    if args.lockstep:
        report["explained"] = explain_streams(report, replay)
        kinds = [e["first_choice"]["kind"] if e["first_choice"] else e["verdict"] for e in report["explained"].values()]
        report["explained_kinds"] = {k: kinds.count(k) for k in sorted(set(kinds))}
        save(report)
    print(json.dumps({k: v for k, v in report.items() if k != "per_frame"}), flush=True)
