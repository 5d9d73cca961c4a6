"""The plain reference against the port at tiny sizes on the CPU (the tests
import both; the reference imports nothing of the port)."""

from __future__ import annotations

import dataclasses

import pytest
import torch

import bench_helpers  # noqa: F401  (the repository's root on sys.path)
from benchmark.inputs import draws, mano_hand
from benchmark.reference import collision, mano, opt as ref_opt, resnet, train as ref_train
from benchmark.traffic.opt_batches import OPT_BATCH_KEYS

CPU = torch.device("cpu")


def port_encoder(weights, **kw):
    from ihmr_tpu_torch.models.encoder import InterHandEncoder

    enc = InterHandEncoder("resnet50", **kw)
    missing, unexpected = enc.load_state_dict(weights, strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    return enc


def test_encoder_inference_matches_the_port():
    weights = draws.encoder_weights(CPU, 5)
    images = draws.images(CPU, 5, 0, 2, 64, "uniform")
    with torch.no_grad():
        p, t = port_encoder(weights).eval()(images, resnet.mean_params(CPU))
        rp, rt = resnet.encoder(weights, images, resnet.mean_params(CPU))
    assert (p - rp).abs().max() <= 1e-5 * rp.abs().max()
    assert (t - rt).abs().max() <= 1e-6


def test_decodes_match_the_port():
    from ihmr_tpu_torch.mano.layer import two_hand_decode, two_hand_decode_mirrored
    from ihmr_tpu_torch.mano.loader import mirror_mano_model
    from ihmr_tpu_torch.mano.model import ManoModel

    hand = mano_hand.tensors(CPU)
    model = ManoModel(**hand)
    h = draws.hands(hand, 7, 0, 5)
    p = draws.init_params(h)
    rv, lv, j = two_hand_decode_mirrored(model, *(p[k] for k in ("right_orient", "left_orient", "right_pose",
                                                                "left_pose", "right_shape", "left_shape", "trans")))
    r = mano.decode_mirrored(hand, p)
    for a, b in zip((rv, lv, j), r):
        assert (a - b).abs().max() < 1e-6
    left = mirror_mano_model(model)
    ref_left = mano.mirror_model(hand)
    for k, v in ref_left.items():
        assert torch.equal(getattr(left, k), v)
    out = two_hand_decode(model, left, h["gt_pose"], h["gt_shape"], h["gt_trans"])
    for a, b in zip(out, mano.decode_two_models(hand, ref_left, h["gt_pose"], h["gt_shape"], h["gt_trans"])):
        assert (a - b).abs().max() < 1e-6


def test_collision_pieces_match_the_port():
    from ihmr_tpu_torch.ops import collision as pc
    from ihmr_tpu_torch.ops import exact_collision as pe

    hand = mano_hand.tensors(CPU)
    h = draws.hands(hand, 9, 0, 3)
    rv, lv, _ = mano.decode_mirrored(hand, draws.init_params(h))
    faces_l = hand["faces"].flip(-1)
    assert torch.equal(collision.nearest_faces(rv[:, ::2], lv, faces_l[::2]),
                       pc.nearest_face_indices(rv[:, ::2], lv, faces_l[::2]))
    assert torch.equal(collision.ray_parity(rv, lv, faces_l), pc.ray_parity_inside(rv, lv, faces_l))
    tri = lv[:, faces_l].reshape(3, -1, 9)
    depth, _, _ = collision.exact_depth(rv, tri)
    assert (depth - pe.exact_penetration_depth_with_dir(rv, tri)[0]).abs().max() < 1e-6
    idx = collision.nearest_faces(rv, lv, faces_l)
    tris = collision.gather_tris(lv, faces_l, idx)
    assert (collision.depth_single(rv, tris) - pc._depth_at_tris_single(rv, tris)).abs().max() < 1e-6


def test_train_step_matches_the_port():
    from ihmr_tpu_torch.mano.loader import mirror_mano_model
    from ihmr_tpu_torch.mano.model import ManoModel
    from ihmr_tpu_torch.train.baseline import BaselineBatch, TrainConfig, create_state, train_step

    hand = mano_hand.tensors(CPU)
    weights = draws.encoder_weights(CPU, 11)
    h = draws.hands(hand, 11, 0, 3)
    b = {k: h[k] for k in ("hand_type_array", "hand_type_valid", "joints_2d", "joints_3d", "mano_params_weight", "hand_trans")}
    b.update(gt_pose=h["gt_pose"], gt_shape=h["gt_shape"], img=draws.images(CPU, 11, 0, 3, 64, "normal"))
    ref = ref_train.run_steps(weights, [b], hand, 1e-4, {"joints_2d": 10.0, "joints_3d": 10.0, "pose": 10.0,
                                                         "shape": 10.0, "trans": 10.0, "shape_reg": 0.1})
    model = ManoModel(**hand)
    state = create_state(port_encoder(weights, bn_impl="fused"), resnet.mean_params(CPU), TrainConfig())
    batch = BaselineBatch(img=b["img"], gt_pose_params=b["gt_pose"], gt_shape_params=b["gt_shape"],
                          do_flip=torch.zeros(3, dtype=torch.int32), **{k: b[k] for k in b if k not in ("img", "gt_pose", "gt_shape")})
    _, metrics = train_step(state, batch, model, mirror_mano_model(model), TrainConfig())
    assert abs(float(metrics["total_loss"]) - ref["loss"][0]) <= 1e-6 * ref["loss"][0]
    for k, m in state.adam.m.items():
        g = ref["grad1"][k]
        assert (m / (1 - 0.9) - g).abs().max() <= 1e-4 * max(float(g.abs().max()), 1e-6), k
    for k, v in state.encoder.named_buffers():
        if "running" in k:
            assert (v - ref["running1"][k]).abs().max() <= 1e-5 * (1 + float(v.abs().max())), k


@pytest.mark.parametrize("seed", [13, 2**31 + 7])
def test_opt_schedule_and_final_pass_match_the_port(seed):
    from ihmr_tpu_torch.mano.model import ManoModel
    from ihmr_tpu_torch.refine.opt_engine import OptBatch, OptConfig, optimize_batch
    from ihmr_tpu_torch.refine.schedule import opt_default

    hand = mano_hand.tensors(CPU)
    B = 4
    h = draws.hands(hand, seed, 0, B)
    batch = OptBatch(gt_pose_params=h["gt_pose"], gt_shape_params=h["gt_shape"], **{k: h[k] for k in OPT_BATCH_KEYS})
    stages = tuple(dataclasses.replace(s, epoch=12) for s in opt_default)
    refined, results = optimize_batch(ManoModel(**hand), draws.init_params(h), batch, stages, OptConfig(save_mid_freq=10))
    config = {"stages": [{"update": list(s.update_params), "weights": dict(s.loss_weights), "lr": s.lr, "epoch": 12,
                          "filter": [list(f) for f in s.filter_loss], "select": s.select_loss} for s in stages]}
    knobs = {"save_mid_freq": 10, "loop_collision_subsample": 2, "loop_collision_face_subsample": 2, "reselect_every_blocks": 2}
    # a subset, with the whole batch's gradient scale
    rows = torch.tensor([1, 3])
    sub = draws.take(h, rows)
    ref = ref_opt.optimize(hand, draws.init_params(sub), sub, config["stages"], knobs, B)
    gap = (ref_opt.join_flat({k: v[rows] for k, v in refined.items()}) - ref_opt.join_flat(ref)).abs().max()
    assert gap < 1e-4
    from ihmr_tpu_torch.refine.schedule import OPT_DEFAULT_LOSS_WEIGHTS

    fp = ref_opt.final_pass(hand, refined, h, dict(OPT_DEFAULT_LOSS_WEIGHTS), block=3)
    assert (fp["depths"] - results["collision_loss_origin_scale"]).abs().max() < 1e-6
    assert (fp["right_verts"] - results["pred_right_hand_verts"]).abs().max() < 1e-6
    for k in ("total_loss", "joints_2d_loss", "joints_3d_loss", "hand_trans_loss"):
        assert abs(float(fp[k]) - float(results[k])) <= 1e-5 * abs(float(results[k])), k
