"""The operation and byte counts against hand counts at small shapes."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

import bench_helpers  # noqa: F401  (the repository's root on sys.path)
from benchmark.counts import exact_collision, mano as mano_counts, resnet as resnet_counts
from benchmark.inputs import draws, mano_hand
from benchmark.reference import collision, mano, resnet


def test_resnet_forward_flops_match_torch_counter():
    weights = draws.encoder_weights(torch.device("cpu"), 3)
    images = torch.rand(2, 64, 64, 3)
    with FlopCounterMode(display=False) as counter:
        resnet.encoder(weights, images, resnet.mean_params("cpu"))
    assert counter.get_total_flops() == 2 * resnet_counts.forward_flops(64)
    assert resnet_counts.train_flops(64) == 3 * resnet_counts.forward_flops(64)


def test_resnet50_at_224_is_the_published_size():
    convs, bns = resnet_counts.layers(224)
    assert len(convs) == 53 and len(bns) == 53
    conv_macs = sum(ci * co * k * k * s * s for ci, co, k, s in convs)
    assert 4.08e9 < conv_macs < 4.12e9  # ResNet-50 v1.5: ~4.1 GMAC per 224x224 image


def test_bn_input_bytes_match_the_reference_forward(monkeypatch):
    seen = []
    real = resnet._bn

    def spy(x, *args):
        seen.append(x.numel())
        return real(x, *args)

    monkeypatch.setattr(resnet, "_bn", spy)
    weights = draws.encoder_weights(torch.device("cpu"), 4)
    resnet.backbone(weights, torch.rand(3, 64, 64, 3), train=True, stats={})
    assert len(seen) == 53
    assert 4 * sum(seen) == resnet_counts.bn_input_bytes(3, 64)


def test_decode_flops_by_hand():
    hand = mano_hand.tensors("cpu")
    z = torch.zeros(1, 3)
    with FlopCounterMode(display=False) as counter:
        mano.decode(hand, z, torch.zeros(1, 45), torch.zeros(1, 10))
    # the counter sees every product but the final per-vertex apply (778 x 9, element-wise here)
    assert counter.get_total_flops() == mano_counts.decode_flops() - 2 * 778 * 9
    macs = 23340 + 315090 + 37344 + 540 + 144 + 149376 + 7002
    assert mano_counts.decode_flops() == 2 * macs


def test_opt_batch_work_by_hand():
    stage = {"epoch": 20}
    knobs = {"save_mid_freq": 10, "reselect_every_blocks": 2, "loop_collision_subsample": 2,
             "loop_collision_face_subsample": 2}
    work = mano_counts.opt_batch_flops(8, [stage, stage], knobs, k1_pairs=1000)
    d = mano_counts.decode_flops()
    # 2 stages x 21 steps; 3 blocks a stage (10, 10, 1) -> 2 payloads a stage
    assert work["steps"] == 42 * 3 * (16 * d + 16 * 389 * 78)
    assert work["rebuilds"] == 4 * (16 * d + 8 * 16 * 389 * 769)
    assert work["final"] == 16 * d + 1000 * 78 + 20 * 16 * 778 * 1538


def test_k1_pairs_needed_by_brute_force():
    g = torch.Generator().manual_seed(0)
    n, v, f = 2, 300, 260
    centres = torch.tensor([[0.0, 0, 0], [3, 3, 3], [3, 0, 0]]).repeat_interleave(128, 0)
    q = torch.rand(n, v, 3, generator=g) * 0.6 + centres[:v]  # each query block near one tile of triangles
    tri = torch.rand(n, f, 9, generator=g) * 0.5 + centres[:f].repeat(1, 3)
    _, best, _ = collision.exact_depth(q, tri)
    expect = 0
    for i in range(n):
        for b in range(0, v, 128):
            for t in range(0, f, 128):
                tv = torch.cat([tri[i, t:t + 128], tri[i, :1].expand(128 - tri[i, t:t + 128].shape[0], 9)]).reshape(-1, 3)
                centre = (tv.amin(0) + tv.amax(0)) / 2
                radius = (tv - centre).norm(dim=-1).max()
                lb = torch.clamp((q[i, b:b + 128] - centre).norm(dim=-1) - radius, min=0)
                if bool((best[i, b:b + 128] >= lb * lb).any()):
                    expect += q[i, b:b + 128].shape[0] * tri[i, t:t + 128].shape[0]
    got = exact_collision.pairs_needed(q, tri, best)
    assert got == expect and 0 < got < n * v * f
    assert exact_collision.bytes_moved(n, v, f) == 4 * (n * v * 3 + n * f * 9 + n * v * 4)
