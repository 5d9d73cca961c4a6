"""Tests of the port that need an NVIDIA card (the hand-written kernels have
no CPU mode). They skip without one. This file imports nothing of JAX, so it
also runs where JAX is not installed; on the GPU machine:

    python3 -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances: depths 1e-5 absolute, directions 1e-4 where both sides are
inside, inside signs equal on >= 99.9% of queries (the same fp32 arithmetic
as the plain version, tie-set sums in another order); on the adversarial
cases of ``ihmr_tpu_torch.kernel_cases`` depths equal; nearest-centroid
indices 100% equal (the same rank arithmetic and tie rules, no sums that
depend on order); a short refinement on the card and on the CPU within
2e-4 (the slice test's bound); a short MLP training on both within
``pipeline.SHORT_MLP_TOL`` (trained weights 1e-5, residuals 2e-6), accept
masks equal; the BatchNorm-statistics kernel against a float64 sum (sum x
within 1e-5 of sum |x|, sum x^2 within 1e-5 relative; fp32 accumulation in
another order) and its backward against the closed form (1e-6 relative); a
short training on the card and on the CPU within
``pipeline.SHORT_TRAIN_TOL``; the stage-hoisted OPT engine against the full
decode on the card within 5e-5 over 4 x 21 steps (the JAX package's bound
between its engines), one exact-collision launch per ``optimize_batch``
with either; a short ``optimize_loop`` on the card and on the CPU with
every metric within ``pipeline.SHORT_EVAL_RTOL`` = 1e-3 relative. That
bound follows from the short refinement's: params within 2e-4 move joints
by at most ~0.1 x that against joint errors of ~1e-2 (mpjpe_3d,
inter_mpjpe_3d), the depths by less than the collision losses' 1e-3
(collision_ave, collision_max), and one depth crossing one of
collision_auc's thresholds moves it by 1/(2 x 1556 x 49) ~ 7e-6.

Serving and tracking: the predict function (ResNet-18 64x64, B=4) on the
card against the CPU, fp32 within ``pipeline.PREDICT_TOL`` and bf16 within
the band (``pipeline.BF16_BAND``: max |card bf16 - CPU bf16| at most 2x max
|CPU bf16 - CPU fp32|), every backbone layer's input bf16 in the bf16
encoder and the bf16 outputs apart from the fp32 ones, with no kernel
launched; a tracker step launches K1 exactly once (K2, K3 never), and 2
frames of ``streaming_strategy(6)`` then one at the tracker's default
schedule, at B=2, on the card and on the CPU agree within 2e-4 (the
tracker parity test's bound); a bf16 train step of ResNet-50 launches K3 53 times, each
on a bf16 activation, in the warm-up run of its graph and in its capture.

The in-loop collision paths: JAX's per-stage SGD programs, the two-pass
escalation, the grid and the 2-level hierarchy in the loop
(``pipeline.run_short_collision_paths``)
on the card and on the CPU within ``pipeline.SHORT_COLLISION_TOL`` (params
2e-4, final collision 1e-3 relative, escalation masks equal); the grid
build chunked into many calls gives the unchunked bits on the card; a
gradient step with K1 in the loop launches K1 once, and its gradient
matches the same step on the CPU (the plain version) within 1e-5 of the
largest entry. On the same vertices, the 2-level hierarchy's selections on
the card equal the CPU's (the same bf16 rank arithmetic, the first least
index), its depths within 1e-5, and the merged payload builder's triangles
bit for bit. (The decode itself differs by ~4e-8 between the devices.)
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from ihmr_tpu_torch import kernel_cases, profiling, resolve_device
from ihmr_tpu_torch.data import make_mlp_inputs, make_opt_inputs
from ihmr_tpu_torch.device import set_fp32_matmul_precision
from ihmr_tpu_torch.mano import synthetic_mano_model
from ihmr_tpu_torch.ops import bn_stats as K3
from ihmr_tpu_torch.ops import exact_collision as K
from ihmr_tpu_torch.ops import nearest_centroid as NC
from ihmr_tpu_torch.ops.collision import _centroids
from ihmr_tpu_torch.pipeline import (
    BF16_BAND,
    PREDICT_TOL,
    SHORT_EVAL_RTOL,
    SHORT_MLP_TOL,
    SHORT_TRAIN_TOL,
    allclose_ratio,
    bf16_band_ratios,
    make_train_bench_inputs,
    run_short_collision_paths,
    run_short_mlp,
    run_short_opt_eval,
    run_short_predict,
    run_short_tracker,
    run_short_train,
    short_collision_gaps,
    short_eval_gaps,
    short_mlp_gaps,
    short_tracker_gap,
    short_train_gaps,
)
from ihmr_tpu_torch.refine import OptConfig, TwoHandTracker, forward, opt_default, optimize_batch, streaming_strategy
from ihmr_tpu_torch.refine.mlp_engine import seed_from_backbone
from ihmr_tpu_torch.timing import device_kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the port's kernels have no CPU mode)")
    set_fp32_matmul_precision()
    return torch.device("cuda")


def _hand_pairs(device, batch=4):
    mano = synthetic_mano_model(device=device)
    params, _ = make_opt_inputs(mano, batch=batch, seed=0)
    with torch.no_grad():
        rv, lv, _, _ = forward(mano, params)
    fl = mano.faces.flip(-1)
    q = torch.cat([rv, lv])
    tri = torch.cat([lv[:, fl].reshape(batch, -1, 9), rv[:, mano.faces].reshape(batch, -1, 9)])
    return q, tri


_counts_at_zero = {}


def _zero_counts():
    """Take every kernel's launches as 0 from here."""
    _counts_at_zero.clear()
    _counts_at_zero.update(profiling.counters())


def launches(kernel: str) -> int:
    """The launches of ``kernel`` ("k1", "k2" or "k3") since ``_zero_counts()``."""
    name = kernel + ".launches"
    return profiling.counters().get(name, 0) - _counts_at_zero.get(name, 0)


def test_default_device_is_cuda(cuda):
    assert resolve_device().type == "cuda"
    assert synthetic_mano_model().device.type == "cuda"


def test_kernel_matches_plain_version(cuda):
    q, tri = _hand_pairs(cuda)
    qp, tp, bounds = K.pad_inputs(q, tri)
    _zero_counts()
    depth, dirs = K._launch_kernel(qp, tp, bounds, tri.shape[1])
    torch.cuda.synchronize()
    assert launches("k1") == 1
    ref, ref_dirs, _ = K.exact_penetration_depth_reference(qp, tp, bounds, tri.shape[1])
    assert float((depth - ref).abs().max()) <= 1e-5
    assert float(((depth > 0) == (ref > 0)).float().mean()) >= 0.999
    both = (depth > 0) & (ref > 0)
    assert bool(both.any())
    assert float((dirs - ref_dirs)[both].abs().max()) <= 1e-4


EXACT_CASES = [case[0] for case in kernel_cases.exact_cases("cpu")]
NEAREST_CASES = [case[0] for case in kernel_cases.nearest_cases("cpu")]


@pytest.mark.parametrize("label", EXACT_CASES)
def test_kernel_matches_plain_version_on_adversarial_cases(cuda, label):
    q, tri = next(case[1:] for case in kernel_cases.exact_cases(cuda) if case[0] == label)
    qp, tp, bounds = K.pad_inputs(q, tri)
    _zero_counts()
    depth, dirs = K._launch_kernel(qp, tp, bounds, tri.shape[1])
    torch.cuda.synchronize()
    assert launches("k1") == 1
    ref, ref_dirs, evaluated = K.exact_penetration_depth_reference(qp, tp, bounds, tri.shape[1])
    assert torch.equal(depth, ref)  # the same best d2, so the same depths and inside signs
    gap = (dirs - ref_dirs)[(depth > 0) & (ref > 0)].abs()
    assert gap.numel() == 0 or float(gap.max()) <= 1e-4
    if label == "pruned after the first tile":
        assert not bool(evaluated[:, :, 1:].any())


def test_kernel_division_rounds_as_ieee(cuda):
    num, den = kernel_cases.division_operands(cuda)
    ours, ref = K.kernel_divide(num, den), K._safe_div(num, den)
    assert torch.equal(ours.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("label", NEAREST_CASES)
def test_nearest_kernel_matches_plain_version_on_adversarial_cases(cuda, label):
    q, cent, picks = next(case[1:] for case in kernel_cases.nearest_cases(cuda) if case[0] == label)
    qp, cp = NC.pad_inputs(q, cent)
    _zero_counts()
    idx = NC._launch_kernel(qp, cp, cent.shape[1])
    torch.cuda.synchronize()
    assert launches("k2") == 1
    assert torch.equal(idx, NC.nearest_centroid_reference(qp, cp, cent.shape[1]))
    for n, pick in enumerate(picks or ()):
        assert bool((idx[n, : q.shape[1]] == pick).all()), (n, idx[n, : q.shape[1]].tolist())


def test_wrapper_gradient_matches_cpu(cuda):
    q, tri = _hand_pairs(cuda, batch=2)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        x = q.to(dev).clone().requires_grad_(True)
        (K.exact_penetration_depth(x, tri.to(dev)) ** 2).sum().backward()
        grads.append(x.grad.cpu())
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(), atol=1e-5)


def test_short_refinement_matches_cpu(cuda):
    strategy = tuple(dataclasses.replace(s, epoch=20) for s in opt_default)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        mano = synthetic_mano_model(device=dev)
        params, batch = make_opt_inputs(mano, batch=2, seed=0)
        _zero_counts()
        out, res = optimize_batch(mano, params, batch, strategy, OptConfig(save_mid_freq=10))
        assert launches("k1") == (1 if dev.type == "cuda" else 0)
        outs.append(({k: v.cpu() for k, v in out.items()}, res["collision_loss"].cpu()))
    (p_gpu, c_gpu), (p_cpu, c_cpu) = outs
    for k in p_cpu:
        np.testing.assert_allclose(p_gpu[k].numpy(), p_cpu[k].numpy(), atol=2e-4, err_msg=k)
    np.testing.assert_allclose(c_gpu.numpy(), c_cpu.numpy(), rtol=1e-3, atol=1e-6)


def test_nearest_kernel_matches_plain_version(cuda):
    mano = synthetic_mano_model(device=cuda)
    batch = make_mlp_inputs(mano, batch=4, seed=0)
    with torch.no_grad():
        rv, lv, _, _ = forward(mano, seed_from_backbone(batch))
    q = torch.cat([rv, lv])
    cent = _centroids(torch.cat([lv[:, mano.faces.flip(-1)], rv[:, mano.faces]]))
    qp, cp = NC.pad_inputs(q, cent)
    _zero_counts()
    idx = NC._launch_kernel(qp, cp, cent.shape[1])
    torch.cuda.synchronize()
    assert launches("k2") == 1
    ref = NC.nearest_centroid_reference(qp, cp, cent.shape[1])
    assert torch.equal(idx, ref)


def test_short_mlp_training_matches_cpu(cuda):
    _zero_counts()
    gpu = run_short_mlp(cuda)
    assert launches("k2") == 6  # one per train step
    gaps, masks_equal = short_mlp_gaps(gpu, run_short_mlp("cpu"))
    assert masks_equal
    for k, gap in gaps.items():
        assert gap <= SHORT_MLP_TOL[k], (k, gap)


@pytest.mark.parametrize("shape,dtype,offset", [
    ((3, 5, 7, 11), torch.float32, 0),  # ragged: masked scalar loads
    ((8, 64, 28, 28), torch.float32, 0),  # runs path, several slices
    ((8, 32, 14, 14), torch.bfloat16, 0),
    ((1061, 24), torch.float32, 0),  # (rows, C), the JAX function's layout
    ((8, 2048, 7, 7), torch.bfloat16, 0),  # tiles path: 7x7 in 16-byte loads
    ((8, 256, 14, 14), torch.bfloat16, 0),
    ((8, 512, 7, 7), torch.float32, 0),
    ((1, 2048, 7, 7), torch.float32, 0),  # B=1: one slice, no combine
    ((8, 1025, 14, 14), torch.float32, 0),  # C not a multiple of the channel tile
    ((8, 256, 14, 14), torch.float32, 1),  # base not 16-byte aligned: the masked walk
    ((8, 64, 28, 28), torch.bfloat16, 1),
])
def test_bn_stats_kernel_matches_float64(cuda, shape, dtype, offset):
    gen = torch.Generator(device="cuda").manual_seed(0)
    flat = (torch.randn((math.prod(shape) + offset,), generator=gen, device="cuda") * 2.0 + 0.5).to(dtype)
    x = flat[offset:].view(shape)  # contiguous; offset 1 moves its base off 16-byte alignment
    plan = K3.launch_plan(shape, x.element_size(), x.data_ptr() % 16 == 0)
    assert (x.data_ptr() % 16 == 0) == (offset == 0) and (not plan.vector if offset else True)
    _zero_counts()
    s, s2 = K3._launch_kernel(x)
    torch.cuda.synchronize()
    assert launches("k3") == 1
    dims = (0,) + tuple(range(2, x.dim()))
    x64 = x.double()
    ref_s, ref_q = x64.sum(dims), (x64 * x64).sum(dims)
    assert float(((s.double() - ref_s).abs() / x64.abs().sum(dims)).max()) <= 1e-5
    assert float(((s2.double() - ref_q).abs() / ref_q).max()) <= 1e-5
    again = []

    def launch():  # keeps the recorded (third) call's sums
        again[:] = K3._launch_kernel(x)

    kernels = device_kernels(launch)
    assert len(kernels) == 1 and "bn_stats" in kernels[0], kernels  # one device kernel a call
    assert torch.equal(s, again[0]) and torch.equal(s2, again[1])  # no float atomics: the same bits

    xg = x.clone().requires_grad_(True)
    gs, gs2 = torch.randn((2, x.shape[1]), generator=gen, device="cuda")
    a, b = K3.bn_stats(xg)
    (a * gs + b * gs2).sum().backward()
    view = (1, x.shape[1]) + (1,) * (x.dim() - 2)
    ref_gx = (gs.reshape(view) + 2.0 * x.float() * gs2.reshape(view)).to(dtype)
    torch.testing.assert_close(xg.grad, ref_gx, rtol=1e-6, atol=0)


def test_bn_stats_kernel_raises_on_other_layouts(cuda):
    x = torch.randn(4, 8, 6, 6, device="cuda")
    _zero_counts()
    with pytest.raises(ValueError):
        K3.bn_stats(x.to(memory_format=torch.channels_last))
    with pytest.raises(ValueError):
        K3.bn_stats(x[:, :, :, :3])
    with pytest.raises(ValueError):
        K3.bn_stats(x.half())
    assert launches("k3") == 0


def test_bn_stats_streams_keep_their_own_tickets(cuda):
    """Launches on two streams at once, on a runs-path shape whose channels
    span several slices (the ticket counters in use), give the one-stream
    results bit for bit; the first launch on a new stream inside a CUDA graph
    capture raises (its counters would not be zeroed before the graph runs)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    xs = [torch.randn((64, 128, 28, 28), generator=gen, device="cuda") for _ in range(2)]
    plan = K3.launch_plan(tuple(xs[0].shape), 4)
    assert plan.path == "runs" and plan.slices > 1
    want = [K3._launch_kernel(x) for x in xs]
    streams = [torch.cuda.Stream() for _ in xs]
    torch.cuda.synchronize()
    got = [None, None]
    for _ in range(10):  # interleaved, so that the streams' launches overlap
        for i, (x, s) in enumerate(zip(xs, streams)):
            with torch.cuda.stream(s):
                got[i] = K3._launch_kernel(x)
    torch.cuda.synchronize()
    for (s, s2), (gs, gs2) in zip(want, got):
        assert torch.equal(s, gs) and torch.equal(s2, gs2)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="capture"):
        with torch.cuda.graph(graph, stream=torch.cuda.Stream()):
            K3._launch_kernel(xs[0])


def test_short_training_matches_cpu(cuda):
    _zero_counts()
    gpu = run_short_train(cuda)
    # 20 BatchNorms x (the graph's warm-up run + its capture): a replay launches K3 from the graph, where no
    # wrapper runs
    assert launches("k3") == 40
    gaps = short_train_gaps(gpu, run_short_train("cpu"))
    for k, gap in gaps.items():
        assert gap <= SHORT_TRAIN_TOL[k], (k, gap)


def test_hoisted_engine_matches_full_decode(cuda):
    mano = synthetic_mano_model(device=cuda)
    params, batch = make_opt_inputs(mano, batch=2, seed=0)
    strategy = tuple(dataclasses.replace(s, epoch=20) for s in opt_default)
    outs = []
    for hoist in (True, False):
        _zero_counts()
        config = OptConfig(save_mid_freq=10, stage_hoist_decode=hoist)
        outs.append(optimize_batch(mano, params, batch, strategy, config)[0])
        torch.cuda.synchronize()
        assert launches("k1") == 1
    assert max(float((outs[0][k] - outs[1][k]).abs().max()) for k in params) <= 5e-5


def test_short_opt_eval_matches_cpu(cuda):
    gaps = short_eval_gaps(run_short_opt_eval(cuda), run_short_opt_eval("cpu"))
    assert set(gaps) == {"mpjpe_3d", "inter_mpjpe_3d", "collision_ave", "collision_max", "collision_auc"}
    assert all(v <= SHORT_EVAL_RTOL for v in gaps.values()), gaps




def test_short_predict_matches_cpu(cuda):
    _zero_counts()
    gpu = run_short_predict(cuda)
    assert (launches("k1"), launches("k2"), launches("k3")) == (0, 0, 0)  # eval-mode BN, no collision
    cpu = run_short_predict("cpu")
    for k, ref in cpu["fp32"].items():
        assert allclose_ratio(gpu["fp32"][k], ref, **PREDICT_TOL) <= 1.0, k
    ratios = bf16_band_ratios(gpu["bf16"], cpu["bf16"], cpu["fp32"])
    assert all(r <= BF16_BAND for r in ratios.values()), ratios
    # the band cannot tell an encoder that computes in fp32: the dtype can
    assert gpu["dtypes"] == cpu["dtypes"] == {"fp32": ["float32"], "bf16": ["bfloat16"]}
    assert all(np.abs(gpu["bf16"][k] - v).max() > 0 for k, v in gpu["fp32"].items())


def test_tracker_step_launches_the_exact_kernel_once(cuda):
    mano = synthetic_mano_model(device=cuda)
    params, batch = make_opt_inputs(mano, batch=2, seed=1000)
    tracker = TwoHandTracker(mano, streaming_strategy(6))
    state = tracker.init(params)
    _zero_counts()
    state, results = tracker.step(state, batch, params)
    torch.cuda.synchronize()
    assert (launches("k1"), launches("k2"), launches("k3")) == (1, 0, 0)
    assert state.frame_idx == 1 and bool(torch.isfinite(results["collision_loss"]).all())


def test_short_tracker_matches_cpu(cuda):
    assert short_tracker_gap(run_short_tracker(cuda), run_short_tracker("cpu")) <= 2e-4


def test_bf16_train_step_launches_k3_on_bf16(cuda):
    from ihmr_tpu_torch.models.resnet import BatchNorm
    from ihmr_tpu_torch.train.baseline import train_step

    inputs = make_train_bench_inputs(batch=2, image_size=64, arch="resnet50", bn_impl="pallas", device=cuda,
                                     dtype=torch.bfloat16)
    dtypes = []
    bns = [m for m in inputs.state.encoder.modules() if isinstance(m, BatchNorm)]
    hooks = [m.register_forward_pre_hook(lambda _m, args: dtypes.append(args[0].dtype)) for m in bns]
    _zero_counts()
    _, metrics = train_step(inputs.state, inputs.batch, inputs.mano_right, inputs.mano_left, inputs.config)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    # the first step: the wrapper runs in the graph's warm-up and in its capture, and so do the hooks;
    # the replay launches K3 from the graph
    assert launches("k3") == 2 * 53 and dtypes == [torch.bfloat16] * (2 * 53)
    assert all(bool(torch.isfinite(v).all()) for v in metrics.values())


def test_short_collision_paths_match_cpu(cuda):
    gaps, ok = short_collision_gaps(run_short_collision_paths(cuda), run_short_collision_paths("cpu"))
    print(f"collision paths, card vs CPU (params, collision): {gaps}")
    assert ok, gaps


def test_chunked_grid_build_gives_the_same_bits(cuda, monkeypatch):
    from ihmr_tpu_torch.ops import grid_sdf

    mano = synthetic_mano_model(device=cuda)
    params, _ = make_opt_inputs(mano, batch=4, seed=0, variant="interlocked")
    with torch.no_grad():
        rv, _, _, _ = forward(mano, params)
    whole = grid_sdf.build_penetration_grid(rv, mano.faces, res=32, num_candidates=8)
    monkeypatch.setattr(grid_sdf, "BUILD_CHUNK_PAIRS", 1000 * mano.faces.shape[0])  # 1000 rows a call
    chunked = grid_sdf.build_penetration_grid(rv, mano.faces, res=32, num_candidates=8)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)
    assert bool((whole[0] > 0).any())


def test_exact_kernel_in_the_loop_launches_once_a_step(cuda):
    from ihmr_tpu_torch.refine import compute_losses

    config = OptConfig(loop_collision_fast=False, loop_collision_subsample=1)
    weights = opt_default[1].weights
    grads = []
    for dev in (cuda, torch.device("cpu")):
        mano = synthetic_mano_model(device=dev)
        params, batch = make_opt_inputs(mano, batch=2, seed=0, variant="interlocked")
        leaves = {k: params[k].clone().requires_grad_(True) for k in ("right_orient", "left_orient")}
        _zero_counts()
        total, _ = compute_losses(mano, {**params, **leaves}, batch, weights, config, in_loop=True)
        grads.append([g.cpu() for g in torch.autograd.grad(total, list(leaves.values()))])
        torch.cuda.synchronize()
        assert launches("k1") == (1 if dev.type == "cuda" else 0)
    scale = max(float(g.abs().max()) for g in grads[1])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5 * scale)


@pytest.mark.parametrize("group,fsub", [(8, 1), (8, 2), (7, 2)])
def test_two_level_depth_matches_cpu(cuda, group, fsub):
    from ihmr_tpu_torch.ops import collision as C

    mano = synthetic_mano_model(device="cpu")
    params, _ = make_opt_inputs(mano, batch=8, seed=0, variant="interlocked")
    with torch.no_grad():
        rv, lv, _, _ = forward(mano, params)  # the same vertices on both devices
    out = {}
    for dev in (cuda, torch.device("cpu")):
        r, l, faces = rv.to(dev), lv.to(dev), mano.faces[::fsub].to(dev)
        out[dev.type] = (C.nearest_faces_2level(r[:, ::2], l[:, faces], group).cpu(),
                         C.penetration_depth_2level(r[:, ::2], l, faces, group).cpu(),
                         [t.cpu() for t in C.pair_select_tris(r[:, ::2], l[:, ::2], r, l, faces, faces.flip(-1))])
    (idx_g, depth_g, tris_g), (idx_c, depth_c, tris_c) = out["cuda"], out["cpu"]
    assert torch.equal(idx_g, idx_c)
    np.testing.assert_allclose(depth_g.numpy(), depth_c.numpy(), atol=1e-5, rtol=0)
    assert bool((depth_c > 0).any())
    assert all(torch.equal(a, b) for a, b in zip(tris_g, tris_c))
