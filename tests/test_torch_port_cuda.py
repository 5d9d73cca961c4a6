"""Tests of the port that need an NVIDIA card (the hand-written kernels have
no CPU mode). They skip without one. This file imports nothing of JAX, so it
also runs where JAX is not installed; on the GPU machine:

    python3 -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances: depths 1e-5 absolute, directions 1e-4 where both sides are
inside, inside signs equal on >= 99.9% of queries (the same fp32 arithmetic
as the plain version, tie-set sums in another order); nearest-centroid
indices 100% equal (the same rank arithmetic and tie rules, no sums that
depend on order); a short refinement on the card and on the CPU within
2e-4 (the slice test's bound); a short MLP training on both within
``pipeline.SHORT_MLP_TOL`` (trained weights 1e-5, residuals 2e-6), accept
masks equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ihmr_tpu_torch import resolve_device
from ihmr_tpu_torch.data import make_mlp_inputs, make_opt_inputs
from ihmr_tpu_torch.device import set_fp32_matmul_precision
from ihmr_tpu_torch.mano import synthetic_mano_model
from ihmr_tpu_torch.ops import exact_collision as K
from ihmr_tpu_torch.ops import nearest_centroid as NC
from ihmr_tpu_torch.ops.collision import _centroids
from ihmr_tpu_torch.pipeline import SHORT_MLP_TOL, run_short_mlp, short_mlp_gaps
from ihmr_tpu_torch.refine import OptConfig, forward, opt_default, optimize_batch
from ihmr_tpu_torch.refine.mlp_engine import seed_from_backbone

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


def test_default_device_is_cuda(cuda):
    assert resolve_device().type == "cuda"
    assert synthetic_mano_model().device.type == "cuda"


def test_kernel_matches_plain_version(cuda):
    q, tri = _hand_pairs(cuda)
    qp, tp, bounds = K.pad_inputs(q, tri)
    K.reset_launch_count()
    depth, dirs = K._launch_kernel(qp, tp, bounds, tri.shape[1])
    torch.cuda.synchronize()
    assert K.launch_count == 1
    ref, ref_dirs, _ = K.exact_penetration_depth_reference(qp, tp, bounds, tri.shape[1])
    assert float((depth - ref).abs().max()) <= 1e-5
    assert float(((depth > 0) == (ref > 0)).float().mean()) >= 0.999
    both = (depth > 0) & (ref > 0)
    assert bool(both.any())
    assert float((dirs - ref_dirs)[both].abs().max()) <= 1e-4


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
        K.reset_launch_count()
        out, res = optimize_batch(mano, params, batch, strategy, OptConfig(save_mid_freq=10))
        assert K.launch_count == (1 if dev.type == "cuda" else 0)
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
    NC.reset_launch_count()
    idx = NC._launch_kernel(qp, cp, cent.shape[1])
    torch.cuda.synchronize()
    assert NC.launch_count == 1
    ref = NC.nearest_centroid_reference(qp, cp, cent.shape[1])
    assert torch.equal(idx, ref)


def test_short_mlp_training_matches_cpu(cuda):
    NC.reset_launch_count()
    gpu = run_short_mlp(cuda)
    assert NC.launch_count == 6  # one per train step
    gaps, masks_equal = short_mlp_gaps(gpu, run_short_mlp("cpu"))
    assert masks_equal
    for k, gap in gaps.items():
        assert gap <= SHORT_MLP_TOL[k], (k, gap)
