"""Data parallelism (``parallel/mesh.py``) on the card. These tests need an
NVIDIA card and skip without one; this file imports nothing of JAX, so on
the GPU machine:

    python3 -m pytest --noconftest -m cuda tests/test_torch_port_mesh_cuda.py

Two shards on one card (``[cuda:0] * 2``, each on its own stream) against
the one-device run: the OPT workload's ``optimize_batch`` at B=8
(``make_opt_inputs(seed=1)``, ``opt_default``'s first two stages at epoch
6, ``save_mid_freq=2``), every sample's refined params within 5e-5 (the
JAX package's bound between its engines; the card's batched products may
round differently at B=4 than at B=8) and K1 once a shard; the
data-parallel train step of ResNet-18 at 64x64, B=8, ``bn_impl="pallas"``,
within ``pipeline.DP_TOL`` with K3 launched once per BatchNorm and shard
(20 x 2), no gradient crossing streams into a parameter, a second run
within ``pipeline.DP_REPEAT_TOL`` of the first and two more under
deterministic algorithms equal to the bit; the same checks fail on a
planted fault (``pipeline.planted_dp_fault``: each BatchNorm on its own
shard's statistics). A mesh over every card (``make_mesh()``) runs the same
step when the machine has two or more.
"""

import dataclasses
import warnings

import pytest
import torch

from ihmr_tpu_torch import profiling
from ihmr_tpu_torch.data import make_opt_inputs
from ihmr_tpu_torch.device import set_fp32_matmul_precision
from ihmr_tpu_torch.mano import synthetic_mano_model
from ihmr_tpu_torch.models.resnet import BatchNorm
from ihmr_tpu_torch.parallel import gather_to_host, make_mesh, replicate, shard_batch
from ihmr_tpu_torch.pipeline import (
    DP_REPEAT_TOL,
    DP_TOL,
    deterministic_algorithms,
    dp_gaps,
    dp_grads,
    dp_within,
    grad_bits_gap,
    make_train_bench_inputs,
    one_device_grads,
    planted_dp_fault,
)
from ihmr_tpu_torch.refine import OptConfig, opt_default, optimize_batch

pytestmark = pytest.mark.cuda

OPT_TOL = 5e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the port's kernels have no CPU mode)")
    set_fp32_matmul_precision()
    return torch.device("cuda")


def test_sharded_opt_on_one_card_matches_one_device(cuda):
    mano = synthetic_mano_model(device=cuda)
    params, batch = make_opt_inputs(mano, batch=8, seed=1)
    strategy = tuple(dataclasses.replace(s, epoch=6) for s in opt_default[:2])
    config = OptConfig(save_mid_freq=2)
    one, _ = optimize_batch(mano, params, batch, strategy, config)
    mesh = make_mesh([cuda] * 2)
    with profiling.recording() as rec:
        out, results = optimize_batch(replicate(mano, mesh), shard_batch(params, mesh), shard_batch(batch, mesh),
                                      strategy, config)
        torch.cuda.synchronize()
    assert rec.counters.get("k1.launches", 0) == 2
    out = gather_to_host(out)
    gap = max(float((torch.as_tensor(out[k]) - v.cpu()).abs().max()) for k, v in one.items())
    assert gap <= OPT_TOL, gap
    assert gather_to_host(results)["collision_loss"].shape == (8,)


def _check_dp_step(inputs, mesh):
    one = one_device_grads(inputs)
    bns = sum(isinstance(m, BatchNorm) for m in inputs.state.encoder.modules())
    torch.cuda.synchronize()
    with profiling.recording() as rec, warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        dp = dp_grads(inputs, mesh)
        torch.cuda.synchronize()
    assert rec.counters.get("k3.launches", 0) == bns * mesh.size
    assert not [w for w in caught if "AccumulateGrad" in str(w.message)]
    gaps = dp_gaps(dp, one)
    assert dp_within(gaps, DP_TOL), gaps
    spread = dp_gaps(dp_grads(inputs, mesh), dp)
    assert dp_within(spread, DP_REPEAT_TOL), spread
    with deterministic_algorithms():
        first, second = dp_grads(inputs, mesh), dp_grads(inputs, mesh)
    assert grad_bits_gap(second, first) == 0.0 and first.loss == second.loss


def test_dp_step_on_one_card_matches_one_device(cuda):
    inputs = make_train_bench_inputs(batch=8, image_size=64, arch="resnet18", bn_impl="pallas", device=cuda)
    _check_dp_step(inputs, make_mesh([cuda] * 2))


def test_mesh_devices_carry_their_index(cuda):
    mesh = make_mesh([cuda] * 2)
    assert mesh.devices == (torch.device("cuda", torch.cuda.current_device()),) * 2


def test_dp_checks_catch_shard_local_statistics(cuda):
    inputs = make_train_bench_inputs(batch=8, image_size=64, arch="resnet18", bn_impl="pallas", device=cuda)
    one = one_device_grads(inputs)
    with planted_dp_fault("local"):
        gaps = dp_gaps(dp_grads(inputs, make_mesh([cuda] * 2)), one)
    assert not dp_within(gaps, DP_TOL), gaps


def test_dp_step_over_every_card(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs two or more cards for a mesh of distinct devices; this machine has {torch.cuda.device_count()}")
    inputs = make_train_bench_inputs(batch=8, image_size=64, arch="resnet18", bn_impl="pallas", device=cuda)
    mesh = make_mesh()
    if 8 % mesh.size:
        pytest.skip(f"B=8 does not split over {mesh.size} cards")
    _check_dp_step(inputs, mesh)
