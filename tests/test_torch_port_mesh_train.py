"""The port's data-parallel train step (``train/baseline.py::dp_loss_and_grads``)
against the JAX package's, each on 8 devices of the CPU.

The setup of ``tests/test_parallel.py::test_dp_train_step_matches_single_device``:
ResNet-18 at 64x64, B=8, ``TrainConfig(lr=1e-3, num_candidates=4)``, the
batch of ``generate(model, 8, seed=0, noise=0.1)`` and seeded images. The
weights are seeded numpy (``tests/test_torch_port_train.py::_init_variables``,
not flax's init, which compiles for tens of seconds here) and carried into
the port by ``convert.encoder_from_jax``. JAX runs its one program over the
global batch on its 8-device virtual mesh (``tests/conftest.py``): the
batch sharded, the params replicated, flax's stock BatchNorm on the global
batch's moments; it compiles once for the module. The port runs the same
step over 8 CPU shards of one sample each, with ``bn_impl`` "fused" (K3's
plain version) and "stock".

Bounds: loss within 1e-5 relative and the running statistics after the
step within 1e-5 of the ``new_stats`` JAX's ``forward_and_loss`` returns,
as the JAX test holds its own DP step. Gradients: 1e-4 (the JAX test's
absolute bound) times max(1, the tensor's largest |g|). The JAX test's
flax init gives gradients of order 1; these weights give up to 384
(``regressor_ih.0.weight``), where fp32 rounding alone is 2.1e-4 absolute
(5.6e-7 of that tensor's largest entry). Measured, "fused" and "stock"
alike: loss 4.0e-7 relative, gradients at most 1.2e-5 of a tensor's
largest |g| (``layer4.1.conv2``, 6.2e-5 absolute), running statistics
4.8e-7. The teeth case runs the 8 shards with each BatchNorm on its own
shard's statistics, as 8 processes each running ``train_step``'s loss
would: one sample a BatchNorm, so its gradients miss JAX's by 11.4 in the
same units (its loss by 15% relative), and it must miss by at least 100x
the bound.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ihmr_tpu.data.synthetic import generate as jax_generate
from ihmr_tpu.mano.loader import mirror_mano_model as jax_mirror
from ihmr_tpu.mano.loader import synthetic_mano_model as jax_synthetic
from ihmr_tpu.models.encoder import InterHandEncoder as FlaxEncoder
from ihmr_tpu.models.encoder import build_mean_params as jax_mean_params
from ihmr_tpu.parallel import make_mesh as jax_make_mesh
from ihmr_tpu.parallel import replicate as jax_replicate
from ihmr_tpu.parallel import shard_batch as jax_shard_batch
from ihmr_tpu.train import baseline as JB
from ihmr_tpu_torch.convert import encoder_from_jax
from ihmr_tpu_torch.mano import mirror_mano_model, synthetic_mano_model
from ihmr_tpu_torch.models import resnet
from ihmr_tpu_torch.parallel import make_mesh, replicate, shard_batch
from ihmr_tpu_torch.train import baseline as TB
from tests.test_torch_port_train import _by_torch_key, _init_variables
from tests.torch_threads import one_torch_thread  # noqa: F401

B, LR, SHARDS = 8, 1e-3, 8
LOSS_RTOL, GRAD_TOL, STATS_TOL = 1e-5, 1e-4, 1e-5
TEETH = 100  # the shard-local gap must exceed the bound this many times


def T(x):
    return torch.tensor(np.asarray(x))


def _jax_batch(model):
    """The batch of tests/test_parallel.py's DP test."""
    d = jax_generate(model, B, seed=0, noise=0.1)
    ones = jnp.ones((B, 42, 1), jnp.float32)
    rng = np.random.RandomState(0)
    return JB.BaselineBatch(
        img=jnp.asarray(rng.randn(B, 64, 64, 3).astype(np.float32)) * 0.1,
        hand_type_array=jnp.ones((B, 2)),
        hand_type_valid=jnp.ones((B, 1)),
        joints_2d=jnp.concatenate([d["gt_j2"], ones], axis=-1),
        joints_3d=jnp.concatenate([d["gt_j3"], ones], axis=-1),
        gt_pose_params=d["gt_pose"],
        gt_shape_params=d["gt_shape"],
        mano_params_weight=jnp.ones((B, 2)),
        hand_trans=jnp.concatenate([d["gt_trans"], jnp.ones((B, 1))], axis=-1)[:, None, :],
        do_flip=jnp.zeros((B,), jnp.int32),
    )


@pytest.fixture(scope="module")
def jax_dp():
    """JAX's DP loss, gradients and new batch statistics (one compile)."""
    model = jax_synthetic()
    left = jax_mirror(model)
    encoder = FlaxEncoder(arch="resnet18")
    config = JB.TrainConfig(lr=LR, num_candidates=4)
    mean = jax_mean_params(np.zeros(48), np.zeros(10))
    variables = _init_variables(encoder, mean, np.random.RandomState(0))
    batch = _jax_batch(model)

    def f(params, stats, batch_in, mr, ml):
        total, (_, new_stats, _) = JB.forward_and_loss(
            encoder, params, stats, mean, batch_in, mr, ml, config, train=True
        )
        return total, new_stats

    mesh = jax_make_mesh()
    assert mesh.devices.size == SHARDS
    with mesh:
        (loss, new_stats), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
            jax_replicate(jax.tree_util.tree_map(jnp.asarray, variables["params"]), mesh),
            jax_replicate(jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]), mesh),
            jax_shard_batch(batch, mesh), jax_replicate(model, mesh), jax_replicate(left, mesh),
        )
    return dict(
        variables=variables, mean=np.asarray(mean), batch=batch, loss=float(loss),
        grads=_by_torch_key("params", grads), stats=_by_torch_key("batch_stats", new_stats),
    )


def _port_dp(jax_dp, impl):
    """The port's DP loss, gradients and running statistics after the step."""
    encoder = encoder_from_jax(jax_dp["variables"], arch="resnet18", device="cpu", bn_impl=impl)
    state = TB.create_state(encoder, T(jax_dp["mean"]), TB.TrainConfig(lr=LR, num_candidates=4))
    batch = TB.BaselineBatch(**{f.name: T(getattr(jax_dp["batch"], f.name)) for f in dataclasses.fields(TB.BaselineBatch)})
    mesh = make_mesh(["cpu"] * SHARDS)
    mano_right = synthetic_mano_model(device="cpu")
    loss, _, grads = TB.dp_loss_and_grads(
        replicate(state, mesh), shard_batch(batch, mesh), mano_right, mirror_mano_model(mano_right),
        TB.TrainConfig(lr=LR, num_candidates=4),
    )
    stats = {k: v.numpy() for k, v in encoder.state_dict().items() if k.endswith(("running_mean", "running_var"))}
    return float(loss), {k: g.numpy() for k, g in grads.items()}, stats


def _grad_gap(grads, ref):
    """The largest gap of any tensor, in units of max(1, its largest |g|)."""
    assert set(grads) == set(ref) and len(ref) == 68  # every parameter of the resnet18 encoder
    return max(float(np.abs(grads[k] - ref[k]).max() / max(1.0, np.abs(ref[k]).max())) for k in ref)


@pytest.mark.parametrize("impl", ["fused", "stock"])
def test_dp_step_matches_jax_dp_step(jax_dp, impl):
    loss, grads, stats = _port_dp(jax_dp, impl)
    np.testing.assert_allclose(loss, jax_dp["loss"], rtol=LOSS_RTOL)
    gap = _grad_gap(grads, jax_dp["grads"])
    assert gap <= GRAD_TOL, gap
    assert len(stats) == len(jax_dp["stats"]) == 40  # 20 BatchNorms x (mean, var)
    for k, v in jax_dp["stats"].items():
        np.testing.assert_allclose(stats[k], v, rtol=STATS_TOL, atol=STATS_TOL, err_msg=k)
    moved = max(np.abs(v - (1.0 if k.endswith("var") else 0.0)).max() for k, v in jax_dp["stats"].items())
    assert moved > 1e-2  # the update is visible


def test_shard_local_statistics_miss_jax(jax_dp, monkeypatch):
    """Each BatchNorm on its own shard's one sample: the step the reduction
    across shards replaces."""
    monkeypatch.setattr(resnet, "current_shard", lambda: None)
    _, grads, _ = _port_dp(jax_dp, "fused")
    gap = _grad_gap(grads, jax_dp["grads"])
    assert gap > TEETH * GRAD_TOL, gap
