"""Parity of the port's core, MANO and loss modules with the JAX package.

The same numpy inputs go through the JAX function and its port in
``ihmr_tpu_torch`` (on the CPU). Tolerances: rotations and projection 1e-6
absolute (fp32 elementwise math), synthetic MANO arrays and face order
exactly equal (same numpy draws), two-hand decode 1e-5 absolute (fp32
contractions summed in another order), OPT losses 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ihmr_tpu.core.projection import orthographic_project as jax_project
from ihmr_tpu.core.rotations import axis_angle_to_matrix as jax_aa2mat
from ihmr_tpu.core.rotations import flip_hand_pose as jax_flip
from ihmr_tpu.losses import losses as JL
from ihmr_tpu.mano import layer as jax_layer
from ihmr_tpu.mano.loader import mirror_mano_model as jax_mirror
from ihmr_tpu.mano.loader import synthetic_mano_model as jax_synthetic
from ihmr_tpu_torch import resolve_device
from ihmr_tpu_torch.convert import mano_from_numpy
from ihmr_tpu_torch.core import axis_angle_to_matrix, flip_hand_pose, orthographic_project
from ihmr_tpu_torch.losses import losses as TL
from ihmr_tpu_torch.mano import layer as torch_layer
from ihmr_tpu_torch.mano.loader import mirror_mano_model, synthetic_mano_arrays, synthetic_mano_model
from tests.torch_threads import one_torch_thread  # noqa: F401

MANO_FIELDS = ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights", "faces")


def T(x):
    return torch.as_tensor(np.asarray(x))


@pytest.fixture(scope="module")
def jax_mano():
    return jax_synthetic()


@pytest.fixture(scope="module")
def torch_mano():
    return synthetic_mano_model(device="cpu")


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device()
        with pytest.raises(RuntimeError):
            synthetic_mano_model()


@pytest.mark.parametrize("scale", [1e-9, 1e-3, 0.5, 3.0])
def test_axis_angle_to_matrix(scale):
    aa = (np.random.RandomState(0).randn(64, 16, 3) * scale).astype(np.float32)
    np.testing.assert_allclose(
        axis_angle_to_matrix(T(aa)).numpy(), np.asarray(jax_aa2mat(jnp.asarray(aa))), atol=1e-6
    )


@pytest.mark.parametrize("shape", [(4, 45), (4, 15, 3), (3,)])
def test_flip_hand_pose(shape):
    pose = np.random.RandomState(1).randn(*shape).astype(np.float32)
    np.testing.assert_array_equal(flip_hand_pose(T(pose)).numpy(), np.asarray(jax_flip(jnp.asarray(pose))))


def test_orthographic_project():
    rng = np.random.RandomState(2)
    pts = rng.randn(5, 42, 3).astype(np.float32)
    cam = rng.randn(5, 3).astype(np.float32)
    np.testing.assert_allclose(
        orthographic_project(T(pts), T(cam)).numpy(),
        np.asarray(jax_project(jnp.asarray(pts), jnp.asarray(cam))),
        atol=1e-6,
    )


def test_synthetic_mano_arrays_equal(jax_mano, torch_mano):
    for name in MANO_FIELDS:
        ours = getattr(torch_mano, name).numpy()
        ref = np.asarray(getattr(jax_mano, name))
        assert ours.shape == ref.shape, name
        np.testing.assert_array_equal(ours, ref.astype(ours.dtype), err_msg=name)
    # the Morton face order the in-loop face stride relies on
    np.testing.assert_array_equal(synthetic_mano_arrays()["faces"], np.asarray(jax_mano.faces))


def test_mirror_mano_model_equal(jax_mano, torch_mano):
    ours, ref = mirror_mano_model(torch_mano), jax_mirror(jax_mano)
    for name in MANO_FIELDS:
        np.testing.assert_array_equal(
            getattr(ours, name).numpy(), np.asarray(getattr(ref, name)).astype(getattr(ours, name).numpy().dtype)
        )
    assert ours.is_rhand is False


def test_mano_from_numpy_roundtrip(jax_mano):
    m = mano_from_numpy(*(np.asarray(getattr(jax_mano, f)) for f in MANO_FIELDS), device="cpu")
    np.testing.assert_array_equal(m.faces.numpy(), np.asarray(jax_mano.faces))
    np.testing.assert_array_equal(m.posedirs.numpy(), np.asarray(jax_mano.posedirs))


def _decode_inputs(B, seed):
    rng = np.random.RandomState(seed)
    f = lambda *s, k=0.3: (rng.randn(*s) * k).astype(np.float32)
    return dict(
        right_orient=f(B, 3, k=1.0), left_orient=f(B, 3, k=1.0),
        right_pose=f(B, 45), left_pose=f(B, 45),
        right_shape=f(B, 10, k=1.0), left_shape=f(B, 10, k=1.0),
        trans=f(B, 3, k=0.05),
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_two_hand_decode_mirrored(jax_mano, torch_mano, seed):
    x = _decode_inputs(3, seed)
    ref = jax.jit(jax_layer.two_hand_decode_mirrored)(jax_mano, **{k: jnp.asarray(v) for k, v in x.items()})
    ours = torch_layer.two_hand_decode_mirrored(torch_mano, **{k: T(v) for k, v in x.items()})
    for o, r in zip(ours, ref):
        assert tuple(o.shape) == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5)


def test_mano_decode_single_hand(jax_mano, torch_mano):
    x = _decode_inputs(3, 2)
    args = (x["right_orient"], x["right_pose"], x["right_shape"])
    rv, rj = jax.jit(jax_layer.mano_decode)(jax_mano, *map(jnp.asarray, args))
    tv, tj = torch_layer.mano_decode(torch_mano, *map(T, args))
    np.testing.assert_allclose(tv.numpy(), np.asarray(rv), atol=1e-5)
    np.testing.assert_allclose(tj.numpy(), np.asarray(rj), atol=1e-5)
    np.testing.assert_allclose(
        torch_layer.joints21(tv, tj).numpy(), np.asarray(jax_layer.joints21(rv, rj)), atol=1e-5
    )


def _loss_inputs(seed, B=4):
    rng = np.random.RandomState(seed)
    weight = (rng.rand(B, 42, 1) > 0.2).astype(np.float32)
    weight[0, 0, 0] = 0.0  # no right wrist: align by the left
    weight[1, 0, 0] = 0.3  # between 1e-7 and 0.5: left unaligned
    return dict(
        j2_gt=rng.randn(B, 42, 2).astype(np.float32), j2_pred=rng.randn(B, 42, 2).astype(np.float32),
        j3_gt=rng.randn(B, 42, 3).astype(np.float32), j3_pred=rng.randn(B, 42, 3).astype(np.float32),
        weight=weight, trans_gt=rng.randn(B, 1, 3).astype(np.float32),
        trans_pred=rng.randn(B, 3).astype(np.float32), trans_w=rng.rand(B, 1, 1).astype(np.float32),
        shape=rng.randn(B, 20).astype(np.float32),
    )


@pytest.mark.parametrize(
    "name",
    ["joints_2d_loss", "joints_3d_loss", "hand_trans_loss", "shape_reg_loss", "finger_reg_loss"],
)
def test_opt_losses(name):
    x = _loss_inputs(3)
    args = {
        "joints_2d_loss": ("j2_gt", "j2_pred", "weight"),
        "joints_3d_loss": ("j3_gt", "j3_pred", "weight"),
        "hand_trans_loss": ("trans_gt", "trans_pred", "trans_w"),
        "shape_reg_loss": ("shape",),
        "finger_reg_loss": ("j3_pred",),
    }[name]
    ref = getattr(JL, name)(*(jnp.asarray(x[a]) for a in args))
    ours = getattr(TL, name)(*(T(x[a]) for a in args))
    ref = ref if isinstance(ref, tuple) else (ref,)
    ours = ours if isinstance(ours, tuple) else (ours,)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5, atol=1e-7)
